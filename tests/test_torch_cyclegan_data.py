"""The CycleGAN family's data reader and evaluation dispatch against vst's
on the CPU: ``CycleGANFC2Dataset`` on a written styled tree
(``generate_fc2_corpus``, procedural: 5 names, 32²) gives vst's order and
arrays, exactly (both read JPEGs through PIL); ``cyclegan_stylize_fn``
over three models gives vst's outputs within 1e-5 absolute, the style
index clipped into range."""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import random_params, torch_threads  # noqa: F401
from vst.data.fc2 import CycleGANFC2Dataset as JCycleGANFC2Dataset
from vst.eval.drivers import cyclegan_stylize_fn as jcyclegan_stylize_fn
from vst.models.cyclegan import ResnetGenerator as JResnetGenerator
from vst_torch.convert import cyclegan_generator_state_dict_from_jax
from vst_torch.data.datagen import generate_fc2_corpus
from vst_torch.data.fc2 import CycleGANFC2Dataset
from vst_torch.eval.drivers import cyclegan_stylize_fn
from vst_torch.models.cyclegan import ResnetGenerator
from vst_torch.train.cyclegan import cyclegan_batch

ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("styled"))
    generate_fc2_corpus(root, 5, hw=(32, 32), seed=2, styler="procedural", device="cpu")
    return root


@pytest.mark.parametrize("sid,with_flow", [(1, True), (2, False)])
def test_dataset_matches_vst(corpus, sid, with_flow):
    got = CycleGANFC2Dataset(corpus, sid=sid, with_flow=with_flow)
    want = JCycleGANFC2Dataset(corpus, sid=sid, with_flow=with_flow)
    assert got.dataset == want.dataset and len(got) == len(want) == 5
    assert got.dataset[0][1].endswith("_2.jpg")
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert set(a) == set(b) == {"real_A", "real_A2", "real_B", "real_B2"} | (
            {"mask", "flow"} if with_flow else set())
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    for a, b in zip(got.epoch(2, seed=3), want.epoch(2, seed=3)):
        assert all(np.array_equal(a[k], b[k]) for k in b)
    batch = cyclegan_batch(next(got.epoch(2, seed=3)), "cpu")
    assert batch["real_A"].shape == (2, 3, 32, 32) and batch["real_A"].dtype == torch.float32


def test_stylize_fn_matches_vst():
    x = np.random.RandomState(0).rand(1, 32, 48, 3).astype(np.float32) * 2 - 1
    jnet = JResnetGenerator(3, 4, 2)
    tps, gens = [], []
    for m in range(3):
        params = random_params(jnet, (x,), seed=20 + m, std=0.1)
        g = ResnetGenerator(3, 3, 4, 2).eval()
        g.load_state_dict(cyclegan_generator_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params), "resnet_2blocks"))
        tps.append((types.SimpleNamespace(G_A=jnet), {"G_A": params}))
        gens.append(g)
    fn, jfn = cyclegan_stylize_fn(gens), jcyclegan_stylize_fn(tps)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    outs = []
    for style in (0, 1, 2, 7):  # 7: clipped to the last model
        want = np.asarray(jfn(jnp.asarray(x), style))
        with torch.no_grad():
            got = fn(xt, torch.tensor(style)).numpy().transpose(0, 2, 3, 1)
        assert np.abs(got - want).max() <= ATOL
        outs.append(got)
    assert not np.allclose(outs[0], outs[1]) and np.array_equal(outs[2], outs[3])
