"""The StarGAN Sintel drivers and the v2 debug grid against vst's, on the
CPU: ``evaluate_sintel_stargan2`` / ``evaluate_sintel_stargan`` on a
6-frame synthetic clip at 32×48 with given styles and RAFT at 2 iterations
(the same weights on both sides) against vst's ``evaluate_videos`` with its
``stargan2_stylize_fn`` / ``stargan_stylize_fn``: every TCL value within
``RTOL_TCL`` = 1e-4 relative. StarGAN v2 runs vst's 256-pixel layout at
max width 32 (four downsamples: 32×48 divides by 16), v1 at conv_dim 8."""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_sintel import _video
from torch_gan_parity import torch_threads  # noqa: F401
from vst.eval.drivers import stargan2_stylize_fn as jstargan2_stylize_fn
from vst.eval.drivers import evaluate_sintel_stargan as jevaluate_sintel_stargan
from vst.eval.sintel import evaluate_videos as jevaluate_videos
from vst.eval.sintel import load_sintel_videos as jload_sintel_videos
from vst.eval.video import translate_and_reconstruct as jtranslate_and_reconstruct
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst.models.stargan import Generator as JG1
from vst.models.stargan2 import Generator as JG2
from vst.models.stargan2 import MappingNetwork as JMapping
from vst.models.stargan2 import generator_params_from_torch, mapping_params_from_torch
from vst_torch.convert import stargan_generator_state_dict_from_jax
from vst_torch.eval.drivers import (evaluate_sintel_stargan, evaluate_sintel_stargan2,
                                    stargan2_styles)
from vst_torch.eval.sintel import SintelVideo, load_sintel_videos
from vst_torch.eval.video import denormalize, image_grid, translate_and_reconstruct, write_png
from vst_torch.flow.raft import RAFT
from vst_torch.models.stargan import Generator as G1
from vst_torch.models.stargan2 import Generator as G2
from vst_torch.models.stargan2 import MappingNetwork

RTOL_TCL = 1e-4
NUM_DOM = 4
SG2 = dict(img_size=256, style_dim=8, max_conv_dim=32)


@pytest.fixture(scope="module")
def clip_and_raft():
    frames, _ = _video(n_frames=6, seed=4)
    torch.manual_seed(0)
    raft = RAFT(iters=2).eval()
    jraft, jparams = JRAFT(small=False, iters=2), {"params": raft_params_from_torch(
        raft.state_dict())}
    return (SintelVideo("toy", frames), lambda a, b: raft(a, b),
            lambda a, b: jraft.apply(jparams, a, b))


def assert_tcl_agrees(got, want):
    for out_id in ("TCL-ST", "TCL-LT"):
        assert set(got[out_id]) == set(want[out_id])
        for k, v in want[out_id].items():
            assert v > 0.0, k
            np.testing.assert_allclose(got[out_id][k], v, rtol=RTOL_TCL, err_msg=k)


def test_evaluate_sintel_stargan2_matches_vst(clip_and_raft):
    video, raft_apply, jraft_apply = clip_and_raft
    torch.manual_seed(1)
    g = G2(SG2["img_size"], SG2["style_dim"], SG2["max_conv_dim"]).eval()
    f = MappingNetwork(4, SG2["style_dim"], NUM_DOM).eval()
    styles = stargan2_styles(NUM_DOM, 4, seed=3)
    got = evaluate_sintel_stargan2(g, f, [video], raft_apply, num_domains=NUM_DOM, styles=styles,
                                   dt_iters=1, device="cpu")
    trainer = types.SimpleNamespace(G=JG2(**SG2), F=JMapping(4, SG2["style_dim"], NUM_DOM))
    params = {"generator": generator_params_from_torch(g.state_dict(), SG2["img_size"]),
              "mapping": mapping_params_from_torch(f.state_dict())}
    want = jevaluate_videos([video], jstargan2_stylize_fn(trainer, params, 4), jraft_apply,
                            styles=[(y, jnp.asarray(z.numpy())) for y, z in styles],
                            frame_transform=lambda x: x * 2.0 - 1.0, num_domains=NUM_DOM,
                            dt_iters=1)
    assert_tcl_agrees(got, want)
    assert {f"TCL-ST_mean_s{d}" for d in (1, 2, 3)} <= set(got["TCL-ST"])


def test_stargan2_styles_are_seeded():
    a, b = stargan2_styles(NUM_DOM, 16, seed=777), stargan2_styles(NUM_DOM, 16, seed=777)
    assert [y for y, _ in a] == [1, 2, 3]
    assert all(torch.equal(za, zb) and za.shape == (1, 16) for (_, za), (_, zb) in zip(a, b))


def test_evaluate_sintel_stargan_matches_vst(clip_and_raft):
    video, raft_apply, jraft_apply = clip_and_raft
    jg = JG1(conv_dim=8, c_dim=NUM_DOM, repeat_num=2)
    params = jg.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 48, 3)),
                     jnp.zeros((1, NUM_DOM)))["params"]
    g = G1(conv_dim=8, c_dim=NUM_DOM, repeat_num=2).eval()
    g.load_state_dict(stargan_generator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    got = evaluate_sintel_stargan(g, [video], raft_apply, c_dim=NUM_DOM, dt_iters=1,
                                  device="cpu")
    want = jevaluate_sintel_stargan(types.SimpleNamespace(G=jg), params, [video], jraft_apply,
                                    c_dim=NUM_DOM, dt_iters=1)
    assert_tcl_agrees(got, want)


def test_translate_and_reconstruct_matches_vst(tmp_path):
    """The grid's orchestration, with stand-in nets on both sides: rows of
    src, ref, fake, rec in [0, 1], the batch side by side; the PNG written."""
    rng = np.random.RandomState(6)
    x_src, x_ref = (rng.uniform(-1.2, 1.2, (3, 8, 10, 3)).astype(np.float32) for _ in range(2))
    y_src, y_ref = np.asarray([0, 1, 2]), np.asarray([2, 2, 0])

    def jgen(x, s):
        return jnp.tanh(x * s[:, None, None, :3])

    def jenc(x, y):
        return jnp.mean(x, axis=(1, 2)) + jnp.asarray(y, x.dtype)[:, None]

    def gen(x, s):
        return torch.tanh(x * s[:, :3, None, None])

    def enc(x, y):
        return x.mean((2, 3)) + torch.as_tensor(y, dtype=x.dtype)[:, None]

    want = jtranslate_and_reconstruct(jgen, jenc, x_src, y_src, x_ref, y_ref)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    path = tmp_path / "grid" / "sample.png"
    got = translate_and_reconstruct(gen, enc, nchw(x_src), y_src, nchw(x_ref), y_ref,
                                    filename=str(path))
    assert got.shape == (4 * 8, 3 * 10, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(denormalize(np.asarray([-2.0, 0.0, 0.5, 3.0])),
                                  [0.0, 0.5, 0.75, 1.0])
    assert image_grid([[np.zeros((2, 3, 3))] * 2] * 3).shape == (6, 6, 3)


def test_load_sintel_videos_reads_without_imageio(tmp_path):
    """A Sintel tree (training/final and test/final) read through PIL equals
    vst's read through imageio: names, order, the 432-row crop, values."""
    rng = np.random.RandomState(8)
    for split, vid, n in (("training", "alley_1", 3), ("training", "bamboo_2", 2),
                          ("test", "ambush_1", 2)):
        d = tmp_path / split / "final" / vid
        d.mkdir(parents=True)
        for i in range(n):
            write_png(str(d / f"frame_{i + 1:04d}.png"),
                      rng.randint(0, 256, (436, 40, 3)).astype(np.uint8))
    got, want = load_sintel_videos(str(tmp_path)), jload_sintel_videos(str(tmp_path))
    assert [v.name for v in got] == [v.name for v in want] == ["alley_1", "bamboo_2", "ambush_1"]
    for g, w in zip(got, want):
        assert g.frames.shape == w.frames.shape == (len(w), 432, 40, 3)
        np.testing.assert_array_equal(g.frames, w.frames)
