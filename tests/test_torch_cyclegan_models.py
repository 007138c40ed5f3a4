"""The CycleGAN family's nets and pieces (``vst_torch.models.cyclegan``)
against vst's on the CPU, on the same numpy inputs:

* every net of ``define_G`` / ``define_D`` and ``FusionBlock`` at small
  widths (ngf = ndf = 4), vst's seeded params carried over by
  ``vst_torch.convert``, float32 forward within ``NET_ATOL`` = 1e-5
  absolute (outputs of order 0.1 to 1), with the
  'instance', 'batch' and 'none' norms;
* the state_dict keys junyanz's ``nn.Sequential`` fixes;
* ``gan_loss`` in its three modes and ``gradient_penalty`` with a given α,
  float32, within 1e-6 relative;
* the ImagePool bit for bit, fed vst's own draws, over an unfilled, a
  filling and a full query.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import random_params, torch_threads, vst_query_draws  # noqa: F401
from vst.models import cyclegan as J
from vst_torch import convert
from vst_torch.models import cyclegan as T
from vst_torch.models import stargan as sg1
from vst_torch.nn.conv import ConvT

NET_ATOL = 1e-5
LOSS_RTOL = 1e-6
# (kind, name, output channels, side of the input)
NETS = [("G", "resnet_9blocks", 3, 32), ("G", "resnet_6blocks", 3, 32),
        ("G", "resnet_9blocks", 2, 32), ("G", "unet_128", 3, 128), ("G", "unet_256", 3, 256),
        ("D", "basic", 3, 64), ("D", "n_layers", 3, 64), ("D", "pixel", 3, 32)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _net_pair(kind, name, oc, norm):
    if kind == "G":
        return (J.define_G(name, oc, 4, norm), T.define_G(name, oc, 4, norm),
                lambda p: convert.cyclegan_generator_state_dict_from_jax(p, name))
    return (J.define_D(name, 4, 4, norm), T.define_D(name, 4, 4, norm),
            lambda p: convert.cyclegan_discriminator_state_dict_from_jax(p, name))


@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
@pytest.mark.parametrize("kind,name,oc,side", NETS,
                         ids=[f"{n}_{oc}ch" for _, n, oc, _ in NETS])
def test_net_forward_matches_vst(kind, name, oc, side, norm):
    jnet, tnet, to_port = _net_pair(kind, name, oc, norm)
    x = np.random.RandomState(side).randn(2, side, side, oc).astype(np.float32)
    params = random_params(jnet, (x,), seed=3, std=0.1)
    tnet.load_state_dict(to_port(jax.tree_util.tree_map(np.asarray, params)))
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x))
    got = nhwc(tnet(nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= NET_ATOL


def test_fusion_block_matches_vst():
    rng = np.random.RandomState(0)
    s, w = (rng.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    params = random_params(J.FusionBlock(), (s, w), seed=4, std=0.1)
    net = T.FusionBlock()
    net.load_state_dict(convert.fusion_block_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    want = np.asarray(J.FusionBlock().apply({"params": params}, s, w))
    assert np.abs(nhwc(net(nchw(s), nchw(w))) - want).max() <= NET_ATOL


def test_state_dict_keys_are_junyanz():
    g = T.define_G("resnet_9blocks", 3, 8)
    convs = sorted({int(k.split(".")[1]) for k in g.state_dict() if ".conv_block." not in k})
    assert convs == [1, 4, 7, 19, 22, 26]
    assert {k.split(".", 2)[2] for k in g.state_dict() if k.startswith("model.10.")} == {
        f"conv_block.{i}.{p}" for i in (1, 5) for p in ("weight", "bias")}
    assert sorted({int(k.split(".")[1]) for k in g.state_dict() if ".conv_block." in k}) == list(
        range(10, 19))
    g6 = T.define_G("resnet_6blocks", 3, 8)  # the indices after the blocks move down by 3
    assert "model.23.weight" in g6.state_dict() and "model.16.weight" in g6.state_dict()
    d = T.define_D("basic", 8)
    assert sorted({int(k.split(".")[1]) for k in d.state_dict()}) == [0, 2, 5, 8, 11]
    assert all(k.startswith("model.model.") for k in T.define_G("unet_128", 3, 4).state_dict())
    assert set(T.define_D("pixel", 4).state_dict()) == {f"net.{i}.{p}" for i in (0, 2, 5)
                                                       for p in ("weight", "bias")}
    bn = T.define_D("basic", 4, norm="batch")
    assert {"model.3.running_mean", "model.3.running_var"} <= {
        n for n, _ in bn.named_parameters()}  # vst's statistics are parameters


def test_init_and_the_shared_transposed_conv():
    """Convs N(0, 0.02) with zero bias (``networks.py:67-99``); StarGAN v1
    and the CycleGAN nets build the one ``ConvT``."""
    torch.manual_seed(0)
    g = T.define_G("resnet_9blocks", 3, 16)
    w = torch.cat([m.weight.flatten() for m in g.modules() if isinstance(m, (T.Conv, ConvT))])
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert all(float(m.bias.abs().max()) == 0 for m in g.modules() if isinstance(m, T.Conv))
    assert sg1.ConvT is ConvT and any(isinstance(m, ConvT) for m in g.modules())


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_vst(mode, real):
    pred = np.random.RandomState(1).randn(2, 6, 6, 1).astype(np.float32) * 2
    want = float(J.gan_loss(jnp.asarray(pred), real, mode))
    got = float(T.gan_loss(nchw(pred), real, mode))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("mode", ["mixed", "real", "fake"])
def test_gradient_penalty_matches_vst(mode):
    jd = J.define_D("basic", 4)
    rng = np.random.RandomState(2)
    real, fake = (rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    params = random_params(jd, (real,), seed=5, std=0.1)
    key = jax.random.PRNGKey(7)
    want = float(J.gradient_penalty(lambda p, x: jd.apply({"params": p}, x), params, real, fake,
                                    key, mode=mode))
    td = T.define_D("basic", 4)
    td.load_state_dict(convert.cyclegan_discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "basic"))
    alpha = torch.from_numpy(np.asarray(jax.random.uniform(key, (2, 1, 1, 1))))  # vst's draw
    got = float(T.gradient_penalty(td, nchw(real), nchw(fake), alpha, mode=mode))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_image_pool_bit_for_bit():
    """Pool 4, batches of 3: an unfilled query (3 inserts), a filling one (1
    insert, 2 draws) and a full one (3 draws); vst's draws from its keys."""
    P, shape = 4, (5, 6, 3)
    jstate = J.image_pool_init(P, shape)
    tstate = T.image_pool_init(P, (3, 5, 6))
    rng = np.random.RandomState(3)
    swapped = 0
    for q in range(3):
        imgs = rng.randn(3, *shape).astype(np.float32)
        key = jax.random.PRNGKey(10 + q)
        jstate, jout = J.image_pool_query(jstate, jnp.asarray(imgs), key, P)
        u, idx = vst_query_draws(key, 3, P)
        tstate, tout = T.image_pool_query(tstate, nchw(imgs), u, idx, P)
        assert np.array_equal(nhwc(tout), np.asarray(jout))
        assert np.array_equal(nhwc(tstate["buffer"]), np.asarray(jstate["buffer"]))
        assert tstate["count"] == int(jstate["count"]) == min(P, 3 * (q + 1))
        swapped += int(not np.array_equal(nhwc(tout), imgs))
    assert swapped >= 1  # the draws took an old image at least once


def test_image_pool_of_size_0_passes_through():
    imgs = torch.randn(2, 3, 4, 4)
    state = T.image_pool_init(0, (3, 4, 4))
    out_state, out = T.image_pool_query(state, imgs, torch.rand(2), torch.zeros(2).long(), 0)
    assert out is imgs and out_state is state
