"""The FAN (``vst_torch.models.wing``) and StarGAN v2's high-pass branch
against vst's, float32, on the CPU.

The port's FAN is seeded by torch, its batch norms given numpy-seeded
statistics, and its ``state_dict`` handed to vst through vst's own
``fan_params_from_torch``, which consumes every key. One vst FAN run at
1×3×256² is shared by the asserts:

* heatmaps and boundary channels within ``FAN_RTOL`` = 1e-4 of the largest
  heatmap magnitude (measured 4e-7 at 256², 3e-6 through the 64² → 256²
  resize);
* ``preprocess_heatmaps`` on the same heatmaps within ``MASK_RTOL`` = 1e-5
  of the largest mask value (measured 2.0e-7: 2.9e-6 on masks up to 14.5);
  ``get_heatmap`` (resize to 256², FAN, resize back, masks) within it too
  (measured 7.2e-7), but where its truncation at 0.1 flips on float32
  noise (``test_get_heatmap``);
* StarGAN v2's generator with ``w_hpf = 1`` at img_size 64, with the FAN's
  masks and without, within ``tests/test_torch_stargan_models.py``'s
  ``RTOL`` = 1e-5 of vst's output magnitude.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vst.models.stargan2 as jsg2
import vst.models.wing as jwing
from test_torch_stargan_models import RTOL, nchw, nhwc, rel, torch_threads  # noqa: F401
from torch_gan_parity import (CFG, S, fc2_batch, latents, port_loss, rel_err, vst_batch,
                              vst_params, vst_state, vst_step)
from vst.train.stargan2 import StarGAN2Config as JConfig
from vst.train.stargan2 import StarGAN2Trainer as JTrainer
from vst_torch.models import stargan2 as sg2
from vst_torch.models import wing
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer, gan_batch

FAN_RTOL = 1e-4
MASK_RTOL = 1e-5


def _fan():
    torch.manual_seed(11)
    fan = wing.FAN()
    rng = np.random.RandomState(12)
    with torch.no_grad():
        for m in fan.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return fan


@pytest.fixture(scope="module")
def fan_pair():
    """(port FAN, vst FAN, vst params, images (1, 256², 3) and (2, 64², 3)
    in [−1, 1], vst's heat, boundary, raw 64² heatmaps and masks)."""
    fan = _fan()
    jfan = jwing.FAN()
    params = jwing.fan_params_from_torch(fan.state_dict())
    x256 = np.random.RandomState(13).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    x64 = np.random.RandomState(14).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    heat, boundary = jax.jit(jfan.apply)({"params": params}, jnp.asarray(x256 * 0.5 + 0.5))
    raw = jax.jit(lambda p, x: jwing.get_heatmap(jfan, p, x, preprocess=False))(
        params, jnp.asarray(x64))
    masks = jwing.preprocess_heatmaps(jwing.resize_bilinear(raw, (256, 256),
                                                            align_corners=True))
    return {"fan": fan, "jfan": jfan, "params": params, "x256": x256, "x64": x64,
            "heat": np.asarray(heat), "boundary": np.asarray(boundary), "raw": np.asarray(raw),
            "masks": [np.asarray(m) for m in masks]}


def test_fan_bridge_consumes_every_key(fan_pair):
    """vst's converter reads every port key but the batch norms' counters,
    and gives exactly the tree vst's FAN builds, shape for shape."""
    sd = fan_pair["fan"].state_dict()
    tmpl = jax.eval_shape(fan_pair["jfan"].init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 256, 256, 3)))["params"]
    got = jax.tree_util.tree_map(np.shape, fan_pair["params"])
    assert got == jax.tree_util.tree_map(lambda s: s.shape, tmpl)
    assert len(jax.tree_util.tree_leaves(fan_pair["params"])) == len(
        [k for k in sd if not k.endswith("num_batches_tracked")])
    assert sd["m0.coordconv.conv.weight"].shape == (256, 256 + 3, 1, 1)  # first_one: no boundary
    assert sd["conv1.conv.weight"].shape == (64, 3 + 3, 7, 7)
    assert {"conv2.downsample.0.running_var", "conv2.downsample.2.weight", "bn_end0.weight",
            "l0.bias", "m0.b2_plus_1.conv3.weight", "m0.b1_4.conv1.weight"} <= set(sd)


def test_fan_heatmaps_and_boundary(fan_pair):
    with torch.no_grad():
        heat, boundary = fan_pair["fan"](nchw(fan_pair["x256"] * 0.5 + 0.5))
    assert heat.shape == (1, 99, 64, 64) and boundary.shape == (1, 2, 64, 64)
    want = fan_pair["heat"]
    scale = np.abs(want).max()
    assert np.abs(nhwc(heat) - want).max() <= FAN_RTOL * scale
    assert np.abs(nhwc(boundary) - fan_pair["boundary"]).max() <= FAN_RTOL * scale


def test_fan_stays_in_eval_mode(fan_pair):
    fan = fan_pair["fan"]
    fan.train()
    assert not fan.training and not any(m.training for m in fan.modules())


def test_preprocess_heatmaps(fan_pair):
    """On vst's own upsampled heatmaps: both masks within MASK_ATOL."""
    up = jwing.resize_bilinear(jnp.asarray(fan_pair["raw"]), (256, 256), align_corners=True)
    got = wing.preprocess_heatmaps(nchw(np.asarray(up)))
    for g, w in zip(got, fan_pair["masks"]):
        assert g.shape == (2, 1, 256, 256)
        assert np.abs(nhwc(g) - w).max() <= MASK_RTOL * np.abs(w).max()
    assert float(got[1].sum()) <= float(got[0].sum())


def test_preprocess_heatmaps_shifts_by_the_height():
    """At H = 512 the shifts double (``sw`` = 2) but the eyes' do not."""
    hm = np.random.RandomState(15).rand(1, 512, 96, 98).astype(np.float32)
    got = wing.preprocess_heatmaps(nchw(hm))
    want = jwing.preprocess_heatmaps(jnp.asarray(hm))
    for g, w in zip(got, want):
        assert np.abs(nhwc(g) - np.asarray(w)).max() <= MASK_RTOL * np.abs(np.asarray(w)).max()


def test_get_heatmap(fan_pair):
    """The raw 64² heatmaps within FAN_RTOL; the masks within MASK_RTOL at
    every pixel but those a truncation at 0.1 reaches where the two sides'
    float32 upsamplings land on either side of it: a flipped element moves
    at most 2 pixels of a mask (the eyes add two shifted copies), and the
    count of differing pixels is held to that (measured: one flip, a nose
    channel's 0.1 against 0.099999964, moving one pixel of each mask by
    0.34)."""
    x = nchw(fan_pair["x64"])
    raw = wing.get_heatmap(fan_pair["fan"], x, preprocess=False)
    want = fan_pair["raw"]
    assert raw.shape == (2, 98, 64, 64)
    assert np.abs(nhwc(raw) - want).max() <= FAN_RTOL * np.abs(want).max()
    up = wing.resize_bilinear(raw, (256, 256), align_corners=True)
    jup = np.asarray(jwing.resize_bilinear(jnp.asarray(want), (256, 256), align_corners=True))
    flips = int(((nhwc(up) >= 0.1) != (jup >= 0.1)).sum())
    assert flips <= 1e-5 * jup.size
    masks = wing.get_heatmap(fan_pair["fan"], x)
    for g, composed, w in zip(masks, wing.preprocess_heatmaps(up), fan_pair["masks"]):
        assert torch.equal(g, composed)
        assert g.shape == (2, 1, 256, 256)
        assert int((np.abs(nhwc(g) - w) > MASK_RTOL * np.abs(w).max()).sum()) <= 2 * flips


def test_coordconv_with_a_boundary_heatmap():
    """The boundary branch (the reference's second hourglass; the one-module
    FAN never feeds it): coordinates where the heatmap's last channel passes
    0.05, and the conv two channels wider."""
    torch.manual_seed(16)
    conv = wing.CoordConvTh(8, 8, True, True, 4, out_channels=5, kernel_size=1)
    assert conv.conv.in_channels == 4 + 3 + 2
    x = np.random.RandomState(17).randn(2, 8, 8, 4).astype(np.float32)
    hm = np.random.RandomState(18).uniform(-0.1, 0.3, (2, 8, 8, 3)).astype(np.float32)
    jconv = jwing.CoordConvTh(8, 8, True, True, False, out_channels=5, kernel_size=1, stride=1,
                              padding=0)
    params = {"conv": {"Conv_0": {
        "kernel": conv.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
        "bias": conv.conv.bias.detach().numpy()}}}
    want, want_last = jconv.apply({"params": params}, jnp.asarray(x), jnp.asarray(hm))
    with torch.no_grad():
        got, last = conv(nchw(x), nchw(hm))
    assert rel(nhwc(got), want) <= RTOL
    np.testing.assert_array_equal(nhwc(last), np.asarray(want_last))


HPF_SIZE, STYLE = 64, 8


@pytest.fixture(scope="module")
def hpf_pair():
    torch.manual_seed(19)
    g = sg2.Generator(HPF_SIZE, STYLE, max_conv_dim=32, w_hpf=1)
    sd = {k: v for k, v in g.state_dict().items()
          if k != "hpf.filter" and not (k.startswith("decode.") and ".conv1x1." in k)}
    params = jsg2.generator_params_from_torch(sd, HPF_SIZE, w_hpf=1)
    jg = jsg2.Generator(HPF_SIZE, STYLE, max_conv_dim=32, w_hpf=1)
    return g, jg, params


def test_hpf_generator_keeps_the_reference_keys(hpf_pair):
    g, _, _ = hpf_pair
    sd = g.state_dict()
    torch.testing.assert_close(sd["hpf.filter"], torch.tensor(
        [[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]]))
    assert len(g.encode) == len(g.decode) == 3 + 2  # log2(64) − 4, + 1 with w_hpf, + 2
    assert "decode.4.conv1x1.weight" in sd  # 32 → 256 wide: created, as the reference does, unused


@pytest.mark.parametrize("with_masks", [False, True])
def test_hpf_generator(hpf_pair, fan_pair, with_masks):
    """w_hpf = 1 at 64²: the residual-only AdaIN blocks and one level more;
    with masks (the FAN's, from ``get_heatmap`` on the same images) the
    high-pass skips at 32 and 64."""
    g, jg, params = hpf_pair
    x = fan_pair["x64"]
    s = np.random.RandomState(20).randn(2, STYLE).astype(np.float32)
    jmasks = [jnp.asarray(m) for m in fan_pair["masks"]] if with_masks else None
    want = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(x), jnp.asarray(s),
                                        jmasks))
    masks = [nchw(m) for m in fan_pair["masks"]] if with_masks else None
    with torch.no_grad():
        got = g(nchw(x), torch.from_numpy(s), masks)
    assert rel(nhwc(got), want) <= RTOL
    if with_masks:  # the masks move the output
        with torch.no_grad():
            assert rel(nhwc(g(nchw(x), torch.from_numpy(s))), want) > 100 * RTOL


def test_trainer_with_w_hpf_runs_the_generator_without_masks():
    """StarGAN2Trainer with w_hpf = 1 (one level more, residual-only AdaIN
    blocks, no masks, as vst's trainer): a latent G step's losses from the
    same weights within 1e-4 of vst's, as ``test_torch_stargan2_grads.py``
    holds the w_hpf = 0 steps."""
    cfg = dict(CFG, w_hpf=1)
    port = StarGAN2Trainer(StarGAN2Config(**cfg), seed=6, device="cpu")
    assert len(port.nets["generator"].encode) == 2 + 2  # log2(32) − 4 + 1, + 2
    jt = JTrainer(JConfig(**cfg))
    b, z = fc2_batch((S, S), 2, 3, seed=7), latents(jax.random.PRNGKey(8), 2)[0]
    _, want = vst_step(jt, vst_state(jt, vst_params(port)), "g", "latent",
                       {k: jnp.asarray(v) for k, v in vst_batch(b).items()}, jnp.asarray(z))
    _, got = port_loss(port, "g", "latent", gan_batch(b, "cpu"), torch.from_numpy(z))
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = float(w), float(got[k].detach())
        assert (g == w == 0.0) or rel_err(g, w) <= 1e-4, (k, g, w)
