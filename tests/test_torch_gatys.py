"""vst_torch.models.gatys.OBST against vst.models.gatys.OBST on the CPU.

The He-randomized caffe VGG is vst's bit for bit for a seed; ``set_style``'s
Gram targets and ``_loss`` agree in float32 within 1e-5 relative. In
bfloat16 (the VGG's weights and the image cast, Grams and content term
accumulated in float32) each layer's output is rounded to bf16 on both
sides, and an accumulation order that differs flips a rounding now and then
(a quarter of r41's values differ, by about one ulp): ``_loss`` agrees
within one bf16 rounding (2⁻⁸ relative), and a Gram target, the product of
two such features, within two (2⁻⁷, of its largest entry). The
descent is held in float64 (jax's x64 mode, the port's module in
``compute_dtype=torch.float64``): torch's first L-BFGS step, scaled by
1/‖g‖₁, makes the first curvature pair smaller than the two frameworks'
float32 noise (``tests/test_pipeline_parity.py:583-602``). One level of 5
iterations at 16×16 and 32×32, ``run`` over a 2-level pyramid and
``warm_start`` agree within 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vst.models.gatys as jg
from vst.ops.lbfgs import lbfgs_minimize as vst_lbfgs
from vst_torch.convert import caffe_vgg_state_dict_from_jax
from vst_torch.models import gatys

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8  # one bf16 rounding
BF16_GRAM_RTOL = 2.0 ** -7  # a product of two factors, each one rounding off
F64_RTOL = 1e-8
SEED = 3
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def x64():
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def style(hw=32, seed=0):
    return np.random.RandomState(seed).rand(hw, hw, 3)


def caffe(hw, seed, dtype=np.float64):
    """An image in caffe space (BGR ×255 about the mean), NHWC."""
    return ((np.random.RandomState(seed).rand(1, *hw, 3) - 0.45) * 255.0).astype(dtype)


def pair(dtype, max_iters=(1, 1)):
    """(vst OBST, port OBST) on the same seed, in ``dtype`` (float32, bfloat16
    or float64; call under x64 for float64)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype]
    tdt = getattr(torch, dtype)
    return (jg.OBST(max_iters=max_iters, seed=SEED, compute_dtype=jdt),
            gatys.OBST(max_iters=max_iters, seed=SEED, compute_dtype=tdt, device="cpu"))


def test_constants_are_vsts():
    for name in ("STYLE_LAYERS", "CONTENT_LAYERS", "STYLE_WEIGHTS", "CONTENT_WEIGHTS",
                 "PYR_FC2", "PYR_SINTEL", "MAX_ITERS"):
        assert getattr(gatys, name) == getattr(jg, name), name


def test_vgg_is_vsts_bit_for_bit():
    jo, to = pair("float32")
    want = caffe_vgg_state_dict_from_jax(jax.device_get(jo.vgg_params))
    got = to.vgg.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not any(p.requires_grad for p in to.vgg.parameters())


@pytest.mark.parametrize("dtype,rtol,gram_rtol", [("float32", F32_RTOL, F32_RTOL),
                                                   ("bfloat16", BF16_RTOL, BF16_GRAM_RTOL)])
def test_set_style_grams_and_loss(dtype, rtol, gram_rtol):
    """Gram targets per level (float32 in both dtypes) and one closure's
    loss with a live temporal term."""
    jo, to = pair(dtype)
    pyr = ((16, 16), (32, 32))
    s = style(48).astype(np.float32)
    jo.set_style(s, pyr)
    to.set_style(s, pyr)
    for jlvl, tlvl in zip(jo.style_targets, to.style_targets):
        for jg_, tg in zip(jlvl, tlvl):
            assert tg.dtype == torch.float32
            assert rel(tg.numpy(), jg_) <= gram_rtol

    opt, warp_img, content = (caffe((32, 32), s_, np.float32) for s_ in (1, 2, 3))
    mask = np.random.RandomState(4).rand(1, 32, 32, 1).astype(np.float32)
    mask3 = np.repeat(mask, 3, -1)
    jc = [f.astype(jnp.float32) for f in jo.vgg.apply(
        {"params": jo._vgg_params_c}, jnp.asarray(content).astype(jo.compute_dtype), ["r42"])]
    with torch.no_grad():
        tc = [f.float() for f in to._features(nchw(content), ["r42"])]
        got = to._loss(nchw(opt), to.style_targets[1], tc, nchw(warp_img), nchw(mask3), 2000.0)
    want = jo._loss(jnp.asarray(opt), jo.style_targets[1], jc, jnp.asarray(warp_img),
                    jnp.asarray(mask3), 2000.0)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= rtol * abs(float(want))


def _targets(jo, to, hw, seed):
    """A level's (style Grams, content features, warp, mask) for both sides."""
    content, warp_img = caffe(hw, seed), caffe(hw, seed + 1)
    mask = np.repeat(np.random.RandomState(seed + 2).rand(1, *hw, 1), 3, -1)
    s = style(2 * hw[0], seed)
    jo.set_style(s, [hw])
    to.set_style(s, [hw])
    jc = jo.vgg.apply({"params": jo._vgg_params_c}, jnp.asarray(content), ["r42"])
    with torch.no_grad():
        tc = to._features(nchw(content), ["r42"])
    return ((jo.style_targets[0], jc, jnp.asarray(warp_img), jnp.asarray(mask)),
            (to.style_targets[0], tc, nchw(warp_img), nchw(mask)))


@pytest.mark.parametrize("hw", [(16, 16), (32, 32)])
def test_one_level_float64(x64, hw):
    """``descend``: 5 compact L-BFGS iterations of the OBST objective, the
    temporal term on, against vst's lbfgs_minimize on vst's ``_loss``."""
    jo, to = pair("float64")
    (jsg, jc, jw, jm), (tsg, tc, tw, tm) = _targets(jo, to, hw, seed=hw[0])
    x0 = caffe(hw, 7)
    got, got_losses = to.descend(nchw(x0), tsg, tc, tw, tm, 2000.0, 5)
    want, want_losses = vst_lbfgs(lambda x: jo._loss(x, jsg, jc, jw, jm, 2000.0),
                                  jnp.asarray(x0), num_iters=5, impl="compact")
    assert got.dtype == torch.float64
    assert rel(nhwc(got), want) <= F64_RTOL
    assert rel(got_losses.numpy(), want_losses) <= F64_RTOL
    assert got_losses[-1] < got_losses[0]


def test_run_two_levels_and_warm_start_float64(x64):
    """``run`` over a 2-level pyramid (20 + 20 closure calls) from a warm
    start built by ``warm_start`` with a live mask and a real flow."""
    jo, to = pair("float64")
    pyr = ((16, 16), (32, 32))
    s = style(64)
    jo.set_style(s, pyr)
    to.set_style(s, pyr)
    img, prev = caffe((32, 32), 11), caffe((32, 32), 12)
    bf = np.random.RandomState(13).randn(1, 32, 32, 2) * 2.0
    mask = (np.random.RandomState(14).rand(1, 32, 32, 1) > 0.3).astype(np.float64)
    want_pre = jo.warm_start(jnp.asarray(prev), jnp.asarray(img), jnp.asarray(bf),
                             jnp.asarray(mask))
    got_pre = to.warm_start(nchw(prev), nchw(img), nchw(bf), nchw(mask))
    assert rel(nhwc(got_pre), want_pre) <= F64_RTOL
    want = jo.run(want_pre, jnp.asarray(img), jnp.asarray(mask), pyr, weight_tcl=2000.0)
    got = to.run(got_pre, nchw(img), nchw(mask), pyr, weight_tcl=2000.0)
    assert got.shape == (1, 3, 32, 32) and got.dtype == torch.float64
    assert rel(nhwc(got), want) <= F64_RTOL


def test_run_needs_a_style():
    with pytest.raises(RuntimeError, match="set_style"):
        pair("float32")[1].run(*(torch.zeros(1, c, 8, 8) for c in (3, 3, 1)), [(8, 8)])
