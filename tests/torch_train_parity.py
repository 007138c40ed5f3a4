"""Shared set-up of the trainer parity tests (``tests/test_torch_train_*.py``):
vst's ``FastStyleTrainer`` and the port's on the same weights and batch.

vst's net and VGG come from its own init (PRNGKey, He-randomized VGG); the
port's trainer receives them through ``faststyle_state_dict_from_jax`` and
``vgg_state_dict_from_jax``. Inputs are vst's numpy ``synthetic_batch``, NHWC
for vst and NCHW for the port. The output conv's kernel is scaled ×300 on
both sides (:func:`spread_output`).

Tolerances: the loss and every aux term within 1e-4 relative, in float32
(the trainers' dtype); every parameter's gradient within 1e-3 relative in L2
(‖port − vst‖ / ‖vst‖), and a 3-step loss trajectory within 1e-3 relative,
with both sides in float64.

Why float64 for the gradients: through a ReLU / max-pool VGG at 32×32 the
loss's gradient is piecewise smooth, and a unit whose pre-activation lies
within rounding of 0 switches a whole unit's share in or out. In float32
such a switch is 0.57 % of the content gradient (on a CPU, a 1e-6 relative
nudge of the styled image moved it that much, a 1e-7 one by 9e-7), above the tolerance
by construction, as ``tests/test_pipeline_parity.py``'s OBST harness found.
Adam then turns each gradient element whose sign differs into a whole
step's difference (a float32 trajectory drifted 0.16 % by step 3). In
float64 the two sides differ by ~1e-15 and no unit switches. Both
instance norms compute their statistics in float32 for float32 input; for
the float64 run vst's is patched to keep float64, as the port's does.

A gradient that is zero in exact arithmetic (a conv bias in front of an
instance norm, which subtracts it again) is rounding noise on both sides:
where vst's norm is below 1e-6 of the whole gradient's, the port's must be
too, and the ratio is not taken (``vst_torch.train.parity.grad_errors``).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vst.nn.norm
from vst.data.styles import load_style_images
from vst.data.synthetic import synthetic_batch
from vst.train.faststyle import FastStyleConfig as JConfig
from vst.train.faststyle import FastStyleTrainer as JTrainer
from vst.train.registry import FASTSTYLE_METHODS
from vst_torch.convert import faststyle_state_dict_from_jax, vgg_state_dict_from_jax
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.parity import grad_errors
from vst_torch.train.registry import select_method

HW = (32, 32)
BATCH = 2
STYLES = load_style_images(size=64)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads for torch while a module of these tests runs:
    the suite runs in six workers on eight cores, and every worker's
    default pool of one thread a core spun the others out (on an
    eight-core CPU the training tests took 292 s together, 130 s with two
    threads each)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


def spread_output(params):
    """The net's params with the output conv's kernel ×300, so the styled
    image spans [0, 1] instead of 0.5 ± 0.01."""
    params = jax.tree_util.tree_map(np.array, params)
    params["ConvTanh_0"]["ConvLayer_0"]["TorchConv_0"]["Conv_0"]["kernel"] *= 300.0
    return params


def make_pair(method, n_styles=1, n_frames=2, seed=0, batch_seed=1):
    """(vst trainer, vst params, port trainer on the same weights, numpy batch)."""
    jt = JTrainer(JConfig(method=method, emphasis=FASTSTYLE_METHODS[method], n_styles=n_styles,
                          batch_size=BATCH, n_frames=n_frames),
                  STYLES[:n_styles], seed=seed)
    batch = synthetic_batch(BATCH, hw=HW, n_frames=n_frames, seed=batch_seed)
    params = jax.device_get(jt.init_state({k: jnp.asarray(v) for k, v in batch.items()}).params)
    params = spread_output(params)
    pre = (faststyle_state_dict_from_jax(jax.device_get(jt.pre_style_params))
           if method == "ruder" else None)
    tt = FastStyleTrainer(select_method(method, n_styles, BATCH, n_frames), STYLES[:n_styles],
                          vgg_state=vgg_state_dict_from_jax(jax.device_get(jt.vgg_params)),
                          pre_style_state=pre, seed=seed, device="cpu")
    tt.model.load_state_dict(faststyle_state_dict_from_jax(params))
    return jt, params, tt, batch


def _instance_norm_keeping_f64(x, eps=1e-5):
    """vst's ``instance_norm`` with float64 statistics for float64 input."""
    xf = x if x.dtype == jnp.float64 else x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    m2 = jnp.mean(jnp.square(xf), axis=(1, 2), keepdims=True)
    var = jnp.maximum(m2 - jnp.square(mean), 0.0)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


@contextlib.contextmanager
def float64(jt, tt):
    """Both trainers in float64 for the duration: jax's x64 mode and vst's
    patched norm; vst's VGG, bootstrap and Gram targets cast, the port's nets
    cast and given vst's Gram targets (equal targets, so the one float32
    step they came from is shared)."""
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vst.nn.norm, "instance_norm", _instance_norm_keeping_f64)
            mp.setattr(jt, "vgg_params", f64(jt.vgg_params))
            mp.setattr(jt, "style_grams", f64(jt.style_grams))
            if jt.pre_style_params is not None:
                mp.setattr(jt, "pre_style_params", f64(jt.pre_style_params))
            tt.to_dtype(torch.float64)
            mp.setattr(tt, "style_grams",
                       [torch.from_numpy(np.array(g, np.float64)) for g in jt.style_grams])
            yield
    finally:
        tt.to_dtype(torch.float32)
        jax.config.update("jax_enable_x64", saved)


def vst_loss(jt, params, batch, style_id, key):
    """(loss, aux) of vst's ``loss_fn``, float32."""
    loss, aux = jax.jit(jt.loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                    style_id, key)
    return float(loss), {k: float(v) for k, v in aux.items()}


def port_loss(tt, batch, style_id, coin=None):
    with torch.no_grad():
        loss, aux = tt.loss_fn(batch_to_tensors(batch, "cpu"), style_id, coin)
    return float(loss), {k: float(v) for k, v in aux.items()}


def vst_grads_f64(jt, params, batch, style_id, key):
    """vst's gradients in float64 (inside :func:`float64`), as port keys."""
    f64 = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
    fn = jax.jit(jax.grad(lambda p: jt.loss_fn(p, f64, style_id, key)[0]))
    grads = fn(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params))
    return faststyle_state_dict_from_jax(jax.device_get(grads))


def port_grads_f64(tt, batch, style_id, coin=None):
    """The port's gradients in float64 (inside :func:`float64`)."""
    tt.model.zero_grad(set_to_none=True)
    tensors = {k: v.double() for k, v in batch_to_tensors(batch, "cpu").items()}
    loss, _ = tt.loss_fn(tensors, style_id, coin)
    assert loss.dtype == torch.float64
    loss.backward()
    return {n: p.grad.clone() for n, p in tt.model.named_parameters()}


def compare_head(jt, params, tt, batch, cases):
    """For each (style_id, vst key, port coin) of ``cases``: ((vst loss,
    aux), (port loss, aux)) in float32 and (vst grads, port grads) in
    float64."""
    losses = [(vst_loss(jt, params, batch, sid, key), port_loss(tt, batch, sid, coin))
              for sid, key, coin in cases]
    with float64(jt, tt):
        grads = [(vst_grads_f64(jt, params, batch, sid, key),
                  port_grads_f64(tt, batch, sid, coin)) for sid, key, coin in cases]
    return losses, grads


def assert_losses_agree(got, want):
    (got_loss, got_aux), (want_loss, want_aux) = got, want
    assert set(got_aux) == set(want_aux)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for k, w in want_aux.items():
        assert np.isfinite(got_aux[k]), k
        assert abs(got_aux[k] - w) <= LOSS_RTOL * abs(w), (k, got_aux[k], w)


def assert_grads_agree(got, want):
    """Every parameter's gradient within ``GRAD_RTOL`` in L2 (a gradient 0
    in exact arithmetic: ``vst_torch.train.parity.grad_errors``)."""
    worst, _ = grad_errors(got, want)
    assert worst <= GRAD_RTOL, worst
