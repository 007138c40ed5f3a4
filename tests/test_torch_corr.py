"""vst_torch's correlation pyramid and window lookup against vst's, and the
Hopper kernel's wrapper (``vst_torch.kernels.corr_lookup``) on the CPU —
where it computes the plain version — against vst's Pallas kernel
``pallas_lookup_pyramid`` run in interpret mode. Tolerance 1e-5 absolute
(measured on a CPU: 1.2e-7 for the pyramid and the lookup, 2.4e-7 for the
wrapper against the Pallas kernel)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vst.flow.corr import build_pyramid as jbuild_pyramid
from vst.flow.corr import lookup_pyramid as jlookup_pyramid
from vst.kernels.pallas_corr import pallas_lookup_pyramid
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.kernels.corr_lookup import check_radius, corr_lookup

ATOL = 1e-5
R = 4


def _case(B=1, H=8, W=16, C=32, seed=0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    # around the grid, with windows that leave every level's map
    coords = (rng.randn(B, H, W, 2) * 5 + 6).astype(np.float32)
    return f1, f2, coords


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _port_pyramid(f1, f2):
    return build_pyramid(_nchw(f1), _nchw(f2), 4)


def test_build_pyramid():
    f1, f2, _ = _case(B=2)
    got = _port_pyramid(f1, f2)
    want = jbuild_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert [tuple(t.shape) for t in got] == [(256, 1, 8, 16), (256, 1, 4, 8),
                                             (256, 1, 2, 4), (256, 1, 1, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w)[..., 0], atol=ATOL)


def test_build_pyramid_tiny_input_guard():
    f1, f2, _ = _case(H=4, W=6)
    got = _port_pyramid(f1, f2)
    want = jbuild_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert [tuple(t.shape[2:]) for t in got] == [np.asarray(w).shape[1:3] for w in want]


def test_lookup_pyramid():
    f1, f2, coords = _case(B=2)
    pyr = _port_pyramid(f1, f2)
    got = lookup_pyramid(pyr, _nchw(coords), R)
    jpyr = jbuild_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    want = jlookup_pyramid(jpyr, jnp.asarray(coords), R, 2)
    assert got.shape == (2, 324, 8, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_on_cpu_against_pallas_interpret():
    f1, f2, coords = _case()
    pyr = _port_pyramid(f1, f2)
    before = corr_lookup.launches
    got = corr_lookup(pyr, _nchw(coords), R)
    assert corr_lookup.launches == before  # the CPU path launches nothing
    jpyr = jbuild_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    want = pallas_lookup_pyramid(jpyr, jnp.asarray(coords), R, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), lookup_pyramid(pyr, _nchw(coords), R).numpy())


def test_wrapper_gradient_matches_plain_autograd():
    f1, f2, coords = _case(seed=1)
    g = torch.from_numpy(np.random.RandomState(2).randn(1, 324, 8, 16).astype(np.float32))

    def grads(fn):
        pyr = [t.clone().requires_grad_() for t in _port_pyramid(f1, f2)]
        c = _nchw(coords).requires_grad_()
        (fn(pyr, c, R) * g).sum().backward()
        return [c.grad] + [t.grad for t in pyr]

    for got, want in zip(grads(corr_lookup), grads(lookup_pyramid)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    f1, f2, coords = _case()
    pyr = _port_pyramid(f1, f2)
    c = _nchw(coords)
    with pytest.raises(TypeError):
        corr_lookup([t.double() for t in pyr], c.double(), R)
    with pytest.raises(ValueError):
        corr_lookup(pyr, c.transpose(2, 3).contiguous().transpose(2, 3), R)
    with pytest.raises(ValueError):
        corr_lookup([pyr[0][:, :, :, :8]] + list(pyr[1:]), c, R)  # a strided view
    with pytest.raises(ValueError):
        corr_lookup([t[:-1] for t in pyr], c, R)  # wrong number of queries
    with pytest.raises(ValueError):
        corr_lookup(list(pyr) * 2, c, R)  # more levels than the kernel takes


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5])
def test_wrapper_on_cpu_takes_any_radius(radius):
    """The kernel is built for radius 3 and 4 only; on the CPU the wrapper
    computes the plain version at every radius, launching nothing."""
    f1, f2, coords = _case(seed=3)
    pyr = _port_pyramid(f1, f2)
    before = corr_lookup.launches
    got = corr_lookup(pyr, _nchw(coords), radius)
    assert corr_lookup.launches == before
    assert got.shape == (1, 4 * (2 * radius + 1) ** 2, 8, 16)
    np.testing.assert_array_equal(got.numpy(), lookup_pyramid(pyr, _nchw(coords), radius).numpy())


@pytest.mark.parametrize("radius,device,ok", [
    (3, "cuda", True), (4, "cuda", True), (2, "cuda", False), (5, "cuda", False),
    (2, "cpu", True), (5, "cpu", True), (-1, "cpu", False), (2.5, "cpu", False)])
def test_radius_rule(radius, device, ok):
    """The wrapper's rule, checked without a tensor on the device: CUDA takes
    the kernel's radii, the CPU any non-negative int."""
    if ok:
        check_radius(radius, torch.device(device))
    else:
        with pytest.raises(ValueError):
            check_radius(radius, torch.device(device))
