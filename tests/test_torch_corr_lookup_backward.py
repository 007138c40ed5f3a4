"""The backward of the correlation lookup (``vst_torch.kernels.corr_lookup``):
on the CPU the plain version's autograd, on the card one launch of
``lookup_grad_kernel`` held to that autograd.

CPU tests: the CPU backward stays plain and counts as such; the new counter
is in ``vst_torch.core.trace``'s table; the wrapper hands the kernel strides
that address the upstream gradient in each layout it arrives in.

Card tests (marked ``cuda``; skip without a CUDA device), at RAFT's chairs
shape, the Sintel tcl2 shape, RAFT small's radius 3 and 1-3 levels, with
coordinates inside, on the border, fully outside the maps and at fractions
that round across an integer: each level's gradient and, when asked, the
coordinates' gradient against ``lookup_pyramid``'s autograd in float32
(``assert_close`` at rtol 1e-5 and atol 1e-6 x max |want|: a pixel sums at
most 4 products, 9 where the window's corners round onto it, in another order
than autograd's sort), two runs bit-equal, and every element written. On a
machine with an H100 (``--noconftest``: the suite's conftest needs jax):

    python -m pytest --noconftest tests/test_torch_corr_lookup_backward.py -q -m cuda
"""

import ctypes

import numpy as np
import pytest
import torch

from vst_torch.core import trace
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.kernels import corr_lookup as corr_lookup_module
from vst_torch.kernels.corr_lookup import corr_lookup


def _pyramid(B, H, W, levels, C=32, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn(B, C, H, W, generator=g).to(device) for _ in range(2))
    return [t.contiguous() for t in build_pyramid(f1, f2, levels)]


# scaled coordinates whose sum with a window offset rounds across an integer
# (x/2^l + a - r rounds up where x/2^l lies just under an integer)
NEAR_INTEGER = np.array([-2.0 ** -24, 1 - 2.0 ** -24, 2 - 2.0 ** -23, 3 - 2.0 ** -23,
                         4 - 2.0 ** -22, 5 - 2.0 ** -22, 8 - 2.0 ** -21, 15 - 2.0 ** -20,
                         2.0 ** -24, 1 + 2.0 ** -23], np.float32)


def _coords(kind, B, H, W, levels, seed=1):
    """(B, 2, H, W) float32 coordinates of one kind."""
    rng = np.random.RandomState(seed)
    size = (B, 2, H, W)
    hi = np.array([W - 1, H - 1], np.float32).reshape(1, 2, 1, 1)
    if kind == "inside":
        c = rng.rand(*size) * hi
    elif kind == "border":  # on the last or first row or column, or a hair off it
        c = np.where(rng.rand(*size) < 0.5, 0.0, hi) + rng.choice([0.0, 1e-3, -1e-3], size)
        c = np.where(rng.rand(*size) < 0.3, rng.rand(*size) * hi, c)
    elif kind == "outside":  # every window past every level's map
        c = np.where(rng.rand(*size) < 0.5, -1000.0, 1000.0) + rng.rand(*size) * hi
    else:  # near_integer: fractions near 0 and 1, and sums that round onto an integer
        scaled = rng.choice(NEAR_INTEGER, size) * 2.0 ** rng.randint(0, levels, size)
        frac = rng.randint(0, 64, size) + rng.choice([2.0 ** -12, 1 - 2.0 ** -12], size)
        c = np.where(rng.rand(*size) < 0.5, scaled, frac)
    return torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32))


def _grads(lookup, pyramid, coords, radius, upstream, need_coords, nan_shapes=()):
    """[d coords or None, d level 0, ...] through ``lookup``'s backward;
    between the forward and the backward, blocks of ``nan_shapes`` are
    filled with NaN and freed, so the backward's ``torch.empty`` takes
    them back and an element it leaves unwritten reads NaN."""
    pyr = [t.detach().requires_grad_() for t in pyramid]
    c = coords.detach().requires_grad_(need_coords)
    out = lookup(pyr, c, radius)
    held = [torch.full(shape, float("nan"), device=c.device) for shape in nan_shapes]
    del held
    wanted = ([c] if need_coords else []) + pyr
    grads = list(torch.autograd.grad(out, wanted, upstream))
    return grads if need_coords else [None] + grads


def test_the_cpu_backward_is_the_plain_autograd():
    """On the CPU the backward recomputes through lookup_pyramid: it counts a
    plain backward, launches no kernel, and gives autograd's bits."""
    pyramid, coords = _pyramid(1, 8, 16, 4), _coords("inside", 1, 8, 16, 4)
    upstream = torch.randn(1, 4 * 81, 8, 16, generator=torch.Generator().manual_seed(2))
    plain, launches = corr_lookup.plain_backwards, corr_lookup.backward_launches
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _grads(corr_lookup, pyramid, coords, 4, upstream, True)
    snap = trace.snapshot()
    trace.reset()
    assert corr_lookup.plain_backwards == plain + 1
    assert corr_lookup.backward_launches == launches
    assert snap["counters"] == {"vst.corr_lookup.backwards": 1}
    assert snap["spans"]["vst.corr_lookup.backward"]["calls"] == 1
    for a, b in zip(got, _grads(lookup_pyramid, pyramid, coords, 4, upstream, True)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_the_backward_launch_counter_is_in_the_trace_table():
    assert "``vst.corr_lookup.backward_launches``" in trace.__doc__


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "strided_columns", "padded_rows",
                                    "one_row"])
def test_the_kernel_is_handed_strides_that_address_the_gradient(monkeypatch, layout):
    """The wrapper folds the upstream gradient's rows and columns into one
    query index (copying it where they do not fold); a stand-in for the
    kernel reads every (query, channel) through the strides it is given."""
    B, H, W, levels, r = 2, (1 if layout == "one_row" else 3), 5, 2, 3
    C = levels * (2 * r + 1) ** 2
    upstream = torch.randn(B, H, W, C).permute(0, 3, 1, 2)  # the forward's own layout
    if layout == "nchw":
        upstream = upstream.contiguous()
    elif layout == "strided_columns":  # rows and columns still fold
        upstream = torch.randn(B, C, H, 2 * W)[..., ::2]
    elif layout == "padded_rows":  # they do not: the wrapper copies
        upstream = torch.randn(B, C, H, W + 3)[..., :W]
    pyramid, coords = _pyramid(B, H, W, levels), _coords("inside", B, H, W, levels)
    seen = {}

    def kernel(maps, dmaps, heights, widths, num_levels, coords_ptr, grad_ptr, sb, sp, sc,
               dcoords, queries, hw, radius, stream):
        span = sb * (B - 1) + sp * (hw - 1) + sc * (C - 1) + 1
        flat = np.ctypeslib.as_array((ctypes.c_float * span).from_address(grad_ptr))
        q = np.arange(queries)
        idx = (q // hw * sb + q % hw * sp)[:, None] + np.arange(C)[None] * sc
        seen["grad"] = flat[idx]
        for t, n in ((dmaps[i], pyramid[i].numel()) for i in range(num_levels)):
            ctypes.memset(t, 0, 4 * n)
        return 0

    monkeypatch.setattr(corr_lookup_module, "_grad_kernel", lambda: kernel)
    monkeypatch.setattr(corr_lookup_module, "_check_current_device", lambda c: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    launches = corr_lookup.backward_launches
    out = corr_lookup_module._launch_grad(pyramid, coords, upstream, r, [False, True, True])
    assert corr_lookup.backward_launches == launches + 1
    assert out[0] is None and [t.shape for t in out[1:]] == [t.shape for t in pyramid]
    want = upstream.permute(0, 2, 3, 1).reshape(B * H * W, C).numpy()
    np.testing.assert_array_equal(seen["grad"], want)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernel has no CPU mode")
    return torch.device("cuda", 0)


SHAPES = {  # B, H, W, levels, radius
    "chairs": (10, 46, 62, 4, 4), "tcl2": (4, 54, 128, 4, 4), "small_r3": (2, 46, 62, 4, 3),
    "levels1": (2, 23, 31, 1, 4), "levels2": (2, 23, 31, 2, 3), "levels3": (2, 23, 31, 3, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inside", "border", "outside", "near_integer"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_backward_kernel_matches_plain_autograd(dev, shape, kind):
    B, H, W, levels, r = SHAPES[shape]
    C = levels * (2 * r + 1) ** 2
    pyramid = _pyramid(B, H, W, levels, seed=3, device=dev)
    coords = _coords(kind, B, H, W, levels, seed=4).to(dev)
    g = torch.Generator().manual_seed(5)
    layouts = {"nchw": torch.randn(B, C, H, W, generator=g).to(dev),
               "channels_last": torch.randn(B, H, W, C, generator=g).to(dev).permute(0, 3, 1, 2)}
    shapes = [coords.shape] + [t.shape for t in pyramid]
    for need_coords in (False, True):
        for layout, upstream in layouts.items():
            args = (pyramid, coords, r, upstream, need_coords)
            want = _grads(lookup_pyramid, *args)
            launches, plain = corr_lookup.backward_launches, corr_lookup.plain_backwards
            got = _grads(corr_lookup, *args, nan_shapes=shapes)
            again = _grads(corr_lookup, *args)
            torch.cuda.synchronize()
            assert corr_lookup.backward_launches == launches + 2
            assert corr_lookup.plain_backwards == plain
            for i, (a, b, c) in enumerate(zip(got, want, again)):
                if b is None:
                    assert a is None and c is None
                    continue
                what = f"{layout}, coords grad {need_coords}, input {i}"
                assert not torch.isnan(a).any(), f"unwritten elements: {what}"
                assert torch.equal(a, c), f"two runs differ: {what}"
                if kind == "outside":
                    assert b.abs().max().item() == 0 == a.abs().max().item(), what
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item(),
                                           msg=what)


@pytest.mark.cuda
def test_the_backward_is_one_launch_and_no_lookup_kernel(dev):
    """One backward pass is one launch of the backward kernel, whose name
    does not hold ``corr_lookup``: the forward's roofline sums the kernels
    whose name does."""
    B, H, W, levels, r = SHAPES["chairs"]
    pyramid = [t.requires_grad_() for t in _pyramid(B, H, W, levels, seed=6, device=dev)]
    coords = _coords("inside", B, H, W, levels).to(dev)
    out = corr_lookup(pyramid, coords, r)
    upstream = torch.randn_like(out)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.autograd.grad(out, pyramid, upstream)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}  # spans echoed on the device
    names = [e.name() for e in events if e.device_type() == cuda and e.name() not in host]
    assert any("lookup_grad_kernel" in n for n in names), names
    assert not any("corr_lookup" in n for n in names), names
    assert not any("index" in n.lower() or "sort" in n.lower() for n in names), names
