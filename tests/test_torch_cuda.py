"""The Hopper kernels on the card: corr_lookup against its plain version and
RAFT through it against RAFT with the plain lookup; pad_conv3x3 in its four
modes and gemm_rate against their plain versions. Marked ``cuda``; they skip
where there is no CUDA device. On a machine with an H100 (``--noconftest``:
the suite's conftest needs jax, which these tests do not):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.raft import RAFT, coords_grid
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.kernels.pad_conv3x3 import MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.probes.bisect_im2col import trunk_inputs
from vst_torch.probes.bisect_mxu import SHAPES as GEMM_SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the corr_lookup kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,H,W,C,radius,levels,shift", [
    (1, 8, 16, 32, 4, 4, 0.0), (2, 55, 128, 64, 4, 4, 0.0), (2, 54, 128, 64, 3, 4, 0.0),
    (2, 55, 128, 64, 4, 1, 0.0), (2, 55, 128, 64, 3, 2, 0.0), (2, 54, 128, 64, 4, 4, 1000.0)],
    ids=["cpu_shape", "ragged", "radius3", "levels1", "levels2", "outside"])
def test_kernel_matches_plain(dev, B, H, W, C, radius, levels, shift):
    """Bit for bit (same operation order); ``outside`` shifts every window
    past its map, so both give zeros."""
    g = torch.Generator(device=dev).manual_seed(0)
    pyr = build_pyramid(torch.randn(B, C, H, W, generator=g, device=dev),
                        torch.randn(B, C, H, W, generator=g, device=dev), levels)
    coords = (coords_grid(B, H, W, device=dev) + shift
              + 8 * torch.randn(B, 2, H, W, generator=g, device=dev)).contiguous()
    before = corr_lookup.launches
    got = corr_lookup(pyr, coords, radius)
    torch.cuda.synchronize()
    assert corr_lookup.launches == before + 1
    want = lookup_pyramid(pyr, coords, radius)
    assert got.shape == (B, levels * (2 * radius + 1) ** 2, H, W)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if shift:
        assert want.abs().max().item() == 0


def test_kernel_gradient_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    f1 = torch.randn(1, 32, 8, 16, generator=g, device=dev)
    f2 = torch.randn(1, 32, 8, 16, generator=g, device=dev)
    coords0 = (coords_grid(1, 8, 16, device=dev)
               + 5 * torch.randn(1, 2, 8, 16, generator=g, device=dev)).contiguous()
    upstream = torch.randn(1, 324, 8, 16, generator=g, device=dev)

    def grads(fn):
        pyr = [t.detach().clone().requires_grad_() for t in build_pyramid(f1, f2, 4)]
        coords = coords0.clone().requires_grad_()
        (fn(pyr, coords, 4) * upstream).sum().backward()
        return [coords.grad] + [t.grad for t in pyr]

    for got, want in zip(grads(corr_lookup), grads(lookup_pyramid)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_kernel_refuses_other_radii(dev):
    pyr = build_pyramid(torch.randn(1, 8, 8, 16, device=dev), torch.randn(1, 8, 8, 16, device=dev))
    with pytest.raises(ValueError):
        corr_lookup(pyr, coords_grid(1, 8, 16, device=dev).contiguous(), 2)


def test_raft_through_the_kernel_matches_plain_lookup(dev):
    torch.manual_seed(0)
    fast = RAFT(iters=4).to(dev).eval()
    plain = RAFT(iters=4, lookup=lookup_pyramid).to(dev).eval()
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    i1 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    i2 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    with torch.no_grad():
        _, up_fast = fast(i1, i2)
        _, up_plain = plain(i1, i2)
    torch.testing.assert_close(up_fast, up_plain, atol=1e-3, rtol=0)


def _randn(shape, seed, dev, dtype, scale=1.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=dtype_name)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(1, 109, 256, 128), (2, 13, 37, 64), (1, 21, 16, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pad_conv3x3_matches_plain(dev, shape, mode, dtype):
    """f32: sums of up to 1152 terms with |y| ~ 1 in another order, ≤ 1e-4;
    bf16: the same f32 sum rounded once, ≤ 1e-3 + 2⁻⁷·|y| (1 ulp)."""
    x = _randn(shape, 0, dev, dtype)
    w = _randn((3, 3, shape[3], shape[3]), 1, dev, dtype, 0.02)
    before = pad_conv3x3.launches[(mode, dtype_name(dtype))]
    got = pad_conv3x3(x, w, mode)
    torch.cuda.synchronize()
    assert pad_conv3x3.launches[(mode, dtype_name(dtype))] == before + 1
    want = pad_conv3x3_plain(x, w, mode)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2.0 ** -7)


# chip_smoke.py's CONV_SHAPES: (N, H, W, C_in) and the C_out of w, which the
# halo-only modes do not read
CONV_SHAPES = [((1, 109, 256, 128), 128), ((2, 13, 37, 64), 64), ((1, 20, 16, 8), 8),
               ((1, 21, 16, 8), 8), ((1, 40, 70, 64), 128), ((1, 40, 70, 128), 64),
               ((2, 13, 37, 64), 8), ((3, 9, 40, 32), 32), ((1, 2, 37, 64), 64),
               ((2, 2, 2, 16), 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=dtype_name)
@pytest.mark.parametrize("mode", ["shift_only", "dma_only"])
@pytest.mark.parametrize("shape,cout", CONV_SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_pad_conv3x3_halo_only_bit_exact(dev, shape, cout, mode, dtype):
    """The modes without a product take the plain version's f32 sums in its
    (dy, dx) order and round once, so they agree bit for bit."""
    x, w = trunk_inputs(dtype, dev, 4, shape, cout)
    before = pad_conv3x3.launches[(mode, dtype_name(dtype))]
    got = pad_conv3x3(x, w, mode)
    torch.cuda.synchronize()
    assert pad_conv3x3.launches[(mode, dtype_name(dtype))] == before + 1
    want = pad_conv3x3_plain(x, w, mode)
    assert got.dtype == dtype and got.shape == want.shape == shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(128, 128), (1152, 128), (256, 256), (24, 40)])
def test_gemm_rate_matches_plain(dev, dtype, tol, K, N):
    """Tolerance relative to max|y|: f32 sums of up to 64·1152 terms in
    another order; bf16 one rounding of the f32 sum."""
    x = _randn((4096, K), 0, dev, dtype)
    w = _randn((K, N), 1, dev, dtype)
    before = gemm_rate.launches[dtype_name(dtype)]
    got = gemm_rate(x, w, 64)
    torch.cuda.synchronize()
    assert gemm_rate.launches[dtype_name(dtype)] == before + 1
    want = gemm_rate_plain(x, w, 64)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=dtype_name)
@pytest.mark.parametrize("mode", ["full", "mxu_only"])
@pytest.mark.parametrize("shape,cout", [((1, 40, 70, 64), 128), ((1, 40, 70, 128), 64),
                                        ((2, 13, 37, 64), 8), ((3, 9, 40, 32), 32),
                                        ((1, 2, 37, 64), 64), ((2, 2, 2, 16), 136)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_pad_conv3x3_bf16_wgmma_shapes(dev, shape, cout, mode, dtype):
    """The weighted modes' kernels (bf16 wgmma, f32 SIMT) at C_in ≠ C_out,
    C_out = 8, C_out past one 128-channel tile, batch 3 and H = 2. f32: sums
    of up to 1152 terms in another order, ≤ 1e-4; bf16: one rounding of the
    f32 sum, ≤ 1e-3 + 2⁻⁷·|y|."""
    x = _randn(shape, 2, dev, dtype)
    w = _randn((3, 3, shape[3], cout), 3, dev, dtype, 0.05)
    before = pad_conv3x3.launches[(mode, dtype_name(dtype))]
    got = pad_conv3x3(x, w, mode)
    torch.cuda.synchronize()
    assert pad_conv3x3.launches[(mode, dtype_name(dtype))] == before + 1
    want = pad_conv3x3_plain(x, w, mode)
    assert got.shape == want.shape == (*shape[:3], cout)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,reps", [(4096, K, N, 64) for K, N in GEMM_SHAPES]
                         + [(4095, 256, 128, 64), (100, 1152, 128, 5), (4096, 128, 128, 0),
                            (4096, 512, 512, 1), (64, 2048, 64, 3)])
def test_gemm_rate_sweep_and_edges(dev, dtype, tol, M, K, N, reps):
    """Every (K, N) of the probe's sweep, ragged M, reps 0 and 1, and K
    past what shared memory holds (both operands streamed). Tolerance
    relative to max|y| as above; reps = 0 gives exact zeros."""
    x = _randn((M, K), 4, dev, dtype)
    w = _randn((K, N), 5, dev, dtype)
    got = gemm_rate(x, w, reps)
    torch.cuda.synchronize()
    want = gemm_rate_plain(x, w, reps)
    assert got.shape == (M, N) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("encoder_dtype,update_dtype", [(torch.bfloat16, None),
                                                        (torch.bfloat16, torch.bfloat16)],
                         ids=["bf16_enc", "bf16_full"])
def test_bf16_raft_through_the_kernel_matches_plain_lookup(dev, encoder_dtype, update_dtype):
    """Under RAFT's bf16 dtypes the correlation volume and its lookup stay
    float32, and the kernel is the plain lookup bit for bit, so the two
    nets' flows agree exactly."""
    torch.manual_seed(0)
    fast = RAFT(iters=4, encoder_dtype=encoder_dtype, update_dtype=update_dtype).to(dev).eval()
    plain = RAFT(iters=4, lookup=lookup_pyramid, encoder_dtype=encoder_dtype,
                 update_dtype=update_dtype).to(dev).eval()
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=dev).manual_seed(2)
    i1 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    i2 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    before = corr_lookup.launches
    with torch.no_grad():
        _, up_fast = fast(i1, i2)
        torch.cuda.synchronize()
        assert corr_lookup.launches == before + 4
        _, up_plain = plain(i1, i2)
    assert up_fast.dtype == torch.float32 and up_fast.shape == (2, 2, 64, 96)
    torch.testing.assert_close(up_fast, up_plain, atol=0, rtol=0)
