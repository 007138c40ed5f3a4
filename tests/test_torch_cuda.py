"""The Hopper kernels on the card: corr_lookup against its plain version and
RAFT through it against RAFT with the plain lookup; pad_conv3x3 in its four
modes and gemm_rate against their plain versions; one training step of each
feed-forward method on the card against the CPU, and the device cache
against the same cache on the CPU; one OBST level (float64) and the FC2
metric nets (float32) on the card against the CPU; each step of a StarGAN v2
iteration and StarGAN v1's D and G steps on the card against the CPU, and
the styled device cache on the card against the CPU; each CycleGAN
variant's E step (and MoGAN's M step) on the card against the CPU, MoGAN's
and ConGAN's with RAFT through the kernel; RAFT small and train mode through
the kernel against the plain lookup, RAFT's sequence loss and its gradients
on the card against the CPU, and ``precompute_lt_flow`` through the kernel
against the plain lookup. Marked ``cuda``; they skip where there
is no CUDA device. On a machine with an H100 (``--noconftest``: the suite's
conftest needs jax, which these tests do not):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from vst_torch.data.device_cache import DeviceFC2Cache, DeviceStyledCache
from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.raft import RAFT, coords_grid
from vst_torch.kernels.corr_lookup import corr_lookup
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.kernels.pad_conv3x3 import MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.metrics.fid import InceptionV3
from vst_torch.metrics.lpips import LPIPS
from vst_torch.models.gatys import OBST
from vst_torch.probes.bisect_im2col import trunk_inputs
from vst_torch.probes.bisect_mxu import SHAPES as GEMM_SHAPES
from vst_torch.data.datagen import generate_fc2_corpus, precompute_lt_flow
from vst_torch.train.parity import (cyclegan_steps, grad_errors, max_loss_rel_err,
                                    param_errors, raft_sequence_step, raft_train_inputs,
                                    stargan2_steps, stargan_steps, training_step)

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


@pytest.mark.parametrize("method", ["johnson", "dumoulin", "huang", "reconet", "ruder"])
def test_training_step_on_the_card_matches_the_cpu(dev, method):
    """One step at 64×64, batch 2 (Ruder unrolled): the loss and its terms in
    float32 within 1e-4 relative; every parameter's gradient in float64
    within 1e-3 relative in L2 (``vst_torch.train.parity``: in float32 the
    ReLUs and max-pools that rounding switches decide 0.6–2 % of a
    parameter's gradient)."""
    coin = True if method == "ruder" else None
    (want, want_aux, _), (got, got_aux, _) = (training_step(method, d, torch.float32, coin)
                                              for d in ("cpu", dev))
    assert abs(got - want) <= 1e-4 * abs(want)
    for k, w in want_aux.items():
        assert abs(got_aux[k] - w) <= 1e-4 * abs(w), k
    (_, _, want_g), (_, _, got_g) = (training_step(method, d, torch.float64, coin)
                                     for d in ("cpu", dev))
    assert grad_errors(got_g, want_g)[0] <= 1e-3


def test_device_cache_on_the_card_is_the_cpus(dev, tmp_path):
    rng = np.random.RandomState(0)
    for i in range(5):
        d = rng.rand(1, 16, 20, 9).astype(np.float32)
        d[..., 7:9] = 8 * d[..., 7:9] - 4
        np.save(tmp_path / f"{i:07d}.npy", d)
    card = DeviceFC2Cache(str(tmp_path), seed=3, device=dev)
    host = DeviceFC2Cache(str(tmp_path), seed=3, device="cpu")
    assert card.imgs.device.type == "cuda"
    for _ in range(3):
        got, want = card.sample(4), host.sample(4)
        for k in want:
            assert got[k].device.type == "cuda"
            torch.testing.assert_close(got[k].cpu(), want[k], atol=0, rtol=0)


def obst_level(device, dtype, hw=(32, 32), iters=20, seed=0):
    """One OBST level on ``device``: 20 compact L-BFGS iterations from a
    seeded image against a seeded style, content, warp target and mask
    (temporal weight 2000). Returns (image, losses) on the CPU."""
    rng = np.random.RandomState(seed)
    obst = OBST(seed=seed, compute_dtype=dtype, device=device)
    obst.set_style(rng.rand(2 * hw[0], 2 * hw[1], 3), [hw])
    x0, content, warp_img = (torch.from_numpy((rng.rand(1, 3, *hw) - 0.45) * 255.0)
                             .to(device, dtype) for _ in range(3))
    mask = torch.from_numpy(rng.rand(1, 3, *hw)).to(device, dtype)
    with torch.no_grad():
        feats = obst._features(content, ["r42"])
    x, losses = obst.descend(x0, obst.style_targets[0], feats, warp_img, mask, 2000.0, iters)
    return x.cpu(), losses.cpu()


def test_obst_level_on_the_card_matches_the_cpu(dev):
    """Float64 (the L-BFGS path amplifies float32 noise; see
    tests/test_torch_gatys.py): the image within 1e-8 relative."""
    got, got_losses = obst_level(dev, torch.float64)
    want, want_losses = obst_level("cpu", torch.float64)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-8
    assert ((got_losses - want_losses).abs().max() / want_losses.abs().max()).item() <= 1e-8
    assert want_losses[-1] < want_losses[0]


def test_inception_and_lpips_on_the_card_match_the_cpu(dev):
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 3, 80, 80).astype(np.float32)) * 2 - 1
    want = InceptionV3(seed=0, device="cpu")(x)
    got = InceptionV3(seed=0, device=dev)(x.to(dev))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    want = LPIPS(seed=0, device="cpu")(x[:2], x[2:])
    got = LPIPS(seed=0, device=dev)(x[:2].to(dev), x[2:].to(dev))
    assert abs(got - want) <= 1e-4 * want


GAN_LOSS_RTOL = 1e-4  # float32, card against CPU
GAN_GRAD_RTOL = 1e-8  # float64, card against CPU, L2 per parameter


@pytest.mark.parametrize("steps", [stargan2_steps, stargan_steps], ids=["stargan2", "stargan"])
def test_gan_steps_on_the_card_match_the_cpu(dev, steps):
    """Every step's losses in float32 and gradients in float64 (in float32 a
    gradient is only as exact as rounding; the R1 / WGAN-GP double backward
    runs on cuDNN with TF32 off)."""
    for dtype, check in ((torch.float32, "loss"), (torch.float64, "grad")):
        want, got = steps("cpu", dtype), steps(dev, dtype)
        for name, (w_loss, w_grad) in want.items():
            g_loss, g_grad = got[name]
            if check == "loss":
                assert max_loss_rel_err(g_loss, w_loss) <= GAN_LOSS_RTOL, name
            else:
                assert grad_errors(g_grad, w_grad)[0] <= GAN_GRAD_RTOL, name


def test_styled_cache_on_the_card_is_the_cpus(dev, tmp_path):
    generate_fc2_corpus(str(tmp_path), 5, hw=(32, 48), seed=2, styler="procedural",
                        device="cpu")
    caches = [DeviceStyledCache(str(tmp_path), num_dom=3, seed=4, device=d) for d in ("cpu", dev)]
    for sampler, args in (("sample", (4,)), ("sample_multidomain", (4,)),
                          ("sample_cyclegan", (3, 2))):
        want, got = (getattr(c, sampler)(*args) for c in caches)
        for k, v in want.items():
            torch.testing.assert_close(got[k].cpu(), v, atol=0, rtol=0)


@pytest.mark.parametrize("variant", ["cyclegan", "cyclegan_con", "mogan", "congan"])
def test_cyclegan_steps_on_the_card_match_the_cpu(dev, variant):
    """At 32² on the stub flow: losses in float32, gradients and updated
    parameters in float64; MoGAN and ConGAN also at 64² with RAFT (4
    iterations), the kernel on the card against the plain lookup on the CPU,
    losses in float32."""
    for dtype in (torch.float32, torch.float64):
        want, got = cyclegan_steps(variant, "cpu", dtype), cyclegan_steps(variant, dev, dtype)
        for step, (w_loss, w_grads, w_params) in want.items():
            g_loss, g_grads, g_params = got[step]
            if dtype == torch.float32:
                assert max_loss_rel_err(g_loss, w_loss) <= GAN_LOSS_RTOL, step
            else:
                assert grad_errors(g_grads, w_grads)[0] <= GAN_GRAD_RTOL, step
                assert param_errors(g_params, w_params, w_grads, 2e-4) <= GAN_GRAD_RTOL, step
    if variant in ("mogan", "congan"):
        runs = []
        for device, lookup in ((dev, corr_lookup), ("cpu", lookup_pyramid)):
            torch.manual_seed(2)
            raft = RAFT(iters=4, lookup=lookup).to(device).eval()
            runs.append(cyclegan_steps(variant, device, torch.float32, raft=raft, hw=(64, 64)))
        for step in runs[1]:
            assert max_loss_rel_err(runs[0][step][0], runs[1][step][0]) <= GAN_LOSS_RTOL, step


@pytest.mark.parametrize("small,train_mode", [(True, False), (True, True), (False, True)],
                         ids=["small", "small_train_mode", "full_train_mode"])
def test_raft_variants_through_the_kernel_match_plain_lookup(dev, small, train_mode):
    """Flows within 1e-3 px; 3 launches a call (radius 3 for the small net)."""
    rng = np.random.RandomState(7)
    i1, i2 = (torch.from_numpy(rng.rand(2, 3, 64, 96).astype(np.float32) * 255).to(dev)
              for _ in range(2))
    torch.manual_seed(7)
    fast = RAFT(iters=3, small=small, train_mode=train_mode).to(dev).eval()
    plain = RAFT(iters=3, small=small, train_mode=train_mode, lookup=lookup_pyramid).to(dev)
    plain.load_state_dict(fast.state_dict())
    before = corr_lookup.launches
    with torch.no_grad():
        got, want = fast(i1, i2), plain(i1, i2)
    torch.cuda.synchronize()
    assert corr_lookup.launches == before + 3
    assert got[1].shape == ((3, 2, 2, 64, 96) if train_mode else (2, 2, 64, 96))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_raft_sequence_loss_on_the_card_matches_the_cpu(dev, small):
    """The loss in f32 through the kernel within 1e-4 relative; every
    gradient in f64 (the plain lookup on both sides) within 1e-8 relative in
    L2; 3 launches and 3 backward passes of the lookup on the card."""
    inputs = raft_train_inputs((64, 64), batch=2, seed=5)
    torch.manual_seed(5)
    net = RAFT(iters=3, small=small, train_mode=True)
    plain = RAFT(iters=3, small=small, train_mode=True, lookup=lookup_pyramid)
    plain.load_state_dict(net.state_dict())
    launches, backwards = corr_lookup.launches, corr_lookup.plain_backwards
    got, _ = raft_sequence_step(net, inputs, dev, torch.float32)
    assert corr_lookup.launches - launches == 3
    assert corr_lookup.plain_backwards - backwards == 3
    want, _ = raft_sequence_step(net, inputs, "cpu", torch.float32)
    assert abs(got - want) <= 1e-4 * abs(want)
    _, got_g = raft_sequence_step(plain, inputs, dev, torch.float64)
    _, want_g = raft_sequence_step(plain, inputs, "cpu", torch.float64)
    worst, _ = grad_errors(got_g, want_g)
    assert worst <= 1e-8, worst


def test_precompute_lt_flow_through_the_kernel_matches_plain_lookup(dev):
    """The random net's flows × 0.1 pass the forward-backward check in part
    (an all-0 mask would compare nothing)."""
    frames = np.random.RandomState(8).rand(7, 64, 96, 3).astype(np.float32)
    outs = []
    for lookup in (corr_lookup, lookup_pyramid):
        torch.manual_seed(8)
        raft = RAFT(iters=4, lookup=lookup).to(dev).eval()
        outs.append(precompute_lt_flow(
            frames, lambda a, b: tuple(0.1 * f for f in raft(255 * a, 255 * b)), device=dev))
    for a, b in zip(*outs):
        assert a.shape == (1, 64, 96, 3)
        assert 0.0 < b[..., 2].mean() < 1.0
        np.testing.assert_allclose(a[..., :2], b[..., :2], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(a[..., 2], b[..., 2])


def test_world_size_one_nccl_step_is_the_plain_step(dev, tmp_path):
    """With an NCCL group of one rank a Johnson trainer's update (the
    gradients' all-reduce, then Adam) is the plain trainer's bit for bit
    over 3 updates from the same gradients (the card's backward itself is
    not bit for bit between runs: reflection pad's backward adds with
    atomics), and a whole reduced step runs and returns finite terms."""
    from vst_torch.data.styles import load_style_images
    from vst_torch.data.synthetic import synthetic_batch
    from vst_torch.parallel.mesh import create_mesh, initialize_distributed
    from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
    from vst_torch.train.registry import select_method

    batches = [batch_to_tensors(synthetic_batch(2, hw=(64, 64), n_frames=2, seed=s), dev)
               for s in range(3)]
    initialize_distributed(f"file://{tmp_path}/pg", 1, 0, device="cuda")
    try:
        plain, reduced = (FastStyleTrainer(select_method("johnson", batch_size=2),
                                           load_style_images(size=64)[:1], seed=0, device=dev,
                                           mesh=mesh)
                          for mesh in (None, create_mesh(devices=[dev])))
        for batch in batches:
            plain.opt.zero_grad(set_to_none=True)
            plain.loss_fn(batch)[0].backward()
            for p, q in zip(plain.model.parameters(), reduced.model.parameters()):
                q.grad = p.grad.clone()
            plain.apply_gradients()
            reduced.apply_gradients()
        same = [torch.equal(reduced.model.state_dict()[k], v)
                for k, v in plain.model.state_dict().items()]
        terms = reduced.train_step(batches[0])
    finally:
        torch.distributed.destroy_process_group()
    assert all(same), f"{same.count(False)} tensors differ"
    assert all(torch.isfinite(v).all() for v in terms.values())
