"""RAFT's SepConvGRU and its fused kernels' wrapper
(``vst_torch.kernels.sepconv_gru``) on the CPU: the plain half-step is the
module's former math bit for bit, in float32 and with bfloat16 gates; the
wrapper on CPU tensors is the plain half-step bit for bit and launches
nothing, and the kernels' own entry points refuse CPU tensors;
``pack_gates`` lays the weights out tap, then input channel, then output
channel; and the dispatch rule: the wrapper only for float32 gates with
autograd not recording, so training keeps its gradients, and the wrapper
raises on CUDA where autograd records. The kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from vst_torch.flow.raft import RAFT, SepConvGRU
from vst_torch.kernels import sepconv_gru as gru_kernels
from vst_torch.kernels.sepconv_gru import (gru_q, gru_zr, gru_zr_plain, half_step_plain,
                                           pack_gates, sepconv_gru)

SHAPE = (2, 6, 10)  # batch, rows, columns: small, with a ragged 1/8 grid


def _inputs(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    B, H, W = SHAPE
    h = torch.tanh(torch.randn(B, 128, H, W, generator=g))
    x = torch.relu(torch.randn(B, 256, H, W, generator=g)).to(dtype)
    return h, x


def _gru(seed, dtype=None):
    torch.manual_seed(seed)
    return SepConvGRU(128, 256, dtype=dtype)


def _former_forward(gru, h, x):
    """``SepConvGRU.forward`` as it was written before the kernels."""
    for tag in ("1", "2"):
        hx = torch.cat([h.to(x.dtype), x], 1)
        z = torch.sigmoid(getattr(gru, f"convz{tag}")(hx))
        r = torch.sigmoid(getattr(gru, f"convr{tag}")(hx))
        q = torch.tanh(getattr(gru, f"convq{tag}")(torch.cat([r * h.to(r.dtype), x], 1)))
        h = (1 - z.to(h.dtype)) * h + z.to(h.dtype) * q.to(h.dtype)
    return h


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's would, so that the
    wrapper's refusals on CUDA can be read without a card (nothing is
    computed on it)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
def test_the_plain_half_steps_are_the_former_math_bit_for_bit(dtype):
    gru = _gru(0, dtype)
    h, x = _inputs(1, dtype or torch.float32)
    with torch.no_grad():
        got = gru(h, x)
        want = _former_forward(gru, h, x)
        first = half_step_plain(h, x, gru.convz1, gru.convr1, gru.convq1)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(half_step_plain(first, x, gru.convz2, gru.convr2, gru.convq2), want)


@pytest.mark.parametrize("tag,axis", [("1", 0), ("2", 1)], ids=["1x5", "5x1"])
def test_the_wrapper_on_the_cpu_is_the_plain_half_step_and_launches_nothing(tag, axis):
    gru = _gru(2)
    h, x = _inputs(3)
    convz, convr, convq = (getattr(gru, f"conv{g}{tag}") for g in "zrq")
    before = sepconv_gru.launches
    with torch.no_grad():
        gates = pack_gates(convz, convr, convq)
        got = sepconv_gru(h, x, convz, convr, convq)
        want = half_step_plain(h, x, convz, convr, convq)
        z, rh = gru_zr_plain(h, x, convz, convr)
    assert gates.axis == axis
    assert torch.equal(got, want)
    assert torch.equal(z, torch.sigmoid(convz(torch.cat([h, x], 1))))
    with pytest.raises(ValueError, match="CUDA"):
        gru_zr(h, x, gates)
    with pytest.raises(ValueError, match="CUDA"):
        gru_q(h, x, z, rh, gates)
    assert sepconv_gru.launches == before


@pytest.mark.parametrize("tag", ["1", "2"], ids=["1x5", "5x1"])
def test_pack_gates_lays_out_tap_then_input_then_output_channel(tag):
    gru = _gru(4)
    convz, convr, convq = (getattr(gru, f"conv{g}{tag}") for g in "zrq")
    gates = pack_gates(convz, convr, convq)
    assert gates.wzr.shape == (5, 384, 256) and gates.wq.shape == (5, 384, 128)
    assert gates.wzr.is_contiguous() and gates.wq.is_contiguous()
    for t in range(5):
        for conv, packed in ((convz, gates.wzr[t, :, :128]), (convr, gates.wzr[t, :, 128:]),
                             (convq, gates.wq[t])):
            assert torch.equal(packed, conv.weight.reshape(128, 384, 5)[:, :, t].T)
    assert torch.equal(gates.bzr, torch.cat([convz.bias, convr.bias]))
    assert torch.equal(gates.bq, convq.bias)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    """Shapes, dtypes and layouts the kernels do not take; and, on CUDA, a
    call that autograd records (the kernels have no backward)."""
    gru = _gru(5)
    h, x = _inputs(6)
    gates = pack_gates(gru.convz1, gru.convr1, gru.convq1)
    with pytest.raises(ValueError, match="must be"):
        gru_zr(h[:, :96], x, gates)  # 96 hidden channels
    with pytest.raises(ValueError, match="must be"):
        gru_zr(h, x[:, :200], gates)  # x's channels not in chunks of 16
    with pytest.raises(ValueError, match="do not fit"):
        gru_zr(h, x[:, :128], gates)
    with pytest.raises(TypeError):
        gru_zr(h.double(), x.double(), gates)
    with pytest.raises(ValueError, match="contiguous"):
        gru_zr(h, x.transpose(2, 3).contiguous().transpose(2, 3), gates)
    with pytest.raises(RuntimeError, match="no backward"):
        sepconv_gru(h.as_subclass(_OnCard), x.as_subclass(_OnCard), gru.convz1, gru.convr1,
                    gru.convq1)


@pytest.mark.parametrize("case,want", [
    ("no_grad", True), ("grad_params", False), ("grad_frozen", True),
    ("grad_frozen_x_requires_grad", False), ("bfloat16", False), ("cpu", True)])
def test_the_dispatch_rule(case, want):
    """The kernels' wrapper only for float32 gates with autograd not
    recording, and then for both passes; ``half_step_plain`` otherwise. The
    rule reads no device: inputs on a card and on the CPU take the same
    route (the wrapper picks the kernels or the plain half-step)."""
    gru = _gru(7, torch.bfloat16 if case == "bfloat16" else None)
    h, x = _inputs(8)
    if case != "cpu":
        h, x = h.as_subclass(_OnCard), x.as_subclass(_OnCard)
    if case.startswith("grad_frozen"):
        gru.requires_grad_(False)
    if case == "grad_frozen_x_requires_grad":
        x.requires_grad_(True)
    with torch.set_grad_enabled(case not in ("no_grad", "cpu")):
        assert gru.half_step(h, x) is (sepconv_gru if want else half_step_plain)
        if want:
            gates = [pack_gates(*gru._convs(tag)) for tag in ("1", "2")]
            assert [g.axis for g in gates] == [0, 1]
            assert not any(t.requires_grad for g in gates for t in g[1:])


def test_under_autograd_nothing_reaches_the_wrapper_and_gradients_are_unchanged(monkeypatch):
    """A training-mode RAFT step on the CPU under autograd routes nothing
    to the kernels' wrapper or packs gates, and the GRU's gradients are the
    former math's bit for bit."""
    calls = []
    monkeypatch.setattr("vst_torch.flow.raft.sepconv_gru", lambda *a: calls.append(a))
    monkeypatch.setattr(gru_kernels, "pack_gates", lambda *a: calls.append(a))
    torch.manual_seed(9)
    raft = RAFT(iters=2, train_mode=True).train()
    i1, i2 = (255 * torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(s))
              for s in (10, 11))
    _, preds = raft(i1, i2)
    preds.abs().mean().backward()
    assert not calls and raft.update_block.gru.convq2.weight.grad is not None

    gru = _gru(12)
    h, x = _inputs(13)
    x.requires_grad_(True)
    got = torch.autograd.grad(gru(h, x).square().sum(), [x, *gru.parameters()])
    want = torch.autograd.grad(_former_forward(gru, h, x).square().sum(),
                               [x, *gru.parameters()])
    assert not calls
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_raft_packs_no_gates_on_the_cpu_and_counts_no_launch(monkeypatch):
    """RAFT outside autograd on the CPU: each iteration's two passes go
    through the wrapper, which runs the plain half-step, packs nothing and
    counts no launch."""
    steps, packs = [], []
    monkeypatch.setattr("vst_torch.flow.raft.sepconv_gru",
                        lambda *a: steps.append(a) or sepconv_gru(*a))
    monkeypatch.setattr(gru_kernels, "pack_gates", lambda *a: packs.append(a))
    torch.manual_seed(14)
    raft = RAFT(iters=2).eval()
    before = sepconv_gru.launches
    img = 255 * torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(15))
    with torch.no_grad():
        raft(img, img)
    assert len(steps) == 2 * 2 and not packs
    assert sepconv_gru.launches == before == gru_kernels.sepconv_gru.launches
