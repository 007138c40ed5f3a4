"""Each frozen reference against ``vst_torch`` at tiny sizes, with the same
weights (the reference's, drawn from a seed, loaded into the port's nets)."""

import time

import pytest
import torch

from vstbench import cell as cells
from vstbench import data
from vstbench.reference import johnson, raft, seeded, stargan2, tcl


def gen(seed=5):
    return seeded.generator(seed, "cpu")


def test_seeded_weights_repeat_and_draw_in_two_calls():
    a, b = johnson.make(3, gen(2 ** 33 + 7)), johnson.make(3, gen(2 ** 33 + 7))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    emb = a.conv1.instance.embed.weight
    assert torch.all(emb[:, 32:] == 0) and abs(float(emb[:, :32].mean().detach()) - 1) < 0.02


def test_faststyle_matches_the_port():
    from vst_torch.models.faststyle import FastStyleNet

    ref = johnson.make(3, gen())
    port = FastStyleNet(3, 3)
    port.load_state_dict(ref.state_dict())
    x = torch.rand(2, 3, 32, 48) * 2 - 1
    with torch.no_grad():
        for style in range(3):
            want = ref(x, style)
            got = port(x, 1.0, style)[1]
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_raft_matches_the_port_with_its_plain_lookup():
    from vst_torch.flow.corr import lookup_pyramid
    from vst_torch.flow.raft import RAFT

    ref = raft.make(3, gen())
    port = RAFT(iters=3, lookup=lookup_pyramid).eval()
    port.load_state_dict(ref.state_dict())
    clip = torch.from_numpy(data.clips(gen(9), 1, 2, (128, 128))[0]).permute(0, 3, 1, 2)
    x = clip * 2 - 1
    with torch.no_grad():
        want = ref(x[:1], x[1:])
        got = port(x[:1], x[1:])[1]
    assert want.abs().mean() > 1e-3
    assert (got - want).abs().max() <= 1e-4


def test_raft_lookup_matches_the_ports_plain_version():
    from vst_torch.flow.corr import lookup_pyramid

    g = torch.Generator().manual_seed(3)
    f1, f2 = torch.randn(2, 16, 16, 24, generator=g), torch.randn(2, 16, 16, 24, generator=g)
    pyr = raft.build_pyramid(f1, f2)
    coords = torch.rand(2, 2, 16, 24, generator=g) * 30 - 3
    assert torch.allclose(raft.lookup(pyr, coords), lookup_pyramid(pyr, coords, 4), atol=1e-5)


def test_warp_mask_and_tcl_match_the_port():
    from vst_torch.eval.sintel import tcl_value
    from vst_torch.ops.flowtools import fbc_mask
    from vst_torch.ops.image import InputPadder
    from vst_torch.ops.sample import warp

    g = torch.Generator().manual_seed(4)
    x = torch.rand(1, 3, 36, 50, generator=g)
    ff = torch.randn(1, 2, 36, 50, generator=g) * 0.3
    bf = -ff + 0.05 * torch.randn(1, 2, 36, 50, generator=g)
    assert torch.allclose(tcl.warp(x, bf), warp(x, bf), atol=1e-6)
    assert torch.equal(tcl.fb_mask(ff, bf), fbc_mask(ff, bf))
    want = tcl_value(fbc_mask(ff, bf), x, warp(x * 0.9, bf))
    assert torch.allclose(tcl.tcl(x, x * 0.9, ff, bf), want, rtol=1e-5)
    padder = InputPadder(x.shape)
    assert torch.equal(tcl.pad(x), padder.pad(x)[0])
    assert torch.equal(tcl.unpad(tcl.pad(x), 36, 50), x)


CFG = dict(img_size=32, style_dim=8, latent_dim=4, max_conv_dim=32, num_domains=4,
           lambda_reg=1.0, lambda_sty=1.0, lambda_cyc=1.0, lambda_tcl=100.0, lr=1e-4,
           f_lr=1e-6, beta1=0.0, beta2=0.99, weight_decay=1e-4, ema_beta=0.999)


def test_stargan2_nets_match_the_port():
    from vst_torch.models import stargan2 as port

    ref = stargan2.make(CFG, gen())
    nets = {"generator": port.Generator(32, 8, 32), "mapping": port.MappingNetwork(4, 8, 4),
            "style_enc": port.StyleEncoder(32, 8, 4, 32), "disc": port.Discriminator(32, 4, 32)}
    for k, net in nets.items():
        net.load_state_dict(ref[k].state_dict())
    g = torch.Generator().manual_seed(1)
    x, z = torch.rand(3, 3, 32, 32, generator=g) * 2 - 1, torch.randn(3, 4, generator=g)
    y = torch.tensor([0, 2, 3])
    with torch.no_grad():
        s = ref["mapping"](z, y)
        assert torch.allclose(nets["mapping"](z, y), s, atol=1e-5)
        assert torch.allclose(nets["generator"](x, s), ref["generator"](x, s), atol=1e-4)
        assert torch.allclose(nets["style_enc"](x, y), ref["style_enc"](x, y), atol=1e-5)
        assert torch.allclose(nets["disc"](x, y), ref["disc"](x, y), atol=1e-5)


def test_advcon_iterations_match_the_trainer_in_float64():
    """Three iterations of the reference and of ``StarGAN2Trainer`` in float64:
    every step loss and every parameter agree to float64 rounding."""
    from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer

    ref = stargan2.make(CFG, gen())
    batches = data.advcon_batches(gen(8), 3, 2, 32, 4, 4)
    t = StarGAN2Trainer(StarGAN2Config(**{k: v for k, v in CFG.items()}), device="cpu")
    for k, net in t.nets.items():
        net.load_state_dict(ref[k].state_dict())
        net.double()
    for k, net in t.ema.items():
        net.load_state_dict(ref[k].state_dict())
        net.double()
    t.opts = {k: torch.optim.AdamW(net.parameters(), lr=CFG["f_lr"] if k == "mapping"
                                   else CFG["lr"], betas=(0.0, 0.99), eps=1e-8,
                                   weight_decay=1e-4) for k, net in t.nets.items()}
    r = stargan2.AdvConTrainer(CFG, {k: v.double() for k, v in ref.items()})
    from vstbench.families.stargan2 import step_losses

    for b in batches:
        b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
        got = step_losses({"stargan2": CFG}, t.train_iteration(
            {k: v for k, v in b.items() if k != "z"}, z=b["z"]))
        want = r.iteration(b, b["z"])
        assert torch.allclose(got, want, rtol=1e-9)
    for k in t.nets:
        for p, q in zip(t.nets[k].parameters(), r.nets[k].parameters()):
            assert torch.allclose(p, q, rtol=0, atol=1e-9)
    for k in t.ema:
        for p, q in zip(t.ema[k].parameters(), r.ema[k].parameters()):
            assert torch.allclose(p, q, rtol=0, atol=1e-9)


def test_advcon_batches_hold_their_flow():
    """x_real warped by the pool's flow lands on x_real2 where the mask is 1,
    to the resampling error of a smooth texture."""
    b = data.advcon_batches(gen(2), 1, 4, 64, 4, 16)[0]
    H = W = 64
    ys, xs = torch.meshgrid(torch.arange(H).float(), torch.arange(W).float(), indexing="ij")
    gx = (2 * (xs + b["flow"][:, 0]) + 1) / W - 1
    gy = (2 * (ys + b["flow"][:, 1]) + 1) / H - 1
    w = torch.nn.functional.grid_sample(b["x_real"], torch.stack([gx, gy], -1),
                                        align_corners=False)
    m = b["mask"]
    err = ((w - b["x_real2"]).abs() * m).sum() / (3 * m.sum())
    assert m.mean() > 0.8 and err < 0.3 * (b["x_real2"] - b["x_real"]).abs().mean()
