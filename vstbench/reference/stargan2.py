"""StarGAN v2 (Choi et al. 2020, arXiv:1912.01865) and one AdvCon training
iteration of the thesis, in plain PyTorch: the benchmark's reference of the
``stargan2`` configuration.

Nets as the authors' ``core/model.py`` (w_hpf = 0): the generator (from_rgb,
4 downsampling and 2 bottleneck ``ResBlk``s with affine instance norms, 2
bottleneck and 4 upsampling ``AdainResBlk``s, to_rgb), the mapping network
(4 shared and 4 per-domain linear layers, 512 wide), the style encoder and
the discriminator (6 downsampling ``ResBlk``s, a 4x4 conv, one head a
domain). Residual paths are divided by sqrt(2). Weights are the authors'
``he_init``: kaiming-normal (fan in, ReLU) on every conv and linear weight,
zero biases. State-dict keys are the authors'.

One iteration (``core/solver.py``, with the thesis' AdvCon term):

1. D step, latent style: BCE(D(x_real), 1) + BCE(D(G(x_real, F(z))), 0) +
   lambda_reg * R1, R1 = 0.5 * mean over the batch of |d D(x_real) / d x_real|^2;
2. the same D step with the reference style E(x_ref);
3. G step, latent style, updating G, F and E: BCE(D(fake), 1) +
   lambda_sty * |E(fake) - s| + lambda_cyc * |G(fake, E(x_real)) - x_real| +
   lambda_tcl * mean((mask * (G(x_real2, s) - warp(fake, flow)))^2), means
   over all elements; the diversity term is disabled in the thesis;
4. the same G step with the reference style, updating G alone;
5. EMA (beta 0.999) of G, F and E.

Optimizers are decoupled-weight-decay Adam (lr 1e-4, 1e-6 for F, betas (0,
0.99), eps 1e-8, weight decay 1e-4), as the port's trainer states.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from vstbench.reference import seeded
from vstbench.reference.tcl import warp

NETS = ("generator", "mapping", "style_enc", "disc")
EMA_NETS = ("generator", "mapping", "style_enc")


class InstanceNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=1e-5)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResBlk(nn.Module):
    def __init__(self, cin, cout, normalize=False, downsample=False):
        super().__init__()
        self.normalize, self.downsample = normalize, downsample
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1)
        self.conv2 = nn.Conv2d(cin, cout, 3, 1, 1)
        if normalize:
            self.norm1 = InstanceNorm(cin)
            self.norm2 = InstanceNorm(cin)
        self.conv1x1 = nn.Conv2d(cin, cout, 1, 1, 0, bias=False) if cin != cout else None

    def forward(self, x):
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        if self.downsample:
            sc = F.avg_pool2d(sc, 2)
        h = self.norm1(x) if self.normalize else x
        h = self.conv1(lrelu(h))
        if self.downsample:
            h = F.avg_pool2d(h, 2)
        if self.normalize:
            h = self.norm2(h)
        h = self.conv2(lrelu(h))
        return (sc + h) / math.sqrt(2)


class AdaIN(nn.Module):
    def __init__(self, style_dim, c):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * c)

    def forward(self, x, s):
        gamma, beta = self.fc(s)[:, :, None, None].chunk(2, dim=1)
        return (1 + gamma) * F.instance_norm(x, eps=1e-5) + beta


class AdainResBlk(nn.Module):
    def __init__(self, cin, cout, style_dim, upsample=False):
        super().__init__()
        self.upsample = upsample
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.norm1 = AdaIN(style_dim, cin)
        self.norm2 = AdaIN(style_dim, cout)
        self.conv1x1 = nn.Conv2d(cin, cout, 1, 1, 0, bias=False) if cin != cout else None

    def forward(self, x, s):
        h = lrelu(self.norm1(x, s))
        if self.upsample:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = self.conv2(lrelu(self.norm2(self.conv1(h), s)))
        sc = F.interpolate(x, scale_factor=2, mode="nearest") if self.upsample else x
        if self.conv1x1 is not None:
            sc = self.conv1x1(sc)
        return (h + sc) / math.sqrt(2)


def _dims(img_size, max_conv_dim, n):
    dims = [2 ** 14 // img_size]
    for _ in range(n):
        dims.append(min(dims[-1] * 2, max_conv_dim))
    return dims


class Generator(nn.Module):
    def __init__(self, img_size=256, style_dim=64, max_conv_dim=512):
        super().__init__()
        n = int(math.log2(img_size)) - 4
        d = _dims(img_size, max_conv_dim, n)
        self.from_rgb = nn.Conv2d(3, d[0], 3, 1, 1)
        self.encode = nn.ModuleList([ResBlk(d[i], d[i + 1], True, True) for i in range(n)]
                                    + [ResBlk(d[-1], d[-1], True) for _ in range(2)])
        self.decode = nn.ModuleList([AdainResBlk(d[-1], d[-1], style_dim) for _ in range(2)]
                                    + [AdainResBlk(d[n - i], d[n - 1 - i], style_dim, True)
                                       for i in range(n)])
        self.to_rgb = nn.Sequential(InstanceNorm(d[0]), nn.LeakyReLU(0.2),
                                    nn.Conv2d(d[0], 3, 1, 1, 0))

    def forward(self, x, s):
        h = self.from_rgb(x)
        for block in self.encode:
            h = block(h)
        for block in self.decode:
            h = block(h, s)
        return self.to_rgb(h)


def _pick(out, y):
    return out[torch.arange(out.shape[0], device=out.device), y]


class MappingNetwork(nn.Module):
    def __init__(self, latent_dim=16, style_dim=64, num_domains=4):
        super().__init__()
        layers = [nn.Linear(latent_dim, 512), nn.ReLU()]
        for _ in range(3):
            layers += [nn.Linear(512, 512), nn.ReLU()]
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList(
            nn.Sequential(nn.Linear(512, 512), nn.ReLU(), nn.Linear(512, 512), nn.ReLU(),
                          nn.Linear(512, 512), nn.ReLU(), nn.Linear(512, style_dim))
            for _ in range(num_domains))

    def forward(self, z, y):
        h = self.shared(z)
        return _pick(torch.stack([u(h) for u in self.unshared], 1), y)


def _trunk(img_size, max_conv_dim):
    n = int(math.log2(img_size)) - 2
    d = _dims(img_size, max_conv_dim, n)
    return ([nn.Conv2d(3, d[0], 3, 1, 1)] + [ResBlk(d[i], d[i + 1], downsample=True)
                                             for i in range(n)]
            + [nn.LeakyReLU(0.2), nn.Conv2d(d[-1], d[-1], 4, 1, 0), nn.LeakyReLU(0.2)], d[-1])


class StyleEncoder(nn.Module):
    def __init__(self, img_size=256, style_dim=64, num_domains=4, max_conv_dim=512):
        super().__init__()
        layers, c = _trunk(img_size, max_conv_dim)
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList(nn.Linear(c, style_dim) for _ in range(num_domains))

    def forward(self, x, y):
        h = self.shared(x).flatten(1)
        return _pick(torch.stack([u(h) for u in self.unshared], 1), y)


class Discriminator(nn.Module):
    def __init__(self, img_size=256, num_domains=4, max_conv_dim=512):
        super().__init__()
        layers, c = _trunk(img_size, max_conv_dim)
        self.main = nn.Sequential(*layers, nn.Conv2d(c, num_domains, 1, 1, 0))

    def forward(self, x, y):
        return _pick(self.main(x).flatten(1), y)


def builders(cfg: Dict) -> Dict:
    return {
        "generator": lambda: Generator(cfg["img_size"], cfg["style_dim"], cfg["max_conv_dim"]),
        "mapping": lambda: MappingNetwork(cfg["latent_dim"], cfg["style_dim"],
                                          cfg["num_domains"]),
        "style_enc": lambda: StyleEncoder(cfg["img_size"], cfg["style_dim"], cfg["num_domains"],
                                          cfg["max_conv_dim"]),
        "disc": lambda: Discriminator(cfg["img_size"], cfg["num_domains"], cfg["max_conv_dim"]),
    }


def he_rule(name, t):
    if t.dim() == 1 and name.endswith(".weight"):  # instance norms' scales
        return ("const", 1.0)
    if name.endswith(".bias"):
        return ("const", 0.0)
    return ("normal", 0.0, math.sqrt(2.0 / seeded.fan_in(t)))


def make(cfg: Dict, generator: torch.Generator, names=NETS) -> Dict[str, nn.Module]:
    """The nets of ``names`` on the generator's device, he-initialised from it,
    in the order of ``NETS``."""
    out = {}
    for name in NETS:
        if name in names:
            net = seeded.build(builders(cfg)[name], generator.device)
            out[name] = seeded.fill(net, generator, he_rule)
    return out


def adv_loss(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


class AdvConTrainer:
    """The reference of one AdvCon iteration, stepping its own copies of the
    nets (``nets``, a dict under ``NETS``) with its own optimizers."""

    def __init__(self, cfg: Dict, nets: Dict[str, nn.Module]):
        self.cfg = cfg
        self.nets = nets
        self.ema = {k: copy.deepcopy(nets[k]).requires_grad_(False) for k in EMA_NETS}
        self.opts = {k: torch.optim.AdamW(net.parameters(),
                                          lr=cfg["f_lr"] if k == "mapping" else cfg["lr"],
                                          betas=(cfg["beta1"], cfg["beta2"]), eps=1e-8,
                                          weight_decay=cfg["weight_decay"])
                     for k, net in nets.items()}

    def _style(self, kind, y, z, x_ref):
        return self.nets["mapping"](z, y) if kind == "latent" else self.nets["style_enc"](x_ref, y)

    def _step(self, names, loss):
        for k in names:
            self.opts[k].zero_grad(set_to_none=True)
        loss.backward()
        for k in names:
            self.opts[k].step()

    def d_step(self, kind, b, z):
        n = self.nets
        x = b["x_real"].detach().requires_grad_(True)
        out = n["disc"](x, b["y_org"])
        real = adv_loss(out, 1.0)
        g, = torch.autograd.grad(out.sum(), x, create_graph=True)
        reg = 0.5 * g.pow(2).reshape(g.shape[0], -1).sum(1).mean()
        with torch.no_grad():
            fake_img = n["generator"](x.detach(), self._style(kind, b["y_trg"], z, b["x_ref"]))
        fake = adv_loss(n["disc"](fake_img, b["y_trg"]), 0.0)
        loss = real + fake + self.cfg["lambda_reg"] * reg
        self._step(("disc",), loss)
        return loss.detach()

    def g_step(self, kind, b, z):
        c, n = self.cfg, self.nets
        names = EMA_NETS if kind == "latent" else ("generator",)
        for k, net in n.items():
            net.requires_grad_(k in names)
        s = self._style(kind, b["y_trg"], z, b["x_ref"])
        fake = n["generator"](b["x_real"], s)
        loss = adv_loss(n["disc"](fake, b["y_trg"]), 1.0)
        loss = loss + c["lambda_sty"] * (n["style_enc"](fake, b["y_trg"]) - s).abs().mean()
        rec = n["generator"](fake, n["style_enc"](b["x_real"], b["y_org"]))
        loss = loss + c["lambda_cyc"] * (rec - b["x_real"]).abs().mean()
        fake2 = n["generator"](b["x_real2"], s)
        tcl = (b["mask"] * (fake2 - warp(fake, b["flow"]))).pow(2).mean()
        loss = loss + c["lambda_tcl"] * tcl
        self._step(names, loss)
        for net in n.values():
            net.requires_grad_(True)
        return loss.detach()

    @torch.no_grad()
    def ema_step(self):
        beta = self.cfg["ema_beta"]
        for k in EMA_NETS:
            for e, p in zip(self.ema[k].parameters(), self.nets[k].parameters()):
                e.copy_(torch.lerp(p, e, beta))

    def iteration(self, b, z):
        """One iteration; the four steps' total losses (D latent, D ref, G
        latent, G ref)."""
        losses = [self.d_step("latent", b, z), self.d_step("ref", b, z),
                  self.g_step("latent", b, z), self.g_step("ref", b, z)]
        self.ema_step()
        return torch.stack(losses)
