"""Shared set-up of the GAN trainer parity tests
(``tests/test_torch_stargan*.py``, ``tests/test_torch_cyclegan*.py``): the
port's trainers and vst's on the same weights, batch and random draws;
StarGAN v2 at ``CFG`` (32², style 8, latent 4, 3 domains, max width 32);
the CycleGAN family at ``CG`` (32², batch 2, ngf = ndf = 8, generators of 2
resnet blocks, pool 4; :func:`cyclegan_pair`).

The port's nets are seeded; vst receives their weights through its own
``*_params_from_torch`` (v2) or the port's ``stargan_*_state_dict_from_jax``
inverse (v1: vst has no torch bridge). vst's state is built from those
params without ``init_state`` (whose eager init of 512-wide convs takes
tens of seconds on a CPU). Batches are vst's numpy ``synthetic_fc2_batches``.

Gradients: vst's step functions apply their optimizer inside the jitted
step, so vst's gradient is read through a probe optimizer whose update is
g − p (the step then writes p + (g − p), g within a rounding of p's size).
Float64 runs use jax's x64 mode; vst rounds to float32 at its loss sites,
its instance norms and its adversarial loss even then, so :func:`float64`
patches those sites to keep float64 as the port's do:
``vst.nn.norm.instance_norm`` (and its imports in ``vst.models.stargan2``
and ``vst.models.cyclegan``), ``vst.train.stargan2.f32`` and ``adv_loss``,
``vst.train.cyclegan.f32`` and ``gan_loss`` as imported there.

The CycleGAN family's vst weights are seeded draws in each net's param
tree (``jax.eval_shape`` of its init: no eager init), carried to the port
by ``vst_torch.convert.cyclegan_*`` / ``fusion_block_state_dict_from_jax``;
vst's gradients are read from a recording optimizer's state beside the
real Adam step (:func:`recording`).
"""

import contextlib

import flax.linen
import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import vst.models.cyclegan
import vst.models.stargan2
import vst.nn.norm
import vst.train.cyclegan
import vst.train.stargan2
from vst.data.fc2 import synthetic_fc2_batches
from vst.models.cyclegan import ResnetGenerator, image_pool_init
from vst.models.stargan2 import (discriminator_params_from_torch, generator_params_from_torch,
                                 mapping_params_from_torch, style_encoder_params_from_torch)
from vst.ops.image import avg_pool2d as vst_avg_pool2d
from vst.train.cyclegan import CycleGANConfig as JCycleGANConfig
from vst.train.cyclegan import CycleGANState
from vst.train.cyclegan import CycleGANTrainer as JCycleGANTrainer
from vst.train.stargan2 import StarGAN2State
from vst_torch import convert
from vst_torch.train.cyclegan import CycleGANConfig, CycleGANTrainer, fc2_to_cyclegan
from vst_torch.train.parity import stub_flow
from vst_torch.train.stargan2 import EMA_NETS

TORCH_THREADS = 2
ZERO_GRAD = 1e-12
# StarGAN v2 at 32², batch 2: the first blocks stay 512 wide (dim_in = 2¹⁴ / img_size)
S = 32
CFG = dict(img_size=S, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32)
TO_PORT = {"generator": convert.stargan2_generator_state_dict_from_jax,
           "mapping": convert.stargan2_mapping_state_dict_from_jax,
           "style_enc": convert.stargan2_style_encoder_state_dict_from_jax,
           "disc": convert.stargan2_discriminator_state_dict_from_jax}


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


def fc2_batch(hw, batch_size, num_dom, seed):
    """vst's synthetic FC2 batch: NHWC numpy, the FC2 keys."""
    return synthetic_fc2_batches(1, batch_size, hw=hw, num_dom=num_dom, seed=seed)[0]


def tree(params, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), params)


def grad_probe():
    """An optax transformation whose update is g − p: after the step the
    parameters hold the gradient."""
    return optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(lambda g, p: g - p, grads, params), state))


def rel_err(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def grad_rel_errs(got, want):
    """Per parameter ‖got − want‖ / ‖want‖ (float64); a gradient 0 in exact
    arithmetic on vst's side (below ZERO_GRAD of the whole) must be so on
    the port's, and gives no ratio."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    total = sum(float(torch.as_tensor(w).double().norm()) ** 2 for w in want.values()) ** 0.5
    errs = {}
    for k, w in want.items():
        w, g = torch.as_tensor(np.asarray(w)).double(), got[k].double()
        assert torch.isfinite(g).all(), k
        if float(w.norm()) < ZERO_GRAD * total:
            assert float(g.norm()) < ZERO_GRAD * total, k
            continue
        errs[k] = float((g - w).norm() / w.norm())
    return errs


def vst_params(trainer, dtype=jnp.float32):
    """The port trainer's live nets as vst's param dict."""
    sd = {k: net.state_dict() for k, net in trainer.nets.items()}
    return {"generator": tree(generator_params_from_torch(sd["generator"], S), dtype),
            "mapping": tree(mapping_params_from_torch(sd["mapping"]), dtype),
            "style_enc": tree(style_encoder_params_from_torch(sd["style_enc"], S), dtype),
            "disc": tree(discriminator_params_from_torch(sd["disc"], S), dtype)}


def vst_state(jt, params):
    """vst's state on copies of ``params`` (vst's steps donate their state)."""
    params = jax.tree_util.tree_map(jnp.copy, params)
    ema = {k: jax.tree_util.tree_map(jnp.copy, params[k])
           for k in ("generator", "mapping", "style_enc")}
    return StarGAN2State(step=jnp.zeros((), jnp.int32), params=params, ema=ema,
                         opts={k: jt.tx[k].init(params[k]) for k in jt.tx},
                         lambda_ds=jnp.asarray(jt.cfg.lambda_ds, jnp.float32))


def vst_batch(b):
    return {"x_real": b["x_src"], "x_real2": b["x2_src"], "x_ref": b["x_ref"],
            "y_org": b["y_src"], "y_trg": b["y_ref"], "mask": b["mask"], "flow": b["flow"]}


def latents(key, n):
    k1, k2 = jax.random.split(key)  # vst's train_iteration
    return [np.array(jax.random.normal(k, (n, CFG["latent_dim"]))) for k in (k1, k2)]


def updated(which, kind):
    return ("disc",) if which == "d" else EMA_NETS if kind == "latent" else ("generator",)


def vst_step(jt, state, which, kind, jb, jz):
    if which == "d":
        return jt.d_step(kind)(state, jb["x_real"], jb["y_org"], jb["y_trg"], jz, jb["x_ref"])
    return jt.g_step(kind, kind == "latent")(state, {**jb, "z": jz})


def port_loss(port, which, kind, tb, tz):
    """The step's loss and metrics, with the nets the step does not update
    frozen, as ``g_step`` does."""
    if which == "d":
        return port.d_loss(kind, tb["x_real"], tb["y_org"], tb["y_trg"], tz, tb["x_ref"])
    for k, net in port.nets.items():
        net.requires_grad_(k in updated(which, kind))
    return port.g_loss(kind, {**tb, "z": tz})


def _instance_norm_keeping_f64(x, eps=1e-5):
    """vst's ``instance_norm`` with float64 statistics for float64 input."""
    xf = x if x.dtype == jnp.float64 else x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    m2 = jnp.mean(jnp.square(xf), axis=(1, 2), keepdims=True)
    var = jnp.maximum(m2 - jnp.square(mean), 0.0)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


def _f32_keeping_f64(x):
    return x.astype(jnp.promote_types(x.dtype, jnp.float32))


def _gan_loss_keeping_f64(pred, target_is_real, mode="lsgan"):
    """vst's ``gan_loss`` with the upcast keeping float64."""
    pred = _f32_keeping_f64(pred)
    if mode == "lsgan":
        return jnp.mean((pred - (1.0 if target_is_real else 0.0)) ** 2)
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return jnp.mean(jnp.maximum(pred, 0) - pred * target + jnp.log1p(jnp.exp(-jnp.abs(pred))))
    return -jnp.mean(pred) if target_is_real else jnp.mean(pred)


def _adv_loss_keeping_f64(logits, target):
    logits = _f32_keeping_f64(logits)
    return jnp.mean(jnp.maximum(logits, 0) - logits * float(target)
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


@contextlib.contextmanager
def float64():
    """jax's x64 mode, and vst's float32 rounding sites keeping float64."""
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vst.nn.norm, "instance_norm", _instance_norm_keeping_f64)
            mp.setattr(vst.models.stargan2, "instance_norm", _instance_norm_keeping_f64)
            mp.setattr(vst.models.cyclegan, "instance_norm", _instance_norm_keeping_f64)
            mp.setattr(vst.train.stargan2, "f32", _f32_keeping_f64)
            mp.setattr(vst.train.stargan2, "adv_loss", _adv_loss_keeping_f64)
            mp.setattr(vst.train.cyclegan, "f32", _f32_keeping_f64)
            mp.setattr(vst.train.cyclegan, "gan_loss", _gan_loss_keeping_f64)
            yield
    finally:
        jax.config.update("jax_enable_x64", saved)


# -- narrow stand-ins for StarGAN v2's D and E in the float64 tests ------------
# vst's float64 convolutions on a CPU run at about 1 GFLOP/s, and the real D
# and E spend 4.8 GFLOP a sample in their first block at any img_size
# (dim_in = 2¹⁴ / img_size): a float64 step took 76–130 s. The float64 tests
# keep the real G and F and put these in place of D and E on both sides.

class JTinyTrunk(flax.linen.Module):
    @flax.linen.compact
    def __call__(self, x):
        pad = ((1, 1), (1, 1))
        h = flax.linen.leaky_relu(flax.linen.Conv(8, (3, 3), padding=pad, name="conv1")(x), 0.2)
        h = vst_avg_pool2d(h, 2, 2)
        h = flax.linen.leaky_relu(flax.linen.Conv(8, (3, 3), padding=pad, name="conv2")(h), 0.2)
        return jnp.mean(h, axis=(1, 2))


class JTinyHead(flax.linen.Module):
    """D (``width`` 1: one logit a domain) or E (``width`` = style_dim)."""
    num_domains: int
    width: int

    @flax.linen.compact
    def __call__(self, x, y):
        h = flax.linen.Dense(self.num_domains * self.width, name="head")(
            JTinyTrunk(name="trunk")(x))
        out = h.reshape(h.shape[0], self.num_domains, self.width)
        out = jnp.take_along_axis(out, y[:, None, None].astype(jnp.int32), axis=1,
                                  mode="clip")[:, 0]
        return out[:, 0] if self.width == 1 else out


class TinyHead(torch.nn.Module):
    def __init__(self, num_domains, width):
        super().__init__()
        self.num_domains, self.width = num_domains, width
        self.conv1 = torch.nn.Conv2d(3, 8, 3, 1, 1)
        self.conv2 = torch.nn.Conv2d(8, 8, 3, 1, 1)
        self.head = torch.nn.Linear(8, num_domains * width)

    def forward(self, x, y):
        lrelu = torch.nn.functional.leaky_relu
        h = lrelu(self.conv2(torch.nn.functional.avg_pool2d(lrelu(self.conv1(x), 0.2), 2)), 0.2)
        out = self.head(h.mean((2, 3))).reshape(x.shape[0], self.num_domains, self.width)
        out = out[torch.arange(x.shape[0]), y.long().clamp(0, self.num_domains - 1)]
        return out[:, 0] if self.width == 1 else out

    def vst_params(self):
        def conv(c):
            return {"kernel": c.weight.detach().numpy().transpose(2, 3, 1, 0),
                    "bias": c.bias.detach().numpy()}
        return {"trunk": {"conv1": conv(self.conv1), "conv2": conv(self.conv2)},
                "head": {"kernel": self.head.weight.detach().numpy().T,
                         "bias": self.head.bias.detach().numpy()}}


# -- the CycleGAN family -----------------------------------------------------------

CG = dict(ngf=8, ndf=8, pool_size=4, steps_per_epoch=10)
CG_BLOCKS = 2


def jstub_raft(i1, i2):
    """vst's stand-in flow (``tests/test_cyclegan.py:160-163``): the channel
    mean of i1 − i2, and its negation. The port's is
    ``vst_torch.train.parity.stub_flow``."""
    d = jnp.mean(i1 - i2, axis=-1, keepdims=True)
    return None, jnp.concatenate([d, -d], axis=-1)


def random_params(module, inputs, seed, std=0.05):
    """Seeded params for a vst net: N(0, std) leaves in its param tree,
    biases N(0, std / 10) (larger ones put an instance norm's mean at tens of
    its deviation, where the one-pass variance keeps 4–5 digits in float32),
    norms' scales 1 + N(0, std) and statistics' variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    tmpl = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "running_var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + std * rng.randn(*s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * std * rng.randn(*s.shape)).astype(np.float32)
        return (std * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tmpl)


def cyclegan_state_dict(name, params, netG="resnet_2blocks", netD="basic"):
    """vst params of net ``name`` (G_A, D_B, M_A, F_B, …) as the port's
    state_dict."""
    params = jax.tree_util.tree_map(np.asarray, params)
    if name[0] in "GM":
        return convert.cyclegan_generator_state_dict_from_jax(params, netG)
    if name[0] == "D":
        return convert.cyclegan_discriminator_state_dict_from_jax(params, netD)
    return convert.fusion_block_state_dict_from_jax(params)


def recording(tx):
    """``tx`` whose state also holds the last gradient: vst's real step and
    its gradient from one run."""

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(
        lambda params: (tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)), update)


def cyclegan_pair(variant, seed=0, raft_apply=jstub_raft, raft=None, dtype=jnp.float32,
                  hw=(S, S), **kw):
    """(vst trainer, its state, the port trainer on the same weights) at
    ``CG``: vst's generators swapped for 2-block ones as its own tests do;
    vst's optimizers record their gradients; the state in ``dtype``, pools
    included. ``raft`` is the port's RAFT (the stub flow by default)."""
    temporal = variant in ("mogan", "congan")
    kw = {**CG, **kw}
    jt = JCycleGANTrainer(JCycleGANConfig(variant=variant, **kw), image_hw=hw,
                  raft_apply=raft_apply if temporal else None)
    jt.G_A = ResnetGenerator(3, CG["ngf"], CG_BLOCKS)
    jt.G_B = ResnetGenerator(3, CG["ngf"], CG_BLOCKS)
    if variant == "mogan":
        jt.M_A = ResnetGenerator(2, CG["ngf"], CG_BLOCKS)
        jt.M_B = ResnetGenerator(2, CG["ngf"], CG_BLOCKS)
    jt.tx_g, jt.tx_d, jt.tx_m = recording(jt.tx_g), recording(jt.tx_d), recording(jt.tx_m)
    img = np.zeros((1,) + tuple(hw) + (3,), np.float32)
    names = ["G_A", "G_B", "D_A", "D_B"] + {"mogan": ["M_A", "M_B"], "congan": ["F_A", "F_B"]}.get(
        variant, [])
    params = {}
    for i, name in enumerate(names):
        inputs = (img[..., :2],) if name[0] == "M" else (img, img) if name[0] == "F" else (img,)
        params[name] = random_params(getattr(jt, name), inputs, seed * 10 + i)
    port = CycleGANTrainer(CycleGANConfig(variant=variant, netG=f"resnet_{CG_BLOCKS}blocks", **kw),
                           raft=(raft or stub_flow) if temporal else None, seed=seed,
                           device="cpu")
    for name in names:
        port.nets[name].load_state_dict(cyclegan_state_dict(name, params[name]))
    params = tree(params, dtype)
    subset = {g: {k: v for k, v in params.items() if k[0] in g} for g in ("GF", "D", "M")}
    state = CycleGANState(
        step=jnp.zeros((), jnp.int32), params=params, opt_g=jt.tx_g.init(subset["GF"]),
        opt_d=jt.tx_d.init(subset["D"]), opt_m=jt.tx_m.init(subset["M"]) if subset["M"] else (),
        pool_a=image_pool_init(jt.cfg.pool_size, tuple(hw) + (3,), dtype),
        pool_b=image_pool_init(jt.cfg.pool_size, tuple(hw) + (3,), dtype))
    return jt, state, port


def vst_query_draws(key, n, pool_size):
    """The draws of vst's ``image_pool_query`` for ``key``
    (``vst/models/cyclegan.py:319-345``): per image, u = uniform(k1) and a
    slot randint(k2, 0, pool_size), (k1, k2) the split of the image's key."""
    u, idx = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        u.append(float(jax.random.uniform(k1)))
        idx.append(int(jax.random.randint(k2, (), 0, pool_size)))
    return torch.tensor(u), torch.tensor(idx)


def vst_pool_draws(rng, n, pool_size):
    """The draws vst's E step makes from ``rng`` (``vst/train/cyclegan.py:
    352-360``): pool A's from the first key of its split, pool B's from the
    second; as the port's ``e_step`` takes them."""
    return tuple(vst_query_draws(key, n, pool_size) for key in jax.random.split(rng))


def cyclegan_batch_np(seed, hw=(S, S), batch_size=2, dtype=np.float32):
    """A CycleGAN batch, NHWC numpy: side A a synthetic FC2 pair with its
    mask and flow, side B another batch's source pair (``fc2_to_cyclegan``).
    (vst's CLI takes real_B2 = real_B, so MoGAN's
    M_B then sees a flow of 0, where the instance norms of a constant map
    give rounding noise: no input for a comparison.)"""
    b = fc2_to_cyclegan(*(fc2_batch(hw, batch_size, 2, seed + k) for k in (0, 100)))
    return {k: np.asarray(v, dtype) for k, v in b.items()}


def vst_params_from_port(module, inputs, state_dict, to_port):
    """The inverse of a vst → port converter ``to_port`` for ``module``: the
    converter is run on a tree whose leaf i is filled with i, which says
    which vst leaf each port key came from; conv kernels go back (O, I, kh,
    kw) → (kh, kw, I, O)."""
    tmpl = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(tmpl)
    tagged = to_port(treedef.unflatten([np.full(s.shape, i, np.float32)
                                        for i, s in enumerate(leaves)]))
    out = [None] * len(leaves)
    for key, tag in tagged.items():
        i = int(tag.flatten()[0])
        a = state_dict[key].detach().cpu().numpy()
        out[i] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        assert out[i].shape == leaves[i].shape, key
    assert all(a is not None for a in out)
    return treedef.unflatten(out)
