"""StarGAN v1 and v2 nets of the port against vst's, float32, on the CPU.

Weights go from the port's modules to vst's trees through vst's own
``*_params_from_torch`` (v2) or the port's ``stargan_*_state_dict_from_jax``
(v1, which vst has no torch bridge for); inputs are numpy-seeded. Every
output is held within ``RTOL`` = 1e-5 of vst's, relative to the largest
magnitude of vst's output. The blocks run at narrow widths; the four v2
nets at 32², where the first blocks are still 512 wide
(``dim_in = 2¹⁴ / img_size``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vst.models.stargan as jsg1
import vst.models.stargan2 as jsg2
from vst.nn.norm import AdaIN as JAdaIN
from vst_torch import convert
from vst_torch.models import stargan as sg1
from vst_torch.models import stargan2 as sg2
from vst_torch.nn.norm import AdaIN

RTOL = 1e-5
S = 32  # v2 img_size of the net tests
CFG2 = dict(style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def images(seed, n=2, hw=(S, S), c=3):
    return np.random.RandomState(seed).uniform(-1, 1, (n, *hw, c)).astype(np.float32)


def block_tree(block, put):
    """A port block's weights as vst's scope, through vst's own helper
    (``_resblk_put`` / ``_adainblk_put``)."""
    out = {}
    for k, v in block.state_dict().items():
        put(out, "blk", k.split("."), v)
    return out["blk"]


@pytest.mark.parametrize("dims,normalize,downsample", [
    ((8, 8), False, False), ((8, 16), True, True), ((16, 8), False, True), ((8, 12), True, False)])
def test_resblk(dims, normalize, downsample):
    torch.manual_seed(0)
    blk = sg2.ResBlk(*dims, normalize=normalize, downsample=downsample)
    with torch.no_grad():  # non-trivial affine norms
        for p in blk.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = images(1, hw=(12, 10), c=dims[0])
    want = jsg2.ResBlk(dims[1], normalize=normalize, downsample=downsample).apply(
        {"params": block_tree(blk, jsg2._resblk_put)}, jnp.asarray(x))
    assert rel(nhwc(blk(nchw(x))), want) <= RTOL


@pytest.mark.parametrize("dims,upsample", [((8, 8), False), ((16, 8), True), ((8, 12), True)])
def test_adain_resblk(dims, upsample):
    torch.manual_seed(1)
    blk = sg2.AdainResBlk(*dims, style_dim=6, upsample=upsample)
    sg2.he_init_(blk)
    x, s = images(2, hw=(6, 10), c=dims[0]), np.random.RandomState(3).randn(2, 6).astype(np.float32)
    want = jsg2.AdainResBlk(dims[1], upsample=upsample).apply(
        {"params": block_tree(blk, jsg2._adainblk_put)}, jnp.asarray(x), jnp.asarray(s))
    assert rel(nhwc(blk(nchw(x), torch.from_numpy(s))), want) <= RTOL


def test_adain_is_vsts_norm_module():
    """``vst_torch.nn.norm.AdaIN`` against ``vst.nn.norm.AdaIN``, and its
    init: torch's default weight bound √(1/fan_in), a zero bias (flax's)."""
    torch.manual_seed(2)
    m = AdaIN(5, 8)
    assert float(m.fc.weight.detach().abs().max()) <= (1 / 5) ** 0.5 and not m.fc.bias.any()
    with torch.no_grad():
        m.fc.bias.normal_()
    x, s = images(4, hw=(5, 7), c=8), np.random.RandomState(5).randn(2, 5).astype(np.float32)
    tree = {"Dense_0": {"kernel": m.fc.weight.detach().numpy().T, "bias": m.fc.bias.detach().numpy()}}
    want = JAdaIN(8).apply({"params": tree}, jnp.asarray(x), jnp.asarray(s))
    assert rel(nhwc(m(nchw(x), torch.from_numpy(s))), want) <= RTOL


def test_high_pass():
    x = images(6, hw=(9, 11), c=4)
    assert rel(nhwc(sg2.high_pass(nchw(x), 1.0)), jsg2.high_pass(jnp.asarray(x), 1.0)) <= RTOL


@pytest.fixture(scope="module")
def v2_nets():
    torch.manual_seed(3)
    return {"generator": sg2.Generator(S, CFG2["style_dim"], CFG2["max_conv_dim"]),
            "mapping": sg2.MappingNetwork(CFG2["latent_dim"], CFG2["style_dim"],
                                          CFG2["num_domains"]),
            "style_enc": sg2.StyleEncoder(S, CFG2["style_dim"], CFG2["num_domains"],
                                          CFG2["max_conv_dim"]),
            "disc": sg2.Discriminator(S, CFG2["num_domains"], CFG2["max_conv_dim"])}


V2_BRIDGE = {
    "generator": (lambda sd: jsg2.generator_params_from_torch(sd, S),
                  convert.stargan2_generator_state_dict_from_jax),
    "mapping": (jsg2.mapping_params_from_torch, convert.stargan2_mapping_state_dict_from_jax),
    "style_enc": (lambda sd: jsg2.style_encoder_params_from_torch(sd, S),
                  convert.stargan2_style_encoder_state_dict_from_jax),
    "disc": (lambda sd: jsg2.discriminator_params_from_torch(sd, S),
             convert.stargan2_discriminator_state_dict_from_jax),
}


@pytest.mark.parametrize("name", list(V2_BRIDGE))
def test_v2_round_trip(v2_nets, name):
    """port → vst's converter → ``convert`` → equal tensors, every key."""
    to_vst, back = V2_BRIDGE[name]
    sd = v2_nets[name].state_dict()
    got = back(jax.tree_util.tree_map(np.asarray, to_vst(sd)))
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_v2_nets(v2_nets):
    """Each v2 net at 32² on vst's weights, ids out of range clipped."""
    x = images(7)
    y = np.asarray([1, 5], np.int32)  # 5 is past num_domains: clipped to 2 on both sides
    z = np.random.RandomState(8).randn(2, CFG2["latent_dim"]).astype(np.float32)
    s = np.random.RandomState(9).randn(2, CFG2["style_dim"]).astype(np.float32)
    jnets = {"generator": jsg2.Generator(S, CFG2["style_dim"], CFG2["max_conv_dim"]),
             "mapping": jsg2.MappingNetwork(CFG2["latent_dim"], CFG2["style_dim"],
                                            CFG2["num_domains"]),
             "style_enc": jsg2.StyleEncoder(S, CFG2["style_dim"], CFG2["num_domains"],
                                            CFG2["max_conv_dim"]),
             "disc": jsg2.Discriminator(S, CFG2["num_domains"], CFG2["max_conv_dim"])}
    args = {"generator": ((x, s), (nchw(x), torch.from_numpy(s))),
            "mapping": ((z, y), (torch.from_numpy(z), torch.from_numpy(y))),
            "style_enc": ((x, y), (nchw(x), torch.from_numpy(y))),
            "disc": ((x, y), (nchw(x), torch.from_numpy(y)))}
    for name, net in v2_nets.items():
        params = V2_BRIDGE[name][0](net.state_dict())
        jargs, targs = args[name]
        want = jax.jit(jnets[name].apply)({"params": params}, *map(jnp.asarray, jargs))
        with torch.no_grad():
            got = net(*targs)
        got = nhwc(got) if got.ndim == 4 else got.numpy()
        assert rel(got, want) <= RTOL, name


def test_v2_generator_refuses_the_high_pass():
    with pytest.raises(NotImplementedError, match="wing"):
        sg2.Generator(S, w_hpf=1)
    g = sg2.Generator(S, CFG2["style_dim"], CFG2["max_conv_dim"])
    with pytest.raises(NotImplementedError, match="wing"):
        g(torch.zeros(1, 3, S, S), torch.zeros(1, CFG2["style_dim"]), masks=[None, None])


def test_he_init():
    """kaiming normal, fan-in, zero biases, on every conv and linear."""
    torch.manual_seed(4)
    d = sg2.Discriminator(64, 2, 64)
    w = d.main[2].conv1.weight.detach()
    assert abs(float(w.std()) - (2 / (w[0].numel())) ** 0.5) < 0.05 * (2 / w[0].numel()) ** 0.5
    assert all(not m.bias.any() for m in d.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None)


@pytest.mark.parametrize("hw", [(20, 28), (36, 44)])
def test_v1_generator(hw):
    """v1's G with the transposed convs at sizes ≡ 4 mod 8 (odd after the
    two stride-2 convs: 5×7 and 9×11), through the port's v1 bridge."""
    jg = jsg1.Generator(conv_dim=4, c_dim=3, repeat_num=2)
    x = images(10, hw=hw)
    c = np.eye(3, dtype=np.float32)[[0, 2]]
    params = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                                        jnp.asarray(c))["params"])
    params = jax.tree_util.tree_map(  # non-trivial norms and ConvT biases
        lambda a: a + np.random.RandomState(a.size).randn(*a.shape).astype(np.float32) * 0.1,
        params)
    g = sg1.Generator(conv_dim=4, c_dim=3, repeat_num=2)
    g.load_state_dict(convert.stargan_generator_state_dict_from_jax(params))
    with torch.no_grad():
        got = nhwc(g(nchw(x), torch.from_numpy(c)))
    assert rel(got, jg.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))) <= RTOL


def test_v1_discriminator():
    jd = jsg1.Discriminator(image_size=32, conv_dim=4, c_dim=3, repeat_num=3)
    x = images(11)
    params = jax.tree_util.tree_map(
        np.asarray, jd.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    d = sg1.Discriminator(image_size=32, conv_dim=4, c_dim=3, repeat_num=3)
    d.load_state_dict(convert.stargan_discriminator_state_dict_from_jax(params))
    want_src, want_cls = jd.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        src, cls = d(nchw(x))
    assert rel(nhwc(src), want_src) <= RTOL and rel(cls.numpy(), want_cls) <= RTOL


def test_v1_init_is_vsts():
    """ConvT N(0, 0.02) with zero bias; convs torch's default bound."""
    torch.manual_seed(5)
    g = sg1.Generator(conv_dim=16, c_dim=4, repeat_num=1)
    convt = [m for m in g.modules() if isinstance(m, sg1.ConvT)]
    assert len(convt) == 2 and all(not m.bias.any() for m in convt)
    assert abs(float(convt[0].weight.detach().std()) - 0.02) < 0.002
    w = g.main[0].weight.detach()
    assert float(w.abs().max()) <= (1 / w[0].numel()) ** 0.5
