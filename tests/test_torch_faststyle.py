"""vst_torch FastStyleNet against vst's, weights carried both ways:
port state_dict → ``faststyle_params_from_torch`` → flax, and flax init →
``faststyle_state_dict_from_jax`` → port. Tolerance 1e-3 absolute on the
~[0, 255]-scale output (measured on a CPU: ≤ 1.6e-5)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vst.models.faststyle import FastStyleNet as JFastStyleNet
from vst.models.faststyle import faststyle_params_from_torch
from vst_torch.convert import faststyle_state_dict_from_jax
from vst_torch.models.faststyle import FastStyleNet

ATOL = 1e-3


def _frame(seed, hw=(32, 48)):
    return np.random.RandomState(seed).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)


def _seeded(n_styles, seed):
    torch.manual_seed(seed)
    net = FastStyleNet(n_styles=n_styles).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # move norms and gates off their identity init
        for name, p in net.named_parameters():
            if p.dim() == 1 or "embed" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    return net


def _run_port(net, x, strength, style):
    with torch.no_grad():
        feats, out = net(torch.from_numpy(x).permute(0, 3, 1, 2), strength, style)
    return feats.permute(0, 2, 3, 1).numpy(), out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n_styles,style,strength", [(1, 0, 1.0), (3, 0, 1.0), (3, 2, 0.6)])
def test_port_to_flax(n_styles, style, strength):
    net = _seeded(n_styles, 10 + n_styles)
    x = _frame(n_styles)
    params = faststyle_params_from_torch(net.state_dict())
    feats_j, out_j = JFastStyleNet(n_styles=n_styles).apply(
        {"params": params}, jnp.asarray(x), strength, style)
    feats_t, out_t = _run_port(net, x, strength, style)
    assert out_t.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(feats_t, np.asarray(feats_j), atol=ATOL)


@pytest.mark.parametrize("n_styles", [1, 3])
def test_flax_to_port(n_styles):
    x = _frame(5)
    jnet = JFastStyleNet(n_styles=n_styles)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(n_styles), jnp.asarray(x))["params"])
    net = FastStyleNet(n_styles=n_styles).eval()
    net.load_state_dict(faststyle_state_dict_from_jax(params), strict=True)
    _, out_j = jnet.apply({"params": params}, jnp.asarray(x), 1.0, n_styles - 1)
    _, out_t = _run_port(net, x, 1.0, n_styles - 1)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=ATOL)


@pytest.mark.parametrize("n_styles", [1, 3])
def test_state_dict_round_trip_is_exact(n_styles):
    sd = _seeded(n_styles, 20).state_dict()
    back = faststyle_state_dict_from_jax(faststyle_params_from_torch(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
