"""One whole StarGAN v2 AdvCon iteration against vst's, float64, on the CPU,
in ``tests/test_torch_stargan2_float64.py``'s set-up (the real G and F,
narrow stand-ins for D and E): ``train_iteration`` from the same weights,
batch and latents (the four steps with their AdamW updates, the EMA and the
λ_ds decay). Every loss within 1e-10 relative, and every parameter, live and
EMA, within ``PARAM_ATOL`` = 1e-8 (1e-4 of the learning rate) of vst's: in
float64 no sign that rounding decides enters the first AdamW update
(≈ lr·sign(g), β1 = 0), but an element whose gradient is near AdamW's eps
(1e-8) moves 1e4× as fast as its gradient (measured: 7.7e-10, a bias).
"""

import numpy as np
import torch
import jax

from torch_gan_parity import float64, torch_threads  # noqa: F401
from torch_gan_parity import fc2_batch, latents, vst_state
from test_torch_stargan2_float64 import S, assert_losses, batches, pair, to_port

PARAM_ATOL = 1e-8


def test_one_advcon_iteration():
    b = fc2_batch((S, S), 2, 3, seed=7)
    key = jax.random.PRNGKey(8)
    with float64():  # vst's latents are float64 draws in x64 mode
        z, z2 = latents(key, 2)
        port, jt, params = pair(100.0, seed=9)
        jb, tb = batches(b, z)
        state, want_m = jt.train_iteration(vst_state(jt, params), jb, key)
    got_m = port.train_iteration(tb, *(torch.from_numpy(np.array(a, np.float64)) for a in (z, z2)))
    assert_losses(got_m, want_m)
    assert port.step == int(state.step) == 1
    assert float(port.lambda_ds) == float(state.lambda_ds)
    for nets, tree_ in ((port.nets, state.params), (port.ema, state.ema)):
        for k, net in nets.items():
            want = to_port(k, tree_[k])
            for n, p in net.state_dict().items():
                err = float((p - want[n]).abs().max())
                assert err <= PARAM_ATOL, (k, n, err)
