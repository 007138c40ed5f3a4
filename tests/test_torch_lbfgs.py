"""vst_torch.ops.lbfgs against vst.ops.lbfgs and against the reference's
``torch.optim.LBFGS`` driver, in float64 (iterates within 1e-10 relative),
on the quartic and Gram-shaped objectives of ``tests/test_lbfgs.py``; the
closure-call counts, a tolerance break that freezes the iterate, and a level
run with every host sync of a tensor patched to raise."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vst.ops.lbfgs import lbfgs_minimize as vst_lbfgs
from vst.ops.lbfgs import torch_eval_counts as vst_counts
from vst_torch.ops.lbfgs import lbfgs_minimize, torch_eval_counts

RTOL = 1e-10
IMPLS = ("two_loop", "compact")


@pytest.fixture(autouse=True)
def x64():
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


def quartic(A, b, lib):
    A, b = lib.asarray(A), lib.asarray(b)

    def f(x):
        r = A @ x - b
        return (r ** 2).mean() + 0.01 * (x ** 4).sum()

    return f


def gram_objective(target, lib):
    W = target.shape[1]
    t = lib.asarray(target)
    gt = t @ t.T / W

    def f(x):
        return ((x @ x.T / W - gt) ** 2).mean() + 0.1 * ((x - t) ** 2).mean()

    return f


class _Torch:
    """``torch`` as the objectives' array library (numpy in, tensor out)."""

    @staticmethod
    def asarray(a):
        return torch.as_tensor(np.asarray(a))


def reference_driver(f, x0, max_iter):
    """The reference's driver: closure-call counter + default LBFGS."""
    x = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.LBFGS([x])
    n_iter = [0]

    def closure():
        opt.zero_grad()
        loss = f(x)
        loss.backward()
        n_iter[0] += 1
        return loss

    while n_iter[0] <= max_iter:
        opt.step(closure)
    return x.detach().numpy(), n_iter[0]


def problems():
    out = []
    for seed, n in ((0, 8), (1, 24)):
        rng = np.random.RandomState(seed)
        A = rng.randn(n, n) / np.sqrt(n)
        b = rng.randn(n)
        out.append((f"quartic{n}", (quartic, A, b), rng.randn(n)))
    rng = np.random.RandomState(3)
    out.append(("gram6", (gram_objective, rng.rand(6, 6)), rng.rand(6, 6)))
    return out


PROBLEMS = problems()


def _objective(spec, lib):
    make, *args = spec
    return make(*args, lib)


def assert_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"max |Δ| / max |want| = {err} > {rtol}"


def test_eval_counts_are_vsts():
    for caps in ((50, 40, 30), (1, 19, 20, 21), (0,)):
        assert torch_eval_counts(caps) == vst_counts(caps)
    assert torch_eval_counts((50, 40, 30)) == (60, 60, 40)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,spec,x0", PROBLEMS, ids=[p[0] for p in PROBLEMS])
@pytest.mark.parametrize("iters", [20, 40])
def test_iterates_match_vst(name, spec, x0, impl, iters):
    got, got_losses = lbfgs_minimize(_objective(spec, _Torch), torch.from_numpy(x0), iters,
                                     impl=impl)
    want, want_losses = vst_lbfgs(_objective(spec, jnp), jnp.asarray(x0), num_iters=iters,
                                  impl=impl)
    assert got.dtype == torch.float64 and got.shape == x0.shape
    assert_rel(got.numpy(), want)
    assert_rel(got_losses.numpy(), want_losses)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,spec,x0", PROBLEMS, ids=[p[0] for p in PROBLEMS])
@pytest.mark.parametrize("cap", [19, 30])
def test_iterates_match_torch_optim_lbfgs(name, spec, x0, impl, cap):
    """The reference's ``while n <= max_iter: step(closure)`` driver against
    the closure-call count's iterations: 19 → 20 calls, one full step; 30 →
    40, where in float64 the |Δloss| break ends torch's second step after 11
    calls and the frozen iterate must be torch's last."""
    f = _objective(spec, _Torch)
    want, n = reference_driver(f, x0, cap)
    (iters,) = torch_eval_counts([cap])
    assert n == iters if cap == 19 else cap < n < iters
    got, losses = lbfgs_minimize(f, torch.from_numpy(x0), iters, impl=impl)
    assert_rel(got.numpy(), want)
    assert losses[-1] < losses[0]


def test_first_step_is_scaled_by_gradient_l1():
    g0 = 50.0
    x, _ = lbfgs_minimize(lambda x: g0 * x.sum() + 0.5 * (x ** 2).sum(),
                          torch.zeros(4, dtype=torch.float64), num_iters=1)
    # d = −g, t = min(1, 1/(4·50)) = 1/200 → x = −50/200 each
    np.testing.assert_allclose(x.numpy(), -0.25 * np.ones(4), rtol=1e-15)


@pytest.mark.parametrize("impl", IMPLS)
def test_tolerance_break_freezes_the_iterate(impl):
    """A quadratic that L-BFGS solves in a few iterations: the break fires,
    the iterate stays where torch's early return leaves it (vst's and the
    reference driver's), and the losses after it repeat."""
    target = np.array([1.0, -2.0, 3.0])
    f_t = lambda x: ((x - torch.from_numpy(target)) ** 2).sum()  # noqa: E731
    f_j = lambda x: ((x - jnp.asarray(target)) ** 2).sum()  # noqa: E731
    x0 = np.zeros(3)
    got, losses = lbfgs_minimize(f_t, torch.from_numpy(x0), 20, impl=impl)
    want, want_losses = vst_lbfgs(f_j, jnp.asarray(x0), num_iters=20, impl=impl)
    ref, _ = reference_driver(f_t, x0, 1)
    np.testing.assert_allclose(got.numpy(), target, rtol=1e-12)
    assert_rel(got.numpy(), want)
    assert_rel(got.numpy(), ref)
    assert_rel(losses.numpy(), want_losses)
    assert (losses[-5:] == losses[-1]).all()


@contextlib.contextmanager
def no_host_sync():
    """Every way Python reads a tensor's value raises for the duration."""
    def refuse(*args, **kwargs):
        raise AssertionError("host sync inside an L-BFGS level")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "item", "__float__", "__int__", "__index__", "tolist",
                     "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("impl", IMPLS)
def test_a_level_never_reads_a_tensor_on_the_host(impl):
    name, spec, x0 = PROBLEMS[1]
    f = _objective(spec, _Torch)
    want, _ = lbfgs_minimize(f, torch.from_numpy(x0), 20, impl=impl)
    with no_host_sync():
        got, losses = lbfgs_minimize(f, torch.from_numpy(x0), 20, impl=impl)
    with pytest.raises(AssertionError, match="host sync"), no_host_sync():
        bool(got.sum() > 0)
    assert torch.equal(got, want) and losses.shape == (20,)


def test_history_shorter_than_the_run_is_refused():
    with pytest.raises(ValueError, match="eviction"):
        lbfgs_minimize(lambda x: (x ** 2).sum(), torch.zeros(2), 5, history_size=4)
