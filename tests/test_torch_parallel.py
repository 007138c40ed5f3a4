"""vst_torch.parallel and the trainers' data-parallel steps against world
size 1 and against vst.

Each trainer (Johnson with vst's TV weight 1e-4, StarGAN v1's D and G steps,
StarGAN v2's latent D and G steps, the cyclegan, MoGAN and ConGAN E steps
with the stub flow) takes one step on a global batch of 2 at 32², once whole in this process (world size 1, no mesh) and
once sharded over 2 spawned gloo ranks (``tests/torch_dp_cases.py``). vst's
sharded step is its single-device step on the global batch
(``tests/test_train_faststyle.py:71``, ``tests/test_gan_multichip.py``), and
so must the port's be. Tolerances:

* float64: the reduced gradients within 1e-10 of the largest |g| (the ranks
  sum the same terms in another order);
* float32: the losses within vst's rtol 2e-4; the parameters within vst's
  Adam flip budget (≤ 0.2 % of the elements outside rtol 5e-3, atol 2e-4,
  each within 2·lr);
* the ranks' parameters equal bit for bit (one reduced step from rank 0's
  nets).

Johnson at world size 2 is also held to vst's sharded step on the 8-device
mesh at vst's tolerances (loss rtol 1e-4, the flip budget), on the same
weights, both in float64; ``shard_batch`` and ``replicate`` to vst's on that mesh. A world-size-1
gloo group's step equals the plain step bit for bit.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_dp_cases as dp
import vst.nn.norm
from torch_train_parity import _instance_norm_keeping_f64
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.data.synthetic import synthetic_batch as jsynthetic_batch
from vst.models.faststyle import faststyle_params_from_torch
from vst.parallel.mesh import create_mesh as jcreate_mesh
from vst.parallel.mesh import replicate as jreplicate
from vst.parallel.mesh import shard_batch as jshard_batch
from vst.perceptual.vgg import vgg16_params_from_torch
from vst.train.faststyle import FastStyleConfig as JConfig
from vst.train.faststyle import FastStyleTrainer as JTrainer
from vst.train.faststyle import TrainState
from vst_torch.convert import faststyle_state_dict_from_jax
from vst_torch.data.loader import prefetch_to_mesh
from vst_torch.data.styles import load_style_images
from vst_torch.parallel import (create_mesh, initialize_distributed, shard_batch,
                                share_of_global)
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.parity import STARGAN2_SMALL, STARGAN_SMALL
from vst_torch.train.registry import FASTSTYLE_METHODS, select_method
from vst_torch.train.stargan import StarGANConfig, StarGANTrainer
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer

GRAD_TOL = 1e-10  # of max |g|, float64
LOSS_RTOL = 2e-4  # vst's, float32
VST_LOSS_RTOL = 1e-4  # tests/test_train_faststyle.py:89
DRYRUN_TIMEOUT_S = 300


def vst_johnson_step_f64():
    """vst's Johnson step on its 8-device mesh, one global batch of 8 at 32²
    (seed 2), from the port's seeded net and VGG (the trainer's, seed 0), in
    float64 (jax x64, vst's instance norm keeping float64 statistics): (its
    loss, its parameters after the step as the port's state_dict)."""
    port = FastStyleTrainer(select_method("johnson", batch_size=dp.VST_BATCH),
                            load_style_images(size=64)[:1], seed=0, device="cpu")
    jt = JTrainer(JConfig(method="johnson", emphasis=FASTSTYLE_METHODS["johnson"],
                          batch_size=dp.VST_BATCH),
                  load_style_images(size=64)[:1],
                  vgg_params=vgg16_params_from_torch(port.vgg.state_dict()), seed=0)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vst.nn.norm, "instance_norm", _instance_norm_keeping_f64)
            mp.setattr(jt, "vgg_params", f64(jt.vgg_params))
            mp.setattr(jt, "style_grams", f64(jt.style_grams))
            params = f64(faststyle_params_from_torch(port.model.state_dict()))
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=jt.tx.init(params))
            batch = f64(jsynthetic_batch(dp.VST_BATCH, hw=dp.HW, n_frames=2, seed=2))
            mesh = jcreate_mesh()
            state, metrics = jt.train_step()(jreplicate(state, mesh), jshard_batch(batch, mesh),
                                             0, jax.random.PRNGKey(1))
            return float(metrics["loss"]), faststyle_state_dict_from_jax(
                jax.device_get(state.params))
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(scope="module")
def dryrun():
    """``python -m vst_torch.parallel.dryrun 2``, started before the other
    runs of this module and read by its test."""
    proc = subprocess.Popen([sys.executable, "-m", "vst_torch.parallel.dryrun", "2"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dryrun):
    """(world size 1's cases, vst's float64 step, each rank's results): the
    first two computed here while the 2 ranks run."""
    ranks, (single, vst_step) = dp.spawn(
        dp.parallel_ranks, 2, tmp_path_factory.mktemp("dp"),
        meanwhile=lambda: (dp.trainer_cases(None), vst_johnson_step_f64()))
    return single, vst_step, ranks


@pytest.mark.parametrize("case", dp.CASES)
def test_ranks_end_equal(runs, case):
    _, _, ranks = runs
    for key in ("metrics", "params"):
        a, b = ranks[0][case]["f32"][key], ranks[1][case]["f32"][key]
        assert set(a) == set(b)
        for k in a:
            if key == "metrics":
                assert a[k] == b[k], k
            else:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", dp.CASES)
def test_reduced_gradients_float64(runs, case):
    single, _, ranks = runs
    want, got = single[case]["f64"]["grads"], ranks[0][case]["f64"]["grads"]
    assert set(got) == set(want) and want
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[k] - w).abs().max()) for k, w in want.items())
    assert worst <= GRAD_TOL * scale, (worst, scale)


@pytest.mark.parametrize("case", dp.CASES)
def test_losses_float32(runs, case):
    single, _, ranks = runs
    want, got = single[case]["f32"]["metrics"], ranks[0][case]["f32"]["metrics"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("case", dp.CASES)
def test_parameters_float32(runs, case):
    single, _, ranks = runs
    dp.params_within_flip_budget(ranks[0][case]["f32"]["params"],
                                 single[case]["f32"]["params"], dp.LR[case])


def test_johnson_matches_vsts_sharded_step(runs):
    """vst's Johnson step on its 8-device mesh against the port's on 2 gloo
    ranks, one global batch of 8 at 32², on the same weights, both in
    float64, where a parameter's update turns on its gradient's sign and
    float32 rounding of two implementations would flip the ~0 gradients'
    signs (``tests/torch_train_parity.py``)."""
    _, (loss, want), ranks = runs
    got = ranks[0]["johnson_vst"]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=VST_LOSS_RTOL)
    dp.params_within_flip_budget(got["params"], {f"model.{k}": v for k, v in want.items()},
                                 dp.LR["johnson"])


def test_random_draws_are_the_global_batchs(monkeypatch):
    """StarGAN v2's latents and StarGAN v1's α: each rank's rows of one
    draw for the global batch from the trainer's seeded generator, whatever
    the rank (vst's keys do not depend on the sharding)."""
    b = {"x_real": torch.zeros(2, 3, 32, 32), "y_org": torch.zeros(2, dtype=torch.long),
         "y_trg": torch.zeros(2, dtype=torch.long), "x_ref": torch.zeros(2, 3, 32, 32)}
    want = torch.randn(8, STARGAN2_SMALL["latent_dim"], generator=torch.Generator().manual_seed(0))
    for rank in range(4):
        trainer = StarGAN2Trainer(StarGAN2Config(**STARGAN2_SMALL), seed=0,
                                  mesh=dp.cpu_mesh(4, rank))
        seen = {}

        def d_step(kind, x_real, y_org, y_trg, z, x_ref):
            seen["z"] = z
            raise StopIteration

        monkeypatch.setattr(trainer, "d_step", d_step)
        with pytest.raises(StopIteration):
            trainer.train_iteration(b)
        assert torch.equal(seen["z"], want[2 * rank:2 * rank + 2])
    alpha = torch.rand(8, 1, 1, 1, generator=torch.Generator().manual_seed(0))
    for rank in range(4):
        trainer = StarGANTrainer(StarGANConfig(**STARGAN_SMALL), seed=0,
                                 mesh=dp.cpu_mesh(4, rank))
        monkeypatch.setattr(trainer, "gradient_penalty", lambda x_hat: x_hat)
        x, c = torch.ones(2, 3, 32, 32), torch.zeros(2, STARGAN_SMALL["c_dim"])
        with torch.no_grad():
            x_fake = trainer.G(x, c)
        _, metrics = trainer.d_loss(x, c, c)
        got = (metrics["D/loss_gp"] - x_fake) / (x - x_fake)
        torch.testing.assert_close(got[:, :1, :1, :1], alpha[2 * rank:2 * rank + 2])


def test_shard_batch_is_vsts_sharding():
    """Each rank's rows of a batch are the shard vst's ``shard_batch`` puts
    on the device of that index of the 8-device mesh."""
    batch = {k: v for k, v in jsynthetic_batch(16, hw=(8, 8), n_frames=2, seed=3).items()}
    jmesh = jcreate_mesh()
    sharded = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jmesh)
    for k, arr in sharded.items():
        shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        for r, device in enumerate(jmesh.devices.reshape(-1)):
            mine = shard_batch(batch, dp.cpu_mesh(8, r))[k]
            assert mine.device.type == "cpu"
            np.testing.assert_array_equal(mine.numpy(), shards[device.id])
    with pytest.raises(ValueError):
        shard_batch({"x": np.zeros((6, 2))}, dp.cpu_mesh(4, 0))


def test_replicate_is_rank_zeros_state_everywhere(runs):
    """Every rank holds rank 0's net and Adam state after ``replicate``, as
    vst's ``replicate`` puts one tree on every device of the mesh."""
    _, _, ranks = runs
    want = dp.state_of(*dp.rank_state(0))
    other = dp.state_of(*dp.rank_state(1))
    assert any(not torch.equal(want[k], other[k]) for k in want)
    on_mesh = jreplicate({k: v.numpy() for k, v in want.items()}, jcreate_mesh())
    for r in range(2):
        got = ranks[r]["replicated"]
        for k, w in want.items():
            assert torch.equal(got[k], w), (r, k)
            for s in on_mesh[k].addressable_shards:
                np.testing.assert_array_equal(np.asarray(s.data), got[k].numpy())


def test_world_size_one_group_is_the_plain_step(tmp_path):
    """With a gloo group of one rank the reductions run and change nothing:
    3 Johnson steps equal the plain trainer's bit for bit."""
    def three_steps(mesh):
        trainer = FastStyleTrainer(select_method("johnson", batch_size=2),
                                   load_style_images(size=64)[:1], seed=0, device="cpu",
                                   mesh=mesh)
        losses = [trainer.train_step(batch)["loss"] for batch in batches]
        return losses, trainer.model.state_dict()

    batches = [batch_to_tensors(jsynthetic_batch(2, hw=dp.HW, n_frames=2, seed=s), "cpu")
               for s in range(3)]
    plain = three_steps(None)
    assert initialize_distributed(f"file://{tmp_path}/pg", 1, 0, device="cpu",
                                  timeout=dp.GROUP_TIMEOUT) == 1
    try:
        mesh = create_mesh(devices=["cpu"])
        assert mesh.size == 1 and mesh.group is not None
        grouped = three_steps(mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert [float(v) for v in grouped[0]] == [float(v) for v in plain[0]]
    for k, v in plain[1].items():
        assert torch.equal(grouped[1][k], v), k


def test_share_of_global_terms():
    """A mean term's share is its local value over the size, a sum term's
    its local value; the loss's share sums the weighted terms' shares."""
    mean, tv = torch.tensor(3.0), torch.tensor(2.0)
    loss = mean + tv
    share, terms = share_of_global(loss, {"loss": loss, "content": mean, "tv": tv},
                                   dp.cpu_mesh(4, 1), sums=("tv",))
    assert float(share) == pytest.approx(3.0 / 4 + 2.0)
    assert terms["loss"] is share and terms["tv"] is tv and float(terms["content"]) == 0.75
    same, same_terms = share_of_global(loss, {"loss": loss}, None)
    assert same is loss and same_terms["loss"] is loss


def test_mesh_without_a_group():
    """One process and no group: ``initialize_distributed`` is a no-op that
    returns 1, the mesh has one rank and no group; the model axis is
    reserved; without CUDA the default device raises instead of falling
    back to the CPU."""
    assert initialize_distributed() == 1
    mesh = create_mesh(devices=["cpu"])
    assert (mesh.size, mesh.rank, mesh.device, mesh.group) == (1, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError):
        create_mesh(n_model=2, devices=["cpu"])
    with pytest.raises(ValueError):
        create_mesh(n_data=2, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_mesh()


def test_prefetch_to_mesh_yields_the_ranks_shards_in_order():
    batches = [{"imgs": np.full((4, 2, 3), i, np.float32), "ids": np.arange(4) + 10 * i}
               for i in range(5)]
    for rank in (0, 1):
        got = list(prefetch_to_mesh(iter(batches), dp.cpu_mesh(2, rank), depth=2))
        assert len(got) == len(batches)
        for i, b in enumerate(got):
            assert torch.equal(b["imgs"], torch.full((2, 2, 3), float(i)))
            assert b["ids"].tolist() == [10 * i + 2 * rank, 10 * i + 2 * rank + 1]


def test_prefetch_to_mesh_raises_the_producers_error_and_stops():
    def failing():
        yield {"x": np.zeros((2, 1))}
        raise OSError("unreadable batch")

    it = prefetch_to_mesh(failing(), dp.cpu_mesh(2, 0))
    assert next(it)["x"].shape == (1, 1)
    with pytest.raises(OSError, match="unreadable"):
        next(it)

    def endless():
        while True:
            yield {"x": np.zeros((2, 1))}

    before = threading.active_count()
    it = prefetch_to_mesh(endless(), dp.cpu_mesh(2, 1), depth=1)
    next(it)
    it.close()  # the consumer stops early: the producer ends
    assert threading.active_count() == before


def test_dryrun_two_ranks_exits_0(dryrun):
    """``python -m vst_torch.parallel.dryrun 2``: two gloo ranks run vst's
    three checks (a Johnson step, the sharded evaluation through the full
    RAFT, a StarGAN v2 AdvCon iteration) and print vst's line."""
    out, err = dryrun.communicate(timeout=DRYRUN_TIMEOUT_S)
    assert dryrun.returncode == 0, err[-2000:]
    assert out.startswith("dryrun_multichip(2): ok, loss=")
