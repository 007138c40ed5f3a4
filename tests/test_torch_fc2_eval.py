"""The FC2 eval set and metric harness against vst's on the CPU: the
synthetic batches and the file reader give vst's batches bit for bit;
``calculate_metrics``, ``evaluate_fc2_obst`` (float64) and
``evaluate_fc2_ruder`` on synthetic batches at 32×32 write vst's JSON names
and keys with vst's values (TCL and FID within 1e-6 relative, LPIPS within
1e-5).

InceptionV3 is undefined below 75×75 (torch refuses the convs; vst's VALID
convs leave an empty map at Mixed_6a and its pool is NaN), so at 32×32 both
sides score FID on one stand-in feature map (4×4 block means of the pixels,
``PixelFeatures``) and the drivers' bookkeeping is what is compared; one
``calculate_metrics`` run at 75×75 scores it with the seeded He-randomized
Inception on both sides (vst's weights, ``tests/test_torch_metrics.py``)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vst.data.fc2 as jfc2
import vst.models.gatys as jg
from test_torch_metrics import vst_inception, vst_random_he_inception
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.data.datagen import to_grayscale3 as jgray
from vst.eval.drivers import evaluate_fc2_obst as jevaluate_fc2_obst
from vst.eval.drivers import evaluate_fc2_ruder as jevaluate_fc2_ruder
from vst.eval.fc2 import calculate_metrics as jcalculate_metrics
from vst.metrics.lpips import LPIPS as JLPIPS
from vst.models.faststyle import FastStyleNet as JFastStyleNet
from vst.models.faststyle import faststyle_params_from_torch
from vst_torch.data import fc2
from vst_torch.eval.drivers import evaluate_fc2_obst, evaluate_fc2_ruder
from vst_torch.eval.fc2 import calculate_metrics
from vst_torch.metrics.fid import InceptionV3
from vst_torch.metrics.lpips import LPIPS
from vst_torch.models import gatys
from vst_torch.train.registry import bootstrap_net, method_net

RTOL = 1e-6
LPIPS_RTOL = 1e-5
HW = (32, 32)


class PixelFeatures:
    """A stand-in for InceptionV3 at sizes it cannot take: 4×4 block means of
    the pixels, flattened channel first. ``nchw``: the port's layout."""

    backbone = "pixels"

    def __init__(self, nchw: bool):
        self.nchw = nchw

    def __call__(self, images):
        x = np.asarray(images.cpu() if torch.is_tensor(images) else images, np.float64)
        if self.nchw:
            x = x.transpose(0, 2, 3, 1)
        n, h, w, c = x.shape
        return x.reshape(n, h // 4, 4, w // 4, 4, c).mean((2, 4)).transpose(0, 3, 1, 2).reshape(
            n, -1)


def assert_tables(got, want, tmp_path, names):
    """Same metrics, keys, written files and values (TCL, FID within RTOL;
    LPIPS within LPIPS_RTOL; strings equal)."""
    assert set(got) == set(want)
    for metric in got:
        assert list(got[metric]) == list(want[metric]), metric
        for k, w in want[metric].items():
            g = got[metric][k]
            if isinstance(w, str):
                assert g == w, k
            else:
                tol = LPIPS_RTOL if metric == "LPIPS" else RTOL
                assert abs(g - w) <= tol * max(abs(w), 1e-12), (k, g, w)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert sorted(p.name for p in (tmp_path / "vst").iterdir()) == names
    for name in names:
        g = json.loads((tmp_path / "port" / name).read_text())
        w = json.loads((tmp_path / "vst" / name).read_text())
        assert set(g) == set(w), name


def test_synthetic_batches_are_vsts():
    got = fc2.synthetic_fc2_batches(2, 3, hw=HW, num_dom=4, seed=1)
    want = jfc2.synthetic_fc2_batches(2, 3, hw=HW, num_dom=4, seed=1)
    for g, w in zip(got, want):
        assert list(g) == list(fc2.BATCH_KEYS)
        for k in fc2.BATCH_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k
    img = np.random.RandomState(0).rand(2, 5, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(fc2.to_grayscale3(img), jgray(img))


def test_files_read_as_vsts(tmp_path):
    """A 2-domain corpus of 3 images in the reference's layout: the same
    entries, split and batches as vst's reader (imageio, through PIL)."""
    rng = np.random.RandomState(2)
    for d in ("style0", "style1"):
        for sub in ("styled-files", "styled-files3"):
            (tmp_path / sub / d).mkdir(parents=True)
    (tmp_path / "DATAFiles").mkdir()
    for i in range(3):
        stem = f"{i:07d}"
        for d in ("style0", "style1"):
            for sub, name in (("styled-files", stem + ".jpg"), ("styled-files3", stem + "_2.jpg")):
                Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(
                    tmp_path / sub / d / name, quality=90)
        np.save(tmp_path / "DATAFiles" / (stem + ".npy"),
                rng.rand(1, 16, 16, 9).astype(np.float32))
    args = [str(tmp_path / s) for s in ("DATAFiles", "styled-files", "styled-files3")]
    got, want = fc2.DatasetFC2(*args, base_len=3), jfc2.DatasetFC2(*args, base_len=3)
    assert got.dataset == want.dataset and len(got) == 12
    with pytest.raises(ValueError, match="expected 4"):
        fc2.DatasetFC2(*args, base_len=4)
    for split in (0.5, 0.97):
        for g, w in zip(fc2.train_eval_split(len(got), split), jfc2.train_eval_split(len(got), split)):
            np.testing.assert_array_equal(g, w)
    tl = fc2.FC2Loader(got, np.arange(12), 4, seed=3)
    jl = jfc2.FC2Loader(want, np.arange(12), 4, seed=3)
    assert len(tl) == len(jl) == 3
    for g, w in zip(tl.epoch(), jl.epoch()):
        for k in fc2.BATCH_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _style_fns():
    """(vst's, the port's) style_fn: the same deterministic function of (x,
    y, x_ref, round), so each round's fakes differ (LPIPS has a spread)
    without a random draw the two frameworks would have to share."""
    def rounds():
        calls = [0]

        def next_round():
            calls[0] += 1
            return (calls[0] - 1) // 2  # two calls a round: frame 1, frame 2

        return next_round

    jround, tround = rounds(), rounds()

    def vst_fn(x, y, mode, rng, x_ref):
        shift = (y[:, None, None, None].astype(x.dtype) - 1.0) * 0.1 + 0.05 * jround()
        return jnp.clip(x + shift + 0.1 * x_ref, -1, 1)

    def port_fn(x, y, mode, rng, x_ref):
        shift = (y.view(-1, 1, 1, 1).to(x.dtype) - 1.0) * 0.1 + 0.05 * tround()
        return (x + shift + 0.1 * x_ref).clamp(-1, 1)

    return vst_fn, port_fn


@pytest.fixture(scope="module")
def lpipses():
    return JLPIPS(seed=1), LPIPS(seed=1, device="cpu")


@pytest.mark.parametrize("mode,deterministic", [("latent", False), ("reference", True)])
def test_calculate_metrics_matches_vst(lpipses, tmp_path, mode, deterministic):
    batches = fc2.synthetic_fc2_batches(2, 3, hw=HW, num_dom=4, seed=1)
    jfn, tfn = _style_fns()
    kw = dict(num_domains=4, mode=mode, num_outs_per_domain=3, step=7,
              deterministic=deterministic)
    want = jcalculate_metrics(jfn, batches, out_dir=str(tmp_path / "vst"),
                              inception=PixelFeatures(False), lpips=lpipses[0], **kw)
    got = calculate_metrics(tfn, batches, out_dir=str(tmp_path / "port"),
                            inception=PixelFeatures(True), lpips=lpipses[1], device="cpu", **kw)
    assert_tables(got, want, tmp_path, [f"{m}_00007_{mode}.json" for m in ("FID", "LPIPS", "TCL")])
    assert len(got["TCL"]) == 3 + 1  # three tasks and the mean
    if not deterministic:
        assert all(v > 0 for k, v in got["LPIPS"].items() if not k.endswith("backbone"))


def test_calculate_metrics_real_inception_75(lpipses, tmp_path):
    """FID through the seeded He-randomized InceptionV3 on both sides; the
    batch's one task has two samples, so the piles take the sample-subspace
    path of ``fid_from_activations`` (a pile of one takes a 2048² sqrtm)."""
    batches = fc2.synthetic_fc2_batches(1, 4, hw=(76, 76), num_dom=2, seed=0)
    jfn, tfn = _style_fns()
    kw = dict(num_domains=2, num_outs_per_domain=2)
    want = jcalculate_metrics(jfn, batches, out_dir=str(tmp_path / "vst"),
                              inception=vst_inception(vst_random_he_inception(0)),
                              lpips=lpipses[0], **kw)
    got = calculate_metrics(tfn, batches, out_dir=str(tmp_path / "port"),
                            inception=InceptionV3(seed=0, device="cpu"), lpips=lpipses[1],
                            device="cpu", **kw)
    names = [f"{m}_00000_latent.json" for m in ("FID", "LPIPS", "TCL")]
    assert got["FID"]["FID_latent/backbone"] == "random-he"
    assert list(got["TCL"]) == ["TCL_latent/style02style1", "TCL_latent/mean"]
    for task, w in want["FID"].items():  # the net in float32: 1e-4, as its activations
        if isinstance(w, float):
            assert abs(got["FID"][task] - w) <= 1e-4 * abs(w), task
    got["FID"], want["FID"] = {}, {}
    assert_tables(got, want, tmp_path, names)


def test_calculate_metrics_hands_each_round_one_seed(tmp_path):
    """Both frames of a round draw from generators of one seed (vst's shared
    key); rounds draw anew."""
    draws = []

    def fn(x, y, mode, rng, x_ref):
        noise = torch.randn(x.shape, generator=rng)
        draws.append(noise)
        return (x + 0.01 * noise).clamp(-1, 1)

    batches = fc2.synthetic_fc2_batches(1, 4, hw=HW, num_dom=2, seed=0)
    calculate_metrics(fn, batches, num_domains=2, num_outs_per_domain=2,
                      inception=PixelFeatures(True), lpips=LPIPS(seed=0, device="cpu"),
                      device="cpu")
    assert torch.equal(draws[0], draws[1]) and torch.equal(draws[2], draws[3])
    assert not torch.equal(draws[0], draws[2])


@pytest.fixture
def x64():
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


def test_evaluate_fc2_obst_matches_vst(x64, tmp_path):
    """Float64, one level of 20 closure calls; the batch's two valid samples
    are (0 → 3), style 3's grayscale references, then (0 → 1), a change of
    style that sets the targets anew."""
    batches = fc2.synthetic_fc2_batches(1, 4, hw=HW, num_dom=4, seed=1)
    for b in batches:  # OBST takes [0, 1] images
        for k in ("x_src", "x2_src", "x_ref"):
            b[k] = ((b[k] + 1.0) / 2.0).astype(np.float64)
        b["mask"], b["flow"] = b["mask"].astype(np.float64), b["flow"].astype(np.float64)
    styles = np.random.RandomState(3).rand(3, 48, 48, 3)
    pyr = (HW,)
    jo = jg.OBST(max_iters=(1,), seed=2, compute_dtype=jnp.float64)
    to = gatys.OBST(max_iters=(1,), seed=2, compute_dtype=torch.float64, device="cpu")
    want = jevaluate_fc2_obst(jo, batches, jnp.asarray(styles), pyr, weight_tcl=2000.0,
                              out_dir=str(tmp_path / "vst"), inception=PixelFeatures(False))
    got = evaluate_fc2_obst(to, batches, styles, pyr, weight_tcl=2000.0,
                            out_dir=str(tmp_path / "port"), inception=PixelFeatures(True))
    assert_tables(got, want, tmp_path, ["FID.json", "TCL.json"])
    assert list(got["TCL"]) == ["TCL/style02style1", "TCL/style02style3", "TCL/mean"]
    assert got["FID"]["FID/backbone"] == "pixels"


def test_evaluate_fc2_ruder_matches_vst(tmp_path):
    batches = fc2.synthetic_fc2_batches(2, 3, hw=HW, num_dom=4, seed=7)
    torch.manual_seed(0)
    net, pre = method_net("ruder", 3).eval(), bootstrap_net(3).eval()
    with torch.no_grad():  # spread the outputs over [0, 255]
        for m in (net, pre):
            m.deconv3.conv2d.weight.mul_(300.0)
    jtrainer = types.SimpleNamespace(model=JFastStyleNet(num_inp=7, n_styles=3),
                                     pre_model=JFastStyleNet(num_inp=3, n_styles=3))
    want = jevaluate_fc2_ruder(jtrainer, faststyle_params_from_torch(net.state_dict()),
                               faststyle_params_from_torch(pre.state_dict()), batches,
                               out_dir=str(tmp_path / "vst"), inception=PixelFeatures(False))
    got = evaluate_fc2_ruder(net, net.state_dict(), pre, pre.state_dict(), batches,
                             out_dir=str(tmp_path / "port"), inception=PixelFeatures(True),
                             device="cpu")
    assert_tables(got, want, tmp_path, ["FID.json", "TCL.json"])
    assert got["TCL"]["TCL_mean"] > 0 and "TCL_style02style3" in got["TCL"]
