"""The CLI's ``eval-obst`` and ``eval-fc2`` on the CPU (``--device cpu``) at
small sizes write vst's file layout: ``<out>/<λ>/{TCL-ST,TCL-LT,DT,RAFT-MS}.json``
and a ``summary.json`` that a second run merges into, with vst's keys;
``eval-fc2 --family obst`` writes ``<out>/<λ>/{FID,TCL}.json``, the
faststyle family ``{FID,LPIPS,TCL}_00000_latent.json`` (Ruder:
``{FID,TCL}.json``), and so do the StarGAN families (``--mode reference``:
``tests/test_torch_cli_stargan.py``).
Sizes: 64×64 for eval-obst (RAFT's 4-level correlation pyramid needs 1/8 of
the frame to halve 3 times), 76×76 for eval-fc2 (InceptionV3 needs 75×75),
one pyramid level of 20 closure calls. ``--seed 6`` gives 4 synthetic
batches of 1 with two samples on each of the 2-domain tasks, so FID takes
the sample-subspace path."""

import json

import numpy as np
import pytest

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst_torch.cli.__main__ import main, obst_pyramid

OBST_SUMMARY_KEYS = {"hw", "n_videos", "n_frames", "iters_pyr", "vgg_backbone", "device",
                     "obst_dtype", "methodology"}  # vst/cli/__main__.py:873-888
OBST_LAMBDA_KEYS = {"DT_ms_mean", "TCL-ST_mean", "TCL-LT_mean", "RAFT_ms_mean", "wall_s"}
SINTEL_FILES = ["DT.json", "RAFT-MS.json", "TCL-LT.json", "TCL-ST.json"]
FC2 = ["--device", "cpu", "--hw", "76", "76", "--batch-size", "1", "--num-domains", "2",
       "--seed", "6"]


def test_pyramid_is_vsts():
    assert obst_pyramid((436, 1024), (50, 40, 30)) == ((109, 256), (218, 512), (436, 1024))
    assert obst_pyramid((64, 64), (1,)) == ((64, 64),)


def test_eval_obst_writes_vsts_layout_and_merges_the_summary(tmp_path):
    common = ["eval-obst", "--device", "cpu", "--hw", "64", "64", "--n-videos", "1",
              "--n-frames", "2", "--iters-pyr", "1", "--raft-iters", "2",
              "--out-dir", str(tmp_path)]
    first = main([*common, "--lambda-tcl", "0"])
    summary = main([*common, "--lambda-tcl", "2000"])
    for lam in ("0", "2000"):
        assert sorted(p.name for p in (tmp_path / lam).iterdir()) == SINTEL_FILES
        dt = json.loads((tmp_path / lam / "DT.json").read_text())
        assert set(dt) == {"DT_synthetic_1_s1", "DT_synthetic_1_s2", "DT_synthetic_1_s3",
                           "_mean", "_mean_s1", "_mean_s2", "_mean_s3"}
    on_disk = json.loads((tmp_path / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    assert set(on_disk) == OBST_SUMMARY_KEYS | {"0", "2000"}
    assert on_disk["0"] == json.loads(json.dumps(first["0"]))  # kept by the second run
    for lam in ("0", "2000"):
        assert set(on_disk[lam]) == OBST_LAMBDA_KEYS | {"peak_mem_gib"}
        assert on_disk[lam]["peak_mem_gib"] is None  # a CPU run
        assert all(np.isfinite(on_disk[lam][k]) for k in OBST_LAMBDA_KEYS)
    assert on_disk["device"] == "cpu" and on_disk["obst_dtype"] == "float32"
    # the temporal term pulls frame 1 to its warm start
    assert on_disk["2000"]["TCL-ST_mean"] < on_disk["0"]["TCL-ST_mean"]


def test_eval_fc2_obst(tmp_path):
    res = main(["eval-fc2", *FC2, "--family", "obst", "--iters-pyr", "1",
                "--obst-lambdas", "2000", "--out-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2000"]
    assert sorted(p.name for p in (tmp_path / "2000").iterdir()) == ["FID.json", "TCL.json"]
    fid = json.loads((tmp_path / "2000" / "FID.json").read_text())
    assert set(fid) == {"FID/style02style1", "FID/mean", "FID/backbone"}
    assert fid["FID/backbone"] == "random-he" and np.isfinite(fid["FID/mean"])
    assert res["2000"]["TCL"]["TCL/mean"] > 0


@pytest.mark.parametrize("method,files", [
    ("johnson", ["FID_00000_latent.json", "LPIPS_00000_latent.json", "TCL_00000_latent.json"]),
    ("ruder", ["FID.json", "TCL.json"])])
def test_eval_fc2_faststyle(tmp_path, method, files):
    res = main(["eval-fc2", *FC2, "--family", "faststyle", "--method", method, "--num-outs", "2",
                "--pre-style-ckpt", str(tmp_path / "absent.pt"), "--out-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    # Ruder's protocol skips targets of style 0, as OBST's does
    sep, tasks = (("_", ["style02style1"]) if method == "ruder"
                  else ("_latent/", ["style02style1", "style12style0"]))
    assert set(res["TCL"]) == {f"TCL{sep}{t}" for t in tasks + ["mean"]}
    assert np.isfinite(res["FID"][f"FID{sep}mean"])
    if method == "johnson":  # a per-style head ignores the rng: LPIPS is skipped with a note
        assert list(res["LPIPS"]) == ["LPIPS_latent/note"]


@pytest.mark.parametrize("family", ["stargan", "stargan2"])
def test_eval_fc2_gan_families_stop_with_a_message(family, capsys, tmp_path):
    """The StarGAN families, once stopped with a pointer to ROADMAP.md §1
    item 6, now run: vst's three JSONs, a positive TCL, and LPIPS skipped
    with a note for v1, whose G ignores the latent rng."""
    res = main(["eval-fc2", *FC2, "--family", family, "--num-outs", "2",
                "--out-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{m}_00000_latent.json"
                                                                for m in ("FID", "LPIPS", "TCL"))
    assert res["TCL"]["TCL_latent/mean"] > 0 and res["FID"]["FID_latent/backbone"] == "random-he"
    assert ("LPIPS_latent/note" in res["LPIPS"]) == (family == "stargan")
    assert f"TCL: {res['TCL']['TCL_latent/mean']:.4f}" in capsys.readouterr().out
