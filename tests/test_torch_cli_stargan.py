"""The StarGAN commands of ``python -m vst_torch.cli`` on the CPU at tiny
sizes: their JSON lines' keys, the files they write, and that the
checkpoints load back (``train-stargan2``, ``train-stargan``, ``eval-sintel
--family stargan|stargan2``, ``eval-fc2 --family stargan|stargan2``)."""

import json
import os

import pytest
import torch

from torch_gan_parity import torch_threads  # noqa: F401
from vst_torch.cli.__main__ import main
from vst_torch.data.fc2 import pack_styled_corpus
from vst_torch.models.stargan import Discriminator, Generator
from vst_torch.train.stargan2 import StarGAN2Config, nets_from_state_dicts

TRAIN_KEYS = {"family", "hw", "batch", "iterations", "source", "device", "iteration_ms_median",
              "images_per_s", "wall_s", "peak_mem_gib", "first_losses", "last_losses",
              "n_nonfinite", "checkpoints"}
SG2 = ["--hw", "32", "32", "--batch-size", "2", "--max-conv-dim", "32", "--style-dim", "8",
       "--latent-dim", "4", "--num-domains", "3"]
SG1 = ["--hw", "32", "32", "--batch-size", "2", "--conv-dim", "8", "--repeat-num", "2",
       "--num-domains", "3", "--n-critic", "2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("styled"))
    pack_styled_corpus(root, 5, hw=(32, 32), num_dom=3, seed=1)
    return root


def printed_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [["--lambda-tcl", "100"], ["--compute-dtype", "bfloat16"],
                                   "cache"], ids=["advcon", "bf16", "device_cache"])
def test_train_stargan2(tmp_path, capsys, corpus, extra):
    extra = ["--data-dir", corpus, "--device-cache", "4"] if extra == "cache" else extra
    res = main(["train-stargan2", "--device", "cpu", *SG2, "--steps", "2", "--log-every", "1",
                "--sample-every", "2", "--out-dir", str(tmp_path), *extra])
    line = printed_line(capsys)
    assert TRAIN_KEYS | {"compute_dtype", "lambda_tcl"} <= set(line)
    assert line["n_nonfinite"] == 0 and line["iterations"] == 2 and line["peak_mem_gib"] is None
    assert line["source"] == ("device_cache" if "--device-cache" in extra else "synthetic")
    assert len(res["losses"]) == 2 and "G/ref_cyc" in line["last_losses"]
    assert ("G/latent_tcl" in line["last_losses"]) == ("--lambda-tcl" in extra)
    assert sorted(os.listdir(tmp_path)) == ["000002_nets.ckpt", "000002_nets_ema.ckpt",
                                           "losses.txt", "sample_000002.png"]
    cfg = StarGAN2Config(img_size=32, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32)
    live = torch.load(tmp_path / "000002_nets.ckpt")
    ema = torch.load(tmp_path / "000002_nets_ema.ckpt")
    assert set(live) == {"generator", "mapping_network", "style_encoder", "discriminator"}
    assert set(ema) == {"generator", "mapping_network", "style_encoder"}
    assert set(nets_from_state_dicts(cfg, ema, "cpu")) == {"generator", "mapping", "style_enc"}


def test_train_stargan_from_the_device_cache(tmp_path, capsys, corpus):
    main(["train-stargan", "--device", "cpu", *SG1, "--steps", "4", "--log-every", "2",
          "--data-dir", corpus, "--device-cache", "5", "--out-dir", str(tmp_path)])
    line = printed_line(capsys)
    assert TRAIN_KEYS | {"n_critic", "g_steps"} <= set(line)
    assert line["g_steps"] == 2 and line["source"] == "device_cache" and line["n_nonfinite"] == 0
    assert "G/loss_rec" in line["last_losses"] and "D/loss_gp" in line["first_losses"]
    assert sorted(os.listdir(tmp_path)) == ["4-D.ckpt", "4-G.ckpt", "losses.txt"]
    Generator(8, 3, 2).load_state_dict(torch.load(tmp_path / "4-G.ckpt"))
    # D's depth: min(--repeat-num, log2(32) − 1) = 2
    Discriminator(32, 8, 3, 2).load_state_dict(torch.load(tmp_path / "4-D.ckpt"))


def test_eval_sintel_stargan2_crops_to_sixteens(tmp_path):
    """At 36×48 v2's generator would fail (four downsamples); the command
    crops the clip to 32×48, as vst. (Both families at 32×48:
    ``tests/test_torch_cli_eval.py``.)"""
    res = main(["eval-sintel", "--family", "stargan2", "--device", "cpu", "--hw", "36", "48",
                "--raft-iters", "2", "--dt-iters", "1", "--out-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["DT.json", "TCL-LT.json", "TCL-ST.json"]
    assert "TCL-ST_synthetic_1_s3" in res["TCL-ST"] and res["TCL-ST"]["TCL-ST_mean"] > 0
    assert json.loads((tmp_path / "DT.json").read_text())["DT_mean"] > 0


def test_eval_fc2_stargan2_reference_mode(tmp_path, capsys):
    """The style from the reference image through the style encoder
    (``eval.py:128``); at 76² (InceptionV3's least is 75²), batch 1 at 2
    domains and seed 6, so every task's pile has 2+ samples. (Latent mode and
    v1: ``tests/test_torch_cli_obst.py``.)"""
    family, mode = "stargan2", "reference"
    res = main(["eval-fc2", "--family", family, "--mode", mode, "--device", "cpu", "--hw", "76",
                "76", "--batch-size", "1", "--num-domains", "2", "--seed", "6", "--num-outs", "2",
                "--out-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(f"{m}_00000_{mode}.json"
                                                  for m in ("FID", "LPIPS", "TCL"))
    assert res["TCL"][f"TCL_{mode}/mean"] > 0 and res["FID"][f"FID_{mode}/backbone"] == "random-he"
    assert f"LPIPS_{mode}/note" not in res["LPIPS"]
    assert f"TCL: {res['TCL'][f'TCL_{mode}/mean']:.4f}" in capsys.readouterr().out
