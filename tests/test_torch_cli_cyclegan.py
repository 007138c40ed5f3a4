"""The CycleGAN commands of ``python -m vst_torch.cli`` on the CPU at tiny
sizes (ngf = ndf = 8, batch 2, 2 iterations, RAFT at 2 iterations;
cyclegan and cyclegan_con at 32², MoGAN and ConGAN at 64², RAFT's least):
``train-cyclegan`` writes junyanz's ``{step}_net_{name}.pth`` files and its
JSON line from synthetic batches, the device cache or the corpus;
``eval-sintel --family cyclegan`` on three of those checkpoints agrees with
vst's ``evaluate_videos`` on the same weights (the synthetic clip at 32×48
with its flow oracle), every TCL within ``RTOL_TCL`` = 1e-4 relative."""

import json
import os
import types

import numpy as np
import pytest
import torch

from torch_gan_parity import torch_threads, vst_params_from_port  # noqa: F401
from vst.eval.drivers import cyclegan_stylize_fn as jcyclegan_stylize_fn
from vst.eval.sintel import SintelVideo as JSintelVideo
from vst.eval.sintel import evaluate_videos as jevaluate_videos
from vst.models.cyclegan import ResnetGenerator as JResnetGenerator
from vst_torch.cli.__main__ import cyclegan_eval_generators, main, parser, synthetic_clip
from vst_torch.convert import cyclegan_generator_state_dict_from_jax
from vst_torch.data.fc2 import pack_styled_corpus

RTOL_TCL = 1e-4
HW = {"cyclegan": 32, "cyclegan_con": 32, "mogan": 64, "congan": 64}
NETS = {"cyclegan": ["D_A", "D_B", "G_A", "G_B"], "cyclegan_con": ["D_A", "D_B", "G_A", "G_B"],
        "mogan": ["D_A", "D_B", "G_A", "G_B", "M_A", "M_B"],
        "congan": ["D_A", "D_B", "F_A", "F_B", "G_A", "G_B"]}
TRAIN_KEYS = {"family", "variant", "compute_dtype", "hw", "batch", "iterations", "source",
              "device", "e_step_ms_median", "m_step_ms_median", "images_per_s", "peak_mem_gib",
              "first_losses", "last_losses", "n_nonfinite", "checkpoints"}
COMMON = ["--device", "cpu", "--batch-size", "2", "--steps", "2", "--ngf", "8", "--ndf", "8",
          "--raft-iters", "2", "--log-every", "1"]


def train(variant, out_dir, *extra):
    s = str(HW[variant])
    return main(["train-cyclegan", *COMMON, "--variant", variant, "--hw", s, s,
                 "--out-dir", str(out_dir), *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each variant trained once: {variant: (out_dir, printed JSON line)}."""
    out = {}
    for variant in HW:
        d = tmp_path_factory.mktemp(variant)
        train(variant, d)
        out[variant] = d
    return out


@pytest.mark.parametrize("variant", list(HW))
def test_train_cyclegan_writes_its_nets_and_line(variant, tmp_path, capsys):
    res = train(variant, tmp_path)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TRAIN_KEYS <= set(line) and line["n_nonfinite"] == 0 and line["source"] == "synthetic"
    assert line["variant"] == variant and line["peak_mem_gib"] is None
    assert sorted(os.listdir(tmp_path)) == sorted([f"2_net_{n}.pth" for n in NETS[variant]]
                                                  + ["losses.txt"])
    assert (line["m_step_ms_median"] is not None) == (variant == "mogan")
    if variant == "mogan":  # E then M: the union of both steps' losses
        assert {"MC_A", "MT_B", "AM_A", "D_B"} <= set(line["last_losses"])
        assert "AM_A" not in line["first_losses"] and line["e_steps"] == line["m_steps"] == 1
    assert len(res["losses"]) == 2


@pytest.mark.parametrize("source", ["device_cache", "corpus"])
def test_train_cyclegan_reads_a_corpus(source, tmp_path, capsys):
    root = tmp_path / "styled"
    pack_styled_corpus(str(root), 4, hw=(32, 32), num_dom=3, seed=1)
    extra = ["--data-dir", str(root), "--sid", "2"]
    train("cyclegan_con", tmp_path / "out", *extra,
          *(["--device-cache", "4"] if source == "device_cache" else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["source"] == source and line["n_nonfinite"] == 0
    assert line["last_losses"]["G_T"] > 0


def test_train_cyclegan_defaults(monkeypatch):
    args = parser().parse_args(["train-cyclegan"])
    assert (args.device, list(args.hw), args.batch_size, args.ngf, args.ndf, args.raft_iters,
            args.sid, args.raft_bf16, args.compute_dtype) == ("cuda", [256, 256], 4, 64, 64, 20,
                                                               1, None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        main(["train-cyclegan", "--steps", "1"])


def test_eval_sintel_matches_vst(runs, tmp_path, capsys):
    specs = [str(runs["cyclegan"]), f"mogan:{runs['mogan']}", f"congan:{runs['congan']}"]
    got = main(["eval-sintel", "--family", "cyclegan", "--device", "cpu", "--hw", "32", "48",
                "--dt-iters", "1", "--ckpt-dir", ",".join(specs), "--out-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["DT.json", "TCL-LT.json", "TCL-ST.json"]

    frames, gen = synthetic_clip((32, 48), 8, 0)
    jnet = JResnetGenerator(3, 8, 9)
    x = np.zeros((1, 32, 48, 3), np.float32)
    tps = []
    for d in (runs["cyclegan"], runs["mogan"], runs["congan"]):
        sd = torch.load(os.path.join(d, "2_net_G_A.pth"))
        params = vst_params_from_port(
            jnet, (x,), sd, lambda p: cyclegan_generator_state_dict_from_jax(p, "resnet_9blocks"))
        tps.append((types.SimpleNamespace(G_A=jnet), {"G_A": params}))
    want = jevaluate_videos([JSintelVideo("synthetic_1", frames)], jcyclegan_stylize_fn(tps),
                            None, styles=[0, 1, 2], frame_transform=lambda f: f * 2.0 - 1.0,
                            dt_iters=1, flow_fn=lambda video, i, j: gen.pairwise_flows(j, i))
    for out_id in ("TCL-ST", "TCL-LT"):
        assert set(got[out_id]) == set(want[out_id])
        for k, v in want[out_id].items():
            assert v > 0, k
            np.testing.assert_allclose(got[out_id][k], v, rtol=RTOL_TCL, err_msg=k)


def test_eval_generators_take_the_newest_step(runs, tmp_path):
    for step in (1, 12, 3):
        sd = torch.load(os.path.join(runs["cyclegan"], "2_net_G_A.pth"))
        sd["model.1.bias"] = torch.full_like(sd["model.1.bias"], float(step))
        torch.save(sd, tmp_path / f"{step}_net_G_A.pth")
    (g,) = cyclegan_eval_generators(f"cyclegan_con:{tmp_path}", torch.device("cpu"))
    assert float(g.model[1].bias[0].detach()) == 12.0 and len(g.model) == 9 + 19  # 9 blocks, ngf 8
    assert g.model[1].weight.shape[0] == 8
    with pytest.raises(SystemExit, match="unknown variant"):
        cyclegan_eval_generators(f"pix2pix:{tmp_path}", torch.device("cpu"))
