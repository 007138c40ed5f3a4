"""``python -m vst_torch.cli train-faststyle`` on the CPU at 32×32: each method
writes losses.txt, loss_list.npy and its checkpoint and prints vst's log
lines and one JSON line; the checkpoint loads into ``eval-sintel``,
``stylize-video`` and Ruder's ``--pre-style-ckpt``; ``--data-dir`` streams
the FC2 files and ``--device-cache`` draws from the cache; the experiment
harness runs and its ``infer_test`` is vst's on the same weights (1e-5)."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.train.experiments import infer_test as vst_infer_test
from vst.train.faststyle import FastStyleTrainer as JTrainer
from vst.train.registry import select_method as vst_select_method
from vst_torch.cli.__main__ import CKPT_NAME, load_state, parser
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.convert import faststyle_state_dict_from_jax
from vst_torch.data.datagen import pack_fc2_npy
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.train import experiments
from vst_torch.train.registry import FASTSTYLE_METHODS, method_net

SMALL = ["--device", "cpu", "--hw", "32", "32", "--batch-size", "2"]
LINE_KEYS = {"method", "hw", "batch", "steps", "source", "device", "step_ms_median",
             "images_per_s", "host_batch_ms_median", "wall_s", "wall_images_per_s",
             "peak_mem_gib", "first_loss", "last_loss", "n_nonfinite", "checkpoint"}
AUX = {"johnson": ["loss", "content", "style", "tv"],
       "dumoulin": ["loss", "content", "style"],
       "huang": ["loss", "content", "style", "temporal", "tv"],
       "reconet": ["loss", "content", "style", "f_temporal", "o_temporal", "tv"],
       "ruder": ["loss", "content", "style", "temporal"]}


def _train(out_dir, *flags, steps=3):
    return cli_main(["train-faststyle", *SMALL, "--steps", str(steps), "--log-every", "1",
                     "--ckpt-every", "2", "--out-dir", str(out_dir), *flags])


@pytest.mark.parametrize("method", sorted(FASTSTYLE_METHODS))
def test_train_faststyle_writes_its_files(method, tmp_path, capsys):
    res = _train(tmp_path, "--method", method)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert set(line) == LINE_KEYS
    assert line["method"] == method and line["source"] == "synthetic" and line["device"] == "cpu"
    assert line["steps"] == 3 and line["n_nonfinite"] == 0 and line["peak_mem_gib"] is None
    assert len(res["losses"]) == 3 and res["first_loss"] == res["losses"][0]
    assert all(np.isfinite(res["losses"])) and line["images_per_s"] > 0
    for i in (1, 2, 3):
        words = out[i - 1].split()
        assert words[0] == f"[{i}/3]" and words[1::2] == [f"{k}:" for k in AUX[method]]
    assert sorted(os.listdir(tmp_path)) == sorted(["losses.txt", "loss_list.npy", CKPT_NAME])
    assert len((tmp_path / "losses.txt").read_text().splitlines()) == 3
    curves = np.load(tmp_path / "loss_list.npy")
    assert curves.shape == (3, 1 + len(AUX[method]))
    np.testing.assert_allclose(curves[:, 1], res["losses"], rtol=1e-6)
    net = method_net(method, 1)
    net.load_state_dict(load_state(line["checkpoint"]))  # strict: every key, no more


def test_log_lines_are_vsts_format(tmp_path, capsys):
    res = _train(tmp_path, steps=2)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "[2/2] " + " ".join(
        f"{k}: {v:.4f}" for k, v in zip(AUX["johnson"], np.load(tmp_path / "loss_list.npy")[1, 1:]))
    assert res["last_loss"] == res["losses"][1]


def test_checkpoint_loads_into_eval_and_stylize(tmp_path, capsys):
    """Johnson's checkpoint scores in eval-sintel and styles in
    stylize-video; Ruder trains from it as its bootstrap and its own
    checkpoint scores with both."""
    _train(tmp_path / "johnson")
    ckpt = str(tmp_path / "johnson" / CKPT_NAME)
    small = ["--device", "cpu", "--hw", "32", "48", "--n-styles", "1"]
    res = cli_main(["eval-sintel", *small, "--ckpt-dir", ckpt, "--raft-iters", "1",
                    "--dt-iters", "1", "--out-dir", str(tmp_path / "eval")])
    assert all(np.isfinite(res[k][f"{k}_mean"]) for k in res)
    line = cli_main(["stylize-video", *small, "--ckpt-dir", ckpt, "--n-frames", "3",
                     "--out-dir", str(tmp_path / "video")])
    assert line["frames"] == 3
    _train(tmp_path / "ruder", "--method", "ruder", "--pre-style-ckpt", ckpt)
    res = cli_main(["eval-sintel", *small, "--method", "ruder", "--raft-iters", "1",
                    "--dt-iters", "1", "--ckpt-dir", str(tmp_path / "ruder" / CKPT_NAME),
                    "--pre-style-ckpt", ckpt, "--out-dir", str(tmp_path / "eval_ruder")])
    assert all(np.isfinite(res[k][f"{k}_mean"]) for k in res)
    assert "not found" not in capsys.readouterr().out


@pytest.mark.parametrize("cache", [0, 3], ids=["stream", "device_cache"])
def test_data_dir_sources(cache, tmp_path, capsys):
    root = str(tmp_path / "fc2")
    pack_fc2_npy(root, 4, hw=(32, 32), seed=3)
    res = _train(tmp_path / "out", "--data-dir", root, "--device-cache", str(cache),
                 "--method", "huang")
    assert res["source"] == ("device_cache" if cache else "npy_dir")
    assert res["n_nonfinite"] == 0
    if cache:
        assert "device cache: 3 samples resident on cpu" in capsys.readouterr().out


def test_multi_style_draws_are_seeded(tmp_path):
    a = _train(tmp_path / "a", "--method", "dumoulin", "--n-styles", "3", "--seed", "2")
    b = _train(tmp_path / "b", "--method", "dumoulin", "--n-styles", "3", "--seed", "2")
    assert a["losses"] == b["losses"]
    assert load_state(a["checkpoint"])["conv1.instance.embed.weight"].shape[0] == 3


def test_train_faststyle_defaults_to_cuda(monkeypatch):
    args = parser().parse_args(["train-faststyle"])
    assert args.device == "cuda" and args.method == "johnson" and args.batch_size == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        cli_main(["train-faststyle"])


def test_experiments_param_var_row():
    row, results = experiments.param_var("johnson", 2, [1e-4, 1e-2], steps=1, hw=(16, 16),
                                         device="cpu")
    cells = row.split(" & ")[1:]
    assert row.startswith(" & ") and len(cells) == 4 and len(results) == 2
    assert [float(c) for c in cells] == pytest.approx(
        [r[0] for r in results] + [r[1] for r in results], abs=5e-5)


def test_infer_test_is_vsts():
    """The same FastStyleNet weights over a 7-frame clip: styled frames and
    both consistency means within 1e-5."""
    cfg = vst_select_method("johnson", batch_size=1)
    styles = np.zeros((1, 16, 16, 3), np.float32)
    jt = JTrainer(cfg, styles, seed=0)
    frames = synthetic_batch(1, hw=(16, 16), n_frames=7, seed=4)["imgs"][0]
    state = jt.init_state({"imgs": jnp.asarray(frames[None, :1])})
    trainer, _ = experiments.train_net("johnson", steps=0, batch_size=1, hw=(16, 16),
                                       style_images=np.zeros((3, 16, 16, 3), np.float32),
                                       device="cpu")
    trainer.model.load_state_dict(faststyle_state_dict_from_jax(jax.device_get(state.params)))
    want = vst_infer_test(jt, state, frames)
    got = experiments.infer_test(trainer, frames)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-5) and got[2] == pytest.approx(want[2], abs=1e-5)
