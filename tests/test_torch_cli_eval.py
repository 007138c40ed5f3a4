"""The port's evaluation commands on the CPU at 32×48: ``eval-sintel`` for
Johnson and Ruder (the synthetic clip and its flow oracle, 3 styles) prints
vst's summary dict and writes its JSONs; ``stylize-video`` writes one PNG a
frame and prints vst's JSON keys; the GAN families and a missing card stop
the command."""

import ast
import json
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import _make_raft, source_frames, parser, synthetic_clip
from vst_torch.eval.video import write_png
from vst_torch.flow.raft import RAFT
from vst_torch.train.registry import FASTSTYLE_METHODS, bootstrap_net, method_net, num_inputs

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--hw", "32", "48"]


def _vst_stylize_video_keys():
    """The keys of the dict vst's ``cmd_stylize_video`` prints."""
    tree = ast.parse((ROOT / "vst" / "cli" / "__main__.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "cmd_stylize_video")
    dumps = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dumps[-1].args[0].keys}


@pytest.mark.parametrize("method", ["johnson", "ruder"])
def test_eval_sintel_prints_its_means(method, tmp_path, capsys):
    res = cli_main(["eval-sintel", *SMALL, "--method", method, "--raft-iters", "2",
                    "--dt-iters", "2", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    means = ast.literal_eval(out[-1])
    assert set(means) == {"TCL-ST", "TCL-LT", "DT"}
    assert means == {k: res[k][f"{k}_mean"] for k in res}
    assert all(np.isfinite(v) and v > 0 for v in means.values())
    assert {f"{k}_synthetic_1_s{d}" for k in res for d in (1, 2, 3)} <= {
        key for table in res.values() for key in table}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["DT.json", "TCL-LT.json",
                                                          "TCL-ST.json"]
    if method == "ruder":  # no --pre-style-ckpt file: vst's line, then a seeded net
        assert out[0].startswith("pre-style ckpt") and "seeded bootstrap" in out[0]


def test_eval_sintel_loads_a_state_dict(tmp_path, capsys):
    """--ckpt-dir and --pre-style-ckpt take state_dict files; the same
    weights give the same scores."""
    args = [*SMALL, "--method", "ruder", "--raft-iters", "1", "--dt-iters", "1"]
    first = cli_main(["eval-sintel", *args, "--out-dir", str(tmp_path / "a")])
    torch.manual_seed(0)  # the seeded bootstrap's seed
    torch.save(bootstrap_net(3).state_dict(), tmp_path / "pre.pt")
    torch.manual_seed(0)  # --seed 0
    torch.save(method_net("ruder", 3).state_dict(), tmp_path / "net.pt")
    second = cli_main(["eval-sintel", *args, "--out-dir", str(tmp_path / "b"),
                       "--ckpt-dir", str(tmp_path / "net.pt"),
                       "--pre-style-ckpt", str(tmp_path / "pre.pt")])
    for k in ("TCL-ST", "TCL-LT"):
        assert second[k] == first[k]
    assert capsys.readouterr().out.count("not found") == 1  # the first run only


@pytest.mark.parametrize("family", ["stargan", "stargan2", "cyclegan"])
def test_eval_sintel_gan_families_are_not_ported(family):
    with pytest.raises(SystemExit, match="item 6"):
        cli_main(["eval-sintel", *SMALL, "--family", family])


@pytest.mark.parametrize("command", ["eval-sintel", "stylize-video"])
def test_commands_default_to_cuda(command, monkeypatch):
    args = parser().parse_args([command])
    assert args.device == "cuda" and list(args.hw) == [64, 64]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli_main([command, "--hw", "32", "48"])


@pytest.mark.parametrize("flags,batch", [((), 2), (("--bf16",), 4)])
def test_stylize_video_writes_frames_and_its_line(flags, batch, tmp_path, capsys):
    T = 5
    line = cli_main(["stylize-video", *SMALL, "--n-frames", str(T), "--batch-size", str(batch),
                     "--out-dir", str(tmp_path), *flags])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line and set(line) == _vst_stylize_video_keys()
    assert line["frames"] == T and line["hw"] == [32, 48] and line["batch_size"] == batch
    assert line["dtype"] == ("bfloat16" if flags else "float32") and line["frames_per_sec"] > 0
    pngs = sorted(tmp_path.glob("frame_*.png"))
    assert [p.name for p in pngs] == [f"frame_{i:05d}.png" for i in range(T)]
    frames = np.stack([imageio.imread(p) for p in pngs])
    assert frames.shape == (T, 32, 48, 3) and frames.dtype == np.uint8 and frames.std() > 0
    # an mp4 through imageio's ffmpeg backend, or vst's GIF fallback without one
    assert line["video"] in (str(tmp_path / "styled.mp4"), str(tmp_path / "styled.gif"))
    assert Path(line["video"]).exists()


def test_stylize_video_crops_and_reads_a_frame_dir(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    frames, _ = synthetic_clip((34, 50), 3, seed=1)
    for i, f in enumerate(frames):
        write_png(str(src / f"{i}.png"), (f * 255).astype(np.uint8))
    argv = ["stylize-video", "--device", "cpu", "--source", str(src), "--batch-size", "2",
            "--out-dir", str(tmp_path / "out")]
    line = cli_main(argv)
    assert line["frames"] == 3 and line["hw"] == [32, 48]  # cropped to multiples of 4
    # read through cv2 in RGB order, as written
    read = source_frames(parser().parse_args(argv))
    np.testing.assert_array_equal(read, (frames * 255).astype(np.uint8) / np.float32(255.0))


def test_stylize_video_refuses_ruder():
    with pytest.raises(SystemExit, match="Ruder"):
        cli_main(["stylize-video", *SMALL, "--method", "ruder"])


def test_write_png_round_trip(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (7, 11, 3)).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))


def test_registry_is_vsts():
    from vst.train.registry import FASTSTYLE_METHODS as VST_METHODS

    assert FASTSTYLE_METHODS == VST_METHODS  # names and emphasis parameters
    assert {m: num_inputs(m) for m in FASTSTYLE_METHODS} == {
        "johnson": 3, "dumoulin": 3, "huang": 3, "reconet": 3, "ruder": 7}
    assert method_net("ruder", 3).conv1.conv2d.in_channels == 7
    assert bootstrap_net(3).conv1.conv2d.in_channels == 3
    with pytest.raises(KeyError, match="feed-forward"):
        num_inputs("gatys")


def test_make_raft_takes_the_references_checkpoint(tmp_path):
    """--raft-ckpt: the reference's RAFT state_dict as saved through
    DataParallel ("module." keys, batch-norm counters) loads as it is;
    --raft-bf16 runs the encoders in bf16 on the same weights."""
    torch.manual_seed(3)
    sd = {f"module.{k}": v for k, v in RAFT(iters=1).state_dict().items()}
    sd["module.cnet.norm1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "raft.pth")
    args = parser().parse_args(["eval-sintel", "--raft-iters", "3", "--raft-ckpt",
                                str(tmp_path / "raft.pth"), "--raft-bf16"])
    raft = _make_raft(args, torch.device("cpu"))
    assert raft.iters == 3 and raft.encoder_dtype == torch.bfloat16
    assert raft.update_dtype == torch.float32  # vst's --raft-bf16: encoders only
    for k, v in raft.state_dict().items():
        assert torch.equal(v, sd[f"module.{k}"]), k
    assert parser().parse_args(["eval-sintel"]).raft_bf16 is None  # off by default
