"""The ``datagen-*`` subcommands of vst_torch's CLI against vst's on the CPU
at 32².

``datagen-fc2`` and ``datagen-corpus --styler procedural`` run on both sides:
the same files (``.npy`` frames within the synthetic tolerance of 1e-5,
measured 0, flows and masks equal; every JPEG byte for byte) and the same
printed lines. For the OBST stylers (``datagen-styled``,
``datagen-corpus --styler gatys``), the library call each command makes is
recorded on both sides and compared: the contents bit for bit, the styles,
the pyramid and every keyword. The styling itself is held to vst's in
float64 by ``tests/test_torch_datagen.py``; float32 L-BFGS is not comparable
across frameworks (measured 2–9 % relative after one level). The port's
``datagen-styled`` then runs for real at 32² with one L-BFGS pass a level."""

import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from torch_train_parity import torch_threads  # noqa: F401 (autouse: 2 threads a worker)

import vst.cli.__main__ as vcli
import vst.data.datagen as jdatagen
import vst.models.gatys as jgatys
from vst_torch.cli import __main__ as tcli

FRAME_ATOL = 1e-5  # tests/test_torch_synthetic.py's ATOL_FRAMES


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _both(tmp_path, capsys, argv):
    """Run ``argv`` through vst's CLI and the port's; their printed lines."""
    vcli.main(argv + ["--out-dir", str(tmp_path / "v"), "--platform", "cpu"])
    want = capsys.readouterr().out.replace(str(tmp_path / "v"), "OUT")
    tcli.main(argv + ["--out-dir", str(tmp_path / "p"), "--device", "cpu"])
    got = capsys.readouterr().out.replace(str(tmp_path / "p"), "OUT")
    return got, want


def test_datagen_fc2(tmp_path, capsys):
    got, want = _both(tmp_path, capsys, ["datagen-fc2", "--n-samples", "5", "--hw", "32", "32",
                                         "--seed", "3"])
    assert got == want == "wrote 5 tuples to OUT\n"
    names = _files(tmp_path / "v")
    assert _files(tmp_path / "p") == names == [f"{i:07d}.npy" for i in range(5)]
    for name in names:
        a, b = np.load(tmp_path / "p" / name), np.load(tmp_path / "v" / name)
        assert a.shape == (1, 32, 32, 9)
        np.testing.assert_allclose(a[..., :6], b[..., :6], rtol=0, atol=FRAME_ATOL)
        np.testing.assert_array_equal(a[..., 6:], b[..., 6:])


def test_datagen_corpus_procedural(tmp_path, capsys):
    got, want = _both(tmp_path, capsys, ["datagen-corpus", "--n-samples", "4", "--hw", "32",
                                         "32", "--styler", "procedural", "--seed", "1"])
    assert got == want
    assert got.splitlines()[-1] == "corpus of 4 pairs × domains in OUT"
    names = _files(tmp_path / "v")
    assert _files(tmp_path / "p") == names and len(names) == 4 + 2 * 4 * 4
    for name in names:
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "v" / name, shallow=False), name


class _Calls:
    """Stands in for a library function: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


class _VstOBST:
    def __init__(self, max_iters=(50, 40, 30), **kwargs):
        self.max_iters = tuple(max_iters)


@pytest.fixture
def recorded(monkeypatch):
    """Both sides' generate_styled_dataset / generate_fc2_corpus (and vst's
    OBST, whose VGG init the comparison does not need) record their calls."""
    calls = {}
    for side, module in (("vst", jdatagen), ("port", tcli)):
        for fn in ("generate_styled_dataset", "generate_fc2_corpus"):
            calls[side, fn] = _Calls()
            monkeypatch.setattr(module, fn, calls[side, fn])
    monkeypatch.setattr(jgatys, "OBST", _VstOBST)
    return calls


def test_datagen_styled_calls_what_vst_calls(tmp_path, capsys, recorded):
    got, want = _both(tmp_path, capsys, ["datagen-styled", "--n-samples", "3", "--hw", "32",
                                         "48", "--iters", "5", "4", "3", "--batch-size", "2",
                                         "--seed", "4"])
    assert got == want == "styled 3 images into OUT\n"
    [(jargs, jkw)] = recorded["vst", "generate_styled_dataset"].calls
    [(targs, tkw)] = recorded["port", "generate_styled_dataset"].calls
    (jcontents, jstyles, _), (tcontents, tstyles, _) = jargs, targs
    assert [n for n, _ in tcontents] == [n for n, _ in jcontents] == ["0000000", "0000001",
                                                                      "0000002"]
    for (_, a), (_, b) in zip(tcontents, jcontents):
        assert a.shape == (64, 80, 3)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tstyles, jstyles)
    assert tkw["pyr_shapes"] == jkw["pyr_shapes"] == ((8, 12), (16, 24), (32, 48))
    assert tkw["batch_size"] == jkw["batch_size"] == 2
    assert tkw["obst"].max_iters == jkw["obst"].max_iters == (5, 4, 3)
    assert tkw["obst"].device.type == tkw["device"].type == "cpu"


def test_datagen_corpus_gatys_calls_what_vst_calls(tmp_path, capsys, recorded):
    argv = ["datagen-corpus", "--n-samples", "7", "--hw", "32", "32", "--batch-size", "16",
            "--iters", "3", "2", "1", "--style-dir", "S", "--seed", "5"]
    got, want = _both(tmp_path, capsys, argv)
    assert got == want == "corpus of 7 pairs × domains in OUT\n"
    [(jargs, jkw)] = recorded["vst", "generate_fc2_corpus"].calls
    [(targs, tkw)] = recorded["port", "generate_fc2_corpus"].calls
    assert targs[1:] == jargs[1:] == (7,)
    assert tkw.pop("device").type == "cpu"
    assert tkw == jkw == {"hw": (32, 32), "style_dir": "S", "iters": (3, 2, 1),
                          "batch_size": 16, "seed": 5, "styler": "gatys"}


def test_datagen_styled_runs(tmp_path, capsys):
    tcli.main(["datagen-styled", "--n-samples", "2", "--hw", "32", "32", "--iters", "1", "1",
               "1", "--batch-size", "2", "--device", "cpu", "--out-dir", str(tmp_path)])
    assert capsys.readouterr().out == f"styled 2 images into {tmp_path}\n"
    assert _files(tmp_path) == [f"style{k}/{i:07d}.jpg" for k in range(4) for i in range(2)]
    for k in range(4):
        img = np.asarray(Image.open(tmp_path / f"style{k}" / "0000001.jpg"), np.int32)
        assert img.shape == (32, 32, 3)
    grey = np.asarray(Image.open(tmp_path / "style3" / "0000000.jpg"), np.int32)
    assert np.abs(grey[..., 0] - grey[..., 1]).max() <= 1
    styled = np.asarray(Image.open(tmp_path / "style1" / "0000000.jpg"), np.int32)
    content = np.asarray(Image.open(tmp_path / "style0" / "0000000.jpg"), np.int32)
    assert np.abs(styled - content).mean() > 1  # OBST moved the image


def test_gatys_styler_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tcli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        tcli.main(["datagen-corpus", "--n-samples", "1", "--out-dir", str(tmp_path)])
