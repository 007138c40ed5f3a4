"""The port's visual and profiling tools against vst's, on the CPU:
``flow_to_image`` (uint8 equality), the training ``Visualizer`` (the same
files, HTML, log lines and messages), ``make_videos`` and
``latent_interpolation_video`` (the frames handed to the writer within one
uint8 unit of vst's; measured 0 and 1), the GIF written through PIL where
imageio is not installed, and the profiler hooks of
``vst_torch.core.trace`` (a no-op without a directory; a trace holding the
``span`` names with one)."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import vst.eval.video as jvideo
import vst.models.stargan2 as jsg2
from vst.core.visualizer import Visualizer as JVisualizer
from vst.flow.viz import flow_to_image as j_flow_to_image
from vst.flow.viz import make_colorwheel as j_make_colorwheel
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.core import trace
from vst_torch.core.visualizer import Visualizer
from vst_torch.eval import video
from vst_torch.flow.viz import flow_tensor_to_images, flow_to_image, make_colorwheel
from vst_torch.models import stargan2 as sg2

UINT8_ATOL = 1  # one uint8 unit: × 255 then truncation after float32 nets


def _flows(seed, n=3, hw=(19, 23)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*hw, 2).astype(np.float32) * 10.0 ** rng.uniform(-1, 1.5)
            for _ in range(n)]


def test_colorwheel_is_vsts():
    np.testing.assert_array_equal(make_colorwheel(), j_make_colorwheel())


@pytest.mark.parametrize("clip_flow", [None, 2.5])
@pytest.mark.parametrize("bgr", [False, True])
def test_flow_to_image_is_vsts_bit_for_bit(clip_flow, bgr):
    flows = _flows(1) + [np.zeros((5, 7, 2), np.float32)]  # all-zero flow: the 1e-5 floor
    for flow in flows:
        got = flow_to_image(flow, clip_flow, bgr)
        want = j_flow_to_image(flow, clip_flow, bgr)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    batch = torch.from_numpy(np.stack(flows[:3])).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(flow_tensor_to_images(batch, clip_flow, bgr),
                                  np.stack([j_flow_to_image(f, clip_flow, bgr)
                                            for f in flows[:3]]))


def test_visualizer_writes_vsts_gallery(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("time.strftime", lambda fmt: "Sat Oct 17 12:00:00 2026")
    rng = np.random.RandomState(2)
    visuals = {"real_A": rng.rand(8, 12, 3), "fake_B": rng.rand(8, 12, 3) * 1.4 - 0.2}
    msgs = {}
    for name, cls in (("port", Visualizer), ("vst", JVisualizer)):
        viz = cls(str(tmp_path / name), name="t")
        viz.display_current_results(visuals, epoch=1)
        viz.display_current_results({"rec_A": visuals["real_A"]}, epoch=2)
        msgs[name] = [viz.print_current_losses(1, 100, {"G_A": 0.5, "D_A": 0.25}, 0.1234),
                      viz.print_current_losses(2, 200, {"G_A": np.float32(1.0)})]
    assert msgs["port"] == msgs["vst"] and "G_A: 0.500" in msgs["port"][0]
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] == msgs["port"]
    port, ref = tmp_path / "port", tmp_path / "vst"
    files = sorted(str(p.relative_to(port)) for p in port.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(ref)) for p in ref.rglob("*") if p.is_file())
    for rel in files:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(port / rel)),
                                          np.asarray(Image.open(ref / rel)))
        else:
            assert (port / rel).read_text() == (ref / rel).read_text(), rel


class _Recorder:
    """A writer that keeps the frames handed to it."""

    def __init__(self, frames):
        self.frames = frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def append_data(self, image):
        self.frames.append(np.array(image))


def _record_writers(monkeypatch):
    got = {"port": [], "vst": []}
    monkeypatch.setattr(video, "_writer", lambda path, fps: (path, _Recorder(got["port"])))
    monkeypatch.setattr(jvideo, "_writer", lambda path, fps: (path, _Recorder(got["vst"])))
    return got


def _frame_dirs(root):
    rng = np.random.RandomState(3)
    for sub, n in (("alley_1_s1", 3), ("ambush_2_s2", 2)):
        os.makedirs(root / sub)
        for i in range(n):
            Image.fromarray((rng.rand(16, 24, 3) * 255).astype(np.uint8)).save(
                root / sub / f"frame_{i:04d}.png")
    os.makedirs(root / "empty")
    (root / "notes.txt").write_text("not a frame dir")


def test_make_videos_hands_the_writer_vsts_frames(tmp_path, monkeypatch):
    _frame_dirs(tmp_path / "clips")
    got = _record_writers(monkeypatch)
    paths = video.make_videos(str(tmp_path / "clips"), str(tmp_path / "out"))
    want_paths = jvideo.make_videos(str(tmp_path / "clips"), str(tmp_path / "out"))
    assert paths == want_paths == [str(tmp_path / "out" / f"{s}.mp4")
                                   for s in ("alley_1_s1", "ambush_2_s2")]
    assert len(got["port"]) == len(got["vst"]) == 5
    for g, w in zip(got["port"], got["vst"]):
        assert g.dtype == np.uint8 and g.shape == w.shape == (16, 24, 3)
        assert np.abs(g.astype(int) - w).max() <= UINT8_ATOL


def _hide_imageio(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)


def test_make_videos_writes_a_gif_without_imageio(tmp_path, monkeypatch):
    _frame_dirs(tmp_path / "clips")
    _hide_imageio(monkeypatch)
    paths = video.make_videos(str(tmp_path / "clips"))
    assert paths == [str(tmp_path / "clips" / f"{s}.gif") for s in ("alley_1_s1", "ambush_2_s2")]
    for path, n in zip(paths, (3, 2)):
        with Image.open(path) as gif:
            assert gif.format == "GIF" and gif.n_frames == n and gif.size == (24, 16)
            assert gif.info["duration"] in (50, 55, 56, 60)  # 1000 / 18 ms, GIF's 10 ms steps


G_SIZE, STYLE, LATENT, DOMAINS = 64, 8, 4, 3


@pytest.fixture(scope="module")
def sg2_pair():
    torch.manual_seed(5)
    gen = sg2.Generator(G_SIZE, STYLE, max_conv_dim=32).eval()
    mapping = sg2.MappingNetwork(LATENT, STYLE, DOMAINS).eval()
    jgen = jsg2.Generator(G_SIZE, STYLE, max_conv_dim=32)
    jmap = jsg2.MappingNetwork(LATENT, STYLE, DOMAINS)
    gp = jsg2.generator_params_from_torch(gen.state_dict(), G_SIZE)
    mp = jsg2.mapping_params_from_torch(mapping.state_dict())
    jgenerate = jax.jit(lambda x, s: jgen.apply({"params": gp}, x, s))
    jmapping = jax.jit(lambda z, y: jmap.apply({"params": mp}, z, y))
    return gen, mapping, jgenerate, jmapping


def test_latent_interpolation_video_hands_the_writer_vsts_frames(sg2_pair, tmp_path,
                                                                  monkeypatch):
    gen, mapping, jgenerate, jmapping = sg2_pair
    x = np.random.RandomState(6).uniform(-1, 1, (G_SIZE, G_SIZE, 3)).astype(np.float32)
    latents = np.random.RandomState(7).randn(3, LATENT).astype(np.float32)
    got = _record_writers(monkeypatch)
    path = str(tmp_path / "interp.mp4")
    assert video.latent_interpolation_video(
        gen, mapping, torch.from_numpy(x).permute(2, 0, 1), latents,
        torch.tensor([2]), path, steps_per_pair=4) == path
    jvideo.latent_interpolation_video(jgenerate, jmapping, x, latents, jnp.asarray([2]), path,
                                      steps_per_pair=4)
    assert len(got["port"]) == len(got["vst"]) == 8
    for g, w in zip(got["port"], got["vst"]):
        assert g.dtype == np.uint8 and g.shape == w.shape == (G_SIZE, G_SIZE, 3)
        assert np.abs(g.astype(int) - w).max() <= UINT8_ATOL
    assert not np.array_equal(got["port"][0], got["port"][3])  # the style code moves


def test_latent_interpolation_video_writes_a_gif_without_imageio(sg2_pair, tmp_path,
                                                                  monkeypatch):
    gen, mapping, _, _ = sg2_pair
    _hide_imageio(monkeypatch)
    x = torch.zeros(3, G_SIZE, G_SIZE)
    path = video.latent_interpolation_video(gen, mapping, x, np.eye(3, LATENT, dtype=np.float32),
                                            torch.tensor([0]), str(tmp_path / "v" / "i.mp4"),
                                            steps_per_pair=3)
    assert path == str(tmp_path / "v" / "i.gif")
    with Image.open(path) as gif:
        assert gif.n_frames == 6 and gif.size == (G_SIZE, G_SIZE)


def test_stylize_video_writes_a_gif_without_imageio(tmp_path, monkeypatch):
    _hide_imageio(monkeypatch)
    line = cli_main(["stylize-video", "--device", "cpu", "--hw", "32", "48", "--n-frames", "3",
                     "--batch-size", "2", "--out-dir", str(tmp_path)])
    assert line["video"] == str(tmp_path / "styled.gif")
    with Image.open(line["video"]) as gif:
        assert gif.n_frames == 3 and gif.size == (48, 32)


def _trace_text(log_dir):
    files = [f for f in glob.glob(os.path.join(log_dir, "**", "*"), recursive=True)
             if os.path.isfile(f)]
    assert files, "no trace written"
    return "".join(open(f).read() for f in files)


def test_profile_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("VST_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace.profile_trace():
        with trace.span("vst.unit_test_phase"):
            torch.ones(4).sum()
        assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_profile_trace_writes_the_annotations(how, tmp_path, monkeypatch):
    log_dir = str(tmp_path / "prof")
    if how == "environment":
        monkeypatch.setenv("VST_PROFILE_DIR", log_dir)
    with trace.profile_trace(log_dir if how == "argument" else None):
        with trace.span("vst.unit_test_phase"):
            torch.ones(16).sum()
    text = _trace_text(log_dir)
    json.loads(text)  # one Chrome trace
    assert "vst.unit_test_phase" in text


def test_the_sintel_evaluation_is_traced(tmp_path, monkeypatch):
    """``VST_PROFILE_DIR`` traces eval-sintel, each DT block under
    ``vst.eval.dt``, one a (video, style)."""
    monkeypatch.setenv("VST_PROFILE_DIR", str(tmp_path / "prof"))
    out = cli_main(["eval-sintel", "--device", "cpu", "--hw", "32", "48", "--n-styles", "2",
                    "--raft-iters", "1", "--dt-iters", "1", "--out-dir", str(tmp_path / "out")])
    keys = [k for k in out["DT"] if not k.startswith("DT_mean")]
    assert "DT_synthetic_1_s1" in keys and "DT_synthetic_1_s2" in keys
    text = _trace_text(str(tmp_path / "prof"))
    events = json.loads(text)["traceEvents"]
    assert sum(e.get("name") == "vst.eval.dt" and e.get("cat") == "user_annotation"
               for e in events) == len(keys)
