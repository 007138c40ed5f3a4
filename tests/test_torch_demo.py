"""The live demo (``vst_torch.cli.demo``) and the browser demo
(``vst_torch.cli.webdemo``) against vst's, on the CPU at 32×48.

Both sides run the same Huang weights: the port's net seeded as its demo
seeds it, handed to vst through vst's ``faststyle_params_from_torch``. The
stylized frames are read before they are encoded (vst's float frames with
jit off, through a recording model) and held within ``FRAME_ATOL`` = 1e-5
on [0, 1] (measured 3.0e-7 and 1.8e-7). The synthetic clips are vst's bit for bit; the
browser page is vst's byte for byte; vst's own endpoint test
(``tests/test_webdemo.py``) runs against the port.
"""

import json
import os
import threading
import types
from http.server import ThreadingHTTPServer
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vst.cli.demo as jdemo
import vst.cli.webdemo as jwebdemo
import vst.train.faststyle as jfaststyle
from vst.data.synthetic import AffineMotionGenerator as JGenerator
from vst.data.synthetic import _texture as j_texture
from vst.models.faststyle import faststyle_params_from_torch
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst_torch.cli import demo, webdemo
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import parser
from vst_torch.train.registry import method_net

FRAME_ATOL = 1e-5
HW = (32, 48)


def _port_net_params(seed=0, n_styles=3):
    """vst's params of the net the port's demo seeds with ``seed``."""
    torch.manual_seed(seed)
    return faststyle_params_from_torch(method_net("huang", n_styles).state_dict())


def _vst_clip(hw, n_frames, seed, motion_seed):
    gen = JGenerator(crop_hw=hw, seed=motion_seed)
    rng = np.random.RandomState(seed)
    return gen.generate(j_texture(rng, (hw[0] + 96, hw[1] + 96)), n_frames=n_frames)[0]


def test_demo_clip_is_vsts():
    frames = list(demo._frames(None, 5, HW, seed=3)[0])
    np.testing.assert_array_equal(np.stack(frames), _vst_clip(HW, 5, 3, 3))


def _record_port_stylizer(monkeypatch, frames):
    real = demo.DemoStylizer.__call__

    def call(self, x, strength, sid):
        y = real(self, x, strength, sid)
        frames.append((y[0].permute(1, 2, 0).numpy().copy(), torch.is_inference_mode_enabled()))
        return y

    monkeypatch.setattr(demo.DemoStylizer, "__call__", call)


def _record_vst_model(monkeypatch, params, frames):
    """vst's FastStyleTrainer with ``params`` in its state and a model that
    records clip(out / 255, 0, 1) (run with jit off)."""

    class Recording:
        def __init__(self, model):
            self.model = model

        def apply(self, variables, *args):
            feats, out = self.model.apply(variables, *args)
            frames.append(np.asarray(jnp.clip(out / 255.0, 0.0, 1.0))[0])
            return feats, out

    class Trainer(jfaststyle.FastStyleTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.model = Recording(self.model)

        def init_state(self, sample):
            return types.SimpleNamespace(params=params)

    monkeypatch.setattr(jfaststyle, "FastStyleTrainer", Trainer)


def test_run_demo_frames_are_vsts(tmp_path, monkeypatch, capsys):
    got, want = [], []
    _record_port_stylizer(monkeypatch, got)
    _record_vst_model(monkeypatch, _port_net_params(), want)
    line = demo.run_demo(n_frames=4, hw=HW, out_path=str(tmp_path / "port" / "demo"),
                         device="cpu")
    with jax.disable_jit():
        path = jdemo.run_demo(n_frames=4, hw=HW, out_path=str(tmp_path / "vst" / "demo"),
                              platform="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"demo wrote {tmp_path / 'port'}") and out[0].endswith(" fps)")
    assert json.loads(out[1]) == line
    assert line["frames"] == 4 and line["hw"] == list(HW) and line["fps"] > 0
    assert line["video"] == str(tmp_path / "port" / "demo") + os.path.splitext(path)[1]
    assert len(got) == len(want) == 4
    for (g, inference), w in zip(got, want):
        assert inference and g.shape == w.shape == (*HW, 3)
        assert np.abs(g - w).max() <= FRAME_ATOL


def test_demo_reads_a_state_dict_or_a_train_dir(tmp_path, monkeypatch, capsys):
    """--ckpt-dir: a state_dict file, or a dir holding model.pt (what
    train-faststyle writes); a dir without one keeps the seeded net; ruder
    runs Huang's 3-input net."""
    torch.manual_seed(7)
    saved = method_net("huang", 3).state_dict()
    torch.save(saved, tmp_path / "model.pt")
    (tmp_path / "none").mkdir()
    torch.manual_seed(0)
    seeded = method_net("huang", 3).state_dict()
    for ckpt, want in ((tmp_path / "model.pt", saved), (tmp_path, saved),
                       (tmp_path / "none", seeded), (None, seeded)):
        net = demo.DemoStylizer("huang", 3, ckpt and str(ckpt), seed=0, device="cpu").net
        assert not net.training
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), (ckpt, k)
    assert "no checkpoint at" in capsys.readouterr().out
    assert demo.DemoStylizer("ruder", 3, device="cpu").net.conv1.conv2d.in_channels == 3
    runs = {}
    for name, extra in (("seeded", []), ("loaded", ["--ckpt-dir", str(tmp_path)])):
        runs[name] = []
        with monkeypatch.context() as m:
            _record_port_stylizer(m, runs[name])
            cli_main(["demo", "--device", "cpu", "--hw", *map(str, HW), "--n-frames", "2",
                      "--out-dir", str(tmp_path / name), *extra])
    assert len(runs["loaded"]) == 2
    assert not np.array_equal(runs["loaded"][0][0], runs["seeded"][0][0])


@pytest.mark.parametrize("command", ["demo", "demo-web"])
def test_demos_default_to_cuda(command, monkeypatch):
    args = parser().parse_args([command])
    assert args.device == "cuda" and args.method == "huang" and args.n_styles == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli_main([command, "--hw", *map(str, HW), "--max-frames" if command == "demo-web"
                  else "--n-frames", "1"])


def _serve(demo_obj):
    server = ThreadingHTTPServer(("127.0.0.1", 0), webdemo.make_handler(demo_obj))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def test_web_demo_endpoints(tmp_path):
    """vst's ``tests/test_webdemo.py``, against the port's classes."""
    d = webdemo.WebDemo(hw=HW, out_path=str(tmp_path), n_styles=2, device="cpu")
    server, base = _serve(d)
    try:
        page = urlopen(base + "/", timeout=10).read()
        assert b"vst live stylization" in page
        assert b"style 2" in page and b"snapshot" in page
        for payload in ({"sid": 1}, {"strength": 0.5}, {"scale": 0.5}):
            urlopen(Request(base + "/control", data=json.dumps(payload).encode(),
                            method="POST"), timeout=10).read()
        st = json.loads(urlopen(base + "/state", timeout=10).read())
        assert st["sid"] == 1 and st["strength"] == 0.5 and st["scale"] == 0.5
        t = threading.Thread(target=d.loop, kwargs={"max_frames": 4})
        t.start()
        t.join(300)
        assert not t.is_alive()
        frame = urlopen(base + "/frame.jpg", timeout=10).read()
        assert frame[:2] == b"\xff\xd8"  # JPEG SOI
        saved = json.loads(urlopen(Request(base + "/snapshot", data=b"", method="POST"),
                                   timeout=10).read())["saved"]
        assert open(saved, "rb").read()[:2] == b"\xff\xd8"
        st = json.loads(urlopen(base + "/state", timeout=10).read())
        assert st["frames"] == 4 and st["fps"] >= 0.0
        assert len(d.stage_ms) == 4 and all(set(r) == {"h2d_ms", "stylize_ms", "d2h_ms",
                                                       "jpeg_ms"} for r in d.stage_ms)
    finally:
        d.stop()
        server.shutdown()
        server.server_close()


def test_web_demo_page_is_vsts(tmp_path):
    d = webdemo.WebDemo(hw=HW, out_path=str(tmp_path), n_styles=3, device="cpu")
    server, base = _serve(d)
    try:
        page = urlopen(base + "/", timeout=10).read()
    finally:
        server.shutdown()
        server.server_close()
    buttons = "".join(f'<button onclick="ctl({{sid: {i}}})">style {i + 1}</button>'
                      for i in range(3))
    assert page == jwebdemo._PAGE.format(style_buttons=buttons).encode()


def test_web_demo_frames_are_vsts(tmp_path):
    """The frames before JPEG, after sid, strength and scale changes: style
    0; style 1 at strength 0.5; half scale (16×24); sid −1 passes the frame
    through; quarter scale clamps to 16×16; the clip's texture from the
    seed and its motion from seed + 1."""
    seed = 2
    d = webdemo.WebDemo(hw=HW, out_path=str(tmp_path), n_styles=2, seed=seed, device="cpu")
    jd = jwebdemo.WebDemo(hw=HW, out_path=str(tmp_path), n_styles=2, seed=seed, platform="cpu")
    jd._params = _port_net_params(seed, 2)
    np.testing.assert_array_equal(d._clip, _vst_clip(HW, 48, seed, seed + 1))
    frames = {"port": [], "vst": []}
    for name, obj in (("port", d), ("vst", jd)):
        obj._encode = lambda img, f=frames[name]: f.append(np.array(img)) or b"\xff\xd8"
    controls = [(2, {}), (4, {"sid": 1, "strength": 0.5}), (6, {"scale": 0.5}),
                (7, {"sid": -1}), (9, {"sid": 0, "scale": 0.25})]
    for upto, change in controls:
        for obj in (d, jd):
            for k, v in change.items():
                setattr(obj, k, v)
            obj.loop(max_frames=upto)
    shapes = [f.shape[:2] for f in frames["port"]]
    assert shapes == [HW] * 4 + [(16, 24)] * 3 + [(16, 16)] * 2
    assert len(frames["vst"]) == 9 and d.frames_done == 9
    for g, w in zip(frames["port"], frames["vst"]):
        assert g.shape == w.shape and np.abs(g - w).max() <= FRAME_ATOL
    assert not np.array_equal(frames["port"][0], frames["port"][2])  # the style moved it


def test_web_demo_loop_thread_runs_in_inference_mode(tmp_path, monkeypatch):
    """Grad mode is per thread: the loop's own thread stylizes under
    inference mode though its starter did not enter it."""
    seen = []
    _record_port_stylizer(monkeypatch, seen)
    d = webdemo.WebDemo(hw=HW, out_path=str(tmp_path), n_styles=1, device="cpu")
    assert torch.is_grad_enabled()
    t = threading.Thread(target=d.loop, kwargs={"max_frames": 2})
    t.start()
    t.join(120)
    assert not t.is_alive() and len(seen) == 2 and all(inf for _, inf in seen)


def test_demo_web_command_stops_after_max_frames(tmp_path, capsys):
    cli_main(["demo-web", "--device", "cpu", "--hw", *map(str, HW), "--port", "0",
              "--max-frames", "3", "--out-dir", str(tmp_path)])
    assert capsys.readouterr().out.startswith("vst demo on http://127.0.0.1:")
