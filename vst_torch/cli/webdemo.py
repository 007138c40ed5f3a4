"""Browser demo, port of ``vst/cli/webdemo.py`` (the reference's PyQt5 app,
``methods/learning-based/fs_gui.py:21-312``): style buttons, a 0–2 style
strength slider, a resolution picker, a source picker, a snapshot button
and a live FPS readout.

A standard-library ``http.server`` serves one HTML page (vst's, byte for
byte) whose controls POST to ``/control`` while an ``<img>`` polls
``/frame.jpg``; ``/state`` reports the controls, the FPS readout and the
frame count, ``/snapshot`` saves the current JPEG. The stylize loop runs in
its own thread: one eager net under ``torch.inference_mode()`` serves every
resolution (vst keeps one jitted program a size). Grad mode is per thread
in PyTorch, so :meth:`WebDemo.loop` enters inference mode itself.
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from vst_torch.cli.demo import DemoStylizer
from vst_torch.data.synthetic import MARGIN, AffineMotionGenerator, _texture

CLIP_FRAMES = 48  # the synthetic clip's length (webdemo.py:107-109)
TIMED_FRAMES = 256  # the last frames whose stage times WebDemo keeps

_PAGE = """<!doctype html>
<html><head><title>vst demo</title><style>
body {{ font-family: sans-serif; margin: 1.2em; background: #14141a; color: #eee; }}
#frame {{ border: 1px solid #444; max-width: 90vw; }}
.row {{ margin: 0.6em 0; }}
button {{ margin-right: 0.4em; }}
#fps {{ color: #8c8; }}
</style></head><body>
<h3>vst live stylization</h3>
<img id="frame" src="/frame.jpg">
<div class="row">style:
{style_buttons}
  <button onclick="ctl({{sid: -1}})">off</button>
</div>
<div class="row">strength <input id="strength" type="range" min="0" max="2"
  step="0.05" value="1.0" oninput="ctl({{strength: +this.value}})">
  <span id="sv">1.0</span></div>
<div class="row">resolution <select id="res" onchange="ctl({{scale: +this.value}})">
  <option value="1.0">full</option><option value="0.5">half</option>
  <option value="0.25">quarter</option></select>
  &nbsp; source <select id="src" onchange="ctl({{source: this.value}})">
  <option value="synthetic">synthetic</option></select>
  &nbsp; <button onclick="fetch('/snapshot', {{method: 'POST'}})">snapshot</button>
  <span id="fps"></span></div>
<script>
function ctl(d) {{ fetch('/control', {{method: 'POST', body: JSON.stringify(d)}});
  if ('strength' in d) document.getElementById('sv').textContent = d.strength.toFixed(2); }}
setInterval(() => {{
  document.getElementById('frame').src = '/frame.jpg?' + Date.now();
  fetch('/state').then(r => r.json()).then(s => {{
    document.getElementById('fps').textContent = s.fps.toFixed(1) + ' fps'; }});
}}, 100);
</script></body></html>"""


class WebDemo:
    """The stylization state behind the HTTP handlers. ``device`` is where
    the net runs (CUDA unless the caller asks for the CPU). The synthetic
    clip is vst's webdemo clip: the texture from ``seed``, the motion from
    ``seed + 1``, 48 frames, looped."""

    def __init__(self, method: str = "huang", n_styles: int = 3,
                 ckpt_dir: Optional[str] = None, source: Optional[str] = None,
                 hw=(128, 192), out_path: str = "demo_out", seed: int = 0, device="cuda"):
        self.n_styles = n_styles
        self.out_path = out_path
        self.stylize = DemoStylizer(method, n_styles, ckpt_dir, seed, device)
        self.device = self.stylize.device
        self.base_hw = hw
        if source is None or source == "synthetic":
            rng = np.random.RandomState(seed)
            gen = AffineMotionGenerator(crop_hw=hw, seed=seed + 1)
            frames, _, _ = gen.generate(_texture(rng, (hw[0] + MARGIN, hw[1] + MARGIN)),
                                        n_frames=CLIP_FRAMES)
            self._clip = frames  # [0, 1] float
            self._cap = None
        else:
            import cv2

            self._cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
            self._clip = None

        self.lock = threading.Lock()
        self.sid = 0
        self.strength = 1.0
        self.scale = 1.0
        self.fps = 0.0
        self.frames_done = 0
        # per frame: ms of the host→device copy, the net, the device→host copy
        # (CUDA events on a card, the host clock on the CPU) and the JPEG
        self.stage_ms = collections.deque(maxlen=TIMED_FRAMES)
        self._jpeg = b""
        self._stop = threading.Event()

    def _next_frame(self):
        if self._clip is not None:
            return np.asarray(self._clip[self.frames_done % len(self._clip)], np.float32)
        ok, bgr = self._cap.read()
        if not ok:
            self._cap.set(1, 0)  # CAP_PROP_POS_FRAMES: loop files
            ok, bgr = self._cap.read()
            if not ok:
                return None
        return bgr[..., ::-1].astype(np.float32) / 255.0

    def _stylize(self, frame: np.ndarray, strength: float, sid: int):
        """(the styled (H, W, 3) frame in [0, 1], {h2d_ms, stylize_ms, d2h_ms})."""
        cuda = self.device.type == "cuda"
        stamps = []

        def stamp():
            if cuda:
                stamps.append(torch.cuda.Event(enable_timing=True))
                stamps[-1].record()
            else:
                stamps.append(time.perf_counter())

        stamp()
        x = torch.from_numpy(frame).to(self.device).permute(2, 0, 1)[None]
        stamp()
        y = self.stylize(x, strength, sid)
        stamp()
        out = y[0].permute(1, 2, 0).cpu().numpy()
        stamp()
        if cuda:
            stamps[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return out, dict(zip(("h2d_ms", "stylize_ms", "d2h_ms"), ms))

    def _encode(self, img01: np.ndarray) -> bytes:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=85)
        return buf.getvalue()

    def loop(self, max_frames: Optional[int] = None) -> None:
        """Stylize frames until :meth:`stop` or ``max_frames`` frames in all;
        ``sid`` −1 passes the frame through, ``scale`` resizes it to at least
        16 pixels a side in multiples of 4."""
        t_last = time.perf_counter()
        with torch.inference_mode():  # grad mode is per thread: enter it here
            while not self._stop.is_set():
                if max_frames is not None and self.frames_done >= max_frames:
                    break
                frame = self._next_frame()
                if frame is None:
                    break
                with self.lock:
                    sid, strength, scale = self.sid, self.strength, self.scale
                h = max(int(frame.shape[0] * scale) // 4 * 4, 16)
                w = max(int(frame.shape[1] * scale) // 4 * 4, 16)
                if (h, w) != frame.shape[:2]:
                    import cv2

                    frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
                if sid >= 0:
                    out, ms = self._stylize(frame, float(strength), int(sid))
                else:
                    out, ms = frame, {"h2d_ms": 0.0, "stylize_ms": 0.0, "d2h_ms": 0.0}
                t0 = time.perf_counter()
                jpeg = self._encode(out)
                ms["jpeg_ms"] = (time.perf_counter() - t0) * 1e3
                now = time.perf_counter()
                with self.lock:
                    self._jpeg = jpeg
                    self.fps = 0.9 * self.fps + 0.1 / max(now - t_last, 1e-6)
                    self.frames_done += 1
                    self.stage_ms.append(ms)
                t_last = now

    def snapshot(self) -> str:
        os.makedirs(self.out_path, exist_ok=True)
        path = f"{self.out_path}/snapshot_{self.frames_done:05d}.jpg"
        with self.lock:
            data = self._jpeg
        with open(path, "wb") as f:
            f.write(data)
        return path

    def stop(self) -> None:
        self._stop.set()


def make_handler(demo: WebDemo):
    style_buttons = "".join(f'<button onclick="ctl({{sid: {i}}})">style {i + 1}</button>'
                            for i in range(demo.n_styles))
    page = _PAGE.format(style_buttons=style_buttons).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                with demo.lock:
                    data = demo._jpeg
                self._send(200 if data else 404, data or b"no frame yet",
                           "image/jpeg" if data else "text/plain")
            elif self.path.startswith("/state"):
                with demo.lock:
                    st = {"sid": demo.sid, "strength": demo.strength, "scale": demo.scale,
                          "fps": demo.fps, "frames": demo.frames_done}
                self._send(200, json.dumps(st).encode(), "application/json")
            else:
                self._send(200, page, "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b"{}"
            if self.path.startswith("/snapshot"):
                path = demo.snapshot()
                self._send(200, json.dumps({"saved": path}).encode(), "application/json")
                return
            try:
                d = json.loads(body or b"{}")
            except ValueError:
                self._send(400, b"bad json", "text/plain")
                return
            with demo.lock:
                if "sid" in d:
                    demo.sid = int(d["sid"])
                if "strength" in d:
                    demo.strength = float(d["strength"])
                if "scale" in d:
                    demo.scale = float(d["scale"])
            self._send(200, b"{}", "application/json")

    return Handler


def run_web_demo(port: int = 8600, max_frames: Optional[int] = None, **kw) -> None:
    """Serve :class:`WebDemo` (``kw``) on 127.0.0.1:``port`` and stylize in
    this thread until interrupted or ``max_frames`` frames."""
    demo = WebDemo(**kw)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(demo))
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    print(f"vst demo on http://127.0.0.1:{server.server_address[1]}", flush=True)
    try:
        demo.loop(max_frames=max_frames)  # blocks until stop / max_frames
    except KeyboardInterrupt:
        pass
    finally:
        demo.stop()
        server.shutdown()
        server.server_close()
