"""Training visualizer, port of ``vst/core/visualizer.py`` (junyanz's
``CycleGAN/util/visualizer.py:46-221``): each epoch's images into
``<out_dir>/web/images`` with a self-contained HTML gallery, a
``loss_log.txt`` append log, and the console loss line.

PNGs go through :func:`vst_torch.eval.video.write_png` (the standard
library), so the gallery is written where imageio is not installed.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from vst_torch.eval.video import write_png


class Visualizer:
    def __init__(self, out_dir: str, name: str = "experiment"):
        self.name = name
        self.web_dir = os.path.join(out_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(out_dir, "loss_log.txt")
        with open(self.log_name, "a") as f:
            f.write(f"=== Training Loss ({time.strftime('%c')}) ===\n")
        self._entries = []  # (epoch, label, filename)

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int) -> None:
        """visuals: name → (H, W, 3) float image in [0, 1]."""
        for label, img in visuals.items():
            fname = f"epoch{epoch:03d}_{label}.png"
            write_png(os.path.join(self.img_dir, fname),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            self._entries.append((epoch, label, fname))
        self._write_html()

    def _write_html(self) -> None:
        epochs = sorted({e for e, _, _ in self._entries}, reverse=True)
        rows = []
        for ep in epochs:
            cells = "".join(f'<td><img src="images/{fn}" width="192"/><br/>{lb}</td>'
                            for e, lb, fn in self._entries if e == ep)
            rows.append(f"<h3>epoch {ep}</h3><table><tr>{cells}</tr></table>")
        html = (f"<html><head><title>{self.name}</title></head><body>"
                + "".join(rows) + "</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(html)

    def print_current_losses(self, epoch: int, iters: int, losses: Dict[str, float],
                             t_comp: float = 0.0, t_data: float = 0.0) -> str:
        """``visualizer.py:204-221``'s message, printed and appended to the log."""
        message = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        for k, v in losses.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")
        return message
