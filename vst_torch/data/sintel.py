"""Sintel ground-truth-flow dataset, port of ``vst/data/sintel.py``
(``utils/sintel_dataset.py:22-102``).

Reads ``final/`` frames, ground-truth ``flow/*.flo``, ``occlusions/`` masks
(inverted: 1 = visible) and the precomputed 5-frame long-term flow and mask
``.npy`` files ("Sintel5", ``vst_torch.data.datagen.precompute_lt_flow``).
vst's quirks are kept: every file list is sorted in **reverse** (:45-48), so
a video is read backwards; index 0 (the video's last frame in time) gets a
zero flow and a zero mask; the long-term tuple is empty near both ends.
Frames and masks are read through PIL (vst reads them with imageio, which
the port does not require; for a PNG both give the same pixels).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vst_torch.data.fc2 import _read_image
from vst_torch.flow.io import read_flo


class SintelDataset:
    def __init__(self, sintel_path: str, video_id: str,
                 lt_path: Optional[str] = None, lt_len: int = 5):
        self.frames_path = os.path.join(sintel_path, "final", video_id)
        self.flows_path = os.path.join(sintel_path, "flow", video_id)
        self.masks_path = os.path.join(sintel_path, "occlusions", video_id)
        self.lt_path = os.path.join(lt_path, video_id) if lt_path else None
        self.lt_len = lt_len

        self.frames_list = sorted(os.listdir(self.frames_path), reverse=True)
        self.flows_list = sorted(os.listdir(self.flows_path), reverse=True)
        self.masks_list = sorted(os.listdir(self.masks_path), reverse=True)
        self.lt_data_list = (
            sorted(os.listdir(self.lt_path), reverse=True) if self.lt_path else [])
        self.length = len(self.frames_list)

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        """(frame (H, W, 3) [0, 1], mask (H, W, 1), flow (H, W, 2),
        (lt_flow, lt_mask)), host numpy; the long-term pair is (None, None)
        where the reference has none. Callers apply their own range
        transform (the reference maps to [−1, 1])."""
        frame = _read_image(
            os.path.join(self.frames_path, self.frames_list[idx])).astype(np.float32) / 255.0
        H, W = frame.shape[:2]

        if idx == 0:
            flow = np.zeros((H, W, 2), np.float32)
            mask = np.zeros((H, W, 1), np.float32)
        else:
            flow = read_flo(os.path.join(self.flows_path, self.flows_list[idx - 1]))
            m = _read_image(
                os.path.join(self.masks_path, self.masks_list[idx - 1])).astype(np.float32) / 255.0
            mask = 1.0 - m.reshape(H, W, 1)

        lt_flow, lt_mask = None, None
        if self.lt_data_list and self.lt_len <= idx and idx != self.length - 1:
            data = np.load(os.path.join(self.lt_path, self.lt_data_list[idx - self.lt_len]),
                           allow_pickle=True)
            lt_flow = data[0, :, :, :2].astype(np.float32)
            lt_mask = data[0, :, :, 2:3].astype(np.float32)

        return frame, mask, flow, (lt_flow, lt_mask)
