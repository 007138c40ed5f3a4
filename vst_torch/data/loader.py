"""Training corpora on the host, port of ``vst/data/loader.py``.

Each dataset yields dict batches of numpy arrays in vst's NHWC layout:
imgs (B, n, H, W, 3), masks (B, n−1, H, W, 1), flows (B, n−1, H, W, 2);
``vst_torch.train.faststyle.batch_to_tensors`` moves them to the device as
NCHW. The reference moved tensors to the GPU inside ``__getitem__``
(``methods/learning-based/datasets.py:75-77``); here the host reads a whole
batch (the FC2 files through the native threaded reader) and the trainer
copies it once.

``prefetch_to_mesh`` feeds a data-parallel rank: a background thread cuts
the rank's shard out of each host batch and copies it to the device ahead
of the step.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from vst_torch.data.native_loader import load_npy_batch
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.parallel.mesh import Mesh, local_rows, tree_map

_END = object()


def prefetch_to_mesh(batch_iter: Iterator, mesh: Mesh, depth: int = 2) -> Iterator:
    """Yield each host batch of ``batch_iter`` (a tree of arrays) as this
    rank's shard on its device, ``depth`` batches ahead (vst's
    ``prefetch_to_mesh``, ``vst/data/loader.py:23``).

    A background thread cuts the rank's rows (``P("data")``'s contiguous
    slice) and, on CUDA, copies them through pinned memory with
    ``non_blocking`` on a side stream, recording an event; the consumer's
    stream waits on that event and each tensor is recorded on that stream
    for the allocator. The side stream lets the copy of batch i + 1 overlap
    step i, which a copy on the step's own stream would queue behind. An
    error in the producer is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    cuda = mesh.device.type == "cuda"

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_host(x):
        x = local_rows(x, mesh)
        return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))

    def producer():
        stream = torch.cuda.Stream(mesh.device) if cuda else None
        try:
            for batch in batch_iter:
                host = tree_map(to_host, batch)
                if stream is None:
                    item = (tree_map(lambda t: t.to(mesh.device), host), None)
                else:
                    with torch.cuda.stream(stream):
                        dev = tree_map(lambda t: t.pin_memory().to(mesh.device, non_blocking=True),
                                        host)
                        event = torch.cuda.Event()
                        event.record(stream)
                    item = (dev, event)
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            dev, event = item
            if event is not None:
                current = torch.cuda.current_stream(mesh.device)
                current.wait_event(event)
                tree_map(lambda t: t.record_stream(current), dev)
            yield dev
    finally:
        stop.set()
        thread.join(timeout=10)


class _Dir:
    """A directory of per-sample files, sorted, cut to whole batches, with
    its own shuffling generator."""

    def __init__(self, data_dir: str, batch_size: int, seed: int,
                 expected_size: Optional[int]):
        self.data_dir = data_dir
        self.files = sorted(os.listdir(data_dir))
        if expected_size is not None and len(self.files) != expected_size:
            raise ValueError(f"dataset size {len(self.files)} != expected {expected_size}")
        self.batch_size = batch_size
        self.length = (len(self.files) // batch_size) * batch_size
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length // self.batch_size

    def _batches(self, shuffle: bool):
        """The file paths of each batch of one epoch."""
        order = np.arange(self.length)
        if shuffle:
            self._rng.shuffle(order)
        for i in range(0, self.length, self.batch_size):
            yield [os.path.join(self.data_dir, self.files[j])
                   for j in order[i:i + self.batch_size]]


class NpyDirDataset(_Dir):
    """FC2-style directory of per-sample ``.npy`` files (``DATAFiles``).

    FC2 packing (``datasets.py:52-54``): (1, H, W, 9) channelwise = img1(3) ⊕
    img2(3) ⊕ mask(1) ⊕ backward flow(2); batches imgs (B, 2, H, W, 3),
    masks (B, 1, H, W, 1), flows (B, 1, H, W, 2).
    """

    def __init__(self, data_dir: str, batch_size: int, seed: int = 0,
                 expected_size: Optional[int] = None):
        super().__init__(data_dir, batch_size, seed, expected_size)

    def epoch(self, shuffle: bool = True):
        shape = np.load(os.path.join(self.data_dir, self.files[0]), mmap_mode="r").shape
        for paths in self._batches(shuffle):
            x = load_npy_batch(paths, shape)[:, 0]  # (bs, H, W, 9)
            yield {
                "imgs": np.stack([x[..., 0:3], x[..., 3:6]], axis=1),
                "masks": x[..., 6:7][:, None],
                "flows": x[..., 7:9][:, None],
            }


class TupleNpyDataset(_Dir):
    """HW2/CO2-style directory of pickled-tuple ``.npy`` files
    (``datasets.py:100-137``, Hollywood2Dataset / COCODataset): each file
    holds a (frames, flows, masks) tuple of per-frame arrays; batches imgs
    (B, n, H, W, 3), masks (B, n−1, H, W, 1), flows (B, n−1, H, W, 2).
    The files are unpickled: read only corpora this project wrote.
    """

    def __init__(self, data_dir: str, batch_size: int, seed: int = 0,
                 expected_size: Optional[int] = None):
        super().__init__(data_dir, batch_size, seed, expected_size)

    def epoch(self, shuffle: bool = True):
        for paths in self._batches(shuffle):
            imgs, masks, flows = [], [], []
            for path in paths:
                frames, fls, mks = np.load(path, allow_pickle=True)
                imgs.append(np.stack(list(frames)))
                flows.append(np.stack(list(fls)))
                m = np.stack(list(mks))
                masks.append(m[..., None] if m.ndim == 3 else m)
            yield {
                "imgs": np.stack(imgs).astype(np.float32),
                "masks": np.stack(masks).astype(np.float32),
                "flows": np.stack(flows).astype(np.float32),
            }


def pack_tuple_npy(out_dir: str, n_samples: int, hw=(64, 64), n_frames: int = 3,
                   seed: int = 0) -> None:
    """Write HW2/CO2-format pickled tuples from the affine-motion
    synthesizer (what ``coco-generation.py:345-347`` writes)."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_samples):
        b = synthetic_batch(1, hw=hw, n_frames=n_frames, seed=seed + i)
        frames = [b["imgs"][0, t] for t in range(n_frames)]
        flows = [b["flows"][0, t] for t in range(n_frames - 1)]
        masks = [b["masks"][0, t] for t in range(n_frames - 1)]
        np.save(os.path.join(out_dir, f"{i:07d}.npy"),
                np.asarray([frames, flows, masks], dtype=object), allow_pickle=True)


class ChairsSDHomDataset(_Dir):
    """ChairsSDHom-format directory of per-sample ``.npy`` files
    (``datasets.py:239-269``): (384, 512, 9) packed img1(3) ⊕ img2(3) ⊕ flow(2)
    ⊕ mask(1) (flow BEFORE mask, the opposite of FC2), centre-cropped to
    ``crop_hw`` (256×256 in the reference)."""

    def __init__(self, data_dir: str, batch_size: int, seed: int = 0, crop_hw=(256, 256),
                 expected_size: Optional[int] = None):
        super().__init__(data_dir, batch_size, seed, expected_size)
        self.crop_hw = tuple(crop_hw)

    def _crop(self, x: np.ndarray) -> np.ndarray:
        h, w = self.crop_hw[0] // 2, self.crop_hw[1] // 2
        ih, iw = x.shape[0] // 2, x.shape[1] // 2
        return x[ih - h: ih + h, iw - w: iw + w]

    def epoch(self, shuffle: bool = True):
        for paths in self._batches(shuffle):
            x = np.stack([self._crop(np.asarray(np.load(p, allow_pickle=True), np.float32))
                          for p in paths])  # (bs, h, w, 9)
            yield {
                "imgs": np.stack([x[..., 0:3], x[..., 3:6]], axis=1),
                "masks": x[..., 8:9][:, None],
                "flows": x[..., 6:8][:, None],
            }


class CombinedDataset:
    """Several epoch-iterable datasets back to back (``datasets.py:217-237``,
    FC2 + CO2 + HW2): the reference indexes across member boundaries, which
    at batch granularity is sequential iteration."""

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("CombinedDataset needs at least one member")
        self.datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def epoch(self, shuffle: bool = True):
        for d in self.datasets:
            yield from d.epoch(shuffle)
