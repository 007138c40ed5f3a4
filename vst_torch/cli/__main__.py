"""vst_torch command line, port of ``vst/cli/__main__.py``: the feed-forward
family's evaluation and the benchmarks.

    python -m vst_torch.cli eval-sintel [--method johnson|dumoulin|huang|reconet|ruder]
                                        [--hw 436 1024] [--sintel-dir DIR] [--raft-bf16]
    python -m vst_torch.cli stylize-video [--source DIR|VIDEO] [--batch-size 8] [--bf16]
    python -m vst_torch.cli bench
    python -m vst_torch.cli bench-raft [--hw 436 1024] [--iters 5] [--out-dir DIR]

Every command runs on CUDA unless given ``--device cpu``; without a card it
stops. Float32 runs with TF32 off; RAFT's lookup goes through the
corr_lookup kernel on CUDA. Weights are random, from seeds, unless a
checkpoint is given. Checkpoints are torch ``state_dict`` files with the
reference's key names (vst's flags read orbax directories, which need jax).

``eval-sintel``: TCL-ST / TCL-LT / DT of the FastStyleNet family on Sintel
(``--sintel-dir``) or, without it, on an 8-frame synthetic affine-motion
clip scored with its exact flow (random RAFT weights would fail the
fb-consistency check everywhere). Johnson, Dumoulin, Huang and ReCoNet share
the 3-input net and the generic harness; Ruder runs its streaming protocol
with a 7-input net and a 3-input frame-0 bootstrap (``--pre-style-ckpt``, a
seeded net without it). ``--raft-bf16`` runs RAFT's encoders in bfloat16
(off by default: vst turns it on only on a TPU). Prints the summary dict
and writes the JSONs to ``--out-dir``.

``stylize-video``: a frame directory or a video file (both through cv2) or
the synthetic clip, cropped to multiples of 4, stylized in chunks of ``--batch-size`` (the
tail chunk padded), ``--bf16`` casting the whole net; writes PNGs and, where
imageio is installed, a video, and prints a JSON line of throughput.

``bench`` runs ``vst_torch.bench``. ``bench-raft`` times the Sintel eval
path's RAFT pair program, forward and backward flow of one frame pair in one
call at batch 2 (``vst/eval/sintel.py:compute_raft_pair``), per variant:
``f32``, ``bf16_enc`` (bf16 encoders), ``bf16_full`` (bf16 encoders and
update block), each with InputPadder to multiples of 8, and ``f32_pad64`` /
``bf16_full_pad64`` with multiples of 64; the x2 / x4 direction-batch slope
for ``f32`` and ``bf16_full_pad64``; and each variant's flow against
``f32``'s. It prints one JSON line and writes it to
``<out-dir>/raft_timing.json``. Every variant gets the same weights.

Not ported yet: ``eval-sintel --family stargan|stargan2|cyclegan`` and the
other subcommands (``ROADMAP.md`` §1).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from vst_torch import bench, set_f32_precision
from vst_torch.core.timing import windows_ms
from vst_torch.data.synthetic import AffineMotionGenerator, _texture
from vst_torch.eval.drivers import evaluate_sintel_faststyle, evaluate_sintel_ruder
from vst_torch.eval.sintel import SintelVideo, load_sintel_videos
from vst_torch.eval.video import _writer, write_png
from vst_torch.flow.raft import RAFT
from vst_torch.ops.image import InputPadder
from vst_torch.train.registry import FASTSTYLE_METHODS, bootstrap_net, method_net

BF16 = torch.bfloat16
# variant name → (encoder dtype, update dtype, InputPadder multiple)
RAFT_VARIANTS = {"f32": (None, None, 8), "bf16_enc": (BF16, None, 8),
                 "bf16_full": (BF16, BF16, 8), "f32_pad64": (None, None, 64),
                 "bf16_full_pad64": (BF16, BF16, 64)}
SLOPE_VARIANTS = ("f32", "bf16_full_pad64")
SYNTHETIC_MARGIN = 96  # the texture is this much larger than the clip, as vst's


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _device(args) -> torch.device:
    """The command's device; CUDA without a card stops the command."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{args.command}: needs a CUDA device (or --device cpu)")
    return device


def synthetic_clip(hw, n_frames: int, seed: int):
    """vst's synthetic clip: (frames (n, H, W, 3) in [0, 1], its generator)."""
    rng = np.random.RandomState(seed)
    gen = AffineMotionGenerator(crop_hw=tuple(hw), seed=seed)
    big = (hw[0] + SYNTHETIC_MARGIN, hw[1] + SYNTHETIC_MARGIN)
    frames, _, _ = gen.generate(_texture(rng, big), n_frames=n_frames)
    return frames, gen


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` file, with a DataParallel ``module.`` prefix
    stripped and batch norms' ``num_batches_tracked`` dropped, as vst's
    converters do (eval-mode nets do not read it)."""
    sd = torch.load(path, map_location="cpu")
    return {k.removeprefix("module."): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def bench_raft(hw: Sequence[int] = (436, 1024), raft_iters: int = 20, iters: int = 5,
               seed: int = 0, variants: Sequence[str] = tuple(RAFT_VARIANTS),
               device="cuda") -> Dict:
    """The RAFT pair benchmark; returns the results dict (``cmd_bench_raft``'s
    keys for the variants run). ``f32`` is the reference of the flow deltas
    and is always run."""
    device = torch.device(device)
    set_f32_precision()
    H, W = hw
    rng = np.random.RandomState(seed)
    img1, img2 = (torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32))
                  .permute(0, 3, 1, 2).contiguous().to(device) for _ in range(2))
    results = {"hw": [H, W], "iters": raft_iters, "device": device_name(device),
               "methodology": "pair program, best of 3 windows; CUDA events after a "
                              "synchronize on CUDA, the host clock on the CPU",
               "weights": "seeded-random (program identical to the converted-checkpoint path)"}
    flows = {}
    for name in ["f32"] + [v for v in variants if v != "f32"]:
        enc, upd, mult = RAFT_VARIANTS[name]
        torch.manual_seed(seed)
        raft = RAFT(iters=raft_iters, encoder_dtype=enc, update_dtype=upd).to(device).eval()
        padder = InputPadder(img1.shape, mult=mult)
        i1, i2 = padder.pad(img1, img2)
        a = torch.cat([i1, i2], 0)
        b = torch.cat([i2, i1], 0)
        flows[name] = padder.unpad(raft(a, b)[1][:1]).cpu().numpy()
        for m in (1, 2, 4) if name in SLOPE_VARIANTS else (1,):
            am, bm = torch.cat([a] * m, 0), torch.cat([b] * m, 0)
            ms = min(windows_ms(lambda _: raft(am, bm)[1], am, iters)) / m
            results[f"pair_ms_{name}" + (f"_x{m}" if m > 1 else "")] = ms
            print(f"{name}" + (f" x{m}" if m > 1 else "")
                  + f": {ms:.1f} ms/pair (fwd+bwd batched)", flush=True)
        del raft
    mag = np.sqrt((flows["f32"] ** 2).sum(1)) + 1e-6
    for name, flow in flows.items():
        if name == "f32":
            continue
        epe = np.sqrt(((flow - flows["f32"]) ** 2).sum(1))
        results[f"{name}_vs_f32_epe_mean"] = float(epe.mean())
        results[f"{name}_vs_f32_rel_mean"] = float((epe / mag).mean())
    return results


def _make_raft(args, device: torch.device):
    """RAFT at ``--raft-iters``, encoders in bf16 with ``--raft-bf16``;
    ``--raft-ckpt`` (the reference's ``state_dict``) or seeded weights (seed
    0, as vst's init key)."""
    torch.manual_seed(0)
    raft = RAFT(iters=args.raft_iters, encoder_dtype=BF16 if args.raft_bf16 else None)
    if args.raft_ckpt:
        raft.load_state_dict(load_state(args.raft_ckpt))
    return raft.to(device).eval()


def _load_pre_style(args, device: torch.device):
    """Ruder's frame-0 bootstrap (``fs_ruder.py:25-34``): the
    ``--pre-style-ckpt`` file, else a seeded net."""
    torch.manual_seed(0)
    pre = bootstrap_net(args.n_styles)
    if os.path.isfile(args.pre_style_ckpt):
        pre.load_state_dict(load_state(args.pre_style_ckpt))
    else:
        print(f"pre-style ckpt {args.pre_style_ckpt} not found — seeded bootstrap", flush=True)
    return pre.to(device)


def _eval_videos(args):
    """(videos, flow_fn): Sintel from ``--sintel-dir`` scored through RAFT,
    or the synthetic clip with its analytic motion oracle."""
    if args.sintel_dir:
        return load_sintel_videos(args.sintel_dir), None
    frames, gen = synthetic_clip(args.hw, 8, args.seed)

    def flow_fn(video, i, j):
        """The exact flows between the earlier frame j and frame i."""
        return gen.pairwise_flows(j, i)

    return [SintelVideo("synthetic_1", frames)], flow_fn


def cmd_eval_sintel(args) -> Dict:
    if args.family != "faststyle":
        raise SystemExit(f"eval-sintel --family {args.family}: the GAN families are not "
                         "ported yet (ROADMAP.md §1 item 6)")
    device = _device(args)
    set_f32_precision()
    videos, flow_fn = _eval_videos(args)
    raft_apply = _make_raft(args, device)
    torch.manual_seed(args.seed)
    net = method_net(args.method, args.n_styles).to(device)
    state = load_state(args.ckpt_dir) if args.ckpt_dir else net.state_dict()
    kw = dict(styles=list(range(max(args.n_styles, 3))), out_path=args.out_dir,
              dt_iters=args.dt_iters, flow_fn=flow_fn, device=device)
    if args.method == "ruder":
        pre = _load_pre_style(args, device)
        results = evaluate_sintel_ruder(net, state, pre, pre.state_dict(), videos,
                                        raft_apply, **kw)
    else:
        results = evaluate_sintel_faststyle(net, state, videos, raft_apply, **kw)
    print({k: v[f"{k}_mean"] for k, v in results.items()})
    return results


def source_frames(args) -> np.ndarray:
    """(T, H, W, 3) float32 [0, 1] from ``--source`` or the synthetic clip.
    A frame directory and a video file are both read through cv2 (vst reads
    a directory through imageio, which the card's machine may lack)."""
    if not args.source:
        return synthetic_clip(args.hw, args.n_frames, args.seed)[0]
    import cv2

    if os.path.isdir(args.source):
        names = sorted(f for f in os.listdir(args.source) if f.lower().endswith((".png", ".jpg")))
        bgrs = [cv2.imread(os.path.join(args.source, f), cv2.IMREAD_COLOR) for f in names]
    else:
        cap = cv2.VideoCapture(args.source)
        bgrs = []
        ok, bgr = cap.read()
        while ok:
            bgrs.append(bgr)
            ok, bgr = cap.read()
        cap.release()
    return np.stack([bgr[..., ::-1].astype(np.float32) / 255.0 for bgr in bgrs])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def video_stylizer(args, device: torch.device) -> Tuple[Callable, torch.dtype]:
    """``stylize-video``'s program: the ``--method`` net, seeded by
    ``--seed`` or loaded from ``--ckpt-dir``, cast whole to bf16 with
    ``--bf16``. Returns (x in [0, 1] → clamp(net(x) / 255, 0, 1), its dtype)."""
    torch.manual_seed(args.seed)
    net = method_net(args.method, args.n_styles)
    if args.ckpt_dir:
        net.load_state_dict(load_state(args.ckpt_dir))
    dtype = BF16 if args.bf16 else torch.float32
    net = net.to(device=device, dtype=dtype).eval()
    sid = torch.tensor(args.sid, device=device)

    def stylize(x):
        _, out = net(x, args.strength, sid)
        return (out / 255.0).clamp(0.0, 1.0)

    return stylize, dtype


@torch.no_grad()
def stylize_frames(stylize: Callable, frames: np.ndarray, batch_size: int, dtype: torch.dtype,
                   device: torch.device) -> Tuple[np.ndarray, float]:
    """``stylize-video``'s timed loop: frames (T, H, W, 3) float32 through
    ``stylize`` in chunks of ``batch_size`` (the tail chunk padded, so every
    call has one shape), each copied to ``device`` in ``dtype`` and back.
    Returns (the styled frames, float32 (T, H, W, 3); the wall seconds, with
    a synchronize before the clock is read at each end)."""
    T, B = frames.shape[0], batch_size
    outs = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(0, T, B):
        chunk = frames[i:i + B]
        n = chunk.shape[0]
        if n < B:
            chunk = np.concatenate([chunk, np.zeros((B - n,) + chunk.shape[1:], chunk.dtype)])
        x = torch.from_numpy(chunk).to(device).permute(0, 3, 1, 2).to(dtype).contiguous()
        outs.append(stylize(x)[:n].float().permute(0, 2, 3, 1).cpu().numpy())
    _sync(device)
    return np.concatenate(outs), time.perf_counter() - t0


@torch.no_grad()
def cmd_stylize_video(args) -> Dict:
    if args.method == "ruder":
        raise SystemExit("stylize-video: Ruder's net takes flow and masks; use eval-sintel")
    device = _device(args)
    set_f32_precision()
    frames = source_frames(args)
    T, H, W = frames.shape[:3]
    H4, W4 = H // 4 * 4, W // 4 * 4  # FastStyleNet needs multiples of 4
    frames = np.ascontiguousarray(frames[:, :H4, :W4])
    stylize, dtype = video_stylizer(args, device)
    B = args.batch_size
    os.makedirs(args.out_dir, exist_ok=True)
    stylize(torch.zeros((B, 3, H4, W4), dtype=dtype, device=device))  # warm, outside the clock
    styled, wall = stylize_frames(stylize, frames, B, dtype, device)
    styled = (styled * 255).astype(np.uint8)

    for i, f in enumerate(styled):
        write_png(os.path.join(args.out_dir, f"frame_{i:05d}.png"), f)
    try:
        vpath, writer = _writer(os.path.join(args.out_dir, "styled.mp4"), fps=18)
    except ImportError as e:
        vpath = None
        print(f"stylize-video: no video written, imageio is not installed ({e})", flush=True)
    else:
        with writer:
            for f in styled:
                writer.append_data(f)
    line = {"frames": int(T), "hw": [H4, W4], "batch_size": B,
            "dtype": "bfloat16" if args.bf16 else "float32", "wall_s": round(wall, 3),
            "frames_per_sec": round(T / wall, 2), "video": vpath}
    print(json.dumps(line))
    return line


def cmd_bench(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(json.dumps(bench.run()))


def cmd_bench_raft(args) -> None:
    results = bench_raft(args.hw, args.raft_iters, args.iters, args.seed, args.variants,
                         args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "raft_timing.json"), "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    print(json.dumps(results))


def _add_common(p, hw=(64, 64)) -> None:
    """vst's common flags (``vst/cli/__main__.py:25-36``) that these commands
    read; ``--device`` takes the place of vst's ``--platform``."""
    p.add_argument("--device", default="cuda")
    p.add_argument("--hw", type=int, nargs=2, default=hw)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="runs/latest")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vst_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("eval-sintel", help="TCL-ST / TCL-LT / DT video benchmark")
    _add_common(s)
    s.add_argument("--family", default="faststyle",
                   choices=["faststyle", "stargan", "stargan2", "cyclegan"])
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--pre-style-ckpt", default="runs/johnson.pt",
                   help="Ruder's frame-0 bootstrap, a FastStyleNet state_dict file "
                        "(fs_ruder.py:25-34); a seeded net when the file is absent")
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--sintel-dir", default=None)
    s.add_argument("--ckpt-dir", default=None,
                   help="the method's FastStyleNet state_dict file (reference key names)")
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--raft-ckpt", default=None, help="the reference's RAFT state_dict file")
    s.add_argument("--raft-bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bf16 RAFT encoders (default off: vst turns them on only on a TPU)")
    s.add_argument("--dt-iters", type=int, default=20)
    s.set_defaults(fn=cmd_eval_sintel)

    s = sub.add_parser("stylize-video", help="offline batch video stylization")
    _add_common(s)
    s.add_argument("--batch-size", type=int, default=4)
    s.add_argument("--source", default=None,
                   help="video file or frame dir (both read through cv2), or omit for "
                        "a synthetic clip")
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--ckpt-dir", default=None, help="a FastStyleNet state_dict file")
    s.add_argument("--sid", type=int, default=0)
    s.add_argument("--strength", type=float, default=1.0)
    s.add_argument("--n-frames", type=int, default=24,
                   help="synthetic clip length when no --source")
    s.add_argument("--bf16", action="store_true")
    s.set_defaults(fn=cmd_stylize_video)

    s = sub.add_parser("bench", help="styled frames/s of FastStyleNet at 436x1024")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("bench-raft", help="RAFT pair program timing")
    _add_common(s, hw=(436, 1024))
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--iters", type=int, default=5, help="timing loop length")
    s.add_argument("--variants", nargs="+", choices=tuple(RAFT_VARIANTS),
                   default=list(RAFT_VARIANTS))
    s.set_defaults(fn=cmd_bench_raft)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
