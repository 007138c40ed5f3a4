"""vst_torch command line, port of ``vst/cli/__main__.py``: the feed-forward
family's training and evaluation, and the benchmarks.

    python -m vst_torch.cli train-faststyle [--method johnson|dumoulin|huang|reconet|ruder]
                                            [--hw 256 256] [--batch-size 16] [--steps N]
                                            [--data-dir DIR [--device-cache N]]
    python -m vst_torch.cli train-stargan2 [--hw 256 256] [--batch-size 8] [--steps N]
                                           [--lambda-tcl 100] [--compute-dtype bfloat16]
                                           [--data-dir ROOT [--device-cache N]]
    python -m vst_torch.cli train-stargan [--hw 128 128] [--batch-size 16] [--n-critic 5]
    python -m vst_torch.cli train-cyclegan [--variant cyclegan|cyclegan_con|mogan|congan]
                                           [--hw 256 256] [--batch-size 4] [--sid 1]
                                           [--compute-dtype bfloat16]
                                           [--data-dir ROOT [--device-cache N]]
    python -m vst_torch.cli eval-sintel [--family faststyle|stargan|stargan2|cyclegan]
                                        [--method johnson|dumoulin|huang|reconet|ruder]
                                        [--hw 436 1024] [--sintel-dir DIR] [--raft-bf16]
    python -m vst_torch.cli stylize-video [--source DIR|VIDEO] [--batch-size 8] [--bf16]
    python -m vst_torch.cli eval-obst [--hw 436 1024] [--iters-pyr 50 40 30]
                                      [--lambda-tcl 0 2000] [--obst-bf16] [--sintel-dir DIR]
    python -m vst_torch.cli eval-fc2 [--family stargan2|stargan|obst|faststyle]
                                     [--mode latent|reference] [--method johnson|…|ruder]
                                     [--hw 256 256] [--data-dir DIR]
    python -m vst_torch.cli datagen-fc2 [--n-samples 64] [--hw 256 256] [--out-dir DIR]
    python -m vst_torch.cli datagen-styled [--n-samples 8] [--hw 64 64] [--iters 50 40 30]
    python -m vst_torch.cli datagen-corpus [--n-samples 512] [--hw 256 256] [--batch-size 16]
                                           [--styler gatys|procedural] [--iters 30 25 20]
    python -m vst_torch.cli bench
    python -m vst_torch.cli bench-raft [--hw 436 1024] [--iters 5] [--out-dir DIR]
    python -m vst_torch.cli demo [--source webcam|VIDEO] [--method huang] [--n-frames 60]
                                 [--ckpt-dir FILE|DIR] [--show]
    python -m vst_torch.cli demo-web [--port 8600] [--max-frames N] [--source VIDEO|INDEX]
    python -m vst_torch.cli align-faces --input-dir DIR --output-dir-align DIR [--img-size 256]
                                        [--wing-ckpt FILE] [--lm-path celeba_lm_mean.npz]

Every command runs on CUDA unless given ``--device cpu``; without a card it
stops. Float32 runs with TF32 off; RAFT's lookup goes through the
corr_lookup kernel on CUDA. Weights are random, from seeds, unless a
checkpoint is given. Checkpoints are torch ``state_dict`` files with the
reference's key names (vst's flags read orbax directories, which need jax).

``train-faststyle``: perceptual training (``vst_torch.train.faststyle``) on
FC2-layout ``.npy`` files (``--data-dir``; with ``--device-cache N`` the
first N samples are uploaded to the card once and batches are drawn there) or,
without them, on synthetic affine-motion batches made on the host. The VGG16
is He-randomized from ``--seed`` and the styles procedural unless
``--style-dir`` holds the paintings (no weights or paintings ship with the
repository). Prints vst's line every ``--log-every`` steps, writes
``losses.txt`` and ``loss_list.npy``, saves the net's ``state_dict`` to
``<out-dir>/model.pt`` every ``--ckpt-every`` steps and at the end (what
``eval-sintel`` / ``stylize-video --ckpt-dir`` and ``--pre-style-ckpt``
read), and ends with one JSON line: the device step (CUDA events around each
step, the median after 3 warm-up steps; the host clock on the CPU),
images/s, the host's time to make a batch, peak memory, first and last loss.

``train-stargan2``: StarGAN v2 (``vst_torch.train.stargan2``; ``--lambda-tcl
100`` is AdvCon, ``--compute-dtype bfloat16`` vst's bf16 policy) and
``train-stargan``: StarGAN v1 (WGAN-GP, a G step every ``--n-critic``
iterations; D's depth capped at log2(H) − 1). Batches come from the device
cache (``--data-dir`` holding ``styled-files``, ``styled-files3`` and
``DATAFiles``, with ``--device-cache N``: N names uploaded once, batches
drawn on the card), the corpus read on the host (v2, ``--data-dir`` without
the cache: its 97 % train split) or synthetic affine-motion batches made on
the host. Both print vst's log line every ``--log-every`` iterations, write
``losses.txt`` and torch checkpoints every ``--ckpt-every`` iterations and at
the end: v2 ``<out-dir>/{step:06d}_nets.ckpt`` (a dict of the state_dicts
``generator``, ``mapping_network``, ``style_encoder``, ``discriminator``)
and ``{step:06d}_nets_ema.ckpt`` (the EMA nets, the first three), as the
reference's CheckpointIO names them; v1 ``<out-dir>/{step}-G.ckpt`` and
``{step}-D.ckpt`` (one state_dict each, the reference's names). v2 writes a
debug grid ``sample_{step:06d}.png`` every ``--sample-every`` iterations. Each
ends with one JSON line: the iteration time (CUDA events around each
iteration, the median after 3 warm-up iterations; the host clock on the
CPU), images/s, peak memory, the first and last losses.

``train-cyclegan``: the CycleGAN family (``vst_torch.train.cyclegan``):
``--variant`` cyclegan, cyclegan_con (+ the ground-truth-flow temporal
loss), mogan (motion translators, RAFT in the step, E and M steps in turn)
or congan (fusion blocks, RAFT in the step); one model a style ``--sid``;
resnet_9blocks and the 70×70 PatchGAN at ``--ngf`` / ``--ndf``, pool 50,
the linear schedule over epochs of max(steps // 2, 1) iterations. RAFT
(``--raft-iters``, ``--raft-ckpt``, ``--raft-bf16``) runs in float32 under
``--compute-dtype bfloat16`` too. Batches come from the device cache
(``--data-dir`` with ``--device-cache N``), the corpus read on the host
(``--data-dir``: ``CycleGANFC2Dataset``) or vst's synthetic batches (B's
second frame is its first, as vst's). Prints vst's line every
``--log-every`` iterations (the union of the E and M steps' losses), writes
``losses.txt`` and junyanz's ``<out-dir>/{step}_net_{name}.pth`` (one
state_dict a net) every ``--ckpt-every`` iterations and at the end, and
ends with one JSON line: the E step's (and MoGAN's M step's) median time
by CUDA events after 3 warm-up iterations (the host clock on the CPU),
images/s, peak memory, the first and last losses.

``eval-sintel``: TCL-ST / TCL-LT / DT of the FastStyleNet family on Sintel
(``--sintel-dir``) or, without it, on an 8-frame synthetic affine-motion
clip scored with its exact flow (random RAFT weights would fail the
fb-consistency check everywhere). ``--family stargan2`` scores StarGAN v2's
EMA nets (``--ckpt-dir``: a ``_nets_ema.ckpt`` file) at vst's 256-pixel
configuration, styles = domains 1 … D−1 with seeded latents, the clip cropped
to multiples of 16; ``--family stargan`` StarGAN v1's G (``--ckpt-dir``: a
``-G.ckpt`` file) at conv_dim 64; ``--family cyclegan`` one model a style
(``--ckpt-dir``: a comma list of ``variant:dir``, a bare dir meaning
cyclegan; each dir's newest ``{step}_net_G_A.pth``, its width and depth read
from the file). All three feed RAFT [−1, 1] frames, as vst.
Johnson, Dumoulin, Huang and ReCoNet share
the 3-input net and the generic harness; Ruder runs its streaming protocol
with a 7-input net and a 3-input frame-0 bootstrap (``--pre-style-ckpt``, a
seeded net without it). ``--raft-bf16`` runs RAFT's encoders in bfloat16
(off by default: vst turns it on only on a TPU). Prints the summary dict
and writes the JSONs to ``--out-dir``.

``stylize-video``: a frame directory or a video file (both through cv2) or
the synthetic clip, cropped to multiples of 4, stylized in chunks of ``--batch-size`` (the
tail chunk padded), ``--bf16`` casting the whole net; writes PNGs and a video (an mp4
through imageio's ffmpeg backend, else vst's GIF, through PIL where imageio
is not installed), and prints a JSON line of throughput.

``eval-obst``: OBST (L-BFGS on the image against a caffe VGG19's Grams,
coarse to fine over the pyramid that ``--iters-pyr`` sets under ``--hw``)
streamed over Sintel (``--sintel-dir``) or, without it, ``--n-videos``
synthetic affine-motion clips of ``--n-frames`` frames scored through RAFT,
once per ``--lambda-tcl``, for the first ``--n-styles`` of the 3 styles;
``--obst-bf16`` runs the VGG in bfloat16 (Grams
and losses accumulate in float32). Writes ``<out-dir>/<λ>/{TCL-ST,TCL-LT,DT,
RAFT-MS}.json`` and merges a ``summary.json`` (DT of ``obst.run`` alone,
TCL means, RAFT ms, wall seconds and, on a card, peak memory, per λ).

``eval-fc2``: the FC2 metrics on the eval split of a corpus (``--data-dir``
holding ``DATAFiles``, ``styled-files``, ``styled-files3``) or on 4 synthetic
batches of ``--batch-size``. ``--family obst`` runs OBST's protocol (TCL,
FID) once per ``--obst-lambdas`` into ``<out-dir>/<λ>/``; ``--family
faststyle`` scores ``--method``'s net (``--ckpt-dir``, a state_dict file, or
a seeded net) with TCL / FID / LPIPS through the harness, or, for Ruder, its
two-frame protocol. ``--family stargan2`` scores StarGAN v2's EMA nets with a
latent (``--mode latent``) or a reference image's style (``--mode
reference``), ``--family stargan`` v1's G (deterministic: LPIPS skipped);
``--ckpt-dir`` as for eval-sintel. InceptionV3 and AlexNet are vst's seeded He-randomized
nets (no weights ship with the repository), labelled "random-he" in the
JSONs; InceptionV3 needs images of 75×75 or more.

``bench`` runs ``vst_torch.bench``. ``bench-raft`` times the Sintel eval
path's RAFT pair program, forward and backward flow of one frame pair in one
call at batch 2 (``vst/eval/sintel.py:compute_raft_pair``), per variant:
``f32``, ``bf16_enc`` (bf16 encoders), ``bf16_full`` (bf16 encoders and
update block), each with InputPadder to multiples of 8, and ``f32_pad64`` /
``bf16_full_pad64`` with multiples of 64; the x2 / x4 direction-batch slope
for ``f32`` and ``bf16_full_pad64``; and each variant's flow against
``f32``'s. It prints one JSON line and writes it to
``<out-dir>/raft_timing.json``. Every variant gets the same weights.

``datagen-fc2`` writes ``--n-samples`` FC2 ``.npy`` files
(``vst_torch.data.datagen.pack_fc2_npy``) to ``--out-dir``; ``datagen-styled``
styles ``--n-samples`` texture crops with OBST (the seeded VGG) for each of
the 3 styles into ``<out-dir>/style{k}``; ``datagen-corpus`` writes the
corpus that the trainers' ``--data-dir`` reads (``DATAFiles``,
``styled-files``, ``styled-files3``), styled by OBST in batches of
``--batch-size`` on the device or, with ``--styler procedural``, by fixed
pixelwise transforms on the host (no device, no weights).

Every subcommand accepts vst's common flags (``--steps``, ``--batch-size``,
``--log-every``, ``--ckpt-every``, ``--data-dir``, ``--device-cache``); one
that a command does not read is ignored, and its help says so.

``demo`` (``vst_torch.cli.demo``) stylizes ``--n-frames`` frames of a webcam,
a video file or vst's synthetic clip one by one with ``--method``'s net
(``ruder`` runs Huang's; seeded, or ``--ckpt-dir``: a state_dict file or a
``train-faststyle`` out-dir), writes ``<out-dir>/demo.mp4`` (or vst's GIF),
prints vst's line and one JSON line (frames, size, FPS readout, file);
``--show`` opens an OpenCV window with vst's keys. ``demo-web``
(``vst_torch.cli.webdemo``) serves vst's browser page on 127.0.0.1:``--port``
over the same net and stops after ``--max-frames`` frames when given.
``align-faces`` aligns every image of ``--input-dir`` to the landmark
template with the FAN (``--wing-ckpt``, the reference's ``wing.ckpt``
state_dict, or a net seeded by ``--seed``; ``--lm-path`` the template, the
synthetic one otherwise), writes each under its name in
``--output-dir-align``, prints vst's line and one JSON line (count,
``--img-size``, seconds).

With ``VST_PROFILE_DIR`` set, ``bench`` and the Sintel evaluation write a
torch.profiler trace there (``vst_torch.core.trace``).
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
from vst_torch.core.checkpoint import LAYOUTS, Checkpointer
from vst_torch.core.metrics import MetricsLogger
from vst_torch.core.timing import windows_ms
from vst_torch.core.trace import count, span
from vst_torch.data.device_cache import DeviceFC2Cache, DeviceStyledCache
from vst_torch.data.fc2 import (CycleGANFC2Dataset, DatasetFC2, FC2Loader, synthetic_fc2_batches,
                                train_eval_split)
from vst_torch.data.datagen import generate_fc2_corpus, generate_styled_dataset, pack_fc2_npy
from vst_torch.data.loader import NpyDirDataset
from vst_torch.data.styles import load_style_images
from vst_torch.data.synthetic import MARGIN, AffineMotionGenerator, _texture, synthetic_batch
from vst_torch.eval.drivers import (evaluate_fc2_obst, evaluate_fc2_ruder,
                                    evaluate_sintel_cyclegan, evaluate_sintel_faststyle,
                                    evaluate_sintel_obst, evaluate_sintel_ruder,
                                    evaluate_sintel_stargan, evaluate_sintel_stargan2)
from vst_torch.eval.fc2 import calculate_metrics
from vst_torch.eval.sintel import SintelVideo, load_sintel_videos
from vst_torch.eval.video import _writer, translate_and_reconstruct, write_png
from vst_torch.flow.raft import RAFT
from vst_torch.metrics.fid import InceptionV3
from vst_torch.models.cyclegan import ResnetGenerator
from vst_torch.models.gatys import OBST
from vst_torch.models.stargan import Generator as StarGANGenerator
from vst_torch.ops.image import InputPadder, resize_bilinear
from vst_torch.train.cyclegan import (VARIANTS, CycleGANConfig, CycleGANTrainer, cyclegan_batch,
                                      fc2_to_cyclegan)
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.registry import FASTSTYLE_METHODS, bootstrap_net, method_net, select_method
from vst_torch.train.stargan import StarGANConfig, StarGANTrainer
from vst_torch.train.stargan2 import (StarGAN2Config, StarGAN2Trainer, gan_batch,
                                      nets_from_state_dicts)

BF16 = torch.bfloat16
# variant name → (encoder dtype, update dtype, InputPadder multiple)
RAFT_VARIANTS = {"f32": (None, None, 8), "bf16_enc": (BF16, None, 8),
                 "bf16_full": (BF16, BF16, 8), "f32_pad64": (None, None, 64),
                 "bf16_full_pad64": (BF16, BF16, 64)}
SLOPE_VARIANTS = ("f32", "bf16_full_pad64")
CKPT_NAME = LAYOUTS["faststyle"].format(name="model")  # train-faststyle's in --out-dir
WARMUP_STEPS = 3  # train-faststyle's steps left out of the median step time


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
    big = (hw[0] + MARGIN, hw[1] + MARGIN)
    frames, _, _ = gen.generate(_texture(rng, big), n_frames=n_frames)
    return frames, gen


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file of any name through the ``Checkpointer``: a
    ``state_dict`` with a DataParallel ``module.`` prefix stripped and batch
    norms' ``num_batches_tracked`` dropped, or a dict of them."""
    return Checkpointer.file(path).restore(None, state=None)["state"]


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


def stargan2_eval_nets(args, cfg: StarGAN2Config, device: torch.device):
    """StarGAN v2's EMA nets for evaluation: from the ``--ckpt-dir`` file (a
    ``_nets_ema.ckpt`` dict of state_dicts) or a seeded trainer's (its EMA
    copies of the initial nets, as vst's ``state.ema``)."""
    if args.ckpt_dir:
        return nets_from_state_dicts(cfg, load_state(args.ckpt_dir), device)
    return {k: net.eval() for k, net in StarGAN2Trainer(cfg, args.seed, device).ema.items()}


def stargan_eval_generator(args, cfg: StarGANConfig, device: torch.device):
    """StarGAN v1's G: the ``--ckpt-dir`` file (a ``-G.ckpt`` state_dict) or a
    seeded trainer's (``StarGANTrainer`` builds G first from the seed)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        g = StarGANGenerator(cfg.conv_dim, cfg.c_dim, cfg.repeat_num)
    if args.ckpt_dir:
        g.load_state_dict(load_state(args.ckpt_dir))
    return g.to(device).eval()


def cyclegan_eval_generators(ckpt_dirs: str, device: torch.device):
    """The G_A of each ``variant:dir`` of ``--ckpt-dir`` (a bare dir is
    variant cyclegan): the dir's newest ``{step}_net_G_A.pth``, a resnet
    generator of the file's width and depth."""
    gens = []
    for spec in filter(None, ckpt_dirs.split(",")):
        variant, _, d = spec.rpartition(":")
        if (variant or "cyclegan") not in VARIANTS:
            raise SystemExit(f"--ckpt-dir: unknown variant {variant!r}")
        ckpt = Checkpointer(d, LAYOUTS["cyclegan"])
        steps = [step for step, name in ckpt.entries() if name == "G_A"]
        if not steps:
            raise SystemExit(f"--ckpt-dir: no <step>_net_G_A.pth in {d}")
        sd = ckpt.restore(max(steps), G_A=None)["G_A"]
        n_blocks = len({k.split(".")[1] for k in sd if ".conv_block." in k})
        g = ResnetGenerator(3, 3, sd["model.1.weight"].shape[0], n_blocks)
        g.load_state_dict(sd)
        gens.append(g.to(device).eval())
    return gens


def cmd_eval_sintel(args) -> Dict:
    if args.family == "cyclegan" and not any((args.ckpt_dir or "").split(",")):
        raise SystemExit("--ckpt-dir required for family=cyclegan")  # no model in the list
    device = _device(args)
    set_f32_precision()
    if args.family == "stargan2":
        # the generator needs multiples of 16; the reference crops Sintel to
        # 432 rows for the same reason (sintel_eval.py:82-88)
        args.hw = [args.hw[0] // 16 * 16, args.hw[1] // 16 * 16]
    videos, flow_fn = _eval_videos(args)
    raft_apply = _make_raft(args, device)
    kw = dict(out_path=args.out_dir, dt_iters=args.dt_iters, flow_fn=flow_fn, device=device)
    if args.family == "stargan2":  # vst's 256-pixel configuration, the EMA nets
        nets = stargan2_eval_nets(args, StarGAN2Config(img_size=256,
                                                       num_domains=args.num_domains), device)
        results = evaluate_sintel_stargan2(nets["generator"], nets["mapping"], videos,
                                           raft_apply, num_domains=args.num_domains, **kw)
    elif args.family == "stargan":
        g = stargan_eval_generator(args, StarGANConfig(c_dim=args.num_domains), device)
        results = evaluate_sintel_stargan(g, videos, raft_apply, c_dim=args.num_domains, **kw)
    elif args.family == "cyclegan":  # one model a style (fc2_eval.py:248-251)
        results = evaluate_sintel_cyclegan(cyclegan_eval_generators(args.ckpt_dir, device),
                                           videos, raft_apply, **kw)
    else:
        results = _eval_sintel_faststyle(args, videos, raft_apply, kw, device)
    print({k: v[f"{k}_mean"] for k, v in results.items()})
    return results


def _eval_sintel_faststyle(args, videos, raft_apply, kw, device):
    torch.manual_seed(args.seed)
    net = method_net(args.method, args.n_styles).to(device)
    state = load_state(args.ckpt_dir) if args.ckpt_dir else net.state_dict()
    kw = dict(kw, styles=list(range(max(args.n_styles, 3))))
    if args.method == "ruder":
        pre = _load_pre_style(args, device)
        return evaluate_sintel_ruder(net, state, pre, pre.state_dict(), videos, raft_apply, **kw)
    return evaluate_sintel_faststyle(net, state, videos, raft_apply, **kw)


def obst_pyramid(hw, iters_pyr) -> Tuple[Tuple[int, int], ...]:
    """vst's pyramid: one level per ``--iters-pyr`` entry, halving down from
    ``hw`` (``vst/cli/__main__.py:869-871``)."""
    H, W = hw
    L = len(iters_pyr)
    return tuple((H >> (L - 1 - i), W >> (L - 1 - i)) for i in range(L))


def _obst(args, device: torch.device) -> OBST:
    return OBST(max_iters=tuple(args.iters_pyr), seed=args.seed,
                compute_dtype=BF16 if args.obst_bf16 else torch.float32, device=device)


def _obst_videos(args):
    """Sintel from ``--sintel-dir``, or vst's synthetic clips: one texture
    generator for all, a motion generator seeded per video."""
    if args.sintel_dir:
        return load_sintel_videos(args.sintel_dir)[:args.n_videos]
    rng = np.random.RandomState(args.seed)
    H, W = args.hw
    videos = []
    for v in range(args.n_videos):
        gen = AffineMotionGenerator(crop_hw=(H, W), seed=args.seed + v)
        frames, _, _ = gen.generate(_texture(rng, (H + MARGIN, W + MARGIN)),
                                    n_frames=args.n_frames)
        videos.append(SintelVideo(f"synthetic_{v + 1}", frames))
    return videos


def cmd_eval_obst(args) -> Dict:
    """OBST on Sintel at each ``--lambda-tcl`` (``obst_eval.py:413-566``),
    and a ``summary.json`` merged into the one already in ``--out-dir``."""
    device = _device(args)
    set_f32_precision()
    videos = _obst_videos(args)
    raft = _make_raft(args, device)
    raft_apply = torch.no_grad()(lambda a, b: raft(a, b))
    styles = load_style_images(args.style_dir, size=256)[:args.n_styles]
    pyr = obst_pyramid(args.hw, args.iters_pyr)
    obst = _obst(args, device)
    summary = {
        "hw": list(args.hw), "n_videos": args.n_videos, "n_frames": args.n_frames,
        "iters_pyr": list(args.iters_pyr), "vgg_backbone": "random-he",
        "device": device_name(device),
        "obst_dtype": "bfloat16" if args.obst_bf16 else "float32",
        "methodology": (
            "DT wraps obst.run alone (the reference's t_start/t_end, obst_eval.py:524-531), "
            "timed by CUDA events between two synchronize() calls on a card and by the host "
            "clock on the CPU; per-frame RAFT (forward and backward, and the t-5 pair) runs "
            "outside it and is RAFT_ms_mean. L-BFGS runs the reference driver's closure-call "
            "counts: [50,40,30] -> [60,60,40] (vst_torch.ops.lbfgs.torch_eval_counts)."),
    }
    for wt in args.lambda_tcl:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        res = evaluate_sintel_obst(obst, videos, raft_apply, styles, pyr, weight_tcl=float(wt),
                                   out_path=os.path.join(args.out_dir, str(int(wt))))
        entry = summary[str(int(wt))] = {
            "DT_ms_mean": float(np.mean(list(res["DT"].values()))),
            "TCL-ST_mean": float(np.mean(list(res["TCL-ST"].values()))),
            "TCL-LT_mean": float(np.mean(list(res["TCL-LT"].values()))),
            "RAFT_ms_mean": (float(np.mean(list(res["RAFT-MS"].values())))
                             if "RAFT-MS" in res else None),
            "wall_s": time.time() - t0,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None)}
        print(f"lambda_tcl={wt}: TCL-ST {entry['TCL-ST_mean']:.4f} "
              f"DT {entry['DT_ms_mean']:.0f} ms/frame", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    # merge: runs at other λ (or dtypes) write into the same summary
    summary_path = os.path.join(args.out_dir, "summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = {**json.load(f), **summary}
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    return summary


def _fc2_eval_batches(args, num_dom: int):
    """The eval split of the corpus at ``--data-dir`` (``DATAFiles`` and the
    two styled trees), else 4 synthetic batches."""
    if args.data_dir and os.path.isdir(os.path.join(args.data_dir, "DATAFiles")):
        ds = DatasetFC2(*(os.path.join(args.data_dir, d)
                          for d in ("DATAFiles", "styled-files", "styled-files3")),
                        num_dom=num_dom, base_len=None)
        _, ev = train_eval_split(len(ds), split=args.split, seed=args.seed)
        return list(FC2Loader(ds, ev, args.batch_size, seed=args.seed).epoch(shuffle=False))
    return synthetic_fc2_batches(4, args.batch_size, hw=tuple(args.hw), num_dom=num_dom,
                                 seed=args.seed)


def _fc2_obst(args, batches, num_dom: int, device: torch.device) -> Dict:
    """OBST's own FC2 protocol (``obst_eval.py:570-724``), TCL and FID, one
    out-subdir per ``--obst-lambdas`` (the reference's eval_fc2/{0,2000})."""
    for b in batches:  # the harness speaks [−1, 1]; OBST takes [0, 1]
        for k in ("x_src", "x2_src", "x_ref"):
            b[k] = (np.asarray(b[k]) + 1.0) / 2.0
    styles = load_style_images(args.style_dir, size=256)[:3]
    obst = _obst(args, device)
    inception = InceptionV3(seed=0, device=device)
    results = {}
    for wt in args.obst_lambdas:
        res = results[str(int(wt))] = evaluate_fc2_obst(
            obst, batches, styles, obst_pyramid(args.hw, args.iters_pyr), weight_tcl=float(wt),
            num_domains=num_dom, out_dir=os.path.join(args.out_dir, str(int(wt))),
            inception=inception)
        print(f"lambda_tcl={wt}: TCL {res['TCL'].get('TCL/mean', float('nan')):.4f} "
              f"FID {res['FID'].get('FID/mean', float('nan')):.2f}", flush=True)
    return results


def _fc2_stargan2_style_fn(args, num_dom: int, device: torch.device):
    """StarGAN v2's style_fn for the harness: the EMA nets at ``--hw``, the
    style from a latent drawn from the harness's generator (``latent``) or
    from the reference image (``reference``, ``eval.py:128``)."""
    cfg = StarGAN2Config(img_size=args.hw[0], num_domains=num_dom)
    nets = stargan2_eval_nets(args, cfg, device)

    def style_fn(x, y, mode, rng, x_ref):
        if mode == "latent":
            z = torch.randn(x.shape[0], cfg.latent_dim, generator=rng, device=x.device)
            s = nets["mapping"](z, y)
        else:
            s = nets["style_enc"](x_ref, y)
        return nets["generator"](x, s)

    return style_fn


def _fc2_stargan_style_fn(args, num_dom: int, device: torch.device):
    """StarGAN v1's style_fn: G(x, one_hot(y)), deterministic in (x, y)."""
    g = stargan_eval_generator(args, StarGANConfig(c_dim=num_dom, image_size=args.hw[0]),
                               device)

    def style_fn(x, y, mode, rng, x_ref):
        return g(x, torch.nn.functional.one_hot(y, num_dom).to(x.dtype))

    return style_fn


def cmd_eval_fc2(args) -> Dict:
    """The FC2 metrics (the reference's ``--mode fc2`` drivers)."""
    device = _device(args)
    set_f32_precision()
    num_dom = args.num_domains
    batches = _fc2_eval_batches(args, num_dom)
    if args.family == "obst":
        return _fc2_obst(args, batches, num_dom, device)
    if args.family in ("stargan2", "stargan"):
        make = _fc2_stargan2_style_fn if args.family == "stargan2" else _fc2_stargan_style_fn
        return _fc2_harness(args, make(args, num_dom, device), batches, num_dom, device,
                            deterministic=args.family == "stargan")

    args.n_styles = max(num_dom - 1, 1)
    torch.manual_seed(args.seed)
    net = method_net(args.method, args.n_styles).to(device).eval()
    if args.ckpt_dir:
        net.load_state_dict(load_state(args.ckpt_dir))
    if args.method == "ruder":  # its two-frame protocol (fast_style_transfer.py:640-676)
        pre = _load_pre_style(args, device)
        res = evaluate_fc2_ruder(net, net.state_dict(), pre, pre.state_dict(), batches,
                                 num_domains=num_dom, out_dir=args.out_dir, device=device)
        print(f"ruder FC2: TCL {res['TCL'].get('TCL_mean', float('nan')):.4f} "
              f"FID {res['FID'].get('FID_mean', float('nan')):.2f}", flush=True)
        return res

    def style_fn(x, y, mode, rng, x_ref):
        # the net runs [0, 1] → [0, 255]; the harness speaks [−1, 1]; the
        # batch's style is its first sample's target, as in vst
        sid = (y[0] - 1).clamp(min=0)
        out = (net((x + 1.0) / 2.0, 1.0, sid)[1] / 255.0).clamp(0.0, 1.0)
        return out * 2.0 - 1.0

    # a per-style head ignores the rng: within-chunk LPIPS is degenerate
    return _fc2_harness(args, style_fn, batches, num_dom, device, deterministic=True)


def _fc2_harness(args, style_fn, batches, num_dom: int, device: torch.device,
                 deterministic: bool) -> Dict:
    """``calculate_metrics`` at the command's flags; prints each mean."""
    results = calculate_metrics(style_fn, batches, num_domains=num_dom, mode=args.mode,
                                num_outs_per_domain=args.num_outs, out_dir=args.out_dir,
                                rng_seed=args.seed, deterministic=deterministic, device=device)
    for name, d in results.items():
        key = f"{name}_{args.mode}/mean"
        if key in d:
            print(f"{name}: {d[key]:.4f}", flush=True)
    return results


def _train_batches(args, n_frames: int, device: torch.device):
    """``train-faststyle``'s batches: (the source's name, an endless iterator
    of (batch, whether it is a host batch still to be copied))."""
    if args.data_dir and args.device_cache:
        cache = DeviceFC2Cache(args.data_dir, limit=args.device_cache, seed=args.seed,
                               device=device)
        print(f"device cache: {cache.n} samples resident on {device_name(device)}",
              flush=True)

        def cached():
            while True:
                yield cache.sample(args.batch_size), False

        return "device_cache", cached()
    if args.data_dir:
        ds = NpyDirDataset(args.data_dir, args.batch_size)

        def npy_dir():
            while True:  # FC2 tuples have 2 frames; Ruder unrolls what it gets
                for b in ds.epoch():
                    yield b, True

        return "npy_dir", npy_dir()

    def synthetic():
        i = 0
        while True:
            yield synthetic_batch(args.batch_size, hw=tuple(args.hw), n_frames=n_frames,
                                  seed=args.seed + i), True
            i += 1

    return "synthetic", synthetic()


class _StepTimer:
    """Per-step times: CUDA events around each step on a card (read once, at
    the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def __enter__(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.marks.append([start])
        else:
            self.marks.append([time.perf_counter()])

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.marks[-1].append(end)
        else:
            self.marks[-1].append(time.perf_counter())

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def cmd_train_faststyle(args) -> Dict:
    device = _device(args)
    set_f32_precision()
    cfg = select_method(args.method, n_styles=args.n_styles, batch_size=args.batch_size,
                        n_frames=3 if args.method == "ruder" else 2)
    styles = load_style_images(args.style_dir, size=256)[:max(args.n_styles, 1)]
    # Ruder bootstraps frame 0 from a pretrained Johnson / Dumoulin net (fs_ruder.py:25-34)
    pre_style = load_state(args.pre_style_ckpt) if args.pre_style_ckpt else None
    trainer = FastStyleTrainer(cfg, styles, pre_style_state=pre_style, seed=args.seed,
                               device=device)
    source, batches = _train_batches(args, cfg.n_frames, device)
    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out_dir, "losses.txt"))
    ckpt = Checkpointer(args.out_dir, LAYOUTS["faststyle"])
    sids = np.random.RandomState(args.seed)
    timer = _StepTimer(device)
    batch_ms, losses = [], []

    def next_batch():
        t0 = time.perf_counter()
        batch, on_host = next(batches)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        return batch_to_tensors(batch, device) if on_host else batch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_loop = time.perf_counter()
    batch = next_batch()
    for i in range(args.steps):
        sid = int(sids.randint(args.n_styles)) if args.n_styles > 1 else 0
        with timer:
            metrics = trainer.train_step(batch, sid)
        losses.append(metrics["loss"])
        if (i + 1) % args.log_every == 0:
            logger.log(i + 1, **{k: float(v) for k, v in metrics.items()})
            print(f"[{i + 1}/{args.steps}] " + " ".join(
                f"{k}: {float(v):.4f}" for k, v in metrics.items()), flush=True)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            ckpt.save(None, model=trainer.model)
        if i + 1 < args.steps:
            batch = next_batch()
    step_ms = timer.ms()
    wall = time.perf_counter() - t_loop
    logger.save_curves(os.path.join(args.out_dir, "loss_list.npy"))
    losses = torch.stack(losses).cpu().tolist()
    step = float(np.median(step_ms[WARMUP_STEPS:] or step_ms))
    line = {"method": args.method, "hw": list(args.hw), "batch": args.batch_size,
            "steps": args.steps, "source": source, "device": device_name(device),
            "step_ms_median": step, "images_per_s": args.batch_size * 1e3 / step,
            "host_batch_ms_median": float(np.median(batch_ms)),
            "wall_s": wall, "wall_images_per_s": args.batch_size * args.steps / wall,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None),
            "first_loss": losses[0], "last_loss": losses[-1],
            "n_nonfinite": int(sum(not np.isfinite(v) for v in losses)),
            "checkpoint": ckpt.path(None, "model")}
    print(json.dumps(line))
    return {**line, "losses": losses, "step_ms": step_ms, "batch_ms": batch_ms}


def _gan_batches(args, device: torch.device, multidomain: bool):
    """The GAN trainers' batches: (the source's name, an endless iterator of
    FC2 batches: the device cache's tensors, or host numpy). The cache draws
    v1's plain multi-domain batches (``sample_multidomain``, StarGAN/main.py:30)
    or v2's pseudo-pairs (``sample``)."""
    if args.data_dir and args.device_cache:
        cache = DeviceStyledCache(args.data_dir, num_dom=args.num_domains,
                                  limit=args.device_cache, seed=args.seed, device=device)
        print(f"device cache: {cache.n} samples × {cache.num_dom} domains resident on "
              f"{device_name(device)}", flush=True)
        draw = cache.sample_multidomain if multidomain else cache.sample

        def cached():
            while True:
                yield draw(args.batch_size)

        return "device_cache", cached()
    if args.data_dir and not multidomain:  # the corpus' 97 % train split (data_loader.py:295-317)
        ds = DatasetFC2(*(os.path.join(args.data_dir, d)
                          for d in ("DATAFiles", "styled-files", "styled-files3")),
                        num_dom=args.num_domains, base_len=None)
        tr, _ = train_eval_split(len(ds), split=0.97, seed=args.seed)
        loader = FC2Loader(ds, tr, args.batch_size, seed=args.seed)

        def corpus():
            while True:
                yield from loader.epoch()

        return "corpus", corpus()
    if args.data_dir:
        raise SystemExit("train-stargan reads a corpus through --device-cache only")

    def synthetic():
        j = 0
        while True:
            yield from synthetic_fc2_batches(4, args.batch_size, hw=tuple(args.hw),
                                             num_dom=args.num_domains, seed=args.seed + j)
            j += 4

    return "synthetic", synthetic()


def _gan_loop(args, device: torch.device, source: str, batches, iteration: Callable,
              checkpoint: Callable, every: Callable = lambda i, batch: None,
              to_device: Callable = gan_batch) -> Dict:
    """The GAN trainers' loop: ``iteration(i, batch)`` → metrics per
    iteration under ``_StepTimer``, vst's log line and ``losses.txt``,
    ``checkpoint(step)`` every ``--ckpt-every`` and at the end, ``every(i,
    batch)`` after each iteration; ``to_device(batch, device)`` makes the
    trainer's batch. Returns the JSON line's dict with the losses and times."""
    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out_dir, "losses.txt"))
    timer = _StepTimer(device)
    history, written = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_loop = time.perf_counter()
    for i in range(args.steps):
        batch = to_device(next(batches), device)
        with timer:
            metrics = iteration(i, batch)
        history.append(metrics)
        if (i + 1) % args.log_every == 0:
            logger.log(i + 1, **{k: float(v) for k, v in metrics.items()})
            print(f"[{i + 1}/{args.steps}] " + " ".join(
                f"{k}: {float(v):.4f}" for k, v in metrics.items()), flush=True)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            written += checkpoint(i + 1)
        every(i + 1, batch)
    step_ms = timer.ms()
    wall = time.perf_counter() - t_loop
    losses = [{k: float(v) for k, v in m.items()} for m in history]
    it_ms = float(np.median(step_ms[WARMUP_STEPS:] or step_ms))
    return {"hw": list(args.hw), "batch": args.batch_size, "iterations": args.steps,
            "source": source, "device": device_name(device), "iteration_ms_median": it_ms,
            "images_per_s": args.batch_size * 1e3 / it_ms, "wall_s": wall,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None),
            "first_losses": losses[0], "last_losses": losses[-1],
            "n_nonfinite": int(sum(not np.isfinite(v) for m in losses for v in m.values())),
            "checkpoints": written, "iteration_ms": step_ms, "losses": losses}


def _report(line: Dict) -> Dict:
    print(json.dumps({k: v for k, v in line.items() if k not in ("iteration_ms", "losses")}))
    return line


def cmd_train_stargan2(args) -> Dict:
    device = _device(args)
    set_f32_precision()
    cfg = StarGAN2Config(img_size=args.hw[0], num_domains=args.num_domains,
                         style_dim=args.style_dim, latent_dim=args.latent_dim,
                         max_conv_dim=args.max_conv_dim, compute_dtype=args.compute_dtype,
                         lambda_tcl=args.lambda_tcl)
    trainer = StarGAN2Trainer(cfg, seed=args.seed, device=device)
    source, batches = _gan_batches(args, device, multidomain=False)

    def checkpoint(step):
        return Checkpointer(args.out_dir, LAYOUTS["stargan2"]).save(
            step, nets=trainer.state_dicts(), nets_ema=trainer.state_dicts(use_ema=True))

    def sample_grid(step, batch):
        """The EMA nets' debug grid (core/utils.py:122-148)."""
        if step % args.sample_every:
            return
        n = min(4, batch["x_real"].shape[0])
        translate_and_reconstruct(trainer.generate_fn(), trainer.ema["style_enc"],
                                  batch["x_real"][:n], batch["y_org"][:n],
                                  batch["x_ref"][:n], batch["y_trg"][:n],
                                  filename=os.path.join(args.out_dir, f"sample_{step:06d}.png"))

    line = _gan_loop(args, device, source, batches, lambda i, b: trainer.train_iteration(b),
                     checkpoint, sample_grid)
    return _report({"family": "stargan2", "compute_dtype": args.compute_dtype or "float32",
                    "lambda_tcl": args.lambda_tcl, **line})


def cmd_train_stargan(args) -> Dict:
    device = _device(args)
    set_f32_precision()
    H = args.hw[0]
    cfg = StarGANConfig(c_dim=args.num_domains, image_size=H, conv_dim=args.conv_dim,
                        repeat_num=args.repeat_num, n_critic=args.n_critic,
                        d_repeat_num=min(args.repeat_num, int(np.log2(H)) - 1))
    trainer = StarGANTrainer(cfg, seed=args.seed, device=device)
    source, batches = _gan_batches(args, device, multidomain=True)

    def iteration(i, b):
        c_org, c_trg = (torch.nn.functional.one_hot(b[k], cfg.c_dim).float()
                        for k in ("y_org", "y_trg"))
        return trainer.train_iteration(i, b["x_real"], c_org, c_trg)

    def checkpoint(step):
        return Checkpointer(args.out_dir, LAYOUTS["stargan"]).save(step, G=trainer.G, D=trainer.D)

    line = _gan_loop(args, device, source, batches, iteration, checkpoint)
    return _report({"family": "stargan", "n_critic": cfg.n_critic,
                    "g_steps": trainer.counts["G"], **line})


def _cyclegan_batches(args, device: torch.device):
    """(source, an endless iterator of CycleGAN batches): the device cache's
    ``sample_cyclegan`` (``--data-dir`` with ``--device-cache``), the corpus
    read on the host (``--data-dir``: ``CycleGANFC2Dataset`` with mask and
    flow, an epoch a pass, reshuffled with ``--seed`` + epoch), or vst's
    synthetic batches (real_B2 = real_B, as vst's)."""
    if args.data_dir and args.device_cache:
        cache = DeviceStyledCache(args.data_dir, num_dom=max(args.sid + 1, 2),
                                  limit=args.device_cache, seed=args.seed, device=device)
        print(f"device cache: {cache.n} samples resident on {device_name(device)}", flush=True)

        def cached():
            while True:
                yield cache.sample_cyclegan(args.batch_size, args.sid)

        return "device_cache", cached()
    if args.data_dir:
        ds = CycleGANFC2Dataset(args.data_dir, sid=args.sid, with_flow=True)

        def corpus():
            e = 0
            while True:
                yield from ds.epoch(args.batch_size, seed=args.seed + e)
                e += 1

        return "corpus", corpus()

    def synthetic():
        j = 0
        while True:
            for b in synthetic_fc2_batches(4, args.batch_size, hw=tuple(args.hw), num_dom=2,
                                           seed=args.seed + j):
                yield fc2_to_cyclegan(b)
            j += 4

    return "synthetic", synthetic()


def cmd_train_cyclegan(args) -> Dict:
    device = _device(args)
    set_f32_precision()
    raft = _make_raft(args, device) if args.variant in ("mogan", "congan") else None
    cfg = CycleGANConfig(variant=args.variant, ngf=args.ngf, ndf=args.ndf,
                         steps_per_epoch=max(args.steps // 2, 1),
                         compute_dtype=args.compute_dtype)
    trainer = CycleGANTrainer(cfg, raft=raft, seed=args.seed, device=device)
    source, batches = _cyclegan_batches(args, device)
    merged = {}  # MoGAN's E and M steps log different losses: log the union (vst's)

    def iteration(i, b):
        merged.update(trainer.train_iteration(i, b))
        return dict(merged)

    def checkpoint(step):  # junyanz's save_networks names
        return Checkpointer(args.out_dir, LAYOUTS["cyclegan"]).save(step, **trainer.nets)

    line = _gan_loop(args, device, source, batches, iteration, checkpoint,
                     to_device=cyclegan_batch)
    ms = line["iteration_ms"]
    mogan = args.variant == "mogan"

    def median_ms(steps):
        """The median of those iterations after the warm-up (all, if none is)."""
        late = [i for i in steps if i >= WARMUP_STEPS] or steps
        return float(np.median([ms[i] for i in late])) if late else None

    e_ms = median_ms([i for i in range(len(ms)) if not mogan or i % 2 == 0])
    m_ms = median_ms([i for i in range(1, len(ms), 2)]) if mogan else None
    per_iteration = e_ms if m_ms is None else (e_ms + m_ms) / 2
    return _report({"family": "cyclegan", "variant": args.variant,
                    "compute_dtype": args.compute_dtype or "float32", "ngf": args.ngf,
                    "ndf": args.ndf, **line, "e_step_ms_median": e_ms, "m_step_ms_median": m_ms,
                    "images_per_s": args.batch_size * 1e3 / per_iteration,
                    "e_steps": trainer.counts["G"], "m_steps": trainer.counts.get("M", 0)})


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
    a synchronize before the clock is read at each end). While a profiler
    runs it records the spans ``vst.stream.call``, ``vst.stream.upload`` and
    ``vst.stream.download`` and counts ``vst.stream.frames`` and
    ``vst.stream.pageable_bytes`` (both copies; ``vst_torch.core.trace``)."""
    T, B = frames.shape[0], batch_size
    outs = []
    with span("vst.stream.call"):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(0, T, B):
            chunk = frames[i:i + B]
            n = chunk.shape[0]
            if n < B:
                chunk = np.concatenate([chunk, np.zeros((B - n,) + chunk.shape[1:], chunk.dtype)])
            with span("vst.stream.upload"):
                x = torch.from_numpy(chunk).to(device).permute(0, 3, 1, 2).to(dtype).contiguous()
            y = stylize(x)[:n]
            with span("vst.stream.download"):
                outs.append(y.float().permute(0, 2, 3, 1).cpu().numpy())
            count("vst.stream.frames", n)
            count("vst.stream.pageable_bytes", chunk.nbytes + outs[-1].nbytes)
        _sync(device)
        styled = np.concatenate(outs)
    return styled, time.perf_counter() - t0


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
    vpath, writer = _writer(os.path.join(args.out_dir, "styled.mp4"), fps=18)
    with writer:
        for f in styled:
            writer.append_data(f)
    line = {"frames": int(T), "hw": [H4, W4], "batch_size": B,
            "dtype": "bfloat16" if args.bf16 else "float32", "wall_s": round(wall, 3),
            "frames_per_sec": round(T / wall, 2), "video": vpath}
    print(json.dumps(line))
    return line


def cmd_demo(args) -> Dict:
    from vst_torch.cli.demo import run_demo

    device = _device(args)
    set_f32_precision()
    return run_demo(source=args.source, ckpt_dir=args.ckpt_dir, method=args.method,
                    n_styles=args.n_styles, n_frames=args.n_frames, hw=tuple(args.hw),
                    out_path=os.path.join(args.out_dir, "demo"), show=args.show,
                    seed=args.seed, device=device)


def cmd_demo_web(args) -> None:
    from vst_torch.cli.webdemo import run_web_demo

    device = _device(args)
    set_f32_precision()
    run_web_demo(port=args.port, max_frames=args.max_frames, source=args.source,
                 ckpt_dir=args.ckpt_dir, method=args.method, n_styles=args.n_styles,
                 hw=tuple(args.hw), out_path=os.path.join(args.out_dir, "demo"), seed=args.seed,
                 device=device)


def cmd_align_faces(args) -> Dict:
    """``align_faces`` (``StarGANv2Adv/core/wing.py:413-436``): each image of
    ``--input-dir`` read through PIL as RGB, resized to ``--img-size`` square
    (bilinear), aligned, and written under its name as uint8
    (out · 0.5 + 0.5) · 255, truncated."""
    from PIL import Image

    from vst_torch.models.align import FaceAligner
    from vst_torch.models.wing import FAN

    device = _device(args)
    set_f32_precision()
    torch.manual_seed(args.seed)
    fan = FAN()
    if args.wing_ckpt:
        fan.load_state_dict(load_state(args.wing_ckpt))
    ref = np.load(args.lm_path)["mean"].astype(np.float32) if args.lm_path else None
    aligner = FaceAligner(fan.to(device), output_size=args.img_size, ref_landmarks=ref)

    os.makedirs(args.output_dir_align, exist_ok=True)
    names = sorted(os.listdir(args.input_dir))
    size = (args.img_size, args.img_size)
    t0 = time.perf_counter()
    for name in names:
        with Image.open(os.path.join(args.input_dir, name)) as img:
            rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
        x = torch.from_numpy(rgb).to(device).permute(2, 0, 1)[None]
        out = aligner.align(resize_bilinear(x, size, align_corners=False) * 2.0 - 1.0)[0]
        Image.fromarray((np.clip(out * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.output_dir_align, name))
    seconds = time.perf_counter() - t0
    print(f"aligned {len(names)} images → {args.output_dir_align}")
    line = {"aligned": len(names), "img_size": args.img_size, "seconds": seconds,
            "device": device_name(device)}
    print(json.dumps(line), flush=True)
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


def cmd_datagen_fc2(args) -> None:
    pack_fc2_npy(args.out_dir, args.n_samples, hw=tuple(args.hw), seed=args.seed)
    print(f"wrote {args.n_samples} tuples to {args.out_dir}")


def cmd_datagen_styled(args) -> None:
    device = _device(args)
    set_f32_precision()
    rng = np.random.RandomState(args.seed)
    contents = [(f"{i:07d}", _texture(rng, (args.hw[0] + 32, args.hw[1] + 32)))
                for i in range(args.n_samples)]
    styles = load_style_images(args.style_dir, size=256)[:3]
    generate_styled_dataset(contents, styles, args.out_dir,
                            obst=OBST(max_iters=args.iters, device=device),
                            pyr_shapes=((args.hw[0] // 4, args.hw[1] // 4),
                                        (args.hw[0] // 2, args.hw[1] // 2), tuple(args.hw)),
                            batch_size=args.batch_size, device=device)
    print(f"styled {args.n_samples} images into {args.out_dir}")


def cmd_datagen_corpus(args) -> None:
    device = _device(args) if args.styler == "gatys" else torch.device("cpu")
    set_f32_precision()
    generate_fc2_corpus(args.out_dir, args.n_samples, hw=tuple(args.hw),
                        style_dir=args.style_dir, iters=tuple(args.iters),
                        batch_size=args.batch_size, seed=args.seed, styler=args.styler,
                        device=device)
    print(f"corpus of {args.n_samples} pairs × domains in {args.out_dir}")


# vst's common flags besides --hw, --seed and --out-dir (vst/cli/__main__.py:25-44):
# (flag, argparse keywords, help where a command reads it)
_COMMON = (
    ("--steps", {"type": int, "default": 100}, "iterations"),
    ("--batch-size", {"type": int}, "batch size"),
    ("--log-every", {"type": int, "default": 10}, "print the losses every N iterations"),
    ("--ckpt-every", {"type": int, "default": 1000},
     "write the checkpoints every N iterations and at the end"),
    ("--data-dir", {"default": None}, "corpus directory; synthetic batches if omitted"),
    ("--device-cache", {"type": int, "default": 0},
     "upload N corpus samples to the device once (uint8 images and masks, float16 flows) "
     "and draw every batch there; 0 = read each batch on the host"),
)


def _add_common(p, hw=(64, 64), batch_size: int = 4, reads=(), helps=None) -> None:
    """vst's common flags (``vst/cli/__main__.py:25-44``) on a subcommand, so
    that vst's command lines parse; ``--device`` takes the place of vst's
    ``--platform``. ``reads`` names the flags of :data:`_COMMON` the command
    reads, ``helps`` overrides their help; any other is accepted and ignored,
    and its help says so."""
    helps = helps or {}
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--hw", type=int, nargs=2, default=hw)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="runs/latest")
    for flag, kw, text in _COMMON:
        kw = dict(kw, default=batch_size) if flag == "--batch-size" else kw
        if flag not in reads:
            text = "accepted for vst's command lines; this command does not read it"
        p.add_argument(flag, **kw, help=helps.get(flag, text))


_TRAIN_FLAGS = ("--steps", "--batch-size", "--log-every", "--ckpt-every", "--data-dir",
                "--device-cache")


def _add_gan_common(p, hw, batch_size: int, ckpt_every: str) -> None:
    """The GAN trainers' common flags: every one of vst's is read."""
    _add_common(p, hw=hw, batch_size=batch_size, reads=_TRAIN_FLAGS, helps={
        "--ckpt-every": ckpt_every,
        "--data-dir": "corpus root (styled-files, styled-files3, DATAFiles); synthetic "
                      "batches if omitted"})


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vst_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("train-faststyle", help="Johnson/Dumoulin/Huang/ReCoNet/Ruder training")
    _add_common(s, reads=_TRAIN_FLAGS, helps={
        "--ckpt-every": f"save the net's state_dict to <out-dir>/{CKPT_NAME} every N steps "
                        "and at the end",
        "--data-dir": "FC2 DATAFiles dir ((1, H, W, 9) .npy per sample); synthetic "
                      "batches if omitted"})
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--n-styles", type=int, default=1,
                   help="styles of one net; each step's style is drawn from "
                        "np.random.RandomState(--seed) (vst draws it from numpy's global "
                        "generator)")
    s.add_argument("--style-dir", default=None)
    s.add_argument("--pre-style-ckpt", default=None,
                   help="Ruder's frame-0 bootstrap, a trained Johnson/Dumoulin FastStyleNet "
                        "state_dict file (fs_ruder.py:25-34); a seeded net without it")
    s.set_defaults(fn=cmd_train_faststyle)

    ckpt_every = ("write the checkpoints every N iterations and at the end; torch files with "
                  "the reference's key names (vst writes orbax directories, which need jax)")
    s = sub.add_parser("train-stargan2", help="StarGAN v2 Adv / AdvCon training")
    _add_gan_common(s, hw=(256, 256), batch_size=8, ckpt_every=ckpt_every)
    s.add_argument("--num-domains", type=int, default=4)
    s.add_argument("--style-dim", type=int, default=64)
    s.add_argument("--latent-dim", type=int, default=16)
    s.add_argument("--max-conv-dim", type=int, default=512)
    s.add_argument("--lambda-tcl", type=float, default=0.0, help="100 = AdvCon")
    s.add_argument("--sample-every", type=int, default=1000,
                   help="debug sample grid interval (core/utils.py:122-148)")
    s.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"],
                   help="vst's bf16 policy (vst_torch.train.policy): casts on entry to each "
                        "loss, float32 masters, norms and loss reductions")
    s.set_defaults(fn=cmd_train_stargan2)

    s = sub.add_parser("train-stargan", help="StarGAN v1 (WGAN-GP) training")
    _add_gan_common(s, hw=(128, 128), batch_size=16, ckpt_every=ckpt_every)
    s.add_argument("--num-domains", type=int, default=4)
    s.add_argument("--conv-dim", type=int, default=64)
    s.add_argument("--repeat-num", type=int, default=6)
    s.add_argument("--n-critic", type=int, default=5)
    s.set_defaults(fn=cmd_train_stargan)

    s = sub.add_parser("train-cyclegan", help="CycleGAN / CycleGANCon / MoGAN / ConGAN training")
    _add_gan_common(s, hw=(256, 256), batch_size=4,
                    ckpt_every="write <out-dir>/{step}_net_{name}.pth (one state_dict a net, "
                               "junyanz's names) every N iterations and at the end")
    s.add_argument("--variant", default="cyclegan", choices=VARIANTS)
    s.add_argument("--ngf", type=int, default=64)
    s.add_argument("--ndf", type=int, default=64)
    s.add_argument("--sid", type=int, default=1,
                   help="style id: one model a style (fc2_dataset.py)")
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--raft-ckpt", default=None, help="the reference's RAFT state_dict file")
    s.add_argument("--raft-bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bf16 RAFT encoders (default off: vst turns them on only on a TPU)")
    s.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"],
                   help="vst's bf16 policy for G and D (vst_torch.train.policy); RAFT and the "
                        "M nets stay float32")
    s.set_defaults(fn=cmd_train_cyclegan)

    s = sub.add_parser("eval-sintel", help="TCL-ST / TCL-LT / DT video benchmark")
    _add_common(s)
    s.add_argument("--family", default="faststyle",
                   choices=["faststyle", "stargan", "stargan2", "cyclegan"])
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--pre-style-ckpt", default="runs/johnson.pt",
                   help="Ruder's frame-0 bootstrap, a FastStyleNet state_dict file "
                        "(fs_ruder.py:25-34); a seeded net when the file is absent")
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--num-domains", type=int, default=4, help="the GAN families' domains")
    s.add_argument("--sintel-dir", default=None)
    s.add_argument("--ckpt-dir", default=None,
                   help="a torch file with the reference's key names: the method's "
                        "FastStyleNet state_dict; StarGAN v2's *_nets_ema.ckpt (a dict of "
                        "state_dicts); StarGAN v1's *-G.ckpt; for the CycleGAN family a comma "
                        "list of variant:dir (each dir's newest {step}_net_G_A.pth)")
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--raft-ckpt", default=None, help="the reference's RAFT state_dict file")
    s.add_argument("--raft-bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bf16 RAFT encoders (default off: vst turns them on only on a TPU)")
    s.add_argument("--dt-iters", type=int, default=20)
    s.set_defaults(fn=cmd_eval_sintel)

    s = sub.add_parser("stylize-video", help="offline batch video stylization")
    _add_common(s, reads=("--batch-size",))
    s.add_argument("--source", default=None,
                   help="video file or frame dir (both read through cv2), or omit for "
                        "a synthetic clip")
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--style-dir", default=None,
                   help="accepted for vst's command lines; stylizing reads no style image")
    s.add_argument("--ckpt-dir", default=None, help="a FastStyleNet state_dict file")
    s.add_argument("--sid", type=int, default=0)
    s.add_argument("--strength", type=float, default=1.0)
    s.add_argument("--n-frames", type=int, default=24,
                   help="synthetic clip length when no --source")
    s.add_argument("--bf16", action="store_true")
    s.set_defaults(fn=cmd_stylize_video)

    s = sub.add_parser("eval-obst", help="OBST TCL-ST / TCL-LT / DT on Sintel")
    _add_common(s)
    s.add_argument("--sintel-dir", default=None)
    s.add_argument("--style-dir", default=None)
    s.add_argument("--n-videos", type=int, default=2)
    s.add_argument("--n-frames", type=int, default=8)
    s.add_argument("--n-styles", type=int, default=3, choices=(1, 2, 3),
                   help="the first N of the 3 styles (vst runs all 3)")
    s.add_argument("--iters-pyr", type=int, nargs="+", default=[50, 40, 30],
                   help="L-BFGS iterations a pyramid level, as the reference configures them "
                        "(run as torch's closure-call counts)")
    s.add_argument("--lambda-tcl", type=float, nargs="+", default=[0.0, 2000.0])
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--raft-ckpt", default=None, help="the reference's RAFT state_dict file")
    s.add_argument("--raft-bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bf16 RAFT encoders (default off: vst turns them on only on a TPU)")
    s.add_argument("--obst-bf16", action="store_true",
                   help="bf16 VGG closures (float32 Gram / loss accumulation)")
    s.set_defaults(fn=cmd_eval_obst)

    s = sub.add_parser("eval-fc2", help="FC2 TCL / FID / LPIPS")
    _add_common(s, reads=("--batch-size", "--data-dir"), helps={
        "--data-dir": "FC2 corpus root (DATAFiles, styled-files, styled-files3); 4 "
                      "synthetic batches if omitted"})
    s.add_argument("--family", default="stargan2",
                   choices=["stargan2", "stargan", "faststyle", "obst"])
    s.add_argument("--method", default="johnson", choices=tuple(FASTSTYLE_METHODS),
                   help="the faststyle family's head")
    s.add_argument("--style-dir", default=None, help="style images (obst family)")
    s.add_argument("--iters-pyr", type=int, nargs="+", default=[50, 40, 30],
                   help="L-BFGS iterations a pyramid level (obst family)")
    s.add_argument("--obst-lambdas", type=float, nargs="+", default=[0.0, 2000.0],
                   help="temporal weights, one out-subdir each (obst family)")
    s.add_argument("--obst-bf16", action="store_true", help="bf16 VGG closures (obst family)")
    s.add_argument("--mode", default="latent", choices=["latent", "reference"])
    s.add_argument("--num-domains", type=int, default=4)
    s.add_argument("--num-outs", type=int, default=3,
                   help="fakes an eval sample (the reference uses 10)")
    s.add_argument("--lambda-tcl", type=float, default=0.0,
                   help="accepted for vst's command lines (vst passes it to StarGAN2Config); "
                        "evaluation reads no training weight")
    s.add_argument("--split", type=float, default=0.97)
    s.add_argument("--ckpt-dir", default=None,
                   help="a torch file with the reference's key names: the method's "
                        "FastStyleNet state_dict; StarGAN v2's *_nets_ema.ckpt (a dict of "
                        "state_dicts); StarGAN v1's *-G.ckpt")
    s.add_argument("--pre-style-ckpt", default="runs/johnson.pt",
                   help="Ruder's frame-0 bootstrap, a FastStyleNet state_dict file "
                        "(fs_ruder.py:25-34); a seeded net when the file is absent")
    s.set_defaults(fn=cmd_eval_fc2)

    s = sub.add_parser("datagen-fc2", help="pack FC2-style .npy training tuples (affine motion)")
    _add_common(s)
    s.add_argument("--n-samples", type=int, default=64)
    s.set_defaults(fn=cmd_datagen_fc2)

    s = sub.add_parser("datagen-styled", help="the Gatys batch styler into the styled-files layout")
    _add_common(s, reads=("--batch-size",), helps={"--batch-size": "images an OBST batch"})
    s.add_argument("--n-samples", type=int, default=8)
    s.add_argument("--style-dir", default=None)
    s.add_argument("--iters", type=int, nargs="+", default=(50, 40, 30),
                   help="L-BFGS iterations a pyramid level")
    s.set_defaults(fn=cmd_datagen_styled)

    s = sub.add_parser("datagen-corpus", help="the pseudo-paired FC2 corpus the trainers read")
    _add_common(s, reads=("--batch-size",), helps={"--batch-size": "images an OBST batch"})
    s.add_argument("--n-samples", type=int, default=512)
    s.add_argument("--style-dir", default=None)
    s.add_argument("--iters", type=int, nargs="+", default=(30, 25, 20),
                   help="L-BFGS iterations a pyramid level")
    s.add_argument("--styler", default="gatys", choices=["gatys", "procedural"],
                   help="'procedural' = deterministic per-domain transforms (for environments "
                        "without pretrained VGG weights)")
    s.set_defaults(fn=cmd_datagen_corpus)

    s = sub.add_parser("align-faces", help="FAN-landmark face alignment over an image dir")
    _add_common(s)
    s.add_argument("--input-dir", required=True)
    s.add_argument("--output-dir-align", required=True)
    s.add_argument("--img-size", type=int, default=256)
    s.add_argument("--wing-ckpt", default=None,
                   help="the reference's wing.ckpt state_dict (a FAN seeded by --seed otherwise)")
    s.add_argument("--lm-path", default=None,
                   help="celeba_lm_mean.npz; the synthetic template otherwise")
    s.set_defaults(fn=cmd_align_faces)

    s = sub.add_parser("demo", help="live stylization demo (a video out, or a window with --show)")
    _add_common(s)
    s.add_argument("--source", default=None,
                   help="'webcam', a video path, or omit for a synthetic clip")
    s.add_argument("--method", default="huang", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--n-frames", type=int, default=60)
    s.add_argument("--ckpt-dir", default=None,
                   help=f"a FastStyleNet state_dict file, or a dir holding {CKPT_NAME}")
    s.add_argument("--show", action="store_true")
    s.set_defaults(fn=cmd_demo)

    s = sub.add_parser("demo-web", help="browser demo: style buttons, strength slider, "
                                        "resolution and source pickers, snapshot")
    _add_common(s)
    s.add_argument("--source", default=None,
                   help="video path, webcam index, or omit for synthetic")
    s.add_argument("--method", default="huang", choices=tuple(FASTSTYLE_METHODS))
    s.add_argument("--n-styles", type=int, default=3)
    s.add_argument("--ckpt-dir", default=None,
                   help=f"a FastStyleNet state_dict file, or a dir holding {CKPT_NAME}")
    s.add_argument("--port", type=int, default=8600)
    s.add_argument("--max-frames", type=int, default=None, help="stop after N frames")
    s.set_defaults(fn=cmd_demo_web)

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
