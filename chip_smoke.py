#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports only
the PyTorch package (``infinite_texture_gans_torch``), never JAX.

1. Prints the card's name and power limit, builds the CUDA kernels of
   ``infinite_texture_gans_torch/csrc`` with nvcc (one process per source).
2. Holds each generation kernel (K1-K4) against its plain PyTorch version
   at the flagship's shapes, in float32 with TF32 off and in bfloat16: one
   384^2 sub-image (the raster path) and, for K1, K3 and K4, the 768^2
   one-pass grid too.
3. Holds each training kernel (K5 stats, K6, K7, K8, K3 stats and dW, K4's
   adjoint, the K13 stem trio, and the fused up-conv K9 forward with and
   without stats, dx, dW and its residual join K10 with and without stats)
   against its plain version at every shape of the Experiment-1 step (N = 8
   fake 384^2 grids, tail blocks 5-6) under both tails: ``--fuse_up off``
   and ``auto``, whose half-res shortcut (K3 and its dx form, K3-dW) and
   K10 adjoint (K4-bwd) run at shapes of their own; f32 and bf16, both
   outer paddings. Times each (CUDA-graph replay) beside its bound, its
   plain version and one PyTorch library call, summed per step for each
   tail, and holds the timed calls per step to the tail's launch counts.
4. Loads the trained flagship checkpoint ``examples/241_300ep_ema.ckpt``:
   - float32, 768^2: the one-pass oracle (a main path, launch counts
     read), then the raster engine against it;
   - bfloat16, 1024^2 through ``generate_canvas(wire='u8')`` (the main
     path: K2, K3, K4, launch counts held to 7/3/3 per sub-image), its seam
     ratio and warm wall time;
   - on the first canvas's latents: the seam ratio of the one pass and of
     sub-images generated without the halo cache (which set the raster's
     seam limit), and, attention gate zeroed, the bf16 raster canvas held to
     the bf16 one pass.
5. Step parity: at full Experiment-1 width in float32 (TF32 off), under
   ``--fuse_up auto`` and ``off``, one fused training step from a fixed
   state with the kernels, and the same step with the tail and the stem on
   their plain versions; losses and gradients must agree. Then the fused
   step against the unfused one from the same state and crops, both on the
   kernels.
6. Training runs: 30 bf16 steps of the Experiment-1 recipe on
   ``datasets/241.jpg`` through the train CLI's ``train``, under
   ``--fuse_up auto`` (the default) and then ``off``; exact launch counts
   per step, warm steps/s, the device's busy share (torch.profiler), then
   the written ``.ckpt`` reloaded through the sampling loader and rendered
   to a 384^2 canvas.
7. Prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line; so does a machine without
a card, or a directory that holds this file and nothing else of the repo.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "examples" / "241_300ep_ema.ckpt"

# NVIDIA H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

# float32 with TF32 off: kernel and cuDNN sum up to 9 * 104 = 936 products
# in other orders, and cuDNN may pick Winograd transforms (~1e-5 relative);
# 1e-4 of the output range leaves headroom above both.
F32_TOL = 1e-4
# bfloat16: both sides compute in float32 and round the output once, so an
# output can sit one bf16 ulp (2^-8 of its magnitude) apart; allow two.
BF16_TOL = 2.0**-7
# raster vs one pass, float32, attention gate zeroed: the engine is exact
# up to cuDNN choosing other algorithms for the NHWC blocks 1-3 on a
# sub-image than on the whole canvas (float32 rounding, ~1e-6 relative)
# carried through 13 convs; 5e-3 on the [-1, 1] image.
CANVAS_TOL = 5e-3
# the same in bfloat16 on the u8 canvas: where cuDNN's choices round a
# block 1-3 output one bf16 ulp apart, the difference is carried through
# 13 convs and reaches the image as a few bf16 ulps, each about one u8
# level near +-1 (a bf16 ulp there is 2^-8 of the [-1, 1] range's half)
CANVAS_U8_TOL = 4
# seam ratio of the raster canvas (trained attention gate) against the one
# pass and a broken halo on the same latents: on an H100 (flagship, seed
# 21) the working halo read 0.0005 from the one pass and the broken one 6.4
# above it, so a tenth of that gap leaves a wide margin on both sides
SEAM_GAP_SHARE = 0.1

# The flagship the checks are sized for: G_ch 52, n_layers_G 6, base_res 4
# (patch 128, sub-image 3 x 3 patches = 384^2).
FLAGSHIP = dict(G_ch=52, n_layers_G=6, base_res=4)
GRID = 3


def tail_shapes(plan, base, gh, gw):
    """The channels-major tail's kernel shapes (N = 1) for a merged grid of
    gh x gw patches: conv3x3 (C, Co, H, W), conv1x1 (C, Co, H, W) and the
    upsample's input (C, H, W), from blocks 4 on (the eval gate: i > 3,
    cin <= 128, which holds for every flagship block from 4 on)."""
    conv3, conv1, up2 = [], [], []
    for i, (cin, cout) in enumerate(plan, start=1):
        if i <= 3:
            continue
        h, w = gh * base * 2 ** (i - 1), gw * base * 2 ** (i - 1)
        up2.append((cin, h // 2, w // 2))
        conv3 += [(cin, cout, h, w), (cout, cout, h, w)]
        conv1.append((cin, cout, h, w))
    conv3.append((plan[-1][1], 3, h, w))
    return conv3, conv1, up2


def exp1_shapes(plan, base):
    """The Experiment-1 step's tail shapes (N = EXP1_N): conv3x3 (C, Co, H, W,
    with stats), conv1x1 (C, Co, H, W) and the upsample's input (C, H, W),
    from the train gate's blocks on (i > 3, cin <= 64: blocks 5 and 6)."""
    conv3, conv1, up2 = [], [], []
    for i, (cin, cout) in enumerate(plan, start=1):
        if i <= 3 or cin > 64:
            continue
        h = w = GRID * base * 2 ** (i - 1)
        up2.append((cin, h // 2, w // 2))
        conv3 += [(cin, cout, h, w, True), (cout, cout, h, w, False)]
        conv1.append((cin, cout, h, w))
    conv3.append((plan[-1][1], 3, h, w, False))
    return conv3, conv1, up2


# kernel -> (tag, CUDA source, pallas_call line in ops/pallas_conv.py)
KERNELS = {
    "conv3x3_chw": ("K1/K5", "conv3x3_chw.cu", 395),
    "chw_halo_step": ("K2", "conv3x3_chw.cu", 539),
    "conv3x3_chw_dx": ("K6", "conv3x3_chw_bwd.cu", 775),
    "conv3x3_chw_dw": ("K7", "conv3x3_chw_bwd.cu", 888),
    "bn_corr": ("K8", "conv3x3_chw_bwd.cu", 1061),
    "conv1x1_chw": ("K3", "conv1x1_chw.cu", 2311),
    "conv1x1_chw_dw": ("K3-dW", "conv1x1_chw.cu", 2361),
    "upsample2_chw": ("K4", "upsample2_chw.cu", 2540),
    "upsample2_chw_bwd": ("K4-bwd", "upsample2_chw.cu", 2560),
    "upconv3x3_chw": ("K9", "upconv3x3_chw.cu", 1457),
    "upconv3x3_chw_dx": ("K9-dx", "upconv3x3_chw.cu", 1642),
    "upconv3x3_chw_dw": ("K9-dW", "upconv3x3_chw.cu", 1777),
    "upsample2_chw_add": ("K10", "upsample2_chw.cu", 2199),
    "stem_fwd": ("K13", "stem4x4s2.cu", 2769),
    "stem_dw": ("K13-dW", "stem4x4s2.cu", 2840),
    "stem_dx": ("K13-dx", "stem4x4s2.cu", 2977),
}
# kernels on the generation paths (timed per 384^2 sub-image); those of the
# training step (timed per step) are the ones STEP_LAUNCHES counts
GEN_KERNELS = ("conv3x3_chw", "chw_halo_step", "conv1x1_chw", "upsample2_chw")

# The Experiment-1 step (README quick start; --fuse_up auto, the default):
# N = 8 fake 384^2 grids, tail blocks 5 (52 -> 26 at 192^2) and 6 (26 -> 13
# at 384^2).
EXP1_N = 8
EXP1_BATCH = 64
EXP1_ARGS = ["--data_path", str(ROOT / "datasets" / "241.jpg"), "--random_crop", "192",
             "--G_ch", "52", "--D_ch", "64", "--z_dim", "128", "--n_layers_G", "6",
             "--n_layers_D", "4", "--attention", "--padding_mode", "local", "--type_norm_G", "BN",
             "--spec_norm_D", "--smooth", "--ema", "--compute_dtype", "bfloat16",
             "--batch_size", str(EXP1_BATCH), "--num_images", str(EXP1_N)]
TRAIN_STEPS = 30
WARM_STEPS = 20  # steps/s is the median over the last WARM_STEPS steps
TRACED_STEPS = 3
# the differentiable kernel wrappers the models call, and the plain
# versions (differentiable PyTorch) that step parity swaps in for them
PLAIN_TWINS = {"conv3x3_chw": "conv3x3_chw_plain", "conv1x1_chw": "conv1x1_chw_plain",
               "conv1x1_chw_add": "conv1x1_chw_plain", "upsample2_chw": "upsample2_chw_plain",
               "upconv3x3_chw": "upconv3x3_chw_plain",
               "upsample2_chw_add": "upsample2_chw_add_plain",
               "conv4x4s2_stem_chw": "stem_fwd_plain"}
# exact kernel launches of one Experiment-1 step under each --fuse_up. Fused
# (blocks 5 and 6): forward K9, conv2 (K1), the half-res shortcut (K3), K10
# per block and the final conv (K1); backward K8 at each stats producer,
# K6/K7 for conv2 and the final conv, K9 dx/dW, the shortcut's dx (K3 with
# Wᵀ) and dW, K4's adjoint for K10; no K4 forward. The default tail first.
STEP_LAUNCHES = {
    "auto": {**dict.fromkeys(KERNELS, 0), "conv3x3_chw": 3, "conv3x3_chw_dx": 3,
             "conv3x3_chw_dw": 3, "bn_corr": 4, "conv1x1_chw": 4, "conv1x1_chw_dw": 2,
             "upsample2_chw_bwd": 2, "upconv3x3_chw": 2, "upconv3x3_chw_dx": 2,
             "upconv3x3_chw_dw": 2, "upsample2_chw_add": 2, "stem_fwd": 2, "stem_dw": 1,
             "stem_dx": 1},
    "off": {**dict.fromkeys(KERNELS, 0), "conv3x3_chw": 5, "conv3x3_chw_dx": 5,
            "conv3x3_chw_dw": 5, "bn_corr": 4, "conv1x1_chw": 4, "conv1x1_chw_dw": 2,
            "upsample2_chw": 2, "upsample2_chw_bwd": 2, "stem_fwd": 2, "stem_dw": 1, "stem_dx": 1},
}
# float32 reductions (Σy, Σy², d(scale), d(shift), dW, db) in another order,
# partly by atomics: 1e-4 of the largest reference entry
SUM_TOL = 1e-4
# step parity (f32, TF32 off): losses relative 1e-4; each gradient leaf to
# 1e-3 of its largest reference value (the errors of 13 kernel layers and
# their BatchNorm statistics compound); a leaf below 1e-6 of the model's
# largest gradient is rounding noise (zero in exact arithmetic: a bias that
# reaches only train-mode BatchNorms) and is held to 1e-3 of that largest
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
NOISE_SHARE = 1e-6
# fused against unfused step (kernels both, f32): each gradient leaf's
# norm-relative deviation at most max(FUSE_FLOOR, FUSE_FLOOR_SCALE x) that
# leaf's kernels-vs-plain deviation under --fuse_up off, the reference's
# calibrated criterion (tests/test_upconv.py:214-232); a rounding-noise leaf
# (below NOISE_SHARE of the model's largest gradient) is held as step parity
# holds it
FUSE_FLOOR = 2e-3
FUSE_FLOOR_SCALE = 1.5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S) * 1e3


def device_busy_ms(prof):
    """Device time by kernel name from a torch.profiler trace:
    ({name: (ms, calls)}, total ms). Ranges that annotate the device
    timeline (``Optimizer.step#Adam.step``) are not device work and are
    left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms_, n_ = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms_ + e.time_range.elapsed_us() / 1e3, n_ + 1)
    return by_name, sum(v[0] for v in by_name.values())


@contextlib.contextmanager
def plain_tail():
    """The models' kernel wrappers replaced by their plain versions: the
    comparison run of step parity (the port itself has no such switch)."""
    from infinite_texture_gans_torch.ops import kernels

    saved = {k: getattr(kernels, k) for k in PLAIN_TWINS}
    for k, plain in PLAIN_TWINS.items():
        setattr(kernels, k, getattr(kernels, plain))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)


def step_parity(dev, argv, want_launches, sync):
    """One fused step from a fixed state with the kernels, and the same step
    with the tail's and the stem's plain versions: the losses and every
    gradient leaf must agree; the kernel run must launch ``want_launches``.
    Returns {'kernels' | 'plain': (losses, G grads, D grads, launches)}."""
    import torch

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.latents import build_train_z
    from infinite_texture_gans_torch.train.train_step import create_train_state, train_step

    args = prepare_parser().parse_args(argv)
    data = SingleImageDataset(args.data_path, args.data_ext, None, args.random_crop, 64)
    gen = torch.Generator(device=dev).manual_seed(7)
    real = DeviceCropSampler(data, dev).sample(gen, args.batch_size)
    z = build_train_z(gen, args.num_images, args.z_dim, args.base_res, args.num_patches_height,
                      args.num_patches_width, device=dev)
    runs = {}
    for mode in ("kernels", "plain"):
        st = create_train_state(args, 1, dev, seed=11)
        sync()
        kernels.reset_launches()
        with plain_tail() if mode == "plain" else contextlib.nullcontext():
            m = train_step(st, real, z, smooth=args.smooth, use_ema=args.ema)
        sync()
        runs[mode] = ({k: float(v) for k, v in m.items()},
                      {f"G.{n}": p.grad.float() for n, p in st.G.named_parameters()},
                      {f"D.{n}": p.grad.float() for n, p in st.D.named_parameters()},
                      dict(kernels.LAUNCHES))
        del st
    (lk, gk, dk, nk), (lp, gp, dp, n_plain) = runs["kernels"], runs["plain"]
    print(f"[step parity] --fuse_up {args.fuse_up}, {args.compute_dtype}, G_ch {args.G_ch}, "
          f"D_ch {args.D_ch}, {args.num_images} fakes + {args.batch_size} real "
          f"{args.random_crop}^2 crops; launches with kernels {json.dumps(nk)}")
    if nk != want_launches or any(n_plain.values()):
        fail(f"step parity launches: kernels {nk} (want {want_launches}), plain {n_plain} (want 0)")
    for k, ref in lp.items():
        rel = abs(lk[k] - ref) / max(abs(ref), 1e-30)
        print(f"[step parity] {k}: kernels {lk[k]:.7f} plain {ref:.7f} rel {rel:.3e} "
              f"limit {STEP_LOSS_TOL:g}")
        if not (math.isfinite(lk[k]) and rel <= STEP_LOSS_TOL):
            fail(f"step parity: {k} {lk[k]} vs plain {ref}")
    for model, got, want in (("G", gk, gp), ("D", dk, dp)):
        top = max(float(r.abs().max()) for r in want.values())
        worst = (0.0, "")
        for name, ref in want.items():
            scale = float(ref.abs().max())
            scale = top if scale < NOISE_SHARE * top else scale
            share = float((got[name] - ref).abs().max()) / scale
            worst = max(worst, (share, name))
            if not share <= STEP_GRAD_TOL:
                fail(f"step parity: gradient {name} differs by {share:.3e} of its scale")
        print(f"[step parity] {model} gradients, {len(want)} leaves: worst {worst[1]} at "
              f"{worst[0]:.3e} of its largest reference value (limit {STEP_GRAD_TOL:g}; a leaf "
              f"under {NOISE_SHARE:g} of the model's largest gradient is held to that largest)")
    return runs


def fused_vs_unfused(auto, off) -> None:
    """The fused step (``--fuse_up auto``) against the unfused one, both on
    the kernels, from the same state, crops and latents (``step_parity``'s
    runs): losses within STEP_LOSS_TOL; each gradient leaf's norm-relative
    deviation within max(FUSE_FLOOR, FUSE_FLOOR_SCALE x) the same leaf's
    kernels-vs-plain deviation under ``off``."""
    (la, ga, da, _), (lo, go, do, _), (_, gp, dp, _) = auto["kernels"], off["kernels"], off["plain"]
    for k, ref in lo.items():
        rel = abs(la[k] - ref) / max(abs(ref), 1e-30)
        print(f"[fused vs unfused] {k}: auto {la[k]:.7f} off {ref:.7f} rel {rel:.3e} "
              f"limit {STEP_LOSS_TOL:g}")
        if not rel <= STEP_LOSS_TOL:
            fail(f"fused vs unfused step: {k} {la[k]} vs {ref}")
    for model, fused, unfused, plain in (("G", ga, go, gp), ("D", da, do, dp)):
        top = max(float(r.abs().max()) for r in unfused.values())
        worst, noise = (0.0, "", 0.0, 0.0), 0
        for name, ref in unfused.items():
            if float(ref.abs().max()) < NOISE_SHARE * top:
                noise += 1
                share = float((fused[name] - ref).abs().max()) / top
                if not share <= STEP_GRAD_TOL:
                    fail(f"fused vs unfused: noise leaf {name} differs by {share:.3e} of the "
                         f"largest gradient")
                continue
            norm = float(ref.norm()) + 1e-12
            dev_ = float((fused[name] - ref).norm()) / norm
            floor = float((ref - plain[name]).norm()) / norm
            limit = max(FUSE_FLOOR, FUSE_FLOOR_SCALE * floor)
            worst = max(worst, (dev_ / limit, name, dev_, limit))
            if not dev_ <= limit:
                fail(f"fused vs unfused: gradient {name} deviates {dev_:.3e} (norm-relative) "
                     f"> {limit:.3e} (kernels-vs-plain floor {floor:.3e})")
        print(f"[fused vs unfused] {model} gradients, {len(unfused)} leaves ({noise} rounding-noise "
              f"leaves held to {STEP_GRAD_TOL:g} of the largest gradient): closest to its limit "
              f"{worst[1]}, norm-relative deviation {worst[2]:.3e} against max({FUSE_FLOOR:g}, "
              f"{FUSE_FLOOR_SCALE:g} x its kernels-vs-plain deviation) = {worst[3]:.3e}")


def training_run(dev, argv, steps, want_launches, sync, card, out_dir):
    """``steps`` steps of the train CLI's loop (one epoch) with the exact
    kernel launches of every step held to ``want_launches``, finite losses,
    moved parameters, the warm step time, a traced window's device busy
    share, and the written checkpoint rendered to a 384^2 canvas. Returns the
    run's launch counts, its warm step time (s) and its device busy time per
    traced step (ms, or None where the profiler recorded no device time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import generate_canvas
    from infinite_texture_gans_torch.sampling.latents import build_train_z
    from infinite_texture_gans_torch.train import train_loop
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )
    from infinite_texture_gans_torch.train.train_step import create_train_state, train_step

    args = prepare_parser().parse_args(argv + [
        "--sampling", str(int(argv[argv.index("--batch_size") + 1]) * steps), "--epochs", "1",
        "--saving_rate", "1", "--seed", "5", "--fname", str(out_dir), "--device", dev.type])
    step_log = []

    def on_step(epoch, i, metrics):
        losses = {k: float(v) for k, v in metrics.items()}  # synchronises
        step_log.append((time.perf_counter(), dict(kernels.LAUNCHES), losses))

    sync()
    kernels.reset_launches()
    t_train = time.perf_counter()
    state, _, _ = train_loop.train(args, step_callback=on_step)
    sync()
    launches = dict(kernels.LAUNCHES)
    print(f"[path train] {steps} {args.compute_dtype} steps (--fuse_up {args.fuse_up}), "
          f"launches {json.dumps(launches)}")
    if len(step_log) != steps:
        fail(f"the train loop ran {len(step_log)} steps, not {steps}")
    prev = {k: 0 for k in launches}
    for i, (_, counts, losses) in enumerate(step_log):
        per_step = {k: counts[k] - prev[k] for k in counts}
        prev = counts
        if per_step != want_launches:
            fail(f"step {i} launched {per_step}, not {want_launches}")
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"step {i} losses {losses} are not finite")
    print(f"[path train] launches in each of the {steps} steps: {json.dumps(want_launches)}")
    print(f"[train] losses after step 1 {step_log[0][2]}, after step {steps} {step_log[-1][2]}")
    init = create_train_state(args, 1, "cpu", seed=args.seed)
    for model, before, after in (("G", init.G, state.G), ("D", init.D, state.D)):
        now = after.state_dict()
        leaves = dict(before.named_parameters())
        still = [k for k, p in leaves.items() if torch.equal(p.detach(), now[k].cpu())]
        print(f"[train] {model}: {len(leaves) - len(still)} of {len(leaves)} parameter leaves "
              f"moved; unchanged: {still}")
        if any(leaves[k].dim() == 4 for k in still):
            fail(f"{model} conv weights did not move: {still}")
    del init
    times = [t for t, _, _ in step_log]
    step_s = [b - a for a, b in zip(times[:-1], times[1:])][-WARM_STEPS:]
    warm = statistics.median(step_s)
    print(f"[time] train step (--fuse_up {args.fuse_up}): median of the last {len(step_s)} steps {warm * 1e3:.2f} ms "
          f"({1.0 / warm:.3f} steps/s), min {min(step_s) * 1e3:.2f} ms, max "
          f"{max(step_s) * 1e3:.2f} ms; the whole run with set-up and checkpoints "
          f"{time.perf_counter() - t_train:.1f} s [{card}]")

    sampler = DeviceCropSampler(SingleImageDataset(args.data_path, args.data_ext, None,
                                                   args.random_crop, 64), dev)
    rng = torch.Generator(device=dev).manual_seed(9)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync()
        t1 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            z = build_train_z(rng, args.num_images, args.z_dim, args.base_res,
                              args.num_patches_height, args.num_patches_width, device=dev)
            train_step(state, sampler.sample(rng, args.batch_size), z, loss_type=args.loss,
                       smooth=args.smooth, use_ema=args.ema)
        sync()
        traced_s = time.perf_counter() - t1
    by_name, busy = device_busy_ms(prof)
    per_step = None
    if busy > 0:
        per_step = busy / TRACED_STEPS
        print(f"[trace] --fuse_up {args.fuse_up}: {TRACED_STEPS} train steps, traced wall {traced_s:.4f} s, device busy "
              f"{busy / 1e3:.4f} s ({100 * busy / 1e3 / traced_s:.1f}% of the traced wall); "
              f"{per_step:.2f} ms per step, {100 * per_step / (warm * 1e3):.1f}% of the untraced "
              f"warm step [{card}]")
        for name, (ms_, n_) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
            print(f"[trace]   {ms_ / TRACED_STEPS:9.3f} ms/step {n_ / TRACED_STEPS:6.1f}x  "
                  f"{name[:100]}")
    else:
        print("[trace] train step device time: not measured (no device events recorded)")
    del state

    ck = load_checkpoint(str(out_dir / "1_1.ckpt"))
    if ck["meta"]["epoch"] != 1 or int(ck["opt_G"]["0"]["count"]) != steps:
        fail(f"checkpoint epoch {ck['meta']['epoch']}, opt count {ck['opt_G']['0']['count']}")
    trained, _ = load_generator_from_checkpoint(str(out_dir / "1__ema.ckpt"), device=dev)
    canvas = generate_canvas(trained, torch.Generator(device=dev).manual_seed(3), 384, 384,
                             wire="u8")
    print(f"[train] 1_1.ckpt and 1__ema.ckpt written; the EMA generator renders a 384^2 canvas "
          f"{canvas.shape} {canvas.dtype}, std {canvas.std():.3f}")
    if canvas.shape != (1, 384, 384, 3) or canvas.dtype != np.uint8 or not canvas.std() > 0:
        fail(f"canvas from the trained checkpoint: {canvas.shape} {canvas.dtype} std {canvas.std()}")
    return launches, warm, per_step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "infinite_texture_gans_torch" / "csrc").is_dir() or not CKPT.exists():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from infinite_texture_gans_torch.config import generator_kwargs
    from infinite_texture_gans_torch.models.generator import (
        ResidualPatchGenerator,
        generator_channel_plan,
    )
    from infinite_texture_gans_torch.ops import _build, kernels
    from infinite_texture_gans_torch.sampling.infinite import (
        canvas_geometry,
        generate_canvas,
        generate_one_pass,
    )
    from infinite_texture_gans_torch.sampling.latents import build_z_full, slice_sub_z
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )
    from infinite_texture_gans_torch.utils.metrics import adjacent_mse_baseline, seam_mse

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")

    def sync():
        torch.cuda.synchronize()

    def eager_ms(fn, iters=50, warmup=5):
        """Per call, back to back from Python: includes host issue time."""
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=20):
        """Per call, replayed from a CUDA graph: device time alone."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def table():
        return {k: dict(err=None, sum_err=0.0, ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        library_ms=0.0, nbytes=0.0, flops=0.0, calls=0) for k in KERNELS}

    stats = table()  # per 384^2 sub-image (generation)
    tstats = {fuse: table() for fuse in STEP_LAUNCHES}  # per Experiment-1 step, each tail

    def compare(name, shape, got, ref, exact=False):
        sync()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        tol = 0.0 if exact else (F32_TOL if got.dtype == torch.float32 else BF16_TOL)
        limit = tol * max(1.0, top)
        print(f"[check] {name} {str(got.dtype).replace('torch.', '')} {shape}: "
              f"max_abs_err {err:.3e} max_rel_err {err / max(top, 1e-12):.3e} "
              f"(of max|ref| {top:.3e}) limit {limit:.3e}")
        if not err <= limit:
            fail(f"{name} {shape} {got.dtype}: max abs err {err} > {limit}")
        stats[name]["err"] = max(stats[name]["err"] or 0.0, err)

    def compare_sum(name, shape, got, ref):
        """A float32 reduction: within SUM_TOL of the largest reference entry."""
        sync()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        limit = SUM_TOL * max(top, 1e-30)
        print(f"[check] {name} sums {shape}: max_abs_err {err:.3e} (of max|ref| {top:.3e}) "
              f"limit {limit:.3e}")
        if not err <= limit:
            fail(f"{name} {shape} sums: max abs err {err} > {limit}")
        stats[name]["sum_err"] = max(stats[name]["sum_err"], err)

    # -- 2. kernels against their plain versions --------------------------
    def randn(g, *shape):
        return torch.randn(*shape, device=dev, generator=g)

    def conv3_inputs(c, co, h, w, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = randn(g, 1, c, h, w).to(dtype)
        wt = randn(g, co, c, 3, 3) * (9 * c) ** -0.5
        b = 0.1 * randn(g, co)
        sc = 1 + 0.1 * randn(g, c)
        sh = 0.1 * randn(g, c)
        top = torch.relu(randn(g, 1, c, w + 2)).to(dtype)
        left = torch.relu(randn(g, 1, c, h)).to(dtype)
        return x, wt, b, sc, sh, top, left

    def account(name, shape_s, kernel_fn, plain_fn, lib_fn, nbytes, flops, tails=(), count=1):
        """Time the kernel, its plain version and the library call (bf16,
        device time from CUDA-graph replay, per call) and add ``count`` calls
        to the kernel's sums: per sub-image without ``tails``, else per step
        of each training tail named (a shape both tails run goes into both)."""
        ms, plain, lib = device_ms(kernel_fn), device_ms(plain_fn), device_ms(lib_fn)
        eager = eager_ms(kernel_fn)
        b = bound_ms(nbytes, flops)
        for s in [tstats[t][name] for t in tails] or [stats[name]]:
            s["ms"] += count * ms
            s["eager_ms"] += count * eager
            s["plain_ms"] += count * plain
            s["library_ms"] += count * lib
            s["nbytes"] += count * nbytes
            s["flops"] += count * flops
            s["bound_ms"] += count * b
            s["calls"] += count
        by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOP_PER_S else "operations"
        per = f", x{count} per step under --fuse_up {' and '.join(tails)}" if tails else ""
        print(f"[time] {name} {shape_s}: kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
              f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, library {lib:.4f} ms{per}  "
              f"[{card}]")

    print(f"[tolerance] f32 (TF32 off): max abs err <= {F32_TOL:g} * max(1, max|ref|): kernel "
          "and cuDNN sum up to 936 products in other orders, and cuDNN may use Winograd "
          "(~1e-5 relative)")
    print(f"[tolerance] bf16: max abs err <= {BF16_TOL:g} * max(1, max|ref|): both sides "
          "compute in f32 and round the output once, so an output may sit one bf16 ulp "
          "(2^-8 relative) apart; two allowed")
    print("[tolerance] upsample2_chw: bit-equal (a copy)")
    plan = generator_channel_plan(FLAGSHIP["G_ch"], FLAGSHIP["n_layers_G"])
    base, patch = FLAGSHIP["base_res"], FLAGSHIP["base_res"] * 2 ** (FLAGSHIP["n_layers_G"] - 1)
    _, _, th768, tw768 = canvas_geometry(768, 768, patch, GRID, GRID)
    # K2, K3, K4 on the raster path: one sub-image (checked and timed); K1,
    # K3, K4 on the one-pass path: the 768^2 canvas's whole grid (checked)
    shape_sets = [("sub-image", tail_shapes(plan, base, GRID, GRID), True),
                  (f"one-pass {th768}x{tw768}", tail_shapes(plan, base, th768, tw768), False)]
    t0 = time.perf_counter()
    for where, (conv3, conv1, up2), timed in shape_sets:
        for i, (c, co, h, w) in enumerate(conv3):
            for dtype in (torch.float32, torch.bfloat16):
                x, wt, b, sc, sh, top, left = conv3_inputs(c, co, h, w, dtype, i)
                shape_s = f"{c}->{co} @{h}x{w}"
                for outer in ("replicate", "constant"):
                    compare("conv3x3_chw", f"{where} {shape_s} {outer}",
                            kernels.conv3x3_chw(x, wt, b, sc, sh, True, outer),
                            kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True, outer))
                    if timed:
                        compare("chw_halo_step", f"{where} {shape_s} {outer}",
                                kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left),
                                kernels.conv3x3_chw_halo_plain(x, wt, b, sc, sh, True, outer,
                                                               top, left))
                if not timed or dtype != torch.bfloat16:
                    continue
                es = x.element_size()
                act_bytes = (c + co) * h * w * es + (co * c * 9 + co + 2 * c) * 4
                flops = 2.0 * co * c * 9 * h * w
                a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
                wl, bl = wt.to(dtype), b.to(dtype)
                account("conv3x3_chw", shape_s,
                        lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True),
                        lambda: kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True),
                        lambda: F.conv2d(a_pad, wl, bl), act_bytes, flops)
                halo_bytes = act_bytes + (h + w + 2) * c * es
                account("chw_halo_step", shape_s,
                        lambda: kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate",
                                                         top, left),
                        lambda: kernels.conv3x3_chw_halo_plain(x, wt, b, sc, sh, True,
                                                               "replicate", top, left),
                        lambda: F.conv2d(a_pad, wl, bl), halo_bytes, flops)

        for i, (c, co, h, w) in enumerate(conv1):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(100 + i)
                x = randn(g, 1, c, h, w).to(dtype)
                wt = randn(g, co, c, 1, 1) * c ** -0.5
                b = 0.1 * randn(g, co)
                res = randn(g, 1, co, h, w).to(dtype)
                shape_s = f"{c}->{co} @{h}x{w}"
                compare("conv1x1_chw", f"{where} {shape_s}", kernels.conv1x1_chw(x, wt, b),
                        kernels.conv1x1_chw_plain(x, wt, b))
                compare("conv1x1_chw", f"{where} {shape_s} +res",
                        kernels.conv1x1_chw_add(x, wt, b, res),
                        kernels.conv1x1_chw_plain(x, wt, b, res))
                if not timed or dtype != torch.bfloat16:
                    continue
                es = x.element_size()
                nbytes = (c + 2 * co) * h * w * es + (co * c + co) * 4
                flops = 2.0 * co * c * h * w + 2.0 * co * h * w
                wl, bl = wt.to(dtype), b.to(dtype)
                account("conv1x1_chw", shape_s,
                        lambda: kernels.conv1x1_chw_add(x, wt, b, res),
                        lambda: kernels.conv1x1_chw_plain(x, wt, b, res),
                        lambda: torch.add(F.conv2d(x, wl, bl), res), nbytes, flops)

        for i, (c, h, w) in enumerate(up2):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(200 + i)
                x = randn(g, 1, c, h, w).to(dtype)
                shape_s = f"(1, {c}, {h}, {w})"
                compare("upsample2_chw", f"{where} {shape_s}", kernels.upsample2_chw(x),
                        kernels.upsample2_chw_plain(x), exact=True)
                if not timed or dtype != torch.bfloat16:
                    continue
                nbytes = 5.0 * c * h * w * x.element_size()
                account("upsample2_chw", shape_s,
                        lambda: kernels.upsample2_chw(x),
                        lambda: kernels.upsample2_chw_plain(x),
                        lambda: F.interpolate(x, scale_factor=2, mode="nearest"), nbytes, 0.0)
    print(f"[phase 2] kernel checks and timings in {time.perf_counter() - t0:.1f} s")

    # -- 3. training kernels against their plain versions, Experiment-1 shapes
    t0 = time.perf_counter()
    conv3_t, conv1_t, up2_t = exp1_shapes(plan, base)
    n = EXP1_N
    print(f"[tolerance] sums (Σy, Σy², d(scale), d(shift), dW, db): max abs err <= {SUM_TOL:g} * "
          "max|ref|: float32 reductions in another order, partly by atomics; K5's sums are held "
          "to the sums of the kernel's own stored y; K4's adjoint bit-equal")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        es = 2 if timed else 4
        for i, (c, co, h, w, with_stats) in enumerate(conv3_t):
            g_ = torch.Generator(device=dev).manual_seed(300 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 3, 3) * (9 * c) ** -0.5
            b = 0.1 * randn(g_, co)
            sc = 1 + 0.1 * randn(g_, c)
            sh = 0.1 * randn(g_, c)
            gy = randn(g_, n, co, h, w).to(dtype)
            alpha, beta2 = 1e-3 * randn(g_, co), 1e-4 * randn(g_, co)
            shape_s = f"({n}, {c}->{co}, {h}x{w})"
            for outer in ("replicate", "constant"):
                tag = f"{shape_s} {outer}"
                y, s1, s2 = kernels.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
                compare("conv3x3_chw", f"train {tag}",
                        y, kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True, outer))
                compare_sum("conv3x3_chw", f"Σy {tag}", s1, y.float().sum(dim=(0, 2, 3)))
                compare_sum("conv3x3_chw", f"Σy² {tag}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
                dx, dsc, dsh = kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, outer)
                dx_r, dsc_r, dsh_r = kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, outer)
                compare("conv3x3_chw_dx", tag, dx, dx_r)
                compare_sum("conv3x3_chw_dx", f"d(scale) {tag}", dsc, dsc_r)
                compare_sum("conv3x3_chw_dx", f"d(shift) {tag}", dsh, dsh_r)
                dw, db = kernels.conv3x3_chw_dw(x, gy, sc, sh, True, outer)
                dw_r, db_r = kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, outer)
                compare_sum("conv3x3_chw_dw", f"dW {tag}", dw, dw_r)
                compare_sum("conv3x3_chw_dw", f"db {tag}", db, db_r)
                if with_stats:
                    compare("bn_corr", tag, kernels.bn_corr(gy, y, alpha, beta2),
                            kernels.bn_corr_plain(gy, y, alpha, beta2))
            if not timed:
                continue
            act = n * h * w
            pbytes = (co * c * 9 + co) * 4
            flops = 2.0 * act * co * c * 9
            a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
            wl, bl = wt.to(dtype), b.to(dtype)
            # a block's conv1 (the stats producer) runs only unfused: under
            # auto K9 takes its place; conv2 and the final conv run in both
            tails = ("off",) if with_stats else ("auto", "off")
            account("conv3x3_chw", shape_s,
                    lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True, want_stats=with_stats),
                    lambda: kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True, want_stats=with_stats),
                    lambda: F.conv2d(a_pad, wl, bl), act * (c + co) * es + pbytes + 2 * c * 4,
                    flops, tails=tails)
            account("conv3x3_chw_dx", shape_s,
                    lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, gy, padding=1),
                    act * (2 * c + co) * es + pbytes + 4 * c * 4, flops, tails=tails)
            account("conv3x3_chw_dw", shape_s,
                    lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_weight(a_pad, wl.shape, gy),
                    act * (c + co) * es + pbytes + 2 * c * 4, flops, tails=tails)
            if with_stats:
                # two stats producers per block, each (N, Co, H, W) in both
                # tails: conv1 (K5 or K9) and the block's output (K3 or K10)
                ab = alpha.reshape(1, -1, 1, 1).to(dtype)
                b2b = beta2.reshape(1, -1, 1, 1).to(dtype)
                account("bn_corr", f"({n}, {co}, {h}x{w})",
                        lambda: kernels.bn_corr(gy, y, alpha, beta2),
                        lambda: kernels.bn_corr_plain(gy, y, alpha, beta2),
                        lambda: torch.addcmul(gy + ab, y, b2b),
                        3 * act * co * es + 2 * co * 4, 3.0 * act * co, tails=("auto", "off"),
                        count=2)
        for i, (c, co, h, w) in enumerate(conv1_t):
            g_ = torch.Generator(device=dev).manual_seed(400 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 1, 1) * c ** -0.5
            b = 0.1 * randn(g_, co)
            res = randn(g_, n, co, h, w).to(dtype)
            gy = randn(g_, n, co, h, w).to(dtype)
            wT = wt.reshape(co, c).t().contiguous()
            zc = torch.zeros(c, device=dev)
            shape_s = f"({n}, {c}->{co}, {h}x{w})"
            y, s1, s2 = kernels.conv1x1_chw_add(x, wt, b, res, want_stats=True)
            compare("conv1x1_chw", f"train {shape_s} +res", y,
                    kernels.conv1x1_chw_plain(x, wt, b, res))
            compare_sum("conv1x1_chw", f"Σy {shape_s}", s1, y.float().sum(dim=(0, 2, 3)))
            compare_sum("conv1x1_chw", f"Σy² {shape_s}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
            compare("conv1x1_chw", f"dx form {shape_s}", kernels.conv1x1_chw(gy, wT, zc),
                    kernels.conv1x1_chw_plain(gy, wT, zc))
            dw, db = kernels.conv1x1_chw_dw(x, gy)
            dw_r, db_r = kernels.conv1x1_chw_dw_plain(x, gy)
            compare_sum("conv1x1_chw_dw", f"dW {shape_s}", dw, dw_r)
            compare_sum("conv1x1_chw_dw", f"db {shape_s}", db, db_r)
            if not timed:
                continue
            act = n * h * w
            wl, bl, wTl = wt.to(dtype), b.to(dtype), wT.reshape(c, co, 1, 1).to(dtype)
            account("conv1x1_chw", f"{shape_s} +res +stats",
                    lambda: kernels.conv1x1_chw_add(x, wt, b, res, want_stats=True),
                    lambda: kernels.conv1x1_chw_plain(x, wt, b, res, want_stats=True),
                    lambda: torch.add(F.conv2d(x, wl, bl), res),
                    act * (c + 2 * co) * es + (co * c + 3 * co) * 4, 2.0 * act * co * c,
                    tails=("off",))
            account("conv1x1_chw", f"dx form ({n}, {co}->{c}, {h}x{w})",
                    lambda: kernels.conv1x1_chw(gy, wT, zc),
                    lambda: kernels.conv1x1_chw_plain(gy, wT, zc),
                    lambda: F.conv2d(gy, wTl), act * (c + co) * es + (co * c + c) * 4,
                    2.0 * act * co * c, tails=("off",))
            account("conv1x1_chw_dw", shape_s, lambda: kernels.conv1x1_chw_dw(x, gy),
                    lambda: kernels.conv1x1_chw_dw_plain(x, gy),
                    lambda: torch.nn.grad.conv2d_weight(x, wl.shape, gy),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("off",))
        for i, (c, h, w) in enumerate(up2_t):
            g_ = torch.Generator(device=dev).manual_seed(500 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            gy = randn(g_, n, c, 2 * h, 2 * w).to(dtype)
            shape_s = f"({n}, {c}, {h}, {w})"
            compare("upsample2_chw", f"train {shape_s}", kernels.upsample2_chw(x),
                    kernels.upsample2_chw_plain(x), exact=True)
            compare("upsample2_chw_bwd", f"({n}, {c}, {2 * h}, {2 * w})",
                    kernels.upsample2_chw_bwd(gy), kernels.upsample2_chw_bwd_plain(gy), exact=True)
            if not timed:
                continue
            account("upsample2_chw", shape_s, lambda: kernels.upsample2_chw(x),
                    lambda: kernels.upsample2_chw_plain(x),
                    lambda: F.interpolate(x, scale_factor=2, mode="nearest"),
                    5.0 * n * c * h * w * es, 0.0, tails=("off",))
            account("upsample2_chw_bwd", f"({n}, {c}, {2 * h}, {2 * w})",
                    lambda: kernels.upsample2_chw_bwd(gy),
                    lambda: kernels.upsample2_chw_bwd_plain(gy),
                    lambda: F.avg_pool2d(gy, 2, divisor_override=1),
                    5.0 * n * c * h * w * es, 3.0 * n * c * h * w, tails=("off",))
        hs = conv3_t[-1][2]
        co = 64
        g_ = torch.Generator(device=dev).manual_seed(600)
        x = randn(g_, n, 3, hs, hs).to(dtype)
        wt = randn(g_, co, 3, 4, 4) * 48 ** -0.5
        b = 0.1 * randn(g_, co)
        gy = randn(g_, n, hs // 2, hs // 2, co).to(dtype)
        shape_s = f"({n}, 3, {hs}x{hs}) -> ({n}, {hs // 2}, {hs // 2}, {co})"
        compare("stem_fwd", shape_s, kernels.stem_fwd(x, wt, b), kernels.stem_fwd_plain(x, wt, b))
        compare("stem_dx", shape_s, kernels.stem_dx(gy, wt), kernels.stem_dx_plain(gy, wt))
        dw, db = kernels.stem_dw(x, gy)
        dw_r, db_r = kernels.stem_dw_plain(x, gy)
        compare_sum("stem_dw", f"dW {shape_s}", dw, dw_r)
        compare_sum("stem_dw", f"db {shape_s}", db, db_r)
        if timed:
            act = n * (hs // 2) ** 2
            flops = 2.0 * act * co * 48
            nbytes = (n * 3 * hs * hs + act * co) * es + (co * 48 + co) * 4
            wl, bl = wt.to(dtype), b.to(dtype)
            g_nchw = gy.permute(0, 3, 1, 2)
            account("stem_fwd", shape_s, lambda: kernels.stem_fwd(x, wt, b),
                    lambda: kernels.stem_fwd_plain(x, wt, b),
                    lambda: F.conv2d(x, wl, bl, stride=2, padding=1), nbytes, flops,
                    tails=("auto", "off"), count=2)
            account("stem_dw", shape_s, lambda: kernels.stem_dw(x, gy),
                    lambda: kernels.stem_dw_plain(x, gy),
                    lambda: torch.nn.grad.conv2d_weight(x, wl.shape, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"))
            account("stem_dx", shape_s, lambda: kernels.stem_dx(gy, wt),
                    lambda: kernels.stem_dx_plain(gy, wt),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"))
    # The fused blocks under --fuse_up auto: the unfused conv1 entries at half
    # resolution. K9 and K10, and the kernels that run there at shapes of
    # their own: the half-res shortcut (K3 with no residual and no stats),
    # its dx form and dW, and K4's adjoint of K10's (N, Co, 2H, 2W) gradient.
    print("[tolerance] upconv3x3_chw (K9) against its plain version, the unfused pair "
          "upsample2 + conv3x3: the combined 2x2 kernels regroup float32 additions (~1e-6 "
          "relative), inside the f32/bf16 limits above; K9's sums as K5's; upsample2_chw_add "
          "(K10) bit-equal (one rounded add on both sides), its sums as K5's")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        es = 2 if timed else 4
        for i, (c, co, h, w) in enumerate((c, co, h // 2, w // 2) for c, co, h, w in conv1_t):
            g_ = torch.Generator(device=dev).manual_seed(700 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 3, 3) * (9 * c) ** -0.5
            b = 0.1 * randn(g_, co)
            sc = 1 + 0.1 * randn(g_, c)
            sh = 0.1 * randn(g_, c)
            gy = randn(g_, n, co, 2 * h, 2 * w).to(dtype)
            s_half = randn(g_, n, co, h, w).to(dtype)
            res = randn(g_, n, co, 2 * h, 2 * w).to(dtype)
            w3 = randn(g_, co, c, 1, 1) * c ** -0.5
            b3 = 0.1 * randn(g_, co)
            w3T = w3.reshape(co, c).t().contiguous()
            zc = torch.zeros(c, device=dev)
            shape_s = f"({n}, {c}->{co}, {h}x{w} -> {2 * h}x{2 * w})"
            half_s = f"({n}, {c}->{co}, {h}x{w})"
            half_t = f"({n}, {co}->{c}, {h}x{w})"
            up_s = f"({n}, {co}, {2 * h}, {2 * w})"
            compare("conv1x1_chw", f"train auto shortcut {half_s}", kernels.conv1x1_chw(x, w3, b3),
                    kernels.conv1x1_chw_plain(x, w3, b3))
            compare("conv1x1_chw", f"train auto dx form {half_t}",
                    kernels.conv1x1_chw(s_half, w3T, zc), kernels.conv1x1_chw_plain(s_half, w3T, zc))
            dw, db = kernels.conv1x1_chw_dw(x, s_half)
            dw_r, db_r = kernels.conv1x1_chw_dw_plain(x, s_half)
            compare_sum("conv1x1_chw_dw", f"dW train auto {half_s}", dw, dw_r)
            compare_sum("conv1x1_chw_dw", f"db train auto {half_s}", db, db_r)
            compare("upsample2_chw_bwd", f"train auto {up_s}", kernels.upsample2_chw_bwd(gy),
                    kernels.upsample2_chw_bwd_plain(gy), exact=True)
            for outer in ("replicate", "constant"):
                tag = f"{shape_s} {outer}"
                y_ref = kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, outer)
                compare("upconv3x3_chw", f"train {tag}",
                        kernels.upconv3x3_chw(x, wt, b, sc, sh, True, outer), y_ref)
                y, s1, s2 = kernels.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
                compare("upconv3x3_chw", f"train {tag} +stats", y, y_ref)
                compare_sum("upconv3x3_chw", f"Σy {tag}", s1, y.float().sum(dim=(0, 2, 3)))
                compare_sum("upconv3x3_chw", f"Σy² {tag}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
                del y_ref, y
                dx, dsc, dsh = kernels.upconv3x3_chw_dx(x, gy, wt, sc, sh, True, outer)
                dx_r, dsc_r, dsh_r = kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, outer)
                compare("upconv3x3_chw_dx", tag, dx, dx_r)
                compare_sum("upconv3x3_chw_dx", f"d(scale) {tag}", dsc, dsc_r)
                compare_sum("upconv3x3_chw_dx", f"d(shift) {tag}", dsh, dsh_r)
                dw, db = kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, outer)
                dw_r, db_r = kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, outer)
                compare_sum("upconv3x3_chw_dw", f"dW {tag}", dw, dw_r)
                compare_sum("upconv3x3_chw_dw", f"db {tag}", db, db_r)
            k10_s = f"({n}, {co}, {h}x{w}) + ({n}, {co}, {2 * h}x{2 * w})"
            y_ref = kernels.upsample2_chw_add_plain(s_half, res)
            compare("upsample2_chw_add", k10_s, kernels.upsample2_chw_add(s_half, res), y_ref,
                    exact=True)
            y, s1, s2 = kernels.upsample2_chw_add(s_half, res, want_stats=True)
            compare("upsample2_chw_add", f"{k10_s} +stats", y, y_ref, exact=True)
            compare_sum("upsample2_chw_add", f"Σy {k10_s}", s1, y.float().sum(dim=(0, 2, 3)))
            compare_sum("upsample2_chw_add", f"Σy² {k10_s}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
            del y_ref, y
            if not timed:
                continue
            act = n * h * w  # half-res pixels
            wbytes = (co * c * 9 + co + 2 * c) * 4
            flops = 2.0 * act * co * c * 16  # four phases of 2x2 taps
            a_half = kernels.prenorm(x, sc, sh, True)
            a_up = F.pad(kernels.upsample2_chw_plain(a_half), (1, 1, 1, 1), mode="replicate")
            wl, bl = wt.to(dtype), b.to(dtype)
            wt4 = kernels._upconv_dx_weights(wt).transpose(0, 1).contiguous().to(dtype)
            account("upconv3x3_chw", f"{shape_s} +stats",
                    lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True, want_stats=True),
                    lambda: kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, want_stats=True),
                    lambda: F.conv2d(F.interpolate(a_half, scale_factor=2, mode="nearest"), wl, bl,
                                     padding=1),
                    act * (c + 4 * co) * es + wbytes + 2 * co * 4, flops, tails=("auto",))
            account("upconv3x3_chw_dx", shape_s,
                    lambda: kernels.upconv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: F.conv2d(gy, wt4, stride=2, padding=1),
                    act * (2 * c + 4 * co) * es + wbytes + 2 * c * 4, flops, tails=("auto",))
            account("upconv3x3_chw_dw", shape_s,
                    lambda: kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                    lambda: kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_weight(a_up, wl.shape, gy),
                    act * (c + 4 * co) * es + wbytes, flops, tails=("auto",))
            account("upsample2_chw_add", f"{k10_s} +stats",
                    lambda: kernels.upsample2_chw_add(s_half, res, want_stats=True),
                    lambda: kernels.upsample2_chw_add_plain(s_half, res, want_stats=True),
                    lambda: torch.add(F.interpolate(s_half, scale_factor=2, mode="nearest"), res),
                    9 * act * co * es + 2 * co * 4, 3.0 * 4 * act * co, tails=("auto",))
            w3l, b3l, w3Tl = w3.to(dtype), b3.to(dtype), w3T.reshape(c, co, 1, 1).to(dtype)
            account("conv1x1_chw", f"shortcut {half_s}", lambda: kernels.conv1x1_chw(x, w3, b3),
                    lambda: kernels.conv1x1_chw_plain(x, w3, b3), lambda: F.conv2d(x, w3l, b3l),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("auto",))
            account("conv1x1_chw", f"dx form {half_t}", lambda: kernels.conv1x1_chw(s_half, w3T, zc),
                    lambda: kernels.conv1x1_chw_plain(s_half, w3T, zc),
                    lambda: F.conv2d(s_half, w3Tl), act * (c + co) * es + (co * c + c) * 4,
                    2.0 * act * co * c, tails=("auto",))
            account("conv1x1_chw_dw", half_s, lambda: kernels.conv1x1_chw_dw(x, s_half),
                    lambda: kernels.conv1x1_chw_dw_plain(x, s_half),
                    lambda: torch.nn.grad.conv2d_weight(x, w3l.shape, s_half),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("auto",))
            account("upsample2_chw_bwd", up_s, lambda: kernels.upsample2_chw_bwd(gy),
                    lambda: kernels.upsample2_chw_bwd_plain(gy),
                    lambda: F.avg_pool2d(gy, 2, divisor_override=1), 5.0 * act * co * es,
                    3.0 * act * co, tails=("auto",))
    print("[library] K9 forward: F.interpolate then F.conv2d (two calls, zero padding); K9 dx: "
          "F.conv2d of g with the 4x4 phase-combined kernels at stride 2 (no border folds, no "
          "ReLU mask); K9 dW: conv2d_weight on the materialised padded upsample; K10: "
          "F.interpolate then add (two calls, no stats)")
    for fuse, want in STEP_LAUNCHES.items():
        timed_calls = {k: s["calls"] for k, s in tstats[fuse].items()}
        if timed_calls != want:
            fail(f"phase 3 timed {timed_calls} calls per --fuse_up {fuse} step, not {want}")
    print(f"[phase 3] training-kernel checks and timings in {time.perf_counter() - t0:.1f} s; "
          "the timed calls per step match each tail's launch counts")

    # -- 4. the flagship checkpoint through the port ------------------------
    t0 = time.perf_counter()
    ckpt = load_checkpoint(str(CKPT))
    gen, args = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt)
    print(f"[load] G_ch {args.G_ch} z_dim {args.z_dim} n_layers_G {args.n_layers_G} "
          f"attention {args.attention} dtype {gen.dtype} patch {gen.patch_resolution}")
    if (gen.plan, gen.base_res, gen.num_patches_h, gen.num_patches_w) != (plan, base, GRID, GRID):
        fail("the checkpoint's generator is not the flagship the kernel checks were sized for")
    kw = {**generator_kwargs(args), "dtype": torch.float32}
    gen32 = ResidualPatchGenerator(**kw)
    gen32.load_state_dict(gen.state_dict(), strict=True)
    gen32 = gen32.to(dev).eval()
    P = gen.patch_resolution

    th, tw = th768, tw768
    z768 = build_z_full(torch.Generator(device=dev).manual_seed(0), 1, gen.z_dim,
                        gen.base_res, th, tw, device=dev)
    sync()
    kernels.reset_launches()
    one = generate_one_pass(gen32, z768, th, tw)
    sync()
    one_pass_launches = dict(kernels.LAUNCHES)
    print(f"[path one_pass] f32 {th}x{tw} patches, launches {json.dumps(one_pass_launches)}")
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "conv3x3_chw": 7, "conv1x1_chw": 3,
            "upsample2_chw": 3}
    if one_pass_launches != want:
        fail(f"one-pass launches {one_pass_launches} != {want}")
    if not bool(torch.isfinite(one).all()) or one.shape != (1, th * P, tw * P, 3):
        fail(f"one-pass output {tuple(one.shape)} not finite or of the wrong shape")
    one = one[:, :768, :768].cpu().numpy()
    raster = generate_canvas(gen32, None, 768, 768, z_full=z768)
    d = np.abs(raster - one)
    print(f"[canvas f32 768^2, trained attention gate] raster vs one-pass: max abs "
          f"{d.max():.3e}, mean abs {d.mean():.3e} (the gate spreads sub-image edge "
          "padding into the cached halo: PARITY.md)")
    with torch.no_grad():
        gen32.attention.attn.gamma.zero_()
    one0 = generate_one_pass(gen32, z768, th, tw)[:, :768, :768].cpu().numpy()
    raster0 = generate_canvas(gen32, None, 768, 768, z_full=z768)
    err0 = float(np.abs(raster0 - one0).max())
    print(f"[canvas f32 768^2, gate zeroed] raster vs one-pass: max abs {err0:.3e} "
          f"limit {CANVAS_TOL:.1e} (the engine is exact; the limit covers cuDNN picking "
          "other algorithms for blocks 1-3 on a sub-image than on the whole canvas)")
    if not err0 <= CANVAS_TOL:
        fail(f"raster canvas differs from the one-pass oracle by {err0}")
    del gen32, one, raster, one0, raster0

    steps_h, steps_w, th1k, tw1k = canvas_geometry(1024, 1024, P, GRID, GRID)
    n_sub = steps_h * steps_w
    sync()
    kernels.reset_launches()
    t1 = time.perf_counter()
    img = generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024, wire="u8")
    sync()
    cold_s = time.perf_counter() - t1
    raster_launches = dict(kernels.LAUNCHES)
    print(f"[path raster] bf16 1024^2, {steps_h}x{steps_w} sub-images, "
          f"launches {json.dumps(raster_launches)}")
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "chw_halo_step": 7 * n_sub,
            "conv1x1_chw": 3 * n_sub, "upsample2_chw": 3 * n_sub}
    if n_sub != 16 or raster_launches != want:
        fail(f"raster launches {raster_launches} != {want} for {n_sub} sub-images")
    if img.shape != (1, 1024, 1024, 3) or img.dtype != np.uint8 or img.std() < 1.0:
        fail(f"canvas {img.shape} {img.dtype} std {img.std()}")
    def seam_ratio(u8):
        imgf = u8.astype(np.float64) / 127.5 - 1.0
        return seam_mse(imgf, P, width=1) / max(adjacent_mse_baseline(imgf), 1e-12)

    ratios = [seam_ratio(img)]
    walls = []
    for seed in (22, 23, 24):
        sync()
        t1 = time.perf_counter()
        more = generate_canvas(gen, torch.Generator(device=dev).manual_seed(seed), 1024, 1024,
                               wire="u8")
        sync()
        walls.append(time.perf_counter() - t1)
        ratios.append(seam_ratio(more))
    print(f"[quality] seam ratio 1024^2 (u8 canvas, width 1), seeds 21-24: "
          f"{', '.join(f'{r:.4f}' for r in ratios)} (mean {statistics.mean(ratios):.4f}); "
          "the JAX reference's band is 0.851-0.926 over its 3 seeds")
    print(f"[time] canvas 1024^2 bf16 u8 wall: cold {cold_s:.4f} s, warm "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (median {statistics.median(walls):.4f} s) "
          f"[{card}]")

    # One traced canvas: device busy time by kernel (torch.profiler, CUPTI).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t1 = time.perf_counter()
        generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024, wire="u8")
        sync()
        traced_s = time.perf_counter() - t1
    by_name, busy = device_busy_ms(prof)
    if busy > 0:
        print(f"[trace] canvas 1024^2 bf16 traced wall {traced_s:.4f} s, device busy "
              f"{busy / 1e3:.4f} s ({100 * busy / 1e3 / traced_s:.1f}% of the traced wall) "
              f"[{card}]")
        for name, (ms_, n_) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"[trace]   {ms_:9.3f} ms {n_:6d}x  {name[:110]}")
    else:
        print("[trace] device time: not measured (the profiler recorded no device events)")

    # Seed 21's latents once more, drawn as generate_canvas drew them: the
    # same canvas through the one-pass oracle (no sub-image edges) and with
    # the halo cache left out (a broken halo protocol); then, attention gate
    # zeroed, the raster canvas held to the one pass.
    def to_u8(x):
        return torch.clamp((x.float() * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()

    z21 = build_z_full(torch.Generator(device=dev).manual_seed(21), 1, gen.z_dim, gen.base_res,
                       th1k, tw1k, device=dev)
    if not np.array_equal(generate_canvas(gen, None, 1024, 1024, z_full=z21, wire="u8"), img):
        fail("seed 21's z_full does not reproduce the counted canvas")
    one21 = to_u8(generate_one_pass(gen, z21, th1k, tw1k)[:, :1024, :1024])
    stride, size = (GRID - 1) * P, GRID * P
    tiles = torch.zeros(1, th1k * P, tw1k * P, 3, device=dev)
    with torch.no_grad():
        for r in range(steps_h):
            for c in range(steps_w):
                sub, _ = gen(slice_sub_z(z21, r, c, gen.base_res, GRID, GRID))
                tiles[:, r * stride : r * stride + size, c * stride : c * stride + size] = sub.float()
    tiles = to_u8(tiles[:, :1024, :1024])
    r_one, r_broken = seam_ratio(one21), seam_ratio(tiles)
    seam_limit = r_one + SEAM_GAP_SHARE * (r_broken - r_one)
    print(f"[quality] seam ratio 1024^2, seed 21's latents: raster {ratios[0]:.4f}, one pass "
          f"{r_one:.4f} (no sub-image edges), sub-images without the halo cache "
          f"{r_broken:.4f} (a broken halo); limit {seam_limit:.4f} ({SEAM_GAP_SHARE:g} of the "
          "way from the one pass to the broken halo)")
    if not ratios[0] <= seam_limit:
        fail(f"seam ratio {ratios[0]} > {seam_limit}: the raster canvas shows sub-image seams")
    with torch.no_grad():
        gen.attention.attn.gamma.zero_()
    one0 = generate_one_pass(gen, z21, th1k, tw1k)[:, :1024, :1024]
    raster0 = generate_canvas(gen, None, 1024, 1024, z_full=z21, wire="f32")
    err_f = float(np.abs(raster0 - one0.float().cpu().numpy()).max())
    d = np.abs(to_u8(torch.from_numpy(raster0)).astype(np.int16) - to_u8(one0).astype(np.int16))
    print(f"[canvas bf16 1024^2, gate zeroed] raster vs one-pass: max abs {err_f:.3e} on "
          f"[-1, 1]; u8: max {int(d.max())} levels, {np.count_nonzero(d)} of {d.size} values "
          f"differ; limit {CANVAS_U8_TOL} levels (bf16 ulps from cuDNN's choices in blocks 1-3)")
    if not d.max() <= CANVAS_U8_TOL:
        fail(f"bf16 raster canvas differs from the one-pass oracle by {d.max()} u8 levels")
    print(f"[phase 4] checkpoint phases in {time.perf_counter() - t0:.1f} s")
    del gen, ckpt

    # -- 5. step parity: kernels against plain versions, full width, f32 ------
    t0 = time.perf_counter()
    parity = {fuse: step_parity(dev, EXP1_ARGS + ["--compute_dtype", "float32", "--fuse_up", fuse],
                                STEP_LAUNCHES[fuse], sync)
              for fuse in ("auto", "off")}
    fused_vs_unfused(parity["auto"], parity["off"])
    del parity
    print(f"[phase 5] step parity in {time.perf_counter() - t0:.1f} s")

    # -- 6. training runs: the train CLI's loop, bf16 --------------------------
    t0 = time.perf_counter()
    runs = {fuse: training_run(dev, EXP1_ARGS + ["--fuse_up", fuse], TRAIN_STEPS,
                               STEP_LAUNCHES[fuse], sync, card, ROOT / "build" / f"smoke_train_{fuse}")
            for fuse in ("auto", "off")}
    for fuse, (_, warm, busy) in runs.items():
        share = f"{busy:.2f} ms, {100 * busy / (warm * 1e3):.1f}%" if busy else "not measured"
        print(f"[train] --fuse_up {fuse}: warm step {warm * 1e3:.2f} ms ({1.0 / warm:.3f} "
              f"steps/s), device busy per traced step {share} [{card}]")
    print(f"[phase 6] training runs in {time.perf_counter() - t0:.1f} s")

    # -- 7. report ------------------------------------------------------------
    launches = {"conv3x3_chw": one_pass_launches["conv3x3_chw"]}
    for k in ("chw_halo_step", "conv1x1_chw", "upsample2_chw"):
        launches[k] = raster_launches[k]
    rows = []
    paths = [("generation", "", GEN_KERNELS, stats, launches, "per 384^2 sub-image")]
    paths += [(f"train --fuse_up {fuse}", f":train_{fuse}", [k for k, v in want.items() if v],
               tstats[fuse], runs[fuse][0], "per Experiment-1 step")
              for fuse, want in STEP_LAUNCHES.items()]
    for path, suffix, names, table_, counts, per in paths:
        for name in names:
            tag, src, line = KERNELS[name]
            s = table_[name]
            dom = "bytes" if s["nbytes"] / PEAK_BYTES_PER_S >= s["flops"] / PEAK_BF16_FLOP_PER_S else "operations"
            # the largest error over the kernel's value checks (its reductions'
            # where it has no value output: K7, K3-dW, stem dW)
            err, sum_err = stats[name]["err"], stats[name]["sum_err"]
            rows.append({
                "name": name + suffix, "path": path, "route": "cuda",
                "source": f"infinite_texture_gans_torch/csrc/{src}",
                "replaces": f"infinite_texture_gans_tpu/ops/pallas_conv.py:{line}",
                "launches": counts[name], "max_abs_err": err if err is not None else sum_err,
                "max_abs_err_sums": sum_err, "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": dom,
                "library_ms": s["library_ms"],
            })
            print(f"[kernel] {tag} {name}: {per} (bf16, sum over its shapes) "
                  f"{s['ms']:.4f} ms device (eager calls {s['eager_ms']:.4f} ms) vs bound "
                  f"{s['bound_ms']:.4f} ms ({dom}), plain "
                  f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms, launches "
                  f"{counts[name]} on the {path} path [{card}]")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
