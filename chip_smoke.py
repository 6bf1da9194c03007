#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports only
the PyTorch package (``infinite_texture_gans_torch``), never JAX.

1. Prints the card's name and power limit, builds the CUDA kernels of
   ``infinite_texture_gans_torch/csrc`` with nvcc.
2. Holds each kernel (K1-K4) against its plain PyTorch version at the
   flagship's shapes, in float32 with TF32 off and in bfloat16.
   The shapes are those of one 384^2 sub-image (the raster path) and, for
   K1, K3 and K4, those of the 768^2 one-pass grid too.
3. Loads the trained flagship checkpoint ``examples/241_300ep_ema.ckpt``:
   - float32, 768^2: the one-pass oracle (a main path: K1, K3, K4, launch
     counts read), then the raster engine against it;
   - bfloat16 (the checkpoint's compute type), 1024^2 through
     ``generate_canvas(wire='u8')`` (the main path: K2, K3, K4, launch
     counts read and held to 7/3/3 per sub-image), its seam ratio, and
     its warm wall time;
   - on the first canvas's latents: the seam ratio of the one pass and of
     sub-images generated without the halo cache (which set the raster's
     seam limit), and, attention gate zeroed, the bf16 raster canvas held to the bf16 one pass.
4. Times each kernel (CUDA events) beside its bound, its plain version and
   one PyTorch library call that computes the same function.
5. Prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line; so does a machine without
a card, or a directory that holds this file and nothing else of the repo.
"""

from __future__ import annotations

import json
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

KERNELS = {
    "conv3x3_chw": ("K1", "conv3x3_chw.cu", 344),
    "chw_halo_step": ("K2", "conv3x3_chw.cu", 482),
    "conv1x1_chw": ("K3", "conv1x1_chw.cu", 2276),
    "upsample2_chw": ("K4", "upsample2_chw.cu", 2535),
}


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

    stats = {k: dict(err=0.0, ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                     nbytes=0.0, flops=0.0) for k in KERNELS}

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
        stats[name]["err"] = max(stats[name]["err"], err)

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

    def account(name, shape_s, kernel_fn, plain_fn, lib_fn, nbytes, flops):
        """Time the kernel, its plain version and the library call (bf16,
        device time from CUDA-graph replay) and add them to the kernel's
        per-sub-image sums."""
        ms, plain, lib = device_ms(kernel_fn), device_ms(plain_fn), device_ms(lib_fn)
        eager = eager_ms(kernel_fn)
        b = bound_ms(nbytes, flops)
        s = stats[name]
        s["ms"] += ms
        s["eager_ms"] += eager
        s["plain_ms"] += plain
        s["library_ms"] += lib
        s["nbytes"] += nbytes
        s["flops"] += flops
        s["bound_ms"] += b
        by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_BF16_FLOP_PER_S else "operations"
        print(f"[time] {name} {shape_s}: kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
              f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, library {lib:.4f} ms  [{card}]")

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

    # -- 3. the flagship checkpoint through the port ------------------------
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
    want = {"conv3x3_chw": 7, "chw_halo_step": 0, "conv1x1_chw": 3, "upsample2_chw": 3}
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
    want = {"conv3x3_chw": 0, "chw_halo_step": 7 * n_sub, "conv1x1_chw": 3 * n_sub,
            "upsample2_chw": 3 * n_sub}
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t1 = time.perf_counter()
        generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024, wire="u8")
        sync()
        traced_s = time.perf_counter() - t1
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms_, n_ = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms_ + e.time_range.elapsed_us() / 1e3, n_ + 1)
    busy = sum(v[0] for v in by_name.values())
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
    print(f"[phase 3] checkpoint phases in {time.perf_counter() - t0:.1f} s")

    # -- 4/5. report ----------------------------------------------------------
    launches = {"conv3x3_chw": one_pass_launches["conv3x3_chw"]}
    for k in ("chw_halo_step", "conv1x1_chw", "upsample2_chw"):
        launches[k] = raster_launches[k]
    rows = []
    for name, (tag, src, line) in KERNELS.items():
        s = stats[name]
        dom = "bytes" if s["nbytes"] / PEAK_BYTES_PER_S >= s["flops"] / PEAK_BF16_FLOP_PER_S else "operations"
        rows.append({
            "name": name, "route": "cuda",
            "source": f"infinite_texture_gans_torch/csrc/{src}",
            "replaces": f"infinite_texture_gans_tpu/ops/pallas_conv.py:{line}",
            "launches": launches[name], "max_abs_err": s["err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": dom,
            "library_ms": s["library_ms"],
        })
        print(f"[kernel] {tag} {name}: per 384^2 sub-image (bf16, sum over its shapes) "
              f"{s['ms']:.4f} ms device (eager calls {s['eager_ms']:.4f} ms) vs bound "
              f"{s['bound_ms']:.4f} ms ({dom}), plain "
              f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms, launches "
              f"{launches[name]} [{card}]")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
