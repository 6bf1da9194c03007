#!/usr/bin/env python3
"""The float32 route of K9 dx (``upconv3x3_chw_dx``), K13's forward
(``stem_fwd``), K3-dW (``conv1x1_chw_dw``), K1/K2 (``conv3x3_chw``,
``conv3x3_chw_halo``), K6 (``conv3x3_chw_dx``), K7 (``conv3x3_chw_dw``),
K9's forward and K14 (``upconv3x3_chw``, ``upconv3x3_chw_halo``) and K9 dW
(``upconv3x3_chw_dw``), K13 dW (``stem_dw``), K15's backward
(``ssm.ssm_embed_bwd``), K15's forward (``ssm.ssm_embed``) and K13 dx
(``stem_dx``) on one CUDA card, with the graphed float32 steps they run in,
for one tree of the repository.

Run from the root of a checkout on a machine with a card:
``python3 f32_route_study.py [--tree DIR] [--out FILE] [--only NAMES]``
(``--only``: a comma-separated subset of the sections ``k9dx``, ``k13``,
``k3dw``, ``k1``, ``k6k7``, ``k9``, ``k14``, ``k13dw``, ``k15bwd``,
``k15fwd``, ``k15hid``, ``k13dx``, ``steps``; all by default). It
imports only the PyTorch package, from ``DIR`` where given (default: this
checkout), with that tree's ``chip_smoke.py`` for the train loop's run;
the kernels are built from that tree's sources into its own ``build/``.
The yardstick is this checkout's ``chip_smoke.py`` whatever the tree: its
graph-replay timer (``device_ms``), its bounds (``bound_ms`` of
``upconv_dx_work``, ``stem_fwd_work`` and the byte and FFMA counts of K3-dW
and K1) and ``card_line``. So another
tree, such as a parent commit unpacked with ``git archive`` into an ignored
directory, is timed by the same code; to compare two trees, run them in
turns in one call on one card (parent, this, this, parent).

For each kernel it times, by CUDA-graph replay with TF32 off, the port's
own call on float32 tensors at the Experiment-1 shapes (K9 dx: 52 -> 26 at
96^2 and 26 -> 13 at 192^2, N = 8, replicate padding, ReLU; K13: the 3 x
384^2 fakes, N = 8, to 64 channels, the same to ``--D_ch`` 640, and the SSM
recipe's 3 x 192^2) beside one PyTorch call for the same function (K9 dx:
``F.conv2d`` of g with the 4 x 4 phase kernels at stride 2, no folds or
mask; K13: ``F.conv2d`` writing NHWC) and the largest deviation from the
plain version. Where the tree has the float32 K9 dx planner
(``kernels.upconv_dx_f32_plan``), it also times the C entry point at each
CC of UPCONV_DX_F32_CC: the plan table UPCONV_DX_F32_COST is read from.
K3-dW at the shortcuts of the Experiment-1 steps (``auto``: 52 -> 26 at
96^2 and 26 -> 13 at 192^2; ``off``: 52 -> 26 at 192^2, also the SSM step's,
and 26 -> 13 at 384^2; N = 8) beside ``conv2d_weight``; K1 at every float32
training shape (N = 8; K5's sums where the path takes them) beside
``F.conv2d`` of the post-norm input padded beforehand, and, where the tree has
``kernels.conv3x3_f32_plan``, the C entry point at each (TO, G) plan; K1
and K2 (both cached borders) at the flagship's 384^2 sub-image at eval
(blocks 4-6, N = 1), the float32 canvases' shapes. K6 and K7 at every
float32 training shape (K1's, replicate padding, ReLU) beside
``torch.nn.grad.conv2d_input`` and ``conv2d_weight`` (TF32 off; K7's on the
post-norm input padded beforehand), each row with its largest deviation
from the plain version; where the tree has ``kernels.conv3x3_dx_f32_plan``
and ``conv3x3_dw_f32_plan``, the C entry points at each plan (K6's (CC, G);
K7's chunk heights). K9's forward with its sums and K9 dW at the
Experiment-1 ``auto`` step's two fused up-convs (N = 8, 52 -> 26 at 96^2 and
26 -> 13 at 192^2 half resolution) beside ``F.interpolate`` + ``F.conv2d``
and ``conv2d_weight`` of the upsampled post-norm input (TF32 off), and K9
(one pass) and K14 in its four border cases at the ``--fuse_up all``
sub-image's three fused conv1 sites (N = 1, 104 -> 52 at 48^2 ... 26 -> 13
at 192^2) beside ``F.interpolate`` of the bordered slab + ``F.conv2d``;
each row with its bound (``bound_ms`` of ``upconv_dx_work``'s FLOPs and the
kernel's own bytes) and its largest deviation from the plain version; where
the tree has ``kernels.upconv_f32_plan`` and ``upconv_dw_f32_plan``, the C
entry points at each plan (the forward's (TO, G); dW's chunk heights). K13 dW
at the Experiment-1 fakes (N = 8, 3 x 384^2 -> 64), the same to ``--D_ch``
512 and the SSM recipe's 3 x 192^2, beside ``conv2d_weight`` at stride 2
(TF32 off), with its bound (``stem_fwd_work``: the same bytes and FLOPs);
K15's backward at the SSM step's three sites (N = 8, map_dim 1, 128 hidden
channels, 192^2: Co 104 at bn1 and the shortcut's bn3, 52 at bn2) beside
``conv2d_weight`` + ``conv2d_input`` + ``conv2d_weight`` (no ReLU mask, no
biases' sums), with its bound (FFMA at 67 TFLOP/s) and each of its launches
on its own (device time by kernel name from a ``torch.profiler`` trace of
ten calls, ``chip_smoke.py: device_busy_ms``); where the tree has
``kernels.stem_dw_f32_plan`` and ``ssm.bwd_f32_plan``, the C entry points at
each plan they choose from. K15's forward at the SSM step's three sites
and at the SSM eval sub-image's four (N = 1: Co 208 and 104 at 96^2, 104
and 52 at 192^2) beside ``F.conv2d`` -> ReLU -> ``F.conv2d`` (TF32 off),
with its bound (FFMA at 67 TFLOP/s), each of its launches at the training
sites (profiler, ten calls) and, where the tree has ``ssm.fwd_f32_plan``,
the C entry point at each plan (``k15hid``: at the planned one also a copy
of this tree's forward without its later hidden chunks, built into
``build/k15hid``, for the hidden activation's share of a call); K13 dx at
the Experiment-1 fakes, the SSM recipe's and ``--D_ch`` 640 beside
``conv2d_input`` at stride 2 (TF32 off), with its bound
(``stem_fwd_work``); both with their largest deviation from the plain
version and whether two calls give the same bits. Then it runs the train
loop's graphed float32 steps (Experiment-1 ``--fuse_up auto`` and ``off``,
and the SSM recipe; ``--compute_dtype float32``, cuDNN's TF32 as PyTorch
leaves it, which is how the train CLI runs them) through
``chip_smoke.py: training_run`` (the warm step: the median of the steps
before the traced window; the device busy time per traced step). The
card's name and power limit head the output; the last line is one JSON
object, also written to ``--out`` (default ``build/f32_route_study.json``
of this checkout).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as yard

HERE = Path(__file__).resolve().parent
# K9 dx: (N, C, Co, H, W) of x at half resolution; K13: (N, C, H, W, Co)
DX_SHAPES = ((8, 52, 26, 96, 96), (8, 26, 13, 192, 192))
STEM_SHAPES = {"Exp-1": (8, 3, 384, 384, 64), "--D_ch 640": (8, 3, 384, 384, 640),
               "SSM": (8, 3, 192, 192, 64)}
# K13 dW: (N, C, H, W, Co) and the paths that run it once a step
STEM_DW_SHAPES = {"Exp-1": ((8, 3, 384, 384, 64), ("auto", "off")),
                  "--D_ch 512": ((8, 3, 384, 384, 512), ()),
                  "SSM": ((8, 3, 192, 192, 64), ("ssm",))}
# K15's backward: (N, md, hid, H, W, Co) and its calls a SSM step (bn1 and
# the shortcut's bn3 modulate 52 channels, bn2 26: Co = 2C gamma|beta)
K15_SHAPES = {(8, 1, 128, 192, 192, 104): 2, (8, 1, 128, 192, 192, 52): 1}
# K15's forward at eval: the SSM sub-image's sites (N = 1) and their calls a
# 192^2 sub-image
K15_EVAL_SHAPES = {(1, 1, 128, 96, 96, 208): 2, (1, 1, 128, 96, 96, 104): 1,
                   (1, 1, 128, 192, 192, 104): 2, (1, 1, 128, 192, 192, 52): 1}
# K13 dx: (N, C, H, W, Co) of dx and the paths that run it once a step
STEM_DX_SHAPES = {"Exp-1": ((8, 3, 384, 384, 64), ("auto", "off")),
                  "--D_ch 640": ((8, 3, 384, 384, 640), ()),
                  "SSM": ((8, 3, 192, 192, 64), ("ssm",))}
SECTIONS = ("k9dx", "k13", "k3dw", "k1", "k6k7", "k9", "k14", "k13dw", "k15bwd", "k15fwd", "k15hid",
            "k13dx", "steps")
# the line of csrc/ssm_embed_chw.cu that computes K15's forward's next
# hidden chunk; k15hid times the forward without it
K15_HIDDEN_CALL = "      hidden((k + 1) * kKC, s_h + (cur ^ 1) * kKC * kFHC);\n"
# K3-dW: (N, C, Co, H, W) and the paths that run it once a step
DW_SHAPES = {(8, 52, 26, 96, 96): ("auto",), (8, 26, 13, 192, 192): ("auto",),
             (8, 52, 26, 192, 192): ("off", "ssm"), (8, 26, 13, 384, 384): ("off",)}
# K1 in training: (N, C, Co, H, W, with K5's sums) and the paths that run it
# once a step
K1_SHAPES = {(8, 26, 26, 192, 192, False): ("auto", "off", "ssm"),
             (8, 13, 13, 384, 384, False): ("auto", "off"),
             (8, 13, 3, 384, 384, False): ("auto", "off"),
             (8, 52, 26, 192, 192, True): ("off", "ssm"),
             (8, 26, 13, 384, 384, True): ("off",),
             (8, 26, 3, 192, 192, False): ("ssm",)}
# K9 (forward with its sums, dW) in the Experiment-1 `auto` step: (N, C, Co,
# H, W) of x at half resolution; K9 / K14 at eval: the `--fuse_up all`
# sub-image's fused conv1 sites (N = 1)
K9_SHAPES = ((8, 52, 26, 96, 96), (8, 26, 13, 192, 192))
K14_SHAPES = ((1, 104, 52, 48, 48), (1, 52, 26, 96, 96), (1, 26, 13, 192, 192))
K14_BORDERS = {"no cache": (False, False), "top only": (True, False), "left only": (False, True),
               "top and left": (True, True)}
# K1 / K2 at eval: the flagship's 384^2 sub-image, blocks 4-6 (N = 1)
EVAL_SHAPES = ((1, 104, 52, 96, 96), (1, 52, 52, 96, 96), (1, 52, 26, 192, 192),
               (1, 26, 26, 192, 192), (1, 26, 13, 384, 384), (1, 13, 13, 384, 384),
               (1, 13, 3, 384, 384))


def tree_chip_smoke(tree: Path):
    """The tree's own ``chip_smoke.py`` (its train loop's run)."""
    if tree == HERE:
        return yard
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hidden_ablated_fwd(tree: Path, build):
    """``itg_ssm_embed_fwd`` built from a copy of the tree's
    ``csrc/ssm_embed_chw.cu`` without K15_HIDDEN_CALL, so that only chunk 0's
    hidden activation is computed and the later chunks read stale stages:
    the time it saves is the hidden activation's share of a call. Its
    output is wrong; it is timed and never compared."""
    csrc = tree / "infinite_texture_gans_torch" / "csrc"
    text = (csrc / "ssm_embed_chw.cu").read_text()
    if text.count(K15_HIDDEN_CALL) != 1:
        raise SystemExit(f"k15hid: {csrc / 'ssm_embed_chw.cu'} has no single hidden() call to cut")
    out = tree / "build" / "k15hid"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "ssm_embed_chw_nohidden.cu", out / "libssm_embed_chw_nohidden.so"
    src.write_text(text.replace(K15_HIDDEN_CALL, ""))
    subprocess.run([build._nvcc(), *build.FLAGS, "-shared", "-I", str(csrc), str(src), "-o",
                    str(so)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).itg_ssm_embed_fwd
    fn.argtypes, fn.restype = build.SIGNATURES["itg_ssm_embed_fwd"], ctypes.c_int
    return fn


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=HERE)
    parser.add_argument("--out", type=Path, default=HERE / "build" / "f32_route_study.json")
    parser.add_argument("--only", default=",".join(SECTIONS),
                        help="comma-separated sections to run: " + ", ".join(SECTIONS))
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if only - set(SECTIONS):
        parser.error(f"--only: unknown sections {sorted(only - set(SECTIONS))}")
    if not torch.cuda.is_available():
        print("f32_route_study: needs a CUDA card", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch.nn.functional as F

    from infinite_texture_gans_torch.ops import _build, kernels, ssm
    from infinite_texture_gans_torch.utils.flops import CARD_PEAKS, H100_SXM

    if Path(kernels.__file__).resolve().parents[2] != tree:
        raise SystemExit(f"f32_route_study: imported {kernels.__file__}, not from {tree}")
    cs = tree_chip_smoke(tree)
    bytes_per_s, _, f32_flop_per_s = CARD_PEAKS[H100_SXM]
    card = yard.card_line()
    print(f"card: {card}")
    print(f"tree: {tree}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if line.startswith("==") or "upconv_dx" in line or "stem_fwd" in line or (
                    "registers" in line or "spill" in line):
                print(f"[build] {line.strip()}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(tree), "card": card, "upconv3x3_chw_dx": {}, "stem_fwd": {},
           "conv1x1_chw_dw": {}, "conv3x3_chw": {}, "eval": {}, "conv3x3_chw_dx": {},
           "conv3x3_chw_dw": {}, "upconv3x3_chw": {}, "upconv3x3_chw_dw": {}, "k14": {},
           "stem_dw": {}, "ssm_embed_bwd": {}, "ssm_embed": {}, "stem_dx": {}, "per_step": {},
           "steps": {}, "plans": {}, "hidden": {}}
    plans = hasattr(kernels, "upconv_dx_f32_plan")

    def err(got, ref):
        return max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))

    for i, (n, c, co, h, w) in enumerate(DX_SHAPES if "k9dx" in only else ()):
        g_ = torch.Generator(device=dev).manual_seed(700 + i)
        x = torch.randn(n, c, h, w, device=dev, generator=g_)
        wt = torch.randn(co, c, 3, 3, device=dev, generator=g_) * (9 * c) ** -0.5
        sc = 1 + 0.1 * torch.randn(c, device=dev, generator=g_)
        sh = 0.1 * torch.randn(c, device=dev, generator=g_)
        gy = torch.randn(n, co, 2 * h, 2 * w, device=dev, generator=g_)
        wt4 = kernels._upconv_dx_weights(wt).transpose(0, 1).contiguous()
        got = kernels.upconv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate")
        ref = kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate")
        row = {"ms": yard.device_ms(lambda: kernels.upconv3x3_chw_dx(
                   x, gy, wt, sc, sh, True, "replicate")),
               "library_ms": yard.device_ms(lambda: F.conv2d(gy, wt4, stride=2, padding=1)),
               "bound_ms": yard.bound_ms(*yard.upconv_dx_work(n, c, co, h, w, 4), f32_flop_per_s,
                                         bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max())}
        key = f"({n}, {c}->{co}, {h}x{w} -> {2 * h}x{2 * w})"
        out["upconv3x3_chw_dx"][key] = row
        for cc in kernels.UPCONV_DX_F32_CC if plans else ():
            groups = -(-c // cc)
            plan = kernels.upconv_dx_f32_plan(n, c, co, h, w)._replace(
                cc=cc, groups=groups, wq_numel=co * groups * 16 * (-(-cc // 4) * 4))
            dx = torch.empty_like(x)
            wq = torch.empty(plan.wq_numel, device=dev)
            part = torch.empty(plan.part_rows, 2 * c, device=dev)
            dsc, dsh = torch.empty(c, device=dev), torch.empty(c, device=dev)

            def entry():
                rc = kernels._lib().itg_upconv3x3_chw_dx(
                    x.data_ptr(), gy.data_ptr(), wt.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                    wq.data_ptr(), dx.data_ptr(), part.data_ptr(), dsc.data_ptr(),
                    dsh.data_ptr(), n, c, h, w, co, 1, 0, 0, plan.cc, plan.groups, plan.tiles_h,
                    plan.tiles_w, kernels._stream(x))
                if rc:
                    raise RuntimeError(f"itg_upconv3x3_chw_dx: CUDA error {rc}")

            entry()
            plan_ms = yard.device_ms(entry)
            out["plans"][f"upconv3x3_chw_dx {key} cc {cc}"] = plan_ms
            print(f"[plan] upconv3x3_chw_dx f32 {key}: cc {cc}: {plan_ms:.4f} ms, max abs err "
                  f"{float((dx - ref[0]).abs().max()):.3e}  [{card}]")
        print(f"[time] upconv3x3_chw_dx f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
    for label, (n, c, h, w, co) in (STEM_SHAPES if "k13" in only else {}).items():
        g_ = torch.Generator(device=dev).manual_seed(600)
        x = torch.randn(n, c, h, w, device=dev, generator=g_)
        wt = torch.randn(co, c, 4, 4, device=dev, generator=g_) * (16 * c) ** -0.5
        b = torch.randn(co, device=dev, generator=g_)
        wcl = wt.contiguous(memory_format=torch.channels_last)
        got = kernels.stem_fwd(x, wt, b)
        ref = kernels.stem_fwd_plain(x, wt, b)
        row = {"ms": yard.device_ms(lambda: kernels.stem_fwd(x, wt, b)),
               "library_ms": yard.device_ms(lambda: F.conv2d(x, wcl, b, stride=2, padding=1)),
               "bound_ms": yard.bound_ms(*yard.stem_fwd_work(n, c, h, w, co, 4), f32_flop_per_s,
                                         bytes_per_s),
               "max_abs_err": err((got,), (ref,)), "max_ref": float(ref.abs().max())}
        key = f"{label} ({n}, {c}, {h}x{w}) -> ({n}, {h // 2}, {w // 2}, {co})"
        out["stem_fwd"][key] = row
        print(f"[time] stem_fwd f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        del x, got, ref

    def per_step(name, paths, ms, lib, bound):
        for path in paths:
            row = out["per_step"].setdefault(f"{name} {path}", dict(ms=0.0, library_ms=0.0,
                                                                    bound_ms=0.0))
            row["ms"] += ms
            row["library_ms"] += lib
            row["bound_ms"] += bound

    for i, ((n, c, co, h, w), paths) in enumerate((DW_SHAPES if "k3dw" in only else {}).items()):
        g_ = torch.Generator(device=dev).manual_seed(800 + i)
        x = torch.randn(n, c, h, w, device=dev, generator=g_)
        gy = torch.randn(n, co, h, w, device=dev, generator=g_)
        got = kernels.conv1x1_chw_dw(x, gy)
        ref = kernels.conv1x1_chw_dw_plain(x, gy)
        act = n * h * w
        row = {"ms": yard.device_ms(lambda: kernels.conv1x1_chw_dw(x, gy)),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_weight(
                   x, (co, c, 1, 1), gy)),
               "bound_ms": yard.bound_ms(act * (c + co) * 4 + (co * c + co) * 4,
                                         2.0 * act * co * c, f32_flop_per_s, bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max())}
        key = f"({n}, {c}->{co}, {h}x{w})"
        out["conv1x1_chw_dw"][key] = row
        per_step("conv1x1_chw_dw", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] conv1x1_chw_dw f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        del x, gy

    k1_plans = hasattr(kernels, "conv3x3_f32_plan")

    def k1_inputs(seed, n, c, co, h, w):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(n, c, h, w, device=dev, generator=g_)
        wt = torch.randn(co, c, 3, 3, device=dev, generator=g_) * (9 * c) ** -0.5
        b = 0.1 * torch.randn(co, device=dev, generator=g_)
        sc = 1 + 0.1 * torch.randn(c, device=dev, generator=g_)
        sh = 0.1 * torch.randn(c, device=dev, generator=g_)
        top = torch.relu(torch.randn(n, c, w + 2, device=dev, generator=g_))
        left = torch.relu(torch.randn(n, c, h, device=dev, generator=g_))
        a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
        return x, wt, b, sc, sh, top, left, a_pad

    def k1_plan_table(key, x, wt, b, sc, sh):
        """The C entry point at each (TO, G) the kernel takes."""
        n, c, h, w = x.shape
        co = wt.shape[0]
        y = torch.empty(n, co, h, w, device=dev)
        for to in kernels.CONV3X3_F32_TO:
            for g in kernels.CONV3X3_F32_G:
                if g > -(-co // to) and g > 1:
                    continue

                def entry():
                    rc = kernels._lib().itg_conv3x3_chw(
                        x.data_ptr(), wt.data_ptr(), b.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                        None, None, y.data_ptr(), None, None, None, n, c, h, w, co, 1, 0, 0, to,
                        g, kernels._stream(x))
                    if rc:
                        raise RuntimeError(f"itg_conv3x3_chw: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"conv3x3_chw {key} to {to} g {g}"] = plan_ms
                print(f"[plan] conv3x3_chw f32 {key}: to {to} g {g}: {plan_ms:.4f} ms  [{card}]")

    for i, ((n, c, co, h, w, stats), paths) in enumerate((K1_SHAPES if "k1" in only else {}).items()):
        x, wt, b, sc, sh, _, _, a_pad = k1_inputs(820 + i, n, c, co, h, w)
        got = kernels.conv3x3_chw(x, wt, b, sc, sh, True)
        ref = kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True)
        act = n * h * w
        row = {"ms": yard.device_ms(lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True,
                                                                want_stats=stats)),
               "library_ms": yard.device_ms(lambda: F.conv2d(a_pad, wt, b)),
               "bound_ms": yard.bound_ms(act * (c + co) * 4 + (co * c * 9 + co + 2 * c) * 4,
                                         2.0 * act * co * c * 9, f32_flop_per_s, bytes_per_s),
               "max_abs_err": err((got,), (ref,)), "max_ref": float(ref.abs().max())}
        key = f"({n}, {c}->{co}, {h}x{w}){' +stats' if stats else ''}"
        out["conv3x3_chw"][key] = row
        per_step("conv3x3_chw", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] conv3x3_chw f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        if k1_plans:
            k1_plan_table(key, x, wt, b, sc, sh)
        del x, got, ref, a_pad
    for i, (n, c, co, h, w) in enumerate(EVAL_SHAPES if "k1" in only else ()):
        x, wt, b, sc, sh, top, left, a_pad = k1_inputs(840 + i, n, c, co, h, w)
        got = kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", top, left)
        ref = kernels.conv3x3_chw_halo_plain(x, wt, b, sc, sh, True, "replicate", top, left)
        row = {"k1_ms": yard.device_ms(lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True)),
               "k2_ms": yard.device_ms(lambda: kernels.conv3x3_chw_halo(
                   x, wt, b, sc, sh, True, "replicate", top, left)),
               "library_ms": yard.device_ms(lambda: F.conv2d(a_pad, wt, b)),
               "k2_max_abs_err": err((got,), (ref,))}
        key = f"({n}, {c}->{co}, {h}x{w})"
        out["eval"][key] = row
        print(f"[time] eval f32 {key}: K1 {row['k1_ms']:.4f} ms, K2 (both borders) "
              f"{row['k2_ms']:.4f} ms, library {row['library_ms']:.4f} ms, K2 max abs err "
              f"{row['k2_max_abs_err']:.3e}  [{card}]")
        if k1_plans:
            k1_plan_table(key, x, wt, b, sc, sh)
        del x, got, ref, a_pad
    bwd_plans = hasattr(kernels, "conv3x3_dx_f32_plan")

    def k6_plan_table(key, x, gy, wt, sc, sh):
        """K6's C entry point at each (CC, G) it takes."""
        n, c, h, w = x.shape
        co = wt.shape[0]
        dx = torch.empty_like(x)
        dsc, dsh = torch.empty(c, device=dev), torch.empty(c, device=dev)
        part = torch.empty(kernels.conv3x3_dx_f32_plan(n, c, co, h, w).part_rows, 2 * c,
                           device=dev)
        for cc in kernels.CONV3X3_F32_TO:
            for g in kernels.CONV3X3_F32_G:
                if g > -(-c // cc) and g > 1:
                    continue

                def entry():
                    rc = kernels._lib().itg_conv3x3_chw_dx(
                        x.data_ptr(), gy.data_ptr(), wt.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                        dx.data_ptr(), part.data_ptr(), dsc.data_ptr(), dsh.data_ptr(), n, c, h, w,
                        co, 1, 0, 0, cc, g, kernels._stream(x))
                    if rc:
                        raise RuntimeError(f"itg_conv3x3_chw_dx: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"conv3x3_chw_dx {key} cc {cc} g {g}"] = plan_ms
                print(f"[plan] conv3x3_chw_dx f32 {key}: cc {cc} g {g}: {plan_ms:.4f} ms  [{card}]")

    def k7_plan_table(key, x, gy, sc, sh):
        """K7's C entry point at the planned pixel slots and each chunk height
        of CONV3X3_DW_F32_ROWS that gives every slot a run and whose two
        stages fit the shared memory: the table CONV3X3_DW_F32_CHUNK_COST is
        read from."""
        n, c, h, w = x.shape
        co = gy.shape[1]
        plan = kernels.conv3x3_dw_f32_plan(n, c, co, h, w, kernels._sm_count(dev.index or 0))
        dw, db = torch.empty(co, c, 3, 3, device=dev), torch.empty(co, device=dev)
        part = torch.empty(plan.blocks, plan.part_entries, device=dev)
        cols = kernels.CONV3X3_DW_F32_COLS
        for rows in kernels.CONV3X3_DW_F32_ROWS:
            stage = 4 * ((rows + 2) * 13 * plan.tiles_c * (cols + 3)
                         + rows * 3 * plan.tiles_o * (cols + 1))
            if (plan.slots * kernels.CONV3X3_DW_F32_RUN > rows * cols
                    or 2 * stage + 8 * 13 * 4 > kernels.CONV3X3_DW_F32_SMEM):
                continue

            def entry():
                rc = kernels._lib().itg_conv3x3_chw_dw(
                    x.data_ptr(), gy.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), n, c, h, w, co, 1, 0, 0, plan.blocks,
                    plan.slots, rows, kernels._stream(x))
                if rc:
                    raise RuntimeError(f"itg_conv3x3_chw_dw: CUDA error {rc}")

            plan_ms = yard.device_ms(entry)
            out["plans"][f"conv3x3_chw_dw {key} rows {rows}"] = plan_ms
            print(f"[plan] conv3x3_chw_dw f32 {key}: slots {plan.slots} rows {rows}"
                  f"{' (planned)' if rows == plan.rows else ''}: {plan_ms:.4f} ms  [{card}]")

    for i, ((n, c, co, h, w, _), paths) in enumerate((K1_SHAPES if "k6k7" in only else {}).items()):
        x, wt, _, sc, sh, _, _, a_pad = k1_inputs(860 + i, n, c, co, h, w)
        gy = torch.randn(n, co, h, w, device=dev, generator=torch.Generator(device=dev).manual_seed(
            880 + i))
        act, weights = n * h * w, (co * c * 9 + co) * 4
        key = f"({n}, {c}->{co}, {h}x{w})"
        got = kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate")
        ref = kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate")
        row = {"ms": yard.device_ms(lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True,
                                                                   "replicate")),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_input(
                   x.shape, wt, gy, padding=1)),
               "bound_ms": yard.bound_ms(act * (2 * c + co) * 4 + weights + 4 * c * 4,
                                         2.0 * act * co * c * 9, f32_flop_per_s, bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max())}
        out["conv3x3_chw_dx"][key] = row
        per_step("conv3x3_chw_dx", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] conv3x3_chw_dx f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        if bwd_plans:
            k6_plan_table(key, x, gy, wt, sc, sh)
        got = kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate")
        ref = kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate")
        row = {"ms": yard.device_ms(lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True,
                                                                   "replicate")),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_weight(
                   a_pad, wt.shape, gy)),
               "bound_ms": yard.bound_ms(act * (c + co) * 4 + weights + 2 * c * 4,
                                         2.0 * act * co * c * 9, f32_flop_per_s, bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max())}
        out["conv3x3_chw_dw"][key] = row
        per_step("conv3x3_chw_dw", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] conv3x3_chw_dw f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        if bwd_plans:
            k7_plan_table(key, x, gy, sc, sh)
        del x, gy, got, ref, a_pad
    up_plans = hasattr(kernels, "upconv_f32_plan")

    def k9_plan_table(key, x, wt, b, sc, sh):
        """K9's C entry point (no sums) at each (TO, G) of UPCONV_F32_TO and
        UPCONV_F32_G that its groups fill: the table the planner is read
        from."""
        n, c, h, w = x.shape
        co = wt.shape[0]
        y = torch.empty(n, co, 2 * h, 2 * w, device=dev)
        planned = kernels.upconv_f32_plan(n, c, co, h, w, kernels._sm_count(dev.index or 0))
        for to in kernels.UPCONV_F32_TO:
            groups = -(-co // to)
            for g in kernels.UPCONV_F32_G:
                if g > groups and g > 1:
                    continue
                wp = torch.empty(-(-groups // g) * c * 16 * g * to, device=dev)

                def entry():
                    rc = kernels._lib().itg_upconv3x3_chw(
                        x.data_ptr(), wt.data_ptr(), b.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                        None, None, wp.data_ptr(), y.data_ptr(), None, None, None, n, c, h, w, co,
                        1, 0, 0, to, g, kernels._stream(x))
                    if rc:
                        raise RuntimeError(f"itg_upconv3x3_chw: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"upconv3x3_chw {key} to {to} g {g}"] = plan_ms
                mark = " (planned)" if (to, g) == (planned.to, planned.g) else ""
                print(f"[plan] upconv3x3_chw f32 {key}: to {to} g {g}{mark}: {plan_ms:.4f} ms  "
                      f"[{card}]")

    def k9dw_plan_table(key, x, gy, sc, sh):
        """K9 dW's C entry point at the planned pixel slots and each chunk
        height of UPCONV_DW_F32_ROWS that gives every slot a run and whose two
        stages fit the shared memory: the table UPCONV_DW_F32_CHUNK_COST is
        read from."""
        n, c, h, w = x.shape
        co = gy.shape[1]
        plan = kernels.upconv_dw_f32_plan(n, c, co, h, w, kernels._sm_count(dev.index or 0))
        dw, db = torch.empty(co, c, 3, 3, device=dev), torch.empty(co, device=dev)
        part = torch.empty(plan.blocks, plan.part_entries, device=dev)
        for rows in kernels.UPCONV_DW_F32_ROWS:
            stage = kernels.upconv_dw_stage_bytes(rows, plan.tiles_o, plan.tiles_c)
            if (plan.slots * kernels.UPCONV_DW_F32_RUN > rows * kernels.UPCONV_DW_F32_COLS
                    or 2 * stage > kernels.CONV3X3_DW_F32_SMEM):
                continue

            def entry():
                rc = kernels._lib().itg_upconv3x3_chw_dw(
                    x.data_ptr(), gy.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), n, c, h, w, co, 1, 0, 0, plan.blocks,
                    plan.slots, rows, kernels._stream(x))
                if rc:
                    raise RuntimeError(f"itg_upconv3x3_chw_dw: CUDA error {rc}")

            plan_ms = yard.device_ms(entry)
            out["plans"][f"upconv3x3_chw_dw {key} rows {rows}"] = plan_ms
            print(f"[plan] upconv3x3_chw_dw f32 {key}: slots {plan.slots} rows {rows}"
                  f"{' (planned)' if rows == plan.rows else ''}: {plan_ms:.4f} ms  [{card}]")

    def k9_inputs(seed, n, c, co, h, w):
        x, wt, b, sc, sh, top, left, _ = k1_inputs(seed, n, c, co, h, w)
        a_half = kernels.prenorm(x, sc, sh, True)
        return x, wt, b, sc, sh, top, left, a_half

    for i, (n, c, co, h, w) in enumerate(K9_SHAPES if "k9" in only else ()):
        x, wt, b, sc, sh, _, _, a_half = k9_inputs(900 + i, n, c, co, h, w)
        gy = torch.randn(n, co, 2 * h, 2 * w, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(920 + i))
        a_up = F.pad(kernels.upsample2_chw_plain(a_half), (1, 1, 1, 1), mode="replicate")
        nbytes, flops = yard.upconv_dx_work(n, c, co, h, w, 4)
        act, weights = n * h * w, (co * c * 9 + co + 2 * c) * 4
        key = f"({n}, {c}->{co}, {h}x{w} -> {2 * h}x{2 * w})"
        got = kernels.upconv3x3_chw(x, wt, b, sc, sh, True, want_stats=True)
        ref = kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, want_stats=True)
        row = {"ms": yard.device_ms(lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True,
                                                                  want_stats=True)),
               "library_ms": yard.device_ms(lambda: F.conv2d(
                   F.interpolate(a_half, scale_factor=2, mode="nearest"), wt, b, padding=1)),
               "bound_ms": yard.bound_ms(act * (c + 4 * co) * 4 + weights + 2 * co * 4, flops,
                                         f32_flop_per_s, bytes_per_s),
               "max_abs_err": err(got[:1], ref[:1]), "max_ref": float(ref[0].abs().max())}
        out["upconv3x3_chw"][key] = row
        per_step("upconv3x3_chw", ("auto",), row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] upconv3x3_chw f32 {key} +stats: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        if up_plans:
            k9_plan_table(key, x, wt, b, sc, sh)
        got = kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, "replicate")
        ref = kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate")
        row = {"ms": yard.device_ms(lambda: kernels.upconv3x3_chw_dw(x, gy, sc, sh, True,
                                                                     "replicate")),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_weight(
                   a_up, wt.shape, gy)),
               "bound_ms": yard.bound_ms(act * (c + 4 * co) * 4 + weights, flops,
                                         f32_flop_per_s, bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max())}
        out["upconv3x3_chw_dw"][key] = row
        per_step("upconv3x3_chw_dw", ("auto",), row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] upconv3x3_chw_dw f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e})  [{card}]")
        if up_plans:
            k9dw_plan_table(key, x, gy, sc, sh)
        del x, gy, got, ref, a_half, a_up
    for i, (n, c, co, h, w) in enumerate(K14_SHAPES if "k14" in only else ()):
        x, wt, b, sc, sh, top, left, a_half = k9_inputs(940 + i, n, c, co, h, w)
        _, flops = yard.upconv_dx_work(n, c, co, h, w, 4)
        io, weights = n * h * w * (c + 4 * co) * 4, (co * c * 9 + co + 2 * c) * 4
        key = f"({n}, {c}->{co}, {h}x{w} -> {2 * h}x{2 * w})"
        row = {"k9_ms": yard.device_ms(lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True)),
               "k9_library_ms": yard.device_ms(lambda: F.conv2d(
                   F.interpolate(a_half, scale_factor=2, mode="nearest"), wt, b, padding=1)),
               "bound_ms": yard.bound_ms(io + (h + w + 2) * c * 4 * n + weights, flops,
                                         f32_flop_per_s, bytes_per_s)}
        for case, (t_, l_) in K14_BORDERS.items():
            tb, lb = (top if t_ else None), (left if l_ else None)
            got = kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", tb, lb)
            ref = kernels.upconv3x3_chw_halo_plain(x, wt, b, sc, sh, True, "replicate", tb, lb)
            slab = kernels._halo_padded(x, sc, sh, True, "replicate", tb, lb)
            row[case] = {
                "ms": yard.device_ms(lambda: kernels.upconv3x3_chw_halo(
                    x, wt, b, sc, sh, True, "replicate", tb, lb)),
                "library_ms": yard.device_ms(lambda: F.conv2d(
                    F.interpolate(slab, scale_factor=2, mode="nearest")[..., 1:-1, 1:-1], wt, b)),
                "max_abs_err": err((got,), (ref,))}
            print(f"[time] upconv3x3_chw_halo (K14) f32 {key} {case}: kernel "
                  f"{row[case]['ms']:.4f} ms, library {row[case]['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms, max abs err {row[case]['max_abs_err']:.3e}  [{card}]")
        out["k14"][key] = row
        print(f"[time] upconv3x3_chw (K9, one pass) f32 {key}: kernel {row['k9_ms']:.4f} ms, "
              f"library {row['k9_library_ms']:.4f} ms  [{card}]")
        if up_plans:
            k9_plan_table(key, x, wt, b, sc, sh)
        del x, got, ref, a_half
    stem_dw_plans = hasattr(kernels, "stem_dw_f32_plan")
    for label, ((n, c, h, w, co), paths) in (STEM_DW_SHAPES if "k13dw" in only else {}).items():
        g_ = torch.Generator(device=dev).manual_seed(960)
        x = torch.randn(n, c, h, w, device=dev, generator=g_)
        gy = torch.randn(n, h // 2, w // 2, co, device=dev, generator=g_)
        g_nchw = gy.permute(0, 3, 1, 2)
        got = kernels.stem_dw(x, gy)
        ref = kernels.stem_dw_plain(x, gy)
        row = {"ms": yard.device_ms(lambda: kernels.stem_dw(x, gy)),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_weight(
                   x, (co, c, 4, 4), g_nchw, stride=2, padding=1)),
               "bound_ms": yard.bound_ms(*yard.stem_fwd_work(n, c, h, w, co, 4), f32_flop_per_s,
                                         bytes_per_s),
               "max_abs_err": err(got, ref), "max_ref": float(ref[0].abs().max()),
               "bit_equal": all(torch.equal(a, b_) for a, b_ in zip(got, kernels.stem_dw(x, gy)))}
        key = f"{label} ({n}, {c}, {h}x{w}) -> ({n}, {h // 2}, {w // 2}, {co})"
        out["stem_dw"][key] = row
        per_step("stem_dw", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] stem_dw f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e}), two calls "
              f"{'bit-equal' if row['bit_equal'] else 'differ'}  [{card}]")
        if stem_dw_plans:
            planned = kernels.stem_dw_f32_plan(n, c, co, h, w, kernels._sm_count(dev.index or 0))
            dw, db = torch.empty(co, c, 4, 4, device=dev), torch.empty(co, device=dev)
            for plan in kernels.stem_dw_f32_plans(n, c, co, h, w,
                                                  kernels._sm_count(dev.index or 0)):
                part = torch.empty(plan.blocks, plan.part_entries, device=dev)

                def entry():
                    rc = kernels._lib().itg_stem_dw(
                        x.data_ptr(), gy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                        db.data_ptr(), n, c, h, w, co, 0, plan.blocks, plan.slots, plan.rows,
                        kernels._stream(x))
                    if rc:
                        raise RuntimeError(f"itg_stem_dw: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"stem_dw {key} slots {plan.slots} rows {plan.rows}"] = plan_ms
                mark = " (planned)" if plan == planned else ""
                print(f"[plan] stem_dw f32 {key}: slots {plan.slots} rows {plan.rows} blocks "
                      f"{plan.blocks}{mark}: {plan_ms:.4f} ms  [{card}]")
        del x, gy, g_nchw, got, ref
    for i, ((n, md, hid, h, w, co), calls) in enumerate(
            (K15_SHAPES if "k15bwd" in only else {}).items()):
        g_ = torch.Generator(device=dev).manual_seed(980 + i)
        maps = torch.randn(n, md, h + 4, w + 4, device=dev, generator=g_)
        w1 = torch.randn(hid, md, 3, 3, device=dev, generator=g_) / 3
        b1 = 0.1 * torch.randn(hid, device=dev, generator=g_)
        w2 = torch.randn(co, hid, 3, 3, device=dev, generator=g_) * (9 * hid) ** -0.5
        gy = torch.randn(n, co, h, w, device=dev, generator=g_)
        a_lib = torch.relu(torch.nn.functional.conv2d(maps, w1, b1))

        def lib_bwd():
            torch.nn.grad.conv2d_weight(a_lib, w2.shape, gy)
            d_act = torch.nn.grad.conv2d_input(a_lib.shape, w2, gy)
            torch.nn.grad.conv2d_weight(maps, w1.shape, d_act)

        got = ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
        ref = ssm.ssm_embed_bwd_plain(maps, w1, b1, w2, gy)
        pix, hpix = n * h * w, n * (h + 2) * (w + 2)
        flops = 2 * 2.0 * hpix * hid * 9 * md + 2 * 2.0 * pix * co * hid * 9
        nbytes = n * md * (h + 4) * (w + 4) * 4 + pix * co * 4 + 2 * (
            hid * md * 9 + hid + co * hid * 9 + co) * 4
        row = {"ms": yard.device_ms(lambda: ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)),
               "library_ms": yard.device_ms(lib_bwd),
               "bound_ms": yard.bound_ms(nbytes, flops, f32_flop_per_s, bytes_per_s),
               "max_rel_err": max(float((a - r).abs().max() / r.abs().max())
                                  for a, r in zip(got, ref)),
               "bit_equal": all(torch.equal(a, b_) for a, b_ in
                                zip(got, ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)))}
        # each launch on its own: device time by kernel name over ten calls
        for _ in range(3):
            ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
            torch.cuda.synchronize()
        by_name, _ = yard.device_busy_ms(prof)
        row["launches"] = {yard.kernel_name(name): ms_ / 10 for name, (ms_, _) in by_name.items()}
        key = f"({n}, {md} -> {hid} -> {co}, {h}x{w})"
        out["ssm_embed_bwd"][key] = row
        for _ in range(calls):
            per_step("ssm_embed_bwd", ("ssm",), row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] ssm_embed_bwd f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs err / "
              f"max|ref| {row['max_rel_err']:.3e}, two calls "
              f"{'bit-equal' if row['bit_equal'] else 'differ'}, x{calls} a SSM step  [{card}]")
        for name, ms_ in sorted(row["launches"].items(), key=lambda kv: -kv[1]):
            print(f"[launch] ssm_embed_bwd f32 {key}: {name}: {ms_:.4f} ms a call (profiler)  "
                  f"[{card}]")
        if hasattr(ssm, "bwd_f32_plan"):
            planned = ssm.bwd_f32_plan(n, md, hid, h, w, co, kernels._sm_count(dev.index or 0))
            outs = [torch.empty_like(t) for t in got]
            for plan in ssm.bwd_f32_plans(n, md, hid, h, w, co, kernels._sm_count(dev.index or 0)):
                part1 = torch.empty(plan.s1, hid, 9 * md + 1, device=dev)
                part2 = torch.empty(plan.s2, co, hid, 9, device=dev)
                partb2 = torch.empty(plan.s2, co, device=dev)

                def entry():
                    rc = kernels._lib().itg_ssm_embed_bwd(
                        maps.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        gy.data_ptr(), part1.data_ptr(), part2.data_ptr(), partb2.data_ptr(),
                        *(t.data_ptr() for t in outs), n, md, hid, h, w, co, plan.s2,
                        plan.rows2, kernels._stream(maps))
                    if rc:
                        raise RuntimeError(f"itg_ssm_embed_bwd: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"ssm_embed_bwd {key} s2 {plan.s2} rows2 {plan.rows2}"] = plan_ms
                mark = " (planned)" if plan == planned else ""
                print(f"[plan] ssm_embed_bwd f32 {key}: s2 {plan.s2} rows2 {plan.rows2}{mark}: "
                      f"{plan_ms:.4f} ms  [{card}]")
        del maps, gy, a_lib, got, ref
    k15_fwd = {**{k: (v, "train") for k, v in K15_SHAPES.items()},
               **{k: (v, "eval") for k, v in K15_EVAL_SHAPES.items()}}
    ablated = hidden_ablated_fwd(tree, _build) if "k15hid" in only else None
    for i, ((n, md, hid, h, w, co), (calls, where)) in enumerate(
            (k15_fwd if only & {"k15fwd", "k15hid"} else {}).items()):
        g_ = torch.Generator(device=dev).manual_seed(990 + i)
        maps = torch.randn(n, md, h + 4, w + 4, device=dev, generator=g_)
        w1 = torch.randn(hid, md, 3, 3, device=dev, generator=g_) / 3
        b1 = 0.1 * torch.randn(hid, device=dev, generator=g_)
        w2 = torch.randn(co, hid, 3, 3, device=dev, generator=g_) * (9 * hid) ** -0.5
        b2 = 0.1 * torch.randn(co, device=dev, generator=g_)
        got = ssm.ssm_embed(maps, w1, b1, w2, b2)
        ref = ssm.ssm_embed_plain(maps, w1, b1, w2, b2)
        pix, hpix = n * h * w, n * (h + 2) * (w + 2)
        flops = 2.0 * hpix * hid * 9 * md + 2.0 * pix * co * hid * 9
        nbytes = n * md * (h + 4) * (w + 4) * 4 + pix * co * 4 + (
            hid * md * 9 + hid + co * hid * 9 + co) * 4
        row = {"ms": yard.device_ms(lambda: ssm.ssm_embed(maps, w1, b1, w2, b2)),
               "library_ms": yard.device_ms(lambda: F.conv2d(torch.relu(F.conv2d(maps, w1, b1)),
                                                             w2, b2)),
               "bound_ms": yard.bound_ms(nbytes, flops, f32_flop_per_s, bytes_per_s),
               "max_abs_err": err((got,), (ref,)), "max_ref": float(ref.abs().max()),
               "bit_equal": torch.equal(got, ssm.ssm_embed(maps, w1, b1, w2, b2)),
               "calls": calls, "where": where}
        key = f"({n}, {md} -> {hid} -> {co}, {h}x{w})"
        if where == "train":
            # each launch of a call on its own: device time by kernel name
            # over ten calls
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    ssm.ssm_embed(maps, w1, b1, w2, b2)
                torch.cuda.synchronize()
            by_name, _ = yard.device_busy_ms(prof)
            row["launches"] = {yard.kernel_name(name): ms_ / 10
                               for name, (ms_, _) in by_name.items()}
            for _ in range(calls):
                per_step("ssm_embed", ("ssm",), row["ms"], row["library_ms"], row["bound_ms"])
        out["ssm_embed"][key] = row
        per = "a SSM step" if where == "train" else "a 192^2 SSM sub-image (eval)"
        print(f"[time] ssm_embed f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['ms']:.1f}% of it), max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e}), two calls "
              f"{'bit-equal' if row['bit_equal'] else 'differ'}, x{calls} {per}  [{card}]")
        for name, ms_ in sorted(row.get("launches", {}).items(), key=lambda kv: -kv[1]):
            print(f"[launch] ssm_embed f32 {key}: {name}: {ms_:.4f} ms a call (profiler)  "
                  f"[{card}]")
        if hasattr(ssm, "fwd_f32_plan"):
            sms = kernels._sm_count(dev.index or 0)
            planned = ssm.fwd_f32_plan(n, md, hid, h, w, co, sms)
            y = torch.empty_like(got)
            for plan in ssm.fwd_f32_plans(n, md, hid, h, w, co, sms):
                def entry():
                    rc = kernels._lib().itg_ssm_embed_fwd(
                        maps.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), y.data_ptr(), n, md, hid, h, w, co, plan.warps,
                        kernels._stream(maps))
                    if rc:
                        raise RuntimeError(f"itg_ssm_embed_fwd: CUDA error {rc}")

                plan_ms = yard.device_ms(entry)
                out["plans"][f"ssm_embed {key} warps {plan.warps}"] = plan_ms
                mark = " (planned)" if plan == planned else ""
                print(f"[plan] ssm_embed f32 {key}: warps {plan.warps} blocks {plan.blocks}{mark}: "
                      f"{plan_ms:.4f} ms, bit-equal to the call {torch.equal(y, got)}  [{card}]")
                if ablated is None or plan != planned:
                    continue

                def cut():
                    rc = ablated(maps.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                 b2.data_ptr(), y.data_ptr(), n, md, hid, h, w, co, plan.warps,
                                 kernels._stream(maps))
                    if rc:
                        raise RuntimeError(f"itg_ssm_embed_fwd (hidden cut): CUDA error {rc}")

                cut_ms = yard.device_ms(cut)
                chunks = -(-hid // ssm.F32_FWD_KC)
                share = (plan_ms - cut_ms) / plan_ms * chunks / (chunks - 1)
                out["hidden"][key] = {"ms": plan_ms, "cut_ms": cut_ms, "share": share,
                                      "channel_blocks": plan.channel_blocks}
                print(f"[hidden] ssm_embed f32 {key}: planned {plan_ms:.4f} ms, without chunks "
                      f"1.. of the hidden activation {cut_ms:.4f} ms: the hidden activation "
                      f"{100 * share:.1f}% of a call, computed in each of "
                      f"{plan.channel_blocks} channel blocks  [{card}]")
        del maps, got, ref
    for label, ((n, c, h, w, co), paths) in (STEM_DX_SHAPES if "k13dx" in only else {}).items():
        g_ = torch.Generator(device=dev).manual_seed(970)
        gy = torch.randn(n, h // 2, w // 2, co, device=dev, generator=g_)
        wt = torch.randn(co, c, 4, 4, device=dev, generator=g_) * (16 * c) ** -0.5
        g_nchw = gy.permute(0, 3, 1, 2)
        got = kernels.stem_dx(gy, wt)
        ref = kernels.stem_dx_plain(gy, wt)
        row = {"ms": yard.device_ms(lambda: kernels.stem_dx(gy, wt)),
               "library_ms": yard.device_ms(lambda: torch.nn.grad.conv2d_input(
                   (n, c, h, w), wt, g_nchw, stride=2, padding=1)),
               "bound_ms": yard.bound_ms(*yard.stem_fwd_work(n, c, h, w, co, 4), f32_flop_per_s,
                                         bytes_per_s),
               "max_abs_err": err((got,), (ref,)), "max_ref": float(ref.abs().max()),
               "bit_equal": torch.equal(got, kernels.stem_dx(gy, wt))}
        key = f"{label} ({n}, {h // 2}, {w // 2}, {co}) -> ({n}, {c}, {h}x{w})"
        out["stem_dx"][key] = row
        per_step("stem_dx", paths, row["ms"], row["library_ms"], row["bound_ms"])
        print(f"[time] stem_dx f32 {key}: kernel {row['ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['ms']:.1f}% of it), max abs err "
              f"{row['max_abs_err']:.3e} (max|ref| {row['max_ref']:.3e}), two calls "
              f"{'bit-equal' if row['bit_equal'] else 'differ'}  [{card}]")
        del gy, g_nchw, got, ref
    for name, row in out["per_step"].items():
        print(f"[step sum] {name}: kernel {row['ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms a step  [{card}]")

    # the graphed float32 steps, as the train CLI runs them (cuDNN's TF32 on:
    # PyTorch's default, which the port leaves alone)
    torch.backends.cudnn.allow_tf32 = True
    recipes = {"auto": cs.EXP1_ARGS + ["--fuse_up", "auto"],
               "off": cs.EXP1_ARGS + ["--fuse_up", "off"], "ssm": cs.SSM_ARGS}
    entries = ("itg_upconv3x3_chw_dx", "itg_stem_fwd", "itg_conv1x1_chw_dw", "itg_conv3x3_chw",
               "itg_conv3x3_chw_dx", "itg_conv3x3_chw_dw", "itg_upconv3x3_chw",
               "itg_upconv3x3_chw_dw", "itg_stem_dw")
    for tail, argv in (recipes if "steps" in only else {}).items():
        argv32 = [a if a != "bfloat16" else "float32" for a in argv]
        kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
        launches, warm, busy, routed, peak = cs.training_run(
            dev, argv32, cs.TRAIN_STEPS, cs.STEP_LAUNCHES[tail], torch.cuda.synchronize, card,
            tree / "build" / f"f32_study_{tail}", "0", render=False)
        out["steps"][tail] = {"wall_ms": warm * 1e3, "busy_ms": busy, "peak_gib": peak / 2**30,
                              **{e: routed[e] for e in entries}}
        print(f"[step] float32 {tail}, graphed: warm step {warm * 1e3:.2f} ms, busy "
              f"{busy if busy is None else round(busy, 3)} ms per traced step; routed launches "
              + ", ".join(f"{e} {routed[e]}" for e in entries) + f"  [{card}]")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
