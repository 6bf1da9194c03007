#!/usr/bin/env python3
"""The float32 route of K9 dx (``upconv3x3_chw_dx``) and K13's forward
(``stem_fwd``) on one CUDA card, with the graphed float32 Experiment-1 steps
they run in, for one tree of the repository.

Run from the root of a checkout on a machine with a card:
``python3 f32_route_study.py [--tree DIR] [--out FILE]``. It
imports only the PyTorch package, from ``DIR`` where given (default: this
checkout), with that tree's ``chip_smoke.py`` for the train loop's run;
the kernels are built from that tree's sources into its own ``build/``.
The yardstick is this checkout's ``chip_smoke.py`` whatever the tree: its
graph-replay timer (``device_ms``), its bounds (``bound_ms`` of
``upconv_dx_work`` and ``stem_fwd_work``) and ``card_line``. So another
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
Then it runs the train loop's graphed float32 Experiment-1 steps
(``--fuse_up auto`` and ``off``, ``--compute_dtype float32``, cuDNN's TF32
as PyTorch leaves it, which is how the train CLI runs them) through
``chip_smoke.py: training_run`` (the warm step: the median of the steps
before the traced window; the device busy time per traced step). The
card's name and power limit head the output; the last line is one JSON
object, also written to ``--out`` (default ``build/f32_route_study.json``
of this checkout).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import chip_smoke as yard

HERE = Path(__file__).resolve().parent
# K9 dx: (N, C, Co, H, W) of x at half resolution; K13: (N, C, H, W, Co)
DX_SHAPES = ((8, 52, 26, 96, 96), (8, 26, 13, 192, 192))
STEM_SHAPES = {"Exp-1": (8, 3, 384, 384, 64), "--D_ch 640": (8, 3, 384, 384, 640),
               "SSM": (8, 3, 192, 192, 64)}


def tree_chip_smoke(tree: Path):
    """The tree's own ``chip_smoke.py`` (its train loop's run)."""
    if tree == HERE:
        return yard
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=HERE)
    parser.add_argument("--out", type=Path, default=HERE / "build" / "f32_route_study.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_route_study: needs a CUDA card", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch.nn.functional as F

    from infinite_texture_gans_torch.ops import _build, kernels
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
    out = {"tree": str(tree), "card": card, "upconv3x3_chw_dx": {}, "stem_fwd": {}, "steps": {},
           "plans": {}}
    plans = hasattr(kernels, "upconv_dx_f32_plan")

    def err(got, ref):
        return max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))

    for i, (n, c, co, h, w) in enumerate(DX_SHAPES):
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
    for label, (n, c, h, w, co) in STEM_SHAPES.items():
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

    # the graphed float32 steps, as the train CLI runs them (cuDNN's TF32 on:
    # PyTorch's default, which the port leaves alone)
    torch.backends.cudnn.allow_tf32 = True
    argv32 = [a if a != "bfloat16" else "float32" for a in cs.EXP1_ARGS]
    for tail in ("auto", "off"):
        kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
        launches, warm, busy, routed, peak = cs.training_run(
            dev, argv32 + ["--fuse_up", tail], cs.TRAIN_STEPS, cs.STEP_LAUNCHES[tail],
            torch.cuda.synchronize, card, tree / "build" / f"f32_study_{tail}", "0", render=False)
        out["steps"][tail] = {"wall_ms": warm * 1e3, "busy_ms": busy, "peak_gib": peak / 2**30,
                              "itg_upconv3x3_chw_dx": routed["itg_upconv3x3_chw_dx"],
                              "itg_stem_fwd": routed["itg_stem_fwd"]}
        print(f"[step] float32 --fuse_up {tail}, graphed: warm step {warm * 1e3:.2f} ms, busy "
              f"{busy if busy is None else round(busy, 3)} ms per traced step; routed launches "
              f"itg_upconv3x3_chw_dx {routed['itg_upconv3x3_chw_dx']}, itg_stem_fwd "
              f"{routed['itg_stem_fwd']}  [{card}]")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
