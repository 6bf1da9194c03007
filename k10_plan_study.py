#!/usr/bin/env python3
"""K10 (``upsample2_chw_add``) on one CUDA card: its time under other launch
plans and without the lane pairs' sector swap, at the main paths' shapes.

Run from the root of a checkout on a machine with a card:
``python3 k10_plan_study.py``. It imports only the PyTorch package.

It builds ``csrc/upsample2_chw.cu`` into two libraries of its own under
``build/``: the source with room for blocks of up to 256 threads
(``kAddThreads``), and the same with the lane swap turned off (each lane
stores its own two 16-byte chunks of a row, so every access instruction
covers half of each 32-byte sector it touches). For each of the Exp-1
step's shapes (N = 8, with stats) and the ``--fuse_up all`` sub-image's
(N = 1, no stats) it times, in bf16 by CUDA-graph replay, the port's own
call (``kernels.upsample2_chw_add``: the built plan), then both libraries
under ``kernels.upsample2_add_plan`` with blocks of at most 64, 128 or 256
threads and at least 4, 8 or 16 blocks per SM, each call's y held
bit-equal to ``upsample2_chw_add_plain``. Beside them: the byte bound at
3.35 TB/s and ``y.copy_(res)`` (8/9 of K10's bytes; shapes that fit in
the 50 MB L2 can beat the bound in replay). The card's name and power
limit head the output.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12
# x shapes (N, C, H, W) and whether the path asks for the stats
SHAPES = [((8, 26, 96, 96), True), ((8, 13, 192, 192), True), ((1, 52, 48, 48), False),
          ((1, 26, 96, 96), False), ((1, 13, 192, 192), False)]
THREADS = (64, 128, 256)
BLOCKS_PER_SM = (4, 8, 16)


def build_variants(build, csrc: Path, out: Path) -> dict:
    """The K10 source with kAddThreads 256, with and without the lane swap,
    each built into a library of its own; name -> the C entry point."""
    src = (csrc / "upsample2_chw.cu").read_text()
    wide = src.replace("constexpr int kAddThreads = 64;", "constexpr int kAddThreads = 256;")
    variants = {"swap": wide,
                "no swap": wide.replace("mode[u] = aligned && je + 2 * V <= W ? kPair",
                                        "mode[u] = false ? kPair")}
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants.items():
        if text == src:
            raise SystemExit(f"k10_plan_study: the {name!r} variant does not apply to the source")
        stem = name.replace(" ", "_")
        path = csrc / f"_study_{stem}.cu"  # beside the headers it includes
        path.write_text(text)
        cmd = [build._nvcc(), *build.FLAGS, "-shared", str(path), "-o", str(out / f"{stem}.so")]
        jobs[name] = (path, out / f"{stem}.so",
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True))
    entries = {}
    for name, (path, lib, proc) in jobs.items():
        log, _ = proc.communicate()
        path.unlink()
        if proc.returncode:
            raise SystemExit(f"k10_plan_study: nvcc failed for {name!r}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(lib)).itg_upsample2_chw_add
        fn.argtypes = build.SIGNATURES["itg_upsample2_chw_add"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k10_plan_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from infinite_texture_gans_torch.ops import _build, kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip().splitlines()[0]}")
    entries = build_variants(_build, _build.CSRC, _build.BUILD_DIR / "k10_plan_study")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def device_ms(fn, iters=20):
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
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device=dev).manual_seed(15)
    for shape, stats in SHAPES:
        n, c, h, w = shape
        x = torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
        res = torch.randn(n, c, 2 * h, 2 * w, device=dev, generator=gen).to(torch.bfloat16)
        ref = kernels.upsample2_chw_add_plain(x, res)
        y = torch.empty_like(res)
        bound = 9 * x.numel() * x.element_size() / PEAK_BYTES_PER_S * 1e3
        built = device_ms(lambda: kernels.upsample2_chw_add(x, res, want_stats=stats))
        print(f"{shape} {'with' if stats else 'no'} stats: bound {bound:.4f} ms, copy of res "
              f"{device_ms(lambda: y.copy_(res)):.4f} ms, the port's call (its plan "
              f"{tuple(kernels.upsample2_add_plan(*shape, 2, sms))}) {built:.4f} ms "
              f"({built / bound:.2f}x)")
        for (name, fn), threads, bps in itertools.product(entries.items(), THREADS, BLOCKS_PER_SM):
            plan = kernels.upsample2_add_plan(*shape, 2, sms, threads=threads, blocks_per_sm=bps)
            part = torch.empty((plan.part_rows, 2 * c), device=dev) if stats else None
            s1, s2 = (torch.empty(c, device=dev), torch.empty(c, device=dev)) if stats else (None,
                                                                                            None)

            def call():
                rc = fn(x.data_ptr(), res.data_ptr(), y.data_ptr(), kernels._ptr(part),
                        kernels._ptr(s1), kernels._ptr(s2), n * c, c, h, w, plan.bx, plan.by,
                        plan.rows, plan.chunk, 1, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"k10_plan_study: {name} {plan}: CUDA error {rc}")

            y.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                raise SystemExit(f"k10_plan_study: {name} {plan}: y differs from the plain version")
            ms = device_ms(call)
            print(f"  {name:7s} threads <= {threads:3d}, >= {bps:2d} blocks/SM: block "
                  f"({plan.bx}, {plan.by}), rows {plan.rows}, chunk {plan.chunk}, "
                  f"{plan.grid[0] * plan.grid[1]} blocks: {ms:.4f} ms ({ms / bound:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
