#!/usr/bin/env python3
"""How many train steps one CUDA graph should hold, measured on one card.

Run from the root of a checkout: ``python3 graph_chunk_study.py``. It
imports only the PyTorch package, never JAX. The train loop replays a
graph of ONE captured step K times per dispatch (``train/train_step.py:
StepDispatch``), so that it can hand each step's losses to a callback; a
graph of K steps would issue one replay per chunk instead. On the
Experiment-1 recipe (bf16, ``--fuse_up auto``) this script times, per
step, in alternating rounds:

- the eager step (one dispatch per step);
- the one-step graph replayed K times, with and without reading each
  step's losses on the host (the train loop's callback reads them);
- one graph of K captured steps, replayed once.

Each form starts from its own state and trains on; the numbers are walls
per step (host clock around a synchronised run of K steps), the median of
ROUNDS rounds, with the card's name and power limit. Exits 2 without a
card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K = 16
ROUNDS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_chunk_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import EXP1_ARGS, card_line
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
    from infinite_texture_gans_torch.ops.graphs import CountedGraph
    from infinite_texture_gans_torch.train.train_step import (
        WARMUP_STEPS,
        StepDispatch,
        create_train_state,
    )

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    args = prepare_parser().parse_args(EXP1_ARGS + ["--fuse_up", "auto", "--device", "cuda"])
    sampler = DeviceCropSampler(SingleImageDataset(args.data_path, args.data_ext, None,
                                                   args.random_crop, 64), dev)

    def dispatch(graphed: bool) -> StepDispatch:
        d = StepDispatch(create_train_state(args, 10**6, dev, seed=5), sampler,
                         torch.Generator(device=dev).manual_seed(5), args, graphed=graphed)
        d.set_lr()
        return d

    eager, one, chunk = dispatch(False), dispatch(True), dispatch(True)
    for _ in range(WARMUP_STEPS + 1):  # the eager warm-up steps, then the capture
        one.step()
        eager.step()
    for _ in range(WARMUP_STEPS):
        chunk.step()
    graph = CountedGraph()
    # K step bodies (draws, fused step, loss sums) in one capture
    graph.capture(lambda: [chunk.body() for _ in range(K)], generators=(chunk.rng,))

    forms = {
        "eager step": lambda: [eager.step() for _ in range(K)],
        "one-step graph, K replays": lambda: [one.step() for _ in range(K)],
        "one-step graph, K replays, losses read each step":
            lambda: [float(one.step()["g_loss"]) for _ in range(K)],
        f"{K}-step graph, one replay": graph.replay,
    }
    walls = {name: [] for name in forms}
    for _ in range(ROUNDS):
        for name, run in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / K * 1e3)
    out = {}
    for name, ms in walls.items():
        out[name] = statistics.median(ms)
        print(f"[chunk] {name}: {out[name]:.3f} ms per step (median of {ROUNDS} rounds of {K} "
              f"steps; rounds {', '.join(f'{m:.3f}' for m in ms)}) [{card}]")
    print(json.dumps({"ms_per_step": out, "K": K, "rounds": ROUNDS, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
