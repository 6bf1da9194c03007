"""Training loop and CLI:
``python -m infinite_texture_gans_torch.train.train_loop --data_path ...``.

Port of ``infinite_texture_gans_tpu/train/train_loop.py: train``: epochs of
``ceil(--sampling / --batch_size)`` steps, each step a batch of random
crops, the latents (and an SSM generator's maps) drawn on the device and
one fused G + D step (``train_step.py``), the epoch's mean losses printed
and kept, and a ``.ckpt`` every ``--saving_rate`` epochs and at the end
(plus ``<epochs>__ema.ckpt`` with ``--ema``), in the reference's format.
Crops, latents and maps come from one ``torch.Generator`` seeded with the
run's seed (other numbers than the reference's ``jax.random`` keys).

Steps are dispatched in chunks of K, the reference's superstep plan
(``--steps_per_dispatch``: 0 plans K itself, 1 dispatches step by step):
on the card a chunk of K > 1 is K replays of one captured CUDA graph of
the step (``StepDispatch``); on the CPU every step runs eagerly. A chunk
never crosses an epoch, so the learning rates are written between chunks.
``--profile_dir`` writes a ``torch.profiler`` trace of the first epoch's
steps 0-4, dispatched one by one.

Not ported yet: the host prefetcher, meshes, multi-image data, resume and
the loss plot. Runs on ``cuda`` (``cuda:<dev_num>``) unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time
from typing import Callable, Dict, Optional

import torch

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.config import check_train_args, prepare_parser, train_device
from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
from infinite_texture_gans_torch.train.checkpoint import save_checkpoint
from infinite_texture_gans_torch.train.train_step import (
    StepDispatch,
    TrainState,
    create_train_state,
    dispatch_chunks,
    dispatch_plan,
    optimizer_tree,
)
from infinite_texture_gans_torch.weights import to_jax_variables

PROFILED_STEPS = 5  # --profile_dir traces the first epoch's steps 0-4


def prepare_filename(args: argparse.Namespace) -> str:
    """Checkpoint prefix ``<fname>/<epochs>_``."""
    filename = f"{args.epochs}_"
    if args.fname is not None:
        os.makedirs(args.fname, exist_ok=True)
        filename = f"{args.fname}/{filename}"
    return filename


def checkpoint_payload(state: TrainState, args: argparse.Namespace, epoch: int, seed: int,
                       G_losses, D_losses) -> Dict:
    """The reference's full training checkpoint: both models' variables,
    both optimizer states, the EMA snapshot and the metadata."""
    scheduled = args.decay_lr in ("exp", "step")
    return {
        "meta": {"epoch": epoch, "args": dict(vars(args)), "seed": seed,
                 "Gloss": list(G_losses), "Dloss": list(D_losses)},
        "netG_variables": to_jax_variables(state.G.state_dict()),
        "netD_variables": to_jax_variables(state.D.state_dict()),
        "opt_G": optimizer_tree(state.G, state.opt_G, state.step, scheduled),
        "opt_D": optimizer_tree(state.D, state.opt_D, state.step, scheduled),
        "ema": to_jax_variables(state.ema) if state.ema is not None else {},
    }


def train(args: argparse.Namespace,
          step_callback: Optional[Callable[[int, int, Dict[str, torch.Tensor]], None]] = None):
    """Run the training; returns (state, G_losses, D_losses).
    ``step_callback(epoch, i, metrics)`` runs after every step; ``metrics``
    holds the step's losses until the next step overwrites them."""
    check_train_args(args)
    device = resolve_device(train_device(args))
    if args.num_workers:
        print("Warning: --num_workers is ignored: single-image batches are sampled on the device")
    seed = args.seed if args.seed is not None else random.randint(1, 10000)
    print("Random Seed: ", seed)
    print(args)
    dataset = SingleImageDataset(args.data_path, args.data_ext, args.center_crop,
                                 args.random_crop, args.sampling)
    print("Training samples: ", len(dataset))
    steps_per_epoch = max(1, math.ceil(len(dataset) / args.batch_size))
    spd = 1 if args.profile_dir else args.steps_per_dispatch
    plan = dispatch_plan(steps_per_epoch, 128 if spd == 0 else spd)
    chunks = dispatch_chunks(steps_per_epoch, plan)
    state = create_train_state(args, steps_per_epoch, device, seed)
    print("# Params. G: ", sum(p.numel() for p in state.G.parameters()))
    print("# Params. D: ", sum(p.numel() for p in state.D.parameters()))
    graphed = device.type == "cuda" and plan[0] > 1
    if plan[0] > 1:
        print(f"steps per dispatch: {plan[0]}"
              + (f" (+ one {plan[1]}-step remainder chunk)" if plan[1] else "")
              + (", replays of a captured CUDA graph of the step" if graphed else ""))
    dispatch = StepDispatch(state, DeviceCropSampler(dataset, device),
                            torch.Generator(device=device).manual_seed(seed), args,
                            graphed=graphed)
    G_losses, D_losses = [], []
    filename = prepare_filename(args)
    profiler = None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    start = time.time()
    print("Starting Training Loop...")
    for epoch in range(args.epochs):
        # the epoch's losses stay on the device until its end (no per-step sync)
        dispatch.begin_epoch()
        if profiler is not None:  # the first epoch: stopped at its step 4 or end
            profiler.start()
        i = 0
        for k in chunks:
            dispatch.set_lr()
            for _ in range(k):
                m = dispatch.step()
                if step_callback is not None:
                    step_callback(epoch, i, m)
                i += 1
                if profiler is not None and (i == PROFILED_STEPS or i == steps_per_epoch):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiler.stop()
                    trace = os.path.join(args.profile_dir, f"train_steps_0-{i - 1}.json")
                    profiler.export_chrome_trace(trace)
                    print("Profiler trace written to", trace)
                    profiler = None
        d_run = float(dispatch.d_sum) / (args.batch_size * steps_per_epoch)
        g_run = float(dispatch.g_sum) / (args.num_images * steps_per_epoch)
        elapsed = time.time() - start
        print("[%d/%d]\tLoss_D: %.4f\tLoss_G: %.4f, elapsed_time = %.4f min (%.2f steps/s)"
              % (epoch + 1, args.epochs, d_run, g_run, elapsed / 60,
                 (epoch + 1) * steps_per_epoch / elapsed))
        G_losses.append(g_run)
        D_losses.append(d_run)
        last = epoch + 1 == args.epochs
        if args.saving_rate is not None and ((epoch + 1) % args.saving_rate == 0 or last):
            save_checkpoint(filename + f"{epoch + 1}.ckpt",
                            checkpoint_payload(state, args, epoch + 1, seed, G_losses, D_losses))
        if last and args.ema:
            ema = to_jax_variables(state.ema)
            save_checkpoint(filename + "_ema.ckpt", {
                "meta": {"args": dict(vars(args))},
                "netG_variables": {"params": ema["params"], "batch_stats": ema["batch_stats"]},
            })
    return state, G_losses, D_losses


def main(argv=None) -> None:
    train(prepare_parser().parse_args(argv))


if __name__ == "__main__":
    main()
