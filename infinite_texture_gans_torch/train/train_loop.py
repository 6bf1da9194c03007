"""Training loop and CLI:
``python -m infinite_texture_gans_torch.train.train_loop --data_path ...``.

Port of ``infinite_texture_gans_tpu/train/train_loop.py: train``: epochs of
``ceil(--sampling / --batch_size)`` steps, each step a batch of random
crops, the latents (and an SSM generator's maps, and the WGAN-GP
penalty's weights) of its ``--disc_iters`` D iterations drawn on the device
and one fused G + D step (``train_step.py``), the epoch's mean losses
printed and kept (a step's D losses summed over its D iterations, as the
reference's loop sums them), and a ``.ckpt`` every ``--saving_rate``
epochs and at the end (plus ``<epochs>__ema.ckpt`` with ``--ema``), in the
reference's format, written by one ``AsyncCheckpointer`` while the steps
go on, and ``<epochs>_losses.png`` at the end (where matplotlib is
installed).
Crops, latents and maps come from one ``torch.Generator``, reseeded in
place at the start of every epoch from (seed, epoch) (:func:`reseed_epoch`,
the reference's ``fold_in(root_key(seed), epoch)``; other numbers than its
``jax.random`` keys), so a run resumed at epoch k draws what the
uninterrupted run drew there.

``--resume PATH`` restores the train state in place
(``checkpoint.restore_train_state``: parameters, statistics, both Adam
states, the EMA and the step count), the loss histories and, without
``--seed``, the run's seed, and runs the epochs from the stored one on.

Steps are dispatched in chunks of K, the reference's superstep plan
(``--steps_per_dispatch``: 0 plans K itself, 1 dispatches step by step):
on the card a chunk of K > 1 is K replays of one captured CUDA graph of
the step (``StepDispatch``); on the CPU every step runs eagerly. A chunk
never crosses an epoch, so the learning rates are written between chunks.
``--profile_dir`` writes a ``torch.profiler`` trace of the first epoch's
steps 0-4, dispatched one by one. A ``StallWatchdog`` (``utils/watchdog.py``)
beats at every epoch's read of its loss sums and warns when the epochs stop
completing; it is stopped, its thread joined, when ``train`` returns or
raises.

``--data multiple_images`` trains on a directory of images
(``data/datasets.py``): its padded stack on the device with crops drawn in
the step (and in its graph), or, over ``DeviceMultiImageSampler
.MAX_DEVICE_MB``, a resident window of the images swapped before every
chunk (``RotatingMultiImageSampler``: windows from (seed, epoch), the next
one copied in ahead on a side stream), or, where neither fits (or
``--batch_size 1`` meets images of different sizes), host batches from a
``Prefetcher``, stepped eagerly. ``Training samples`` and the steps of an
epoch count ``len(dataset)``, and G's and D's image channels are the
stack's.

Not ported yet: meshes. Runs on ``cuda`` (``cuda:<dev_num>``) unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.config import check_train_args, prepare_parser, train_device
from infinite_texture_gans_torch.data.datasets import (
    DeviceCropSampler,
    DeviceMultiImageSampler,
    HostBatches,
    RotatingMultiImageSampler,
    SingleImageDataset,
    prepare_data,
)
from infinite_texture_gans_torch.train.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    restore_train_state,
)
from infinite_texture_gans_torch.train.train_step import (
    StepDispatch,
    TrainState,
    create_train_state,
    dispatch_chunks,
    dispatch_plan,
    optimizer_tree,
)
from infinite_texture_gans_torch.utils.watchdog import StallWatchdog
from infinite_texture_gans_torch.weights import jax_tree

PROFILED_STEPS = 5  # --profile_dir traces the first epoch's steps 0-4


def prepare_filename(args: argparse.Namespace) -> str:
    """Checkpoint prefix ``<fname>/<epochs>_``."""
    filename = f"{args.epochs}_"
    if args.fname is not None:
        os.makedirs(args.fname, exist_ok=True)
        filename = f"{args.fname}/{filename}"
    return filename


def reseed_epoch(rng: torch.Generator, seed: int, epoch: int) -> None:
    """Reseed the run's generator in place for epoch ``epoch`` from (seed,
    epoch) alone, so a resumed run draws what the uninterrupted run drew.
    It stays the same object: a captured step holds it (``ops/graphs.py``),
    and a replay reads its seed and offset when it runs."""
    rng.manual_seed(int(np.random.SeedSequence([seed % 2**64, epoch]).generate_state(
        1, np.uint64)[0]))


def make_sampler(dataset, args: argparse.Namespace, device, seed: int, steps_per_epoch: int):
    """The step's sampler for ``dataset``, built as the reference builds it,
    with its notice: the single image's crops on the device; a directory's
    stack on the device, a rotating window of it (over the cap; windows
    drawn from the run's ``seed``), or, where ``maybe_build`` finds neither,
    :class:`HostBatches` from a prefetcher."""
    if isinstance(dataset, SingleImageDataset):
        return DeviceCropSampler(dataset, device)
    sampler, why_not = DeviceMultiImageSampler.maybe_build(
        dataset, device, batch_size=args.batch_size, seed=seed)
    if sampler is None:
        print(f"on-device multi-image sampling disabled ({why_not}); falling back to the host "
              "prefetcher")
        return HostBatches(dataset, args.batch_size, steps_per_epoch, device)
    if isinstance(sampler, RotatingMultiImageSampler):
        print(f"multi-image dataset exceeds the device cap: rotating HBM subset of "
              f"{sampler.subset_size}/{sampler.n_images} images per dispatch (next window's H2D "
              "overlaps compute)")
    else:
        print(f"multi-image batches sampled on device ({len(dataset.files)} images stacked in HBM)")
    return sampler


def checkpoint_payload(state: TrainState, args: argparse.Namespace, epoch: int, seed: int,
                       G_losses, D_losses) -> Dict:
    """The reference's full training checkpoint: both models' variables,
    both optimizer states, the EMA snapshot and the metadata. The arrays are
    tensors on the state's device (``AsyncCheckpointer`` snapshots them;
    ``save_checkpoint`` takes them as they are)."""
    scheduled = args.decay_lr in ("exp", "step")
    return {
        "meta": {"epoch": epoch, "args": dict(vars(args)), "seed": seed,
                 "Gloss": list(G_losses), "Dloss": list(D_losses)},
        "netG_variables": jax_tree(state.G.state_dict()),
        "netD_variables": jax_tree(state.D.state_dict()),
        "opt_G": optimizer_tree(state.G, state.opt_G, state.step, scheduled),
        # D's count is its updates, disc_iters a step (optax's count)
        "opt_D": optimizer_tree(state.D, state.opt_D, state.step * args.disc_iters, scheduled),
        "ema": jax_tree(state.ema) if state.ema is not None else {},
    }


def ema_payload(state: TrainState, args: argparse.Namespace) -> Dict:
    """``<epochs>__ema.ckpt``: the EMA generator alone, as the reference
    writes it."""
    ema = jax_tree(state.ema)
    return {"meta": {"args": dict(vars(args))},
            "netG_variables": {"params": ema["params"], "batch_stats": ema["batch_stats"]}}


def plot_losses(G_losses, D_losses, filename: str) -> None:
    """``<prefix>losses.png`` (the reference's ``_plot_losses``); skipped
    where matplotlib is not installed, as there."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig = plt.figure(figsize=(10, 5))
    plt.title("Generator and Discriminator Loss During Training")
    plt.plot(G_losses, label="G")
    plt.plot(D_losses, label="D")
    plt.xlabel("iterations")
    plt.ylabel("Loss")
    plt.legend()
    fig.savefig(filename + "losses.png")
    plt.close(fig)


def train(args: argparse.Namespace,
          step_callback: Optional[Callable[[int, int, Dict[str, torch.Tensor]], None]] = None,
          saver: Optional[AsyncCheckpointer] = None):
    """Run the training; returns (state, G_losses, D_losses).
    ``step_callback(epoch, i, metrics)`` runs after every step; ``metrics``
    holds the step's losses until the next step overwrites them. ``saver``
    writes the checkpoints (a new ``AsyncCheckpointer`` by default); every
    save is on disk when ``train`` returns or raises."""
    check_train_args(args)
    device = resolve_device(train_device(args))
    if args.num_workers:
        print("Warning: --num_workers is ignored: batches are sampled on the device, and the "
              "host prefetcher is one thread")
    # a resumed run draws the uninterrupted run's epochs only with its seed
    resume_ckpt = None
    if getattr(args, "resume", None):
        resume_ckpt = load_checkpoint(args.resume)
        ckpt_seed = resume_ckpt.get("meta", {}).get("seed")
        if args.seed is None and ckpt_seed is not None:
            args.seed = int(ckpt_seed)
            print(f"--resume: restored the run's seed {args.seed} from the checkpoint "
                  "(deterministic resume; pass --seed to override)")
    seed = args.seed if args.seed is not None else random.randint(1, 10000)
    print("Random Seed: ", seed)
    print(args)
    dataset = prepare_data(args)
    print("Training samples: ", len(dataset))
    steps_per_epoch = max(1, math.ceil(len(dataset) / args.batch_size))
    sampler = make_sampler(dataset, args, device, seed, steps_per_epoch)
    if dataset.img_ch != args.img_ch:
        print(f"--img_ch {args.img_ch}: the images have {dataset.img_ch} channels; G and D "
              f"take {dataset.img_ch}")
        args.img_ch = dataset.img_ch
    host = isinstance(sampler, HostBatches)  # batches may change shape: eager steps
    spd = 1 if args.profile_dir or host else args.steps_per_dispatch
    plan = dispatch_plan(steps_per_epoch, 128 if spd == 0 else spd)
    chunks = dispatch_chunks(steps_per_epoch, plan)
    rotating = isinstance(sampler, RotatingMultiImageSampler)
    state = create_train_state(args, steps_per_epoch, device, seed)
    G_losses, D_losses = [], []
    start_epoch = 0
    if resume_ckpt is not None:
        start_epoch = restore_train_state(state, resume_ckpt, steps_per_epoch)
        G_losses = list(resume_ckpt["meta"].get("Gloss", []))
        D_losses = list(resume_ckpt["meta"].get("Dloss", []))
        del resume_ckpt
        print(f"Resumed from {args.resume} at epoch {start_epoch}")
    print("# Params. G: ", sum(p.numel() for p in state.G.parameters()))
    print("# Params. D: ", sum(p.numel() for p in state.D.parameters()))
    graphed = device.type == "cuda" and plan[0] > 1
    if plan[0] > 1:
        print(f"steps per dispatch: {plan[0]}"
              + (f" (+ one {plan[1]}-step remainder chunk)" if plan[1] else "")
              + (", replays of a captured CUDA graph of the step" if graphed else ""))
    rng = torch.Generator(device=device)
    dispatch = StepDispatch(state, sampler, rng, args, graphed=graphed)
    saver = saver if saver is not None else AsyncCheckpointer()
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
    # warns (stderr, once per stall) when the epochs stop completing
    watchdog = StallWatchdog().start()
    try:
        for epoch in range(start_epoch, args.epochs):
            reseed_epoch(rng, seed, epoch)
            if rotating:  # the epoch's windows from (seed, epoch)
                sampler.prepare_epoch(epoch)
            elif host:
                sampler.start_epoch([seed, epoch])
            # the epoch's losses stay on the device until its end (no per-step sync)
            dispatch.begin_epoch()
            if profiler is not None:  # the first epoch run: stopped at its step 4 or end
                profiler.start()
            i = 0
            for k in chunks:
                dispatch.set_lr()
                if rotating:
                    sampler.next_window()
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
            watchdog.beat()  # the sums' read waited for the epoch's steps: real progress
            elapsed = time.time() - start
            print("[%d/%d]\tLoss_D: %.4f\tLoss_G: %.4f, elapsed_time = %.4f min (%.2f steps/s)"
                  % (epoch + 1, args.epochs, d_run, g_run, elapsed / 60,
                     (epoch + 1 - start_epoch) * steps_per_epoch / elapsed))
            G_losses.append(g_run)
            D_losses.append(d_run)
            last = epoch + 1 == args.epochs
            if args.saving_rate is not None and ((epoch + 1) % args.saving_rate == 0 or last):
                saver.submit(filename + f"{epoch + 1}.ckpt",
                             checkpoint_payload(state, args, epoch + 1, seed, G_losses, D_losses))
            if last:
                if args.ema:
                    saver.submit(filename + "_ema.ckpt", ema_payload(state, args))
                plot_losses(G_losses, D_losses, filename)
        saver.wait()
    except BaseException:
        # drain the saves in flight so no file is left half written; the
        # drain's own error never masks the first one
        try:
            saver.wait()
        except Exception:
            pass
        raise
    finally:
        if host:
            sampler.close()
        watchdog.stop()
    return state, G_losses, D_losses


def main(argv=None) -> None:
    train(prepare_parser().parse_args(argv))


if __name__ == "__main__":
    main()
