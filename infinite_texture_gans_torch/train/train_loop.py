"""Training loop and CLI:
``python -m infinite_texture_gans_torch.train.train_loop --data_path ...``.

Port of ``infinite_texture_gans_tpu/train/train_loop.py: train`` in its
per-step form: epochs of ``ceil(--sampling / --batch_size)`` steps, each
step a batch of random crops, the latents (and an SSM generator's maps)
drawn on the device and one fused G + D step
(``train_step.py``), the epoch's mean losses printed and kept, and a
``.ckpt`` every ``--saving_rate`` epochs and at the end (plus
``<epochs>__ema.ckpt`` with ``--ema``), in the reference's format.
Crops, latents and maps come from one ``torch.Generator`` seeded with the
run's seed (other numbers than the reference's ``jax.random`` keys).

Not ported yet: the superstep (K steps per dispatch), the host prefetcher,
meshes, multi-image data, resume and the loss plot. Runs on ``cuda`` unless
``--device cpu`` is given.
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
from infinite_texture_gans_torch.config import check_train_args, prepare_parser
from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
from infinite_texture_gans_torch.sampling.latents import build_train_maps, build_train_z
from infinite_texture_gans_torch.train.checkpoint import save_checkpoint
from infinite_texture_gans_torch.train.train_step import (
    TrainState,
    create_train_state,
    optimizer_tree,
    train_step,
)
from infinite_texture_gans_torch.weights import to_jax_variables


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
    ``step_callback(epoch, i, metrics)`` runs after every step."""
    check_train_args(args)
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else random.randint(1, 10000)
    print("Random Seed: ", seed)
    print(args)
    dataset = SingleImageDataset(args.data_path, args.data_ext, args.center_crop,
                                 args.random_crop, args.sampling)
    print("Training samples: ", len(dataset))
    steps_per_epoch = max(1, math.ceil(len(dataset) / args.batch_size))
    state = create_train_state(args, steps_per_epoch, device, seed)
    print("# Params. G: ", sum(p.numel() for p in state.G.parameters()))
    print("# Params. D: ", sum(p.numel() for p in state.D.parameters()))
    sampler = DeviceCropSampler(dataset, device)
    rng = torch.Generator(device=device).manual_seed(seed)
    G = state.G
    filename = prepare_filename(args)
    G_losses, D_losses = [], []
    start = time.time()
    print("Starting Training Loop...")
    for epoch in range(args.epochs):
        # the epoch's losses stay on the device until its end (no per-step sync)
        d_sum = g_sum = 0.0
        for i in range(steps_per_epoch):
            real = sampler.sample(rng, args.batch_size)
            z = build_train_z(rng, args.num_images, G.z_dim, G.base_res,
                              G.num_patches_h, G.num_patches_w, device=device)
            maps = None
            if G.type_norm == "SSM":
                maps = build_train_maps(rng, args.num_images, G.map_dim, G.n_layers_G, G.base_res,
                                        G.num_patches_h, G.num_patches_w, device=device)
            m = train_step(state, real, z, maps, loss_type=args.loss, smooth=args.smooth,
                           ema_decay=args.ema_decay, use_ema=args.ema)
            d_sum = d_sum + m["d_loss_fake"] * args.num_images + m["d_loss_real"] * args.batch_size
            g_sum = g_sum + m["g_loss"] * args.num_images
            if step_callback is not None:
                step_callback(epoch, i, m)
        d_run = float(d_sum) / (args.batch_size * steps_per_epoch)
        g_run = float(g_sum) / (args.num_images * steps_per_epoch)
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
