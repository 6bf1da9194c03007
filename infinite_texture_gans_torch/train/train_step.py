"""The fused G + D training step, its state and optimizers.

Port of ``infinite_texture_gans_tpu/train/train_step.py`` (``lr_schedule``,
``make_optimizers``, ``create_train_state`` and ``_make_step_impl``
:189-395) for ``disc_iters`` 1 and the standard or hinge loss:

* one G forward in train mode (batch statistics, running-stat updates),
  whose autograd graph the G update reuses;
* D on the real crops and on the detached fake (spectral-norm vectors
  updated on each call), one Adam step on D;
* the UPDATED D on the stored fake (SN vectors updated once more), and one
  G backward through the saved forward, no second G forward; one Adam step
  on G;
* an EMA of G's parameters and BN running statistics.

When the generator's tail runs channels-major the fake image stays
(N, 3, H, W) from G's last kernel into D's stem kernel, and its gradient
comes back the same way (the reference's ``chw_wire``).

``torch.optim.Adam`` with betas (beta1, beta2) and eps 1e-8 computes the
update of ``optax.adam``: -lr * m̂ / (sqrt(v̂) + eps).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from infinite_texture_gans_torch.config import discriminator_kwargs, generator_kwargs
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.train import losses as L
from infinite_texture_gans_torch.weights import to_jax_variables

Schedule = Union[float, Callable[[int], float]]


def lr_schedule(base_lr: float, decay_lr: Optional[str], steps_per_epoch: int) -> Schedule:
    """Per-epoch schedules of the reference: 'exp' gamma 0.99, 'step'
    milestones [40, 80, 120] gamma 0.5; else the constant ``base_lr``."""
    if decay_lr == "exp":
        return lambda step: base_lr * 0.99 ** (step // steps_per_epoch)
    if decay_lr == "step":
        return lambda step: base_lr * 0.5 ** sum((step // steps_per_epoch) >= m for m in (40, 80, 120))
    return base_lr


def lr_at(sched: Schedule, step: int) -> float:
    return sched(step) if callable(sched) else sched


@dataclass
class TrainState:
    G: ResidualPatchGenerator
    D: PatchDiscriminator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    sched_G: Schedule
    sched_D: Schedule
    ema: Optional[Dict[str, torch.Tensor]]  # G's state dict: params and BN statistics
    step: int = 0


def make_optimizers(G, D, args: argparse.Namespace):
    kw = dict(betas=(float(args.beta1), float(args.beta2)), eps=1e-8)
    return (torch.optim.Adam(G.parameters(), lr=args.lr_G, **kw),
            torch.optim.Adam(D.parameters(), lr=args.lr_D, **kw))


def create_train_state(args: argparse.Namespace, steps_per_epoch: int, device,
                       seed: int = 0) -> TrainState:
    """Models from the training flags, initialised from ``seed`` on the CPU
    (the reference's initializers, other random numbers) and moved to
    ``device`` in train mode; Adam states; an EMA snapshot when ``--ema``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        G = ResidualPatchGenerator(**generator_kwargs(args))
        D = PatchDiscriminator(**discriminator_kwargs(args))
    G, D = G.to(device).train(), D.to(device).train()
    opt_G, opt_D = make_optimizers(G, D, args)
    ema = None
    if args.ema:
        ema = {k: v.detach().clone() for k, v in G.state_dict().items()}
    return TrainState(G, D, opt_G, opt_D,
                      lr_schedule(args.lr_G, args.decay_lr, steps_per_epoch),
                      lr_schedule(args.lr_D, args.decay_lr, steps_per_epoch), ema)


def train_step(state: TrainState, real_x: torch.Tensor, z: torch.Tensor,
               maps: Optional[List[torch.Tensor]] = None, *, loss_type: str = "standard",
               smooth: bool = False, ema_decay: float = 0.999,
               use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """One fused step on ``real_x`` (B, H, W, C) in [-1, 1], the latent
    ``z`` (the reference's ``build_train_z``) and, for an SSM generator, its
    maps (``build_train_maps``). Updates ``state`` in place; returns the
    three losses (0-d float32 tensors on the device). The parameters keep
    this step's gradients in ``.grad``."""
    G, D = state.G, state.D
    label_t = 0.9 if smooth else 1.0
    wire = G.emits_chw() and G.img_ch == 3
    G.train()
    D.train()
    for opt, sched in ((state.opt_G, state.sched_G), (state.opt_D, state.sched_D)):
        for group in opt.param_groups:
            group["lr"] = lr_at(sched, state.step)

    fake, _ = G(z, maps, out_chw=wire)

    rl = D(real_x, update_sn=True)
    fl = D(fake.detach(), update_sn=True, chw_in=wire)
    loss_real = L.d_loss_real(loss_type, rl, label_t)
    loss_fake = L.d_loss_fake(loss_type, fl, 0.0)
    state.opt_D.zero_grad(set_to_none=True)
    (loss_real + loss_fake).backward()
    state.opt_D.step()

    # the updated D on the stored fake: gradients for the image only
    D.requires_grad_(False)
    try:
        logit = D(fake, update_sn=True, chw_in=wire)
    finally:
        D.requires_grad_(True)
    loss_g = L.g_loss(loss_type, logit, label_t)
    state.opt_G.zero_grad(set_to_none=True)
    loss_g.backward()
    state.opt_G.step()

    if use_ema:
        with torch.no_grad():
            for k, v in G.state_dict().items():
                state.ema[k].copy_(state.ema[k] * ema_decay + v * (1.0 - ema_decay))
    state.step += 1
    return {"d_loss_real": loss_real.detach(), "d_loss_fake": loss_fake.detach(),
            "g_loss": loss_g.detach()}


def optimizer_tree(module: torch.nn.Module, opt: torch.optim.Adam, step: int,
                   scheduled: bool) -> Dict:
    """Adam's state as the reference's checkpoint holds ``optax.adam``'s:
    ``{'0': {'count', 'mu', 'nu'}, '1': {} or {'count'}}`` (the second entry
    is the learning-rate transform, which keeps a count when scheduled)."""
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        st = opt.state.get(p, {})
        mu[name] = st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p)
    count = np.asarray(step, np.int32)
    return {"0": {"count": count, "mu": to_jax_variables(mu).get("params", {}),
                  "nu": to_jax_variables(nu).get("params", {})},
            "1": {"count": count} if scheduled else {}}
