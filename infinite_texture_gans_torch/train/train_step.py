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
update of ``optax.adam``: -lr * m̂ / (sqrt(v̂) + eps). Its learning rate is
a tensor on the parameters' device, written between dispatches, and on
the card it is capturable (its step count a device tensor too), so that
an eager step and a replay of a captured one run the same arithmetic.

The train loop dispatches steps in chunks of K (``dispatch_plan``, the
reference's superstep, :406-530): :class:`StepDispatch` runs one step
with its draws, eagerly or as a replay of a captured CUDA graph.
"""

from __future__ import annotations

import argparse
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from infinite_texture_gans_torch.config import discriminator_kwargs, generator_kwargs
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.graphs import CountedGraph, on_side_stream
from infinite_texture_gans_torch.sampling.latents import build_train_maps, build_train_z
from infinite_texture_gans_torch.train import losses as L
from infinite_texture_gans_torch.weights import jax_tree

Schedule = Union[float, Callable[[int], float]]

# eager steps on a side stream before the step is captured (PyTorch's
# warm-up): real steps of the run
WARMUP_STEPS = 2


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


def dispatch_chunk(steps_per_epoch: int, cap: int = 128) -> int:
    """Largest divisor of ``steps_per_epoch`` that is <= ``cap`` (the
    reference's superstep length K); cap <= 1 disables the superstep."""
    if cap <= 1 or steps_per_epoch <= 1:
        return 1
    best = 1
    for k in range(1, min(steps_per_epoch, cap) + 1):
        if steps_per_epoch % k == 0:
            best = k
    return best


def dispatch_plan(steps_per_epoch: int, cap: int = 128) -> Tuple[int, int]:
    """The superstep's dispatch plan ``(K, remainder)``, as the reference
    plans it: the largest divisor of ``steps_per_epoch`` <= ``cap``; where
    that divisor is degenerate (< cap // 4, e.g. a prime above the cap),
    ``steps // cap`` chunks of K = cap and one chunk of ``steps % cap``."""
    k = dispatch_chunk(steps_per_epoch, cap)
    if cap <= 1 or steps_per_epoch <= 1 or k >= max(2, cap // 4):
        return k, 0
    k = min(cap, steps_per_epoch)
    return k, steps_per_epoch % k


def dispatch_chunks(steps_per_epoch: int, plan: Tuple[int, int]) -> List[int]:
    """The chunk lengths of one epoch under ``plan``."""
    k, rem = plan
    return [k] * (steps_per_epoch // k) + ([rem] if rem else [])


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


def init_adam_state(opt: torch.optim.Adam) -> None:
    """Adam's per-parameter state as its first step creates it (step count
    0, zero moments), made up front: a captured step must find it, since
    creating it inside a capture would zero it at every replay."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            st["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                          if group["capturable"] else torch.tensor(0.0))
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def make_optimizers(G, D, args: argparse.Namespace):
    """Adam for G and D: the learning rate in a float32 tensor on the
    parameters' device (:func:`set_lr` writes it), capturable on the card,
    the state made up front (:func:`init_adam_state`)."""
    opts = []
    for module, lr in ((G, args.lr_G), (D, args.lr_D)):
        dev = next(module.parameters()).device
        opt = torch.optim.Adam(module.parameters(), lr=torch.tensor(float(lr), device=dev),
                               betas=(float(args.beta1), float(args.beta2)), eps=1e-8,
                               capturable=dev.type == "cuda")
        init_adam_state(opt)
        opts.append(opt)
    return tuple(opts)


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


def set_lr(state: TrainState) -> None:
    """Write both learning rates of step ``state.step`` into their tensors."""
    for opt, sched in ((state.opt_G, state.sched_G), (state.opt_D, state.sched_D)):
        for group in opt.param_groups:
            group["lr"].fill_(lr_at(sched, state.step))


def _adam_step(opt: torch.optim.Adam) -> None:
    with warnings.catch_warnings():
        # an eager step of a capturable Adam: the arithmetic of its replays
        warnings.filterwarnings("ignore", message="This instance was constructed with capturable")
        opt.step()


def fused_step(state: TrainState, real_x: torch.Tensor, z: torch.Tensor,
               maps: Optional[List[torch.Tensor]] = None, *, loss_type: str = "standard",
               smooth: bool = False, ema_decay: float = 0.999,
               use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The device work of one step (:func:`train_step` without the
    learning-rate write and the step count): what a captured step holds."""
    G, D = state.G, state.D
    label_t = 0.9 if smooth else 1.0
    wire = G.emits_chw() and G.img_ch == 3
    G.train()
    D.train()

    fake, _ = G(z, maps, out_chw=wire)

    rl = D(real_x, update_sn=True)
    fl = D(fake.detach(), update_sn=True, chw_in=wire)
    loss_real = L.d_loss_real(loss_type, rl, label_t)
    loss_fake = L.d_loss_fake(loss_type, fl, 0.0)
    state.opt_D.zero_grad(set_to_none=True)
    (loss_real + loss_fake).backward()
    _adam_step(state.opt_D)

    # the updated D on the stored fake: gradients for the image only
    D.requires_grad_(False)
    try:
        logit = D(fake, update_sn=True, chw_in=wire)
    finally:
        D.requires_grad_(True)
    loss_g = L.g_loss(loss_type, logit, label_t)
    state.opt_G.zero_grad(set_to_none=True)
    loss_g.backward()
    _adam_step(state.opt_G)

    if use_ema:
        with torch.no_grad():
            for k, v in G.state_dict().items():
                state.ema[k].copy_(state.ema[k] * ema_decay + v * (1.0 - ema_decay))
    return {"d_loss_real": loss_real.detach(), "d_loss_fake": loss_fake.detach(),
            "g_loss": loss_g.detach()}


def train_step(state: TrainState, real_x: torch.Tensor, z: torch.Tensor,
               maps: Optional[List[torch.Tensor]] = None, *, loss_type: str = "standard",
               smooth: bool = False, ema_decay: float = 0.999,
               use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """One fused step on ``real_x`` (B, H, W, C) in [-1, 1], the latent
    ``z`` (the reference's ``build_train_z``) and, for an SSM generator, its
    maps (``build_train_maps``). Updates ``state`` in place; returns the
    three losses (0-d float32 tensors on the device). The parameters keep
    this step's gradients in ``.grad``."""
    set_lr(state)
    m = fused_step(state, real_x, z, maps, loss_type=loss_type, smooth=smooth,
                   ema_decay=ema_decay, use_ema=use_ema)
    state.step += 1
    return m


class StepDispatch:
    """The train loop's step with its draws: a batch of crops from
    ``sampler``, the latent and an SSM generator's maps, all drawn from
    ``rng`` in the eager loop's order, then :func:`fused_step`, and the
    epoch's loss sums ``d_sum`` and ``g_sum`` added on the device: the
    reference's superstep body (``make_train_superstep``, crops sampled
    in-jit).

    ``graphed`` (a state on the card): the first ``WARMUP_STEPS`` steps
    run eagerly on a side stream, the next is captured as a CUDA graph with
    ``rng`` registered, and from then on every step is one replay: the
    same launches on the draws an eager step would make from ``rng``'s
    state. Otherwise every step runs eagerly (the CPU; one step per
    dispatch). :meth:`step` returns the step's losses, which the next step
    overwrites; :meth:`set_lr` writes the learning rates between chunks."""

    def __init__(self, state: TrainState, sampler, rng: torch.Generator,
                 args: argparse.Namespace, graphed: bool = False):
        dev = next(state.G.parameters()).device
        if graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a state on the card, not on {dev}")
        self.state, self.sampler, self.rng, self.args = state, sampler, rng, args
        self.graphed = graphed
        self.d_sum = torch.zeros((), device=dev)
        self.g_sum = torch.zeros((), device=dev)
        self.graph: Optional[CountedGraph] = None
        self._losses: Optional[Dict[str, torch.Tensor]] = None
        self._warm = 0

    def begin_epoch(self) -> None:
        self.d_sum.zero_()
        self.g_sum.zero_()

    def set_lr(self) -> None:
        set_lr(self.state)

    def body(self) -> Dict[str, torch.Tensor]:
        """The step's device work (draws, :func:`fused_step`, the loss sums)
        without the step count: what a capture holds."""
        a, G = self.args, self.state.G
        real = self.sampler.sample(self.rng, a.batch_size)
        dev = real.device
        z = build_train_z(self.rng, a.num_images, G.z_dim, G.base_res, G.num_patches_h,
                          G.num_patches_w, device=dev, padding_mode=G.padding_mode)
        maps = None
        if G.type_norm == "SSM":
            maps = build_train_maps(self.rng, a.num_images, G.map_dim, G.n_layers_G, G.base_res,
                                    G.num_patches_h, G.num_patches_w, device=dev,
                                    padding_mode=G.padding_mode)
        m = fused_step(self.state, real, z, maps, loss_type=a.loss, smooth=a.smooth,
                       ema_decay=a.ema_decay, use_ema=a.ema)
        self.d_sum.add_(m["d_loss_fake"] * a.num_images).add_(m["d_loss_real"] * a.batch_size)
        self.g_sum.add_(m["g_loss"] * a.num_images)
        return m

    def step(self) -> Dict[str, torch.Tensor]:
        if not self.graphed:
            m = self.body()
        elif self.graph is None:
            with torch.cuda.device(self.d_sum.device):
                if self._warm < WARMUP_STEPS:
                    m = on_side_stream(self.body)
                    self._warm += 1
                else:
                    self.graph = CountedGraph()
                    m = self._losses = self.graph.capture(self.body, generators=(self.rng,))
                    self.graph.replay()
        else:
            self.graph.replay()
            m = self._losses
        self.state.step += 1
        return m


def optimizer_tree(module: torch.nn.Module, opt: torch.optim.Adam, step: int,
                   scheduled: bool) -> Dict:
    """Adam's state as the reference's checkpoint holds ``optax.adam``'s:
    ``{'0': {'count', 'mu', 'nu'}, '1': {} or {'count'}}`` (the second entry
    is the learning-rate transform, which keeps a count when scheduled).
    The moments stay tensors on their device (``weights.jax_tree``);
    ``checkpoint.restore_train_state`` is the inverse."""
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        mu[name] = opt.state[p]["exp_avg"]
        nu[name] = opt.state[p]["exp_avg_sq"]
    count = np.asarray(step, np.int32)
    return {"0": {"count": count, "mu": jax_tree(mu).get("params", {}),
                  "nu": jax_tree(nu).get("params", {})},
            "1": {"count": count} if scheduled else {}}
