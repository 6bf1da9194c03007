"""The fused G + D training step, its state and optimizers.

Port of ``infinite_texture_gans_tpu/train/train_step.py`` (``lr_schedule``,
``make_optimizers``, ``create_train_state`` and ``_make_step_impl``
:189-395), every loss and ``disc_iters``:

* k = ``disc_iters`` D iterations on one batch of real crops, each with
  its own latent (and maps): a G forward in train mode (batch statistics,
  running-stat updates, G's spectral-norm vectors refreshed), the first
  k - 1 without a graph, the last one keeping the graph the G update
  reuses; D on the real crops and on the detached fake (SN vectors and
  D's BatchNorm statistics updated on each call), under ``--loss wgan``
  plus ``gp_weight`` times the gradient penalty on its own ``eps``, taken
  through the critic frozen as the fake pass left it (SN vectors not
  refreshed, BatchNorms on their running averages); one Adam step on D;
  the D losses summed over the k iterations;
* the UPDATED D on the stored fake (SN vectors and BN statistics updated
  once more), and one G backward through the saved forward, no second G
  forward; one Adam step on G;
* an EMA of G's parameters and BN running statistics (not of its SN
  vectors, as the reference keeps none).

When the generator's tail runs channels-major the fake image stays
(N, 3, H, W) from G's last kernel into D's stem kernel, and its gradient
comes back the same way (the reference's ``chw_wire``); not under
``--loss wgan``, whose penalty mixes the fake with the NHWC real crops and
differentiates D twice, which ``F.conv2d`` does and the stem kernel's
autograd Function does not.

``torch.optim.Adam`` with betas (beta1, beta2) and eps 1e-8 computes the
update of ``optax.adam``: -lr * m̂ / (sqrt(v̂) + eps). Its learning rate is
a tensor on the parameters' device, written between dispatches, and on
the card it is capturable (its step count a device tensor too), so that
an eager step and a replay of a captured one run the same arithmetic.

The train loop dispatches steps in chunks of K (``dispatch_plan``, the
reference's superstep, :406-530): :class:`StepDispatch` runs one step
with its draws, eagerly or as a replay of a captured CUDA graph.

Data-parallel (a :class:`TrainState` with an ``axis``, the reference's
mesh step :234-252): every rank draws the global batch, takes its slice,
normalises with the global batch's BatchNorm moments, averages the
gradients before each Adam step and returns the global losses, so the
ranks stay equal and the step equals the one-device step on the global
batch (:func:`fused_step`; :func:`check_data_parallel` refuses the flags
that cannot be split so).
"""

from __future__ import annotations

import argparse
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from infinite_texture_gans_torch.config import discriminator_kwargs, generator_kwargs
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import collectives
from infinite_texture_gans_torch.ops.graphs import CountedGraph, on_side_stream
from infinite_texture_gans_torch.parallel.mesh import DataAxis, replicate
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
    ema: Optional[Dict[str, torch.Tensor]]  # G's params and BN statistics (ema_state)
    step: int = 0
    axis: Optional[DataAxis] = None  # the data axis of a data-parallel run (parallel/mesh.py)


class Draw(NamedTuple):
    """One D iteration's draws: the latent, an SSM generator's maps, and
    under ``--loss wgan`` the penalty's interpolation weights (n, 1, 1, 1)."""
    z: torch.Tensor
    maps: Optional[List[torch.Tensor]] = None
    eps: Optional[torch.Tensor] = None


def ema_state(G: ResidualPatchGenerator) -> Dict[str, torch.Tensor]:
    """The entries of G's state dict that the EMA blends: parameters and BN
    statistics, not the spectral-norm vectors (the reference's EMA tree is
    ``{'params', 'batch_stats'}``)."""
    return {k: v for k, v in G.state_dict().items() if k.rsplit(".", 1)[-1] not in ("u", "v")}


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
                       seed: int = 0, axis: Optional[DataAxis] = None) -> TrainState:
    """Models from the training flags, initialised from ``seed`` on the CPU
    (the reference's initializers, other random numbers) and moved to
    ``device`` in train mode; Adam states; an EMA snapshot when ``--ema``.
    With ``axis`` (a rank of a data-parallel run) the state is rank 0's on
    every rank (:func:`replicate_state`) and its steps are data-parallel
    (:func:`fused_step`)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        G = ResidualPatchGenerator(**generator_kwargs(args))
        D = PatchDiscriminator(**discriminator_kwargs(args))
    G, D = G.to(device).train(), D.to(device).train()
    opt_G, opt_D = make_optimizers(G, D, args)
    ema = None
    if args.ema:
        ema = {k: v.detach().clone() for k, v in ema_state(G).items()}
    state = TrainState(G, D, opt_G, opt_D,
                       lr_schedule(args.lr_G, args.decay_lr, steps_per_epoch),
                       lr_schedule(args.lr_D, args.decay_lr, steps_per_epoch), ema, axis=axis)
    replicate_state(state)
    return state


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step reads and writes: both models' parameters and
    buffers, both Adam states and the EMA, in a fixed order."""
    out = [*state.G.state_dict().values(), *state.D.state_dict().values()]
    for module, opt in ((state.G, state.opt_G), (state.D, state.opt_D)):
        for p in module.parameters():
            out += [opt.state[p][k] for k in sorted(opt.state[p])]
    return out + list((state.ema or {}).values())


def replicate_state(state: TrainState) -> None:
    """Rank 0's parameters, statistics, Adam states and EMA on every rank of
    ``state.axis`` (a broadcast; nothing without an axis). The ranks then
    stay equal: every rank applies the same averaged gradients."""
    if state.axis is not None:
        replicate(state_tensors(state), state.axis)


def check_data_parallel(args: argparse.Namespace, size: int) -> None:
    """Refuse the flags whose step cannot be split over ``size`` ranks so
    that it equals the step on the global batch: a ``--batch_size`` the
    ranks do not divide, and the WGAN-GP penalty unless its interpolates
    pair each rank's own real and fake images (the penalty pairs the first
    min(batch_size, num_images) of each global batch: equal batches, split
    alike)."""
    if args.batch_size % size:
        raise ValueError(f"--batch_size {args.batch_size} does not split over {size} ranks")
    if args.loss == "wgan" and args.gp_weight > 0 and not (
            args.num_images == args.batch_size and args.num_images % size == 0):
        raise ValueError(
            f"--gp_weight {args.gp_weight} on {size} ranks: the gradient penalty pairs the first "
            f"min(--batch_size, --num_images) real and fake images of the global batch, which "
            f"splits over the ranks only with --num_images equal to --batch_size "
            f"({args.num_images} vs {args.batch_size})")


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


def fused_step(state: TrainState, real_x: torch.Tensor, draws: Sequence[Draw], *,
               loss_type: str = "standard", smooth: bool = False, gp_weight: float = 10.0,
               ema_decay: float = 0.999, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The device work of one step (:func:`train_step` without the
    learning-rate write and the step count): what a captured step holds.
    One D iteration per entry of ``draws``.

    Data-parallel (``state.axis``): ``real_x`` and ``draws`` are the global
    batch's, and each rank takes its slice of the crops and, where
    ``num_images`` splits (``DataAxis.shards``), of the latents, maps and
    penalty weights; otherwise every rank computes every fake. The
    BatchNorms of a sharded batch take global moments
    (``collectives.global_stats``), each Adam step follows a mean of the
    ranks' gradients (``collectives.average_grads``: each rank's backward
    already carries the other ranks' BatchNorm terms through the moments'
    all-reduce), and the losses returned are the global batch's."""
    G, D = state.G, state.D
    label_t = 0.9 if smooth else 1.0
    wire = G.emits_chw() and G.img_ch == 3 and loss_type != "wgan"
    penalty = loss_type == "wgan" and gp_weight > 0
    G.train()
    D.train()
    axis = state.axis
    group = g_group = None
    if axis is not None:
        group = axis.group
        real_x = axis.shard(real_x)
        if axis.shards(draws[0].z.shape[0]):
            g_group = group
            draws = [Draw(axis.shard(d.z),
                          None if d.maps is None else [axis.shard(m) for m in d.maps],
                          None if d.eps is None else axis.shard(d.eps)) for d in draws]

    def reduce_grads(module):
        if group is not None:
            collectives.average_grads(module.parameters(), group)

    loss_real = loss_fake = None
    for it, d in enumerate(draws):
        last = it == len(draws) - 1
        with torch.set_grad_enabled(last), collectives.global_stats(g_group):
            fake, _ = G(d.z, d.maps, out_chw=wire, update_sn=True)
        with collectives.global_stats(group):
            rl = D(real_x, update_sn=True)
        with collectives.global_stats(g_group):
            fl = D(fake.detach(), update_sn=True, chw_in=wire)
        lr_ = L.d_loss_real(loss_type, rl, label_t)
        lf_ = L.d_loss_fake(loss_type, fl, 0.0)
        total = lr_ + lf_
        if penalty:
            # the critic frozen as the fake pass left it: no SN refresh,
            # BatchNorms on their running averages
            gp = L.gradient_penalty(lambda x: D(x, train=False), real_x, fake.detach(), d.eps)
            total = total + gp_weight * gp
        state.opt_D.zero_grad(set_to_none=True)
        total.backward()
        reduce_grads(D)
        _adam_step(state.opt_D)
        loss_real = lr_.detach() if loss_real is None else loss_real + lr_.detach()
        loss_fake = lf_.detach() if loss_fake is None else loss_fake + lf_.detach()

    # the updated D on the stored fake: gradients for the image only
    D.requires_grad_(False)
    try:
        with collectives.global_stats(g_group):
            logit = D(fake, update_sn=True, chw_in=wire)
    finally:
        D.requires_grad_(True)
    loss_g = L.g_loss(loss_type, logit, label_t)
    state.opt_G.zero_grad(set_to_none=True)
    loss_g.backward()
    reduce_grads(G)
    _adam_step(state.opt_G)

    if use_ema:
        with torch.no_grad():
            for k, v in ema_state(G).items():
                state.ema[k].copy_(state.ema[k] * ema_decay + v * (1.0 - ema_decay))
    losses = {"d_loss_real": loss_real, "d_loss_fake": loss_fake, "g_loss": loss_g.detach()}
    if group is not None:  # the global batch's: the mean of the ranks' equal slices
        summed = torch.stack(list(losses.values()))
        torch.distributed.all_reduce(summed, group=group)
        losses = dict(zip(losses, (summed / axis.size).unbind()))
    return losses


def train_step(state: TrainState, real_x: torch.Tensor, z, maps=None, *, eps=None,
               loss_type: str = "standard", smooth: bool = False, gp_weight: float = 10.0,
               ema_decay: float = 0.999, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """One fused step on ``real_x`` (B, H, W, C) in [-1, 1]. ``z`` is the
    latent (the reference's ``build_train_z``), ``maps`` an SSM generator's
    maps (``build_train_maps``) and ``eps`` the gradient penalty's weights
    (n, 1, 1, 1) for ``--loss wgan``; for ``disc_iters`` k > 1 each is a
    list of k, one per D iteration (``maps`` and ``eps`` may be None).
    Updates ``state`` in place; returns the three losses (0-d float32
    tensors on the device, the D losses summed over the D iterations). The
    parameters keep this step's gradients in ``.grad``: D's from its last
    iteration."""
    if isinstance(z, torch.Tensor):
        draws = [Draw(z, maps, eps)]
    else:
        n = len(z)
        draws = [Draw(z[i], None if maps is None else maps[i], None if eps is None else eps[i])
                 for i in range(n)]
    set_lr(state)
    m = fused_step(state, real_x, draws, loss_type=loss_type, smooth=smooth, gp_weight=gp_weight,
                   ema_decay=ema_decay, use_ema=use_ema)
    state.step += 1
    return m


def draw_iterations(rng: torch.Generator, args: argparse.Namespace, device) -> List[Draw]:
    """Each of the ``args.disc_iters`` D iterations' draws from ``rng``, in
    order: the latent, an SSM generator's maps, and under ``--loss wgan``
    the penalty's weights (one per interpolate: the smaller of the real and
    fake batches)."""
    kw = dict(device=device, padding_mode=args.padding_mode)
    grid = (args.base_res, args.num_patches_height, args.num_patches_width)
    draws = []
    for _ in range(args.disc_iters):
        z = build_train_z(rng, args.num_images, args.z_dim, *grid, **kw)
        maps = None
        if args.type_norm_G == "SSM":
            maps = build_train_maps(rng, args.num_images, args.map_dim, args.n_layers_G, *grid,
                                    **kw)
        eps = None
        if args.loss == "wgan" and args.gp_weight > 0:
            n = min(args.batch_size, args.num_images)
            eps = torch.rand((n, 1, 1, 1), generator=rng, device=device)
        draws.append(Draw(z, maps, eps))
    return draws


class StepDispatch:
    """The train loop's step with its draws: a batch of crops from
    ``sampler``, then for each of the ``disc_iters`` D iterations the
    latent, an SSM generator's maps and under ``--loss wgan`` the penalty's
    weights, all drawn from ``rng`` in that order (:meth:`draw`), then
    :func:`fused_step`, and the epoch's loss sums ``d_sum`` and ``g_sum``
    added on the device: the reference's superstep body
    (``make_train_superstep``, crops sampled in-jit).

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

    def draw(self, rng: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, List[Draw]]:
        """The step's draws from ``rng`` (the run's generator by default):
        the real crops, then :func:`draw_iterations`."""
        rng = self.rng if rng is None else rng
        real = self.sampler.sample(rng, self.args.batch_size)
        return real, draw_iterations(rng, self.args, real.device)

    def body(self) -> Dict[str, torch.Tensor]:
        """The step's device work (:meth:`draw`, :func:`fused_step`, the loss
        sums) without the step count: what a capture holds."""
        a = self.args
        real, draws = self.draw()
        m = fused_step(self.state, real, draws, loss_type=a.loss, smooth=a.smooth,
                       gp_weight=a.gp_weight, ema_decay=a.ema_decay, use_ema=a.ema)
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
