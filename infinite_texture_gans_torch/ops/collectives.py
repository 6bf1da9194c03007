"""The data axis's collectives as the models meet them.

``parallel/`` runs one process per device (``torch.distributed``: NCCL on
the card, gloo on the CPU). Two things inside the models must then reach
across ranks, and both are switched on by a context that the caller sets
around the forward it wants them in, so that the models keep one code path:

* **Global BatchNorm statistics** (:func:`global_stats`): under a group, a
  train-mode BatchNorm all-reduces its per-channel (Σy, Σy²) and its count
  before it takes the moments (:func:`global_sums`), so a rank's slice of a
  batch is normalised with the whole batch's moments, as one device would
  normalise it (the reference's GSPMD did this for its mesh). The
  all-reduce is :class:`_AllReduceSum`, whose backward is the same
  all-reduce of the incoming gradients (and itself differentiable, for the
  gradient penalty's double backward): the per-channel gradient sums that
  reach the BatchNorm's inputs become global by themselves.
* **Width halos** (:func:`width_halo`): the width-sharded one pass
  (``parallel/sharded.py``) splits a canvas into column slabs, one per
  rank; every 3x3 conv of the local-padding generator then reads one column
  of each neighbouring slab (:func:`halo_exchanged`).

Outside these contexts nothing here runs, and the undistributed models do
what they did. :func:`average_grads` is the data-parallel step's gradient
all-reduce (one flat bucket per optimizer).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; its backward is the same sum of the
    gradients (every rank's output depends on every rank's input), taken
    through this Function again so that a double backward works."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``'s ranks."""
    return _AllReduceSum.apply(x, group)


_STATS_GROUP: list = [None]  # the group whose ranks share the BatchNorm statistics


@contextlib.contextmanager
def global_stats(group):
    """Train-mode BatchNorms inside the block take their moments over every
    rank of ``group`` (None: over the local batch, as without the context)."""
    before = _STATS_GROUP[0]
    _STATS_GROUP[0] = group
    try:
        yield
    finally:
        _STATS_GROUP[0] = before


def global_sums(s1: torch.Tensor, s2: torch.Tensor,
                count: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A BatchNorm's per-channel (Σy, Σy², count) over the ranks of the
    :func:`global_stats` group (one all-reduce of both sums; the count is
    the local one times the world size: the ranks hold equal slices), or as
    given outside it."""
    group = _STATS_GROUP[0]
    if group is None:
        return s1, s2, count
    both = all_reduce_sum(torch.stack([s1.float(), s2.float()]), group)
    return both[0], both[1], count * dist.get_world_size(group)


def average_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Replace each parameter's gradient by its mean over ``group``'s ranks:
    one all-reduce of a flat float32 bucket, then a division by the world
    size (exact at world size 1)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


class WidthHalo(NamedTuple):
    """Where this rank's column slab sits: its left and right neighbours'
    ranks in ``group`` (None at the canvas's true edges)."""

    left: Optional[int]
    right: Optional[int]
    group: object = None


_WIDTH_HALO: list = [None]


@contextlib.contextmanager
def width_halo(halo: Optional[WidthHalo]):
    """Every local-padding 3x3 conv of a one pass inside the block reads one
    column of each neighbouring rank's slab (:func:`halo_exchanged`)."""
    before = _WIDTH_HALO[0]
    _WIDTH_HALO[0] = halo
    try:
        yield
    finally:
        _WIDTH_HALO[0] = before


def current_width_halo() -> Optional[WidthHalo]:
    return _WIDTH_HALO[0]


def _exchange_columns(x: torch.Tensor, dim: int, halo: WidthHalo):
    """(left neighbour's last column, right neighbour's first column) of
    ``x`` along ``dim``, each None where the slab has no such neighbour."""
    ops, left, right = [], None, None
    if halo.left is not None:
        left = torch.empty_like(x.narrow(dim, 0, 1).contiguous())
        ops += [dist.P2POp(dist.isend, x.narrow(dim, 0, 1).contiguous(), halo.left, halo.group),
                dist.P2POp(dist.irecv, left, halo.left, halo.group)]
    if halo.right is not None:
        right = torch.empty_like(x.narrow(dim, x.shape[dim] - 1, 1).contiguous())
        ops += [dist.P2POp(dist.isend, x.narrow(dim, x.shape[dim] - 1, 1).contiguous(),
                           halo.right, halo.group),
                dist.P2POp(dist.irecv, right, halo.right, halo.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left, right


def halo_exchanged(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, dim: int,
                   scale: int = 1) -> torch.Tensor:
    """``fn(x)`` of a 3x3 conv under :func:`width_halo`: ``x`` widened along
    ``dim`` by one column of each neighbour's slab, ``fn`` run on that (its
    own padding then applies only at the canvas's true edges), and the
    output narrowed back by ``scale`` columns on each widened side (2 where
    ``fn`` upsamples first). Outside the context, ``fn(x)``."""
    halo = _WIDTH_HALO[0]
    if halo is None:
        return fn(x)
    left, right = _exchange_columns(x, dim, halo)
    wide = torch.cat([t for t in (left, x, right) if t is not None], dim)
    _WIDTH_HALO[0] = None  # fn's own convs are the ones being widened
    try:
        y = fn(wide)
    finally:
        _WIDTH_HALO[0] = halo
    lo = scale if left is not None else 0
    hi = y.shape[dim] - (scale if right is not None else 0)
    return y.narrow(dim, lo, hi - lo).contiguous()
