"""Multi-device generation by sharding: images over the ranks, or one
canvas's width.

Port of ``infinite_texture_gans_tpu/parallel/sharded.py``:

1. :func:`shard_images`: the raster engine's state is per image, so a
   batch of canvases splits over the ranks as it is (each rank runs
   ``generate_canvas`` on its slice of the latents).
2. :func:`generate_one_pass_sharded`: a canvas that fits one generator pass
   runs with its width split into column slabs, one per rank, whole patch
   columns each (the attention is per patch; slabs differ by at most one
   column). The reference's GSPMD inserted the 1-pixel halo exchange of
   every conv; here it is explicit: under ``ops/collectives.py:
   width_halo`` every 3x3 conv of the generator reads one column of each
   neighbouring slab (P2P), and pads itself only at the canvas's true left
   and right edges. The latents and maps carry their own pads, so each
   rank cuts its slab's inputs from the full ones with no exchange. Memory
   is O(canvas / N) a rank; rank 0 gathers the canvas.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import collectives
from infinite_texture_gans_torch.parallel.mesh import DataAxis, current_axis
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import generate_one_pass


def shard_images(tree, axis: Optional[DataAxis] = None):
    """This rank's slice of a tensor of per-image values (leading axis =
    image), or of each tensor of a list, tuple or dict of them; the input
    itself outside a rank."""
    axis = axis or current_axis()
    if axis is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_images(v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_images(v, axis) for v in tree)
    return axis.shard(tree)


def column_slabs(total_patches_w: int, size: int) -> List[tuple]:
    """(first patch column, columns) of each working rank's slab: the
    columns split as evenly as whole columns allow over min(size,
    total_patches_w) ranks (a rank past that has none)."""
    k = min(size, total_patches_w)
    counts = [total_patches_w // k + (1 if i < total_patches_w % k else 0) for i in range(k)]
    starts = [sum(counts[:i]) for i in range(k)]
    return list(zip(starts, counts))


@torch.no_grad()
def generate_one_pass_sharded(
    gen: ResidualPatchGenerator,
    z_full: torch.Tensor,
    maps_full: Optional[List[torch.Tensor]] = None,
    total_patches_h: int = 3,
    total_patches_w: int = 3,
    axis: Optional[DataAxis] = None,
) -> Optional[torch.Tensor]:
    """``sampling.infinite.generate_one_pass`` with the canvas width split
    over the ranks of ``axis`` (the calling rank's by default; the plain one
    pass without one). ``z_full`` (N, tot_h*base+2, tot_w*base+2, z_dim)
    and an SSM generator's ``maps_full`` are the whole canvas's, the same on
    every rank. Returns on rank 0 the (N, tot_h*P, tot_w*P, C) canvas on its
    device, gathered from the slabs; None on the other ranks."""
    axis = axis or current_axis()
    if axis is None:
        return generate_one_pass(gen, z_full, total_patches_h, total_patches_w, maps_full)
    if gen.padding_mode != "local":
        raise ValueError("the width-sharded one pass needs padding_mode='local' (a zeros-padding "
                         "generator attends over the whole image)")
    slabs = column_slabs(total_patches_w, axis.size)
    base, P = gen.base_res, gen.patch_resolution
    out = None
    if axis.rank < len(slabs):
        c0, cw = slabs[axis.rank]
        z = z_full[:, :, c0 * base : (c0 + cw) * base + latents.Z_PAD]
        maps = None
        if maps_full is not None:
            maps = [m[:, :, c0 * (2**i) * base : (c0 + cw) * (2**i) * base + latents.MAP_PAD]
                    for i, m in enumerate(maps_full)]
        halo = collectives.WidthHalo(axis.rank - 1 if axis.rank > 0 else None,
                                     axis.rank + 1 if axis.rank < len(slabs) - 1 else None,
                                     axis.group)
        with collectives.width_halo(halo):
            out = generate_one_pass(gen, z, total_patches_h, cw, maps)
    if axis.rank:
        if out is not None:
            dist.send(out.contiguous(), 0, axis.group)
        return None
    parts = [out]
    for r, (_, cw) in enumerate(slabs[1:], start=1):
        part = torch.empty(out.shape[:2] + (cw * P,) + out.shape[3:], dtype=out.dtype,
                           device=out.device)
        dist.recv(part, r, axis.group)
        parts.append(part)
    return torch.cat(parts, dim=2)
