"""Batched-diagonal canvas engine: several canvas rows in one generator call.

Port of ``infinite_texture_gans_tpu/sampling/diag.py``. Sub-image (r, c)
of the raster needs the halo written by (r, c-1) and, two steps ahead of
it, by row r-1, so rows can advance together on a staggered schedule: the
v3 cyclic wavefront of the multi-device engine
(``parallel/wavefront.py``: :func:`schedule_constants` and
:func:`lane_schedule`, shared), here with its devices as ``lanes`` of one
batch. Each generator call runs L canvas rows at once, N = L x
``num_images``, so the convolutions of a canvas run at batch N where the
raster runs them at ``num_images``, in about ceil(steps_h / L) x steps_w
calls instead of steps_h x steps_w.

Every lane has its own halo cache (its sub-batch of every site's buffers)
and a ``pending`` row buffer for its next row's upstream halo. After every
call each lane's finished bottom-row buffer goes to the next lane
(cyclically), which takes it, by the schedule, into the row it is working
on or into ``pending`` for its next one. The positions of a call are one
per batch element (``ops/padding.py: LanePos``): the halo helpers read and
write each lane's cache at its own column, and a lane with no sub-image
at a step computes a clipped one whose output and cache update are
dropped. The sub-images are trimmed and painted into the canvas as the
raster paints them (``infinite.py: _paint_row``), a row once its lane
finishes it, with the raster's ``wire`` contract.

Equal to :func:`sampling.infinite.generate_canvas` bit for bit on the CPU
in float32 (``tests/test_torch_diag.py``). The engine runs eagerly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.padding import LanePos, finalize_row, init_halo_state
from infinite_texture_gans_torch.parallel.wavefront import lane_schedule, schedule_constants  # noqa: F401
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import _paint_row, canvas_latents


@torch.no_grad()
def generate_canvas_diag(
    gen: ResidualPatchGenerator,
    generator: Optional[torch.Generator] = None,
    output_resolution_height: int = 384,
    output_resolution_width: int = 384,
    num_images: int = 1,
    lanes: Optional[int] = None,
    z_full: Optional[torch.Tensor] = None,
    maps_full: Optional[List[torch.Tensor]] = None,
    wire: str = "f32",
    progress: bool = False,
) -> np.ndarray:
    """The canvas of :func:`sampling.infinite.generate_canvas` (the same
    arguments, latents and ``wire``; a host array (N, out_h, out_w, C)),
    computed ``lanes`` canvas rows at a time (module docstring). ``lanes``
    None takes ``min(steps_h, 8)``; 1 is the sequential schedule. Raises
    ValueError for a generator of fewer than 3 patch columns: the lag-2
    schedule needs the upstream row two columns ahead of the halo it
    reads."""
    if wire not in ("f32", "u8"):
        raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r}")
    P, gh, gw, base = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w, gen.base_res
    if gw < 3:
        raise ValueError(f"diagonal engine requires num_patches_w >= 3 (got {gw}); the lag-2 "
                         "schedule's halo read window would race the row buffer")
    (steps_h, steps_w, tot_h, tot_w), z_full, maps_full = canvas_latents(
        gen, generator, output_resolution_height, output_resolution_width, num_images, z_full,
        maps_full)
    lanes = min(steps_h, 8) if lanes is None else max(1, min(lanes, steps_h))
    sch = lane_schedule(steps_w, steps_h, lanes)
    n = z_full.shape[0]
    dev = z_full.device
    # the per-element positions of every step on the device, a lane's
    # repeated for its n images
    table = {k: torch.from_numpy(np.repeat(sch[k], n, axis=1)).to(dev)
             for k in ("cc", "active", "start", "accept_cur", "accept_pend")}
    first_row = torch.from_numpy(np.repeat(sch["rr"] == 0, n, axis=1)).to(dev)
    first_col = table["cc"] == 0

    halo = init_halo_state(gen.site_specs(), lanes * n, gh, gw, tot_w, dtype=gen.dtype, device=dev)
    pending = {name: torch.zeros_like(s.row_read) for name, s in halo.items()}
    as_uint8 = wire == "u8"
    canvas = torch.zeros((n, tot_h * P, tot_w * P, gen.img_ch),
                         dtype=torch.uint8 if as_uint8 else torch.float32, device=dev)
    rows: Dict[int, list] = {}
    # each step's latent (and map) windows, lane after lane, laid out as the
    # raster's row strips are (``RasterRow``): the generator's first convs
    # then read inputs of the raster's strides
    strips = [torch.empty((lanes * n, gh * base + latents.Z_PAD, tot_w * base + latents.Z_PAD,
                           gen.z_dim), device=dev)]
    if maps_full is not None:
        strips += [torch.empty((lanes * n, gh * (2**i) * base + latents.MAP_PAD,
                                tot_w * (2**i) * base + latents.MAP_PAD, gen.map_dim), device=dev)
                   for i in range(gen.n_layers_G)]

    def per_elem(mask):
        return mask.view(-1, 1, 1, 1)

    for t in range(sch["r"].shape[0]):
        if sch["start"][t].any():  # a lane starts a row: its pending upstream row, a fresh buffer
            start = per_elem(table["start"][t])
            for name, s in halo.items():
                s.row_read.copy_(torch.where(start, pending[name], s.row_read))
                s.row_write.masked_fill_(start, 0)
        rr, cc = sch["rr"][t], sch["cc"][t]
        for l in range(lanes):
            win = [latents.slice_sub_z(z_full, rr[l], cc[l], base, gh, gw)]
            if maps_full is not None:
                win += latents.slice_sub_maps(maps_full, rr[l], cc[l], base, gh, gw)
            for buf, w in zip(strips, win):
                buf[l * n : (l + 1) * n, :, : w.shape[2]] = w
        z_sub, *maps_sub = (buf[:, :, : w.shape[2]] for buf, w in zip(strips, win))
        pos = LanePos(col=table["cc"][t], first_row=first_row[t], first_col=first_col[t],
                      active=table["active"][t])
        out, halo = gen(z_sub, maps_sub or None, halo=halo, pos=pos)
        for l in np.flatnonzero(sch["active"][t]):
            r, c = int(sch["r"][t, l]), int(sch["c"][t, l])
            rows.setdefault(r, [None] * steps_w)[c] = out[l * n : (l + 1) * n]
            if c == steps_w - 1:  # the row is done: trim it into the canvas
                kept = gh * P if r == steps_h - 1 else (gh - 1) * P
                y0 = r * (gh - 1) * P
                _paint_row(canvas[:, y0 : y0 + kept], torch.stack(rows.pop(r)), (gw - 1) * P,
                           as_uint8)
                if progress:
                    print(f"  row {r + 1}/{steps_h} ({steps_w} sub-images, lane {l})", flush=True)
        if sch["accept_cur"][t].any() or sch["accept_pend"][t].any():
            # each lane's finished row buffer to the next lane, cyclically
            cur, pend = per_elem(table["accept_cur"][t]), per_elem(table["accept_pend"][t])
            for name, s in halo.items():
                sent = finalize_row(s._replace(row_write=s.row_write.clone()),
                                    gen.outer_padding).row_write
                recv = torch.roll(sent, n, dims=0)
                s.row_read.copy_(torch.where(cur, recv, s.row_read))
                pending[name].copy_(torch.where(pend, recv, pending[name]))
    out = canvas[:, :output_resolution_height, :output_resolution_width]
    return out.cpu().numpy()
