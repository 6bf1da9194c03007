"""Wavefront canvas generation: one canvas, several ranks, explicit halo
exchange.

Port of ``infinite_texture_gans_tpu/parallel/wavefront.py``. Sub-image
(r, c) of the raster needs the halo cache written by (r, c-1) and, two
steps ahead of it, by row r-1, so canvas rows can run side by side on a
staggered ("wavefront") schedule. Rank d owns canvas rows d, d+N, ... of
the N ranks (N = the data axis's world size); row r starts at step

    s(r) = 2*(r mod N) + (r div N) * max(2N, steps_w)

(:func:`schedule_constants`): lag 2 behind row r-1, except that a rank
runs its own rows one after another. A rank steps its row through
``sampling/infinite.py: RasterRow`` one sub-image at a time, on the
raster's own buffers and slices, so every sub-image is the raster's bit
for bit. After a step, a rank sends its row's bottom-edge halo buffers
(border cells finalised) to rank (d+1) mod N, cyclically, by P2P
``isend``/``irecv`` of one flat buffer; the receiver takes them, by the
schedule (:func:`lane_schedule`), into the row it is on (``row_read``,
whose read window the lag makes final) or into a ``pending`` buffer that
its next row starts from. Only the exchanges that a row reads are made:
every one into a live row, and the last before a row starts into
``pending``. At N = 1 the schedule is the raster's and the "exchange" is a
rank's own buffer.

:func:`generate_canvas_wavefront` gathers the trimmed rows (the raster's
``_paint_row``) on rank 0; :func:`generate_canvas_wavefront_streamed`
runs the canvas in slabs of ``slab_rows`` canvas rows, each slab's last
halo buffers seeding the next slab's first row, and rank 0 writes each
slab's rows into a PNG through ``sampling/stream.py: StreamingPNGWriter``
as ``generate_canvas_streamed`` groups them, so memory is O(slab) on every
rank. Both run eagerly; every rank draws the same latents. Without a data
axis (outside :func:`parallel.mesh.run_ranks`) both run as one rank.
"""

from __future__ import annotations

from math import ceil
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.padding import finalize_row, init_halo_state
from infinite_texture_gans_torch.parallel.mesh import DataAxis, current_axis
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import (
    RasterRow,
    _paint_row,
    canvas_geometry,
    canvas_latents,
)
from infinite_texture_gans_torch.sampling.stream import StreamingPNGWriter

# a rank's sub-image buffer bound (the reference's), checked before any latent is drawn
BUFFER_LIMIT = 6 * 1024**3


def schedule_constants(steps_w: int, steps_h: int, n_dev: int):
    """(row_stride, total_T, n_rows_max) of the v3 cyclic wavefront schedule:
    row r starts at step ``2 * (r % n_dev) + (r // n_dev) * row_stride``,
    and rank (or lane) r % n_dev runs it."""
    row_stride = max(2 * n_dev, steps_w)
    last = steps_h - 1
    total_T = 2 * (last % n_dev) + (last // n_dev) * row_stride + steps_w
    return row_stride, total_T, ceil(steps_h / n_dev)


def lane_schedule(steps_w: int, steps_h: int, lanes: int) -> Dict[str, np.ndarray]:
    """The whole schedule as (total_T, lanes) arrays: each lane's row ``r``
    and column ``c`` (clipped to the canvas: ``rr``, ``cc``), ``active``
    (a real sub-image), ``start`` (its row's first column), and
    ``accept_cur`` / ``accept_pend``: after the step, the lane takes the
    upstream lane's finished row buffer into its current row's
    ``row_read`` / into ``pending`` for its next row. A lane is a rank here
    and a slice of one batch in ``sampling/diag.py``."""
    stride, total_T, n_rows = schedule_constants(steps_w, steps_h, lanes)
    t = np.arange(total_T)[:, None]
    d = np.arange(lanes)[None, :]

    def at(lane):
        u = t - 2 * lane
        i = np.floor_divide(u, stride)
        c = u - i * stride
        r = i * lanes + lane
        return i, c, r, (i >= 0) & (c < steps_w) & (r < steps_h)

    i, c, r, active = at(d)
    _, _, r_s, sender_active = at((d - 1) % lanes)  # the upstream lane
    return {
        "r": r, "c": c, "active": active, "start": active & (c == 0),
        "rr": np.minimum(np.clip(i, 0, n_rows - 1) * lanes + d, steps_h - 1),
        "cc": np.clip(c, 0, steps_w - 1),
        "accept_cur": sender_active & active & (r_s == r - 1),
        "accept_pend": sender_active & (r_s == (i + 1) * lanes + d - 1),
    }


def _exchanges(sch: Dict[str, np.ndarray]) -> np.ndarray:
    """(total_T, lanes): the steps after which a lane takes its upstream
    lane's buffer: every ``accept_cur`` (its live row reads it next), and
    of the ``accept_pend`` only the last before the lane's next row starts
    (an earlier one is overwritten unread)."""
    need = sch["accept_cur"].copy()
    for lane in range(need.shape[1]):
        later = False  # a later accept_pend before the next start
        for t in range(need.shape[0] - 1, -1, -1):
            if sch["accept_pend"][t, lane]:
                need[t, lane] |= not later
                later = True
            if sch["start"][t, lane]:
                later = False
    return need


def _check_geometry(gen: ResidualPatchGenerator, steps_w: int, steps_h: int, n_dev: int,
                    num_images: int) -> None:
    if gen.padding_mode != "local":
        raise ValueError("the wavefront engine needs a local-padding generator")
    if gen.num_patches_w < 3:
        raise ValueError(f"wavefront requires num_patches_w >= 3 (got {gen.num_patches_w}); the "
                         "lag-2 schedule's halo read window would race the row buffer")
    P, gh, gw = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w
    n_rows_max = schedule_constants(steps_w, steps_h, n_dev)[2]
    itemsize = torch.empty((), dtype=gen.dtype).element_size()
    subs_bytes = n_rows_max * steps_w * num_images * (gh * P) * (gw * P) * gen.img_ch * itemsize
    if subs_bytes > BUFFER_LIMIT:
        raise ValueError(
            f"wavefront per-device sub-image buffer would be {subs_bytes / 1024**3:.1f} GiB "
            f"(> {BUFFER_LIMIT / 1024**3:.0f} GiB): generate per horizontal slab "
            "(generate_canvas_wavefront_streamed), or use sampling.stream (O(band) memory) for "
            "canvases this large")


def _zero_pending(gen: ResidualPatchGenerator, num_images: int, tot_w: int, device):
    """Zero first-row upstream buffers (``row_read``-shaped, one per site)."""
    halo = init_halo_state(gen.site_specs(), num_images, gen.num_patches_h, gen.num_patches_w,
                           tot_w, dtype=gen.dtype, device=device)
    return {name: s.row_read for name, s in halo.items()}


def _rank_of(axis: Optional[DataAxis]):
    return (0, 1) if axis is None else (axis.rank, axis.size)


def _wavefront_rows(gen, axis, z_full, maps_full, r0: int, sh: int, steps_h: int, steps_w: int,
                    pending, as_uint8: bool):
    """Canvas rows r0 .. r0+sh-1 on the wavefront schedule, this rank's
    share: ({row: its trimmed band (N, kept_rows, width, C) on the device},
    the finalised halo buffers of row r0+sh-1 on the rank that ran it, else
    None). ``pending``: the buffers row r0 starts from (on the rank that
    runs it: zeros for a canvas's first row, the previous slab's last
    row's buffers for a later slab)."""
    rank, size = _rank_of(axis)
    P, gh, gw = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w
    n_img = z_full.shape[0]
    sch = lane_schedule(steps_w, sh, size)
    need = _exchanges(sch)
    up, down = (rank - 1) % size, (rank + 1) % size
    row = RasterRow(gen, n_img, steps_w)
    halo = dict(row.halo)
    pending = {k: v.clone() for k, v in pending.items()}
    names = list(halo)
    width = (steps_w * (gw - 1) + 1) * P
    done, subs, boundary = {}, [], None

    def finished():  # the row buffers as sent: border cells filled
        return {n: finalize_row(halo[n]._replace(row_write=halo[n].row_write.clone()),
                                gen.outer_padding).row_write for n in names}

    for t in range(sch["r"].shape[0]):
        r, c = int(sch["r"][t, rank]), int(sch["c"][t, rank])
        if sch["start"][t, rank]:  # the row's strip, its upstream buffers, a fresh write buffer
            row.load(*latents.row_strips(z_full, maps_full, r0 + r, gen.base_res, gh))
            for name in names:
                halo[name].row_read.copy_(pending[name])
                halo[name].row_write.zero_()
        if sch["active"][t, rank]:
            out, halo = row.sub_image(c, r0 + r == 0, halo)
            subs.append(out)
            if c == steps_w - 1:  # the row is done: trim it, as the raster trims
                kept = gh * P if r0 + r == steps_h - 1 else (gh - 1) * P
                band = torch.empty((n_img, kept, width, out.shape[-1]),
                                   dtype=torch.uint8 if as_uint8 else out.dtype,
                                   device=out.device)
                _paint_row(band, torch.stack(subs), (gw - 1) * P, as_uint8)
                done[r0 + r], subs = band, []
                if r == sh - 1:
                    boundary = finished()
        send, recv = need[t, down], need[t, rank]
        if not (send or recv):
            continue
        sent = torch.cat([v.reshape(-1) for v in finished().values()]) if send else None
        if size == 1:
            got = sent
        else:
            got = torch.empty(sum(pending[n].numel() for n in names), dtype=gen.dtype,
                              device=z_full.device) if recv else None
            ops = ([dist.P2POp(dist.isend, sent, down, axis.group)] if send else []) + \
                  ([dist.P2POp(dist.irecv, got, up, axis.group)] if recv else [])
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv:  # into the live row, or pending for the next one
            live = sch["accept_cur"][t, rank]
            for n, part in zip(names, got.split([pending[n].numel() for n in names])):
                (halo[n].row_read if live else pending[n]).copy_(part.view_as(pending[n]))
    return done, boundary


def _gather_rows(axis, done: dict, rows: range, r0: int, shape_of, dtype: torch.dtype):
    """Rank 0: every row of ``rows`` by its band ({row: band}, each of
    ``shape_of(row)`` and ``dtype``), received from the rank that ran it
    (``(row - r0) % size``); the other ranks send theirs and get {}."""
    rank, size = _rank_of(axis)
    if size == 1:
        return done
    if rank:
        reqs = [dist.isend(done[r].contiguous(), 0, axis.group) for r in rows
                if (r - r0) % size == rank]
        for req in reqs:
            req.wait()
        return {}
    out = {}
    for r in rows:
        if (r - r0) % size == 0:
            out[r] = done[r]
        else:
            out[r] = torch.empty(shape_of(r), dtype=dtype, device=axis.device)
            dist.recv(out[r], (r - r0) % size, axis.group)
    return out


@torch.no_grad()
def generate_canvas_wavefront(
    gen: ResidualPatchGenerator,
    generator: Optional[torch.Generator] = None,
    output_resolution_height: int = 384,
    output_resolution_width: int = 384,
    axis: Optional[DataAxis] = None,
    num_images: int = 1,
    z_full: Optional[torch.Tensor] = None,
    maps_full: Optional[List[torch.Tensor]] = None,
    wire: str = "f32",
    progress: bool = False,
) -> Optional[np.ndarray]:
    """The canvas of ``sampling.infinite.generate_canvas`` (the same
    arguments, latents, ``wire`` and values, bit for bit), its canvas rows
    run across the ranks of ``axis`` (the calling rank's by default; one
    rank without one) on the wavefront schedule. Every rank passes the same
    latents (or draws them from generators in the same state); rank 0
    returns the host array (N, out_h, out_w, C), the other ranks None.

    Raises ValueError for fewer than 3 patch columns (the lag-2 schedule
    needs the upstream row two columns ahead of the halo it reads) and for
    a canvas whose per-rank sub-image buffer would pass 6 GiB, before any
    latent is drawn."""
    if wire not in ("f32", "u8"):
        raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r}")
    axis = axis or current_axis()
    rank, size = _rank_of(axis)
    steps_h, steps_w, tot_h, tot_w = canvas_geometry(
        output_resolution_height, output_resolution_width, gen.patch_resolution,
        gen.num_patches_h, gen.num_patches_w)
    _check_geometry(gen, steps_w, steps_h, size, num_images)
    (steps_h, steps_w, tot_h, tot_w), z_full, maps_full = canvas_latents(
        gen, generator, output_resolution_height, output_resolution_width, num_images, z_full,
        maps_full)
    P, gh = gen.patch_resolution, gen.num_patches_h
    as_uint8 = wire == "u8"
    done, _ = _wavefront_rows(gen, axis, z_full, maps_full, 0, steps_h, steps_h, steps_w,
                              _zero_pending(gen, z_full.shape[0], tot_w, z_full.device), as_uint8)
    width = tot_w * P

    def shape_of(r):
        kept = gh * P if r == steps_h - 1 else (gh - 1) * P
        return (z_full.shape[0], kept, width, gen.img_ch)

    rows = _gather_rows(axis, done, range(steps_h), 0, shape_of,
                        torch.uint8 if as_uint8 else gen.dtype)
    if rank:
        return None
    canvas = torch.zeros((z_full.shape[0], tot_h * P, width, gen.img_ch),
                         dtype=torch.uint8 if as_uint8 else torch.float32, device=z_full.device)
    for r in range(steps_h):
        y0 = r * (gh - 1) * P
        canvas[:, y0 : y0 + rows[r].shape[1]] = rows[r].to(canvas.dtype)
        if progress:
            print(f"  row {r + 1}/{steps_h} ({steps_w} sub-images, rank {r % size})", flush=True)
    return canvas[:, :output_resolution_height, :output_resolution_width].cpu().numpy()


@torch.no_grad()
def generate_canvas_wavefront_streamed(
    gen: ResidualPatchGenerator,
    generator: Optional[torch.Generator],
    output_resolution_height: int,
    output_resolution_width: int,
    path: str,
    axis: Optional[DataAxis] = None,
    slab_rows: int = 8,
    z_full: Optional[torch.Tensor] = None,
    maps_full: Optional[List[torch.Tensor]] = None,
    progress: bool = False,
) -> Optional[str]:
    """Stream one canvas into the PNG at ``path`` with the wavefront engine:
    ``slab_rows`` canvas rows at a time across the ranks of ``axis`` (the
    calling rank's by default), each slab's last row's halo buffers handed
    to the next slab's first row (rank 0), and rank 0 writing the slab's
    rows as ``sampling.stream.generate_canvas_streamed`` writes its groups
    of ``row_group`` = ``slab_rows`` rows (the body rows of a slab in one
    call, the canvas's last row in one of its own): the same pixels, and
    with ``slab_rows`` equal to that ``row_group`` the same file, byte for
    byte. Memory is O(slab) on every rank, so any height streams. Returns
    ``path`` on rank 0, None on the others."""
    if slab_rows < 1:
        raise ValueError(f"slab_rows must be at least 1, got {slab_rows}")
    axis = axis or current_axis()
    rank, size = _rank_of(axis)
    steps_h, steps_w, _, tot_w = canvas_geometry(
        output_resolution_height, output_resolution_width, gen.patch_resolution,
        gen.num_patches_h, gen.num_patches_w)
    _check_geometry(gen, steps_w, min(slab_rows, steps_h), size, 1)
    (steps_h, steps_w, _, tot_w), z_full, maps_full = canvas_latents(
        gen, generator, output_resolution_height, output_resolution_width, 1, z_full, maps_full)
    P, gh = gen.patch_resolution, gen.num_patches_h
    width = tot_w * P
    writer = None
    if rank == 0:
        writer = StreamingPNGWriter(path, output_resolution_height, output_resolution_width,
                                    gen.img_ch)
    boundary = _zero_pending(gen, 1, tot_w, z_full.device)
    try:
        for r0 in range(0, steps_h, slab_rows):
            sh = min(slab_rows, steps_h - r0)
            done, last = _wavefront_rows(gen, axis, z_full, maps_full, r0, sh, steps_h, steps_w,
                                         boundary, as_uint8=True)
            d_last = (sh - 1) % size
            if r0 + sh < steps_h:  # the next slab's first row runs on rank 0
                if size == 1:
                    boundary = last
                elif rank == d_last and d_last != 0:
                    flat = torch.cat([v.reshape(-1) for v in last.values()])
                    dist.send(flat, 0, axis.group)
                elif rank == 0:
                    if d_last == 0:
                        boundary = last
                    else:
                        flat = torch.empty(sum(v.numel() for v in boundary.values()),
                                           dtype=gen.dtype, device=z_full.device)
                        dist.recv(flat, d_last, axis.group)
                        boundary = {n: part.view_as(boundary[n]) for n, part in
                                    zip(boundary, flat.split([v.numel()
                                                              for v in boundary.values()]))}

            def shape_of(r):
                kept = gh * P if r == steps_h - 1 else (gh - 1) * P
                return (1, kept, width, gen.img_ch)

            rows = _gather_rows(axis, done, range(r0, r0 + sh), r0, shape_of, torch.uint8)
            if writer is None:
                continue
            body = [rows[r][0] for r in range(r0, r0 + sh) if r < steps_h - 1]
            if body:
                writer.write_rows(torch.cat(body).cpu().numpy())
            if r0 + sh == steps_h:
                writer.write_rows(rows[steps_h - 1][0].cpu().numpy())
            if progress:
                print(f"  rows {r0 + 1}-{r0 + sh}/{steps_h} streamed", flush=True)
        if writer is not None:
            writer.close()
    except BaseException:
        if writer is not None:
            writer.abort()
        raise
    return path if rank == 0 else None
