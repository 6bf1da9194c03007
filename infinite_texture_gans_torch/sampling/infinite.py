"""Infinite-canvas generation engine (halo-cache raster scan).

Port of ``infinite_texture_gans_tpu/sampling/infinite.py``. The canvas is
generated sub-image by sub-image in raster order; each local-padding conv
site carries its halo cache (``ops/padding.py``) from step to step, so the
result equals one pass of the generator over the whole canvas
(:func:`generate_one_pass`, the correctness definition). The reference's
``lax.scan`` over rows and columns becomes a Python loop over a dict of
``SiteState`` tensors. Each group of canvas rows is overlap-trimmed and
painted into a canvas on the device (re-generated right patch-columns and
bottom patch-rows are dropped, the reference's crop protocol), and the
finished canvas crosses to the host in one copy. An SSM generator's maps
are windowed like z, one window per layer. :func:`raster_bands` is the scan
itself; ``sampling/stream.py`` streams its bands into a PNG instead.
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional

import numpy as np
import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.padding import (
    GridPos,
    finalize_row,
    init_halo_state,
    rotate_rows,
)
from infinite_texture_gans_torch.sampling import latents


def canvas_geometry(out_h: int, out_w: int, patch_res: int, gh: int, gw: int):
    """Steps and total patch counts for a target resolution."""
    steps_h = max(1, ceil((out_h / patch_res - 1) / (gh - 1)))
    steps_w = max(1, ceil((out_w / patch_res - 1) / (gw - 1)))
    total_h = steps_h * (gh - 1) + 1
    total_w = steps_w * (gw - 1) + 1
    return steps_h, steps_w, total_h, total_w


def dispatch_groups(steps_h: int, gh: int, P: int, row_group: int):
    """Row-group schedule: (r0, n_rows, kept_rows) triples. Every canvas row
    but the last keeps its top (gh-1)*P rows (its bottom patch-row is
    re-generated by the next row); the last row keeps all gh*P and forms a
    group of its own."""
    body = steps_h - 1
    groups = [
        (g0, min(row_group, body - g0), (gh - 1) * P)
        for g0 in range(0, body, max(1, row_group))
    ]
    groups.append((steps_h - 1, 1, gh * P))
    return groups


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8 with the save mapping (x*0.5+0.5)*255 + 0.5,
    clipped and truncated, in float32 (bf16 would break byte identity)."""
    x = x.float()
    return torch.clamp((x * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).to(torch.uint8)


def _trim_rows(subs_g: torch.Tensor, kept_rows: int, kept_cols: int, as_uint8: bool = False):
    """Overlap trimming of a group of sub-images.
    subs_g (n_rows, steps_w, N, gh*P, gw*P, C) ->
    main (n_rows, steps_w, N, kept_rows, kept_cols, C) and the last column's
    right part tail (n_rows, N, kept_rows, gw*P - kept_cols, C)."""
    main = subs_g[:, :, :, :kept_rows, :kept_cols]
    tail = subs_g[:, -1, :, :kept_rows, kept_cols:]
    if as_uint8:
        main, tail = _to_uint8(main), _to_uint8(tail)
    return main, tail


def _assemble_band(subs_g: torch.Tensor, kept_rows: int, kept_cols: int, as_uint8: bool):
    """Trim one group of canvas rows and lay it out as a contiguous band
    (N, n_rows * kept_rows, canvas_w, C)."""
    main, tail = _trim_rows(subs_g, kept_rows, kept_cols, as_uint8)
    n, steps_w, N, kr, kc, C = main.shape
    band_main = main.permute(2, 0, 3, 1, 4, 5).reshape(N, n * kr, steps_w * kc, C)
    band_tail = tail.permute(1, 0, 2, 3, 4).reshape(N, n * kr, -1, C)
    return torch.cat([band_main, band_tail], dim=2)


def canvas_latents(gen: ResidualPatchGenerator, generator: Optional[torch.Generator],
                   out_h: int, out_w: int, num_images: int = 1,
                   z_full: Optional[torch.Tensor] = None,
                   maps_full: Optional[List[torch.Tensor]] = None):
    """The geometry of an (out_h, out_w) canvas and its latents on the
    generator's device: (steps_h, steps_w, tot_h, tot_w), z_full and, for an
    SSM generator, maps_full. What is not passed is drawn with
    ``generator`` (on the generator's device, or None for the global one),
    z first."""
    device = next(gen.parameters()).device
    base = gen.base_res
    geometry = canvas_geometry(out_h, out_w, gen.patch_resolution, gen.num_patches_h,
                               gen.num_patches_w)
    _, _, tot_h, tot_w = geometry
    if z_full is None:
        z_full = latents.build_z_full(generator, num_images, gen.z_dim, base, tot_h, tot_w,
                                      device=device)
    z_full = z_full.to(device)
    if gen.type_norm == "SSM":
        if maps_full is None:
            maps_full = latents.build_maps_full(generator, num_images, gen.map_dim, gen.n_layers_G,
                                                base, tot_h, tot_w, device=device)
        maps_full = [m.to(device) for m in maps_full]
    return geometry, z_full, maps_full


def raster_bands(gen: ResidualPatchGenerator, z_full: torch.Tensor,
                 maps_full: Optional[List[torch.Tensor]], steps_h: int, steps_w: int,
                 row_group: int, as_uint8: bool):
    """The raster scan, one group of canvas rows at a time (``dispatch_groups``):
    yields (r0, n, band): canvas rows r0 .. r0+n-1 of sub-images, laid out
    as band (N, rows, tot_w*P, C) on the device, their kept pixel rows
    (uint8 with ``as_uint8``) from canvas pixel row ``r0 * (gh-1) * P`` on. The halo cache lives from the first group to
    the last."""
    P = gen.patch_resolution
    gh, gw, base = gen.num_patches_h, gen.num_patches_w, gen.base_res
    tot_w = steps_w * (gw - 1) + 1
    halo = init_halo_state(gen.site_specs(), z_full.shape[0], gh, gw, tot_w, dtype=gen.dtype,
                           device=z_full.device)
    for r0, n, kept_rows in dispatch_groups(steps_h, gh, P, row_group):
        rows = []
        for r in range(r0, r0 + n):
            strip, map_strips = latents.row_strips(z_full, maps_full, r, base, gh)
            subs = []
            for c in range(steps_w):
                c0 = c * (gw - 1) * base
                z_sub = strip[:, :, c0 : c0 + gw * base + latents.Z_PAD]
                maps_sub = None
                if map_strips is not None:
                    maps_sub = [m[:, :, c * (gw - 1) * (2**i) * base :
                                  c * (gw - 1) * (2**i) * base + gw * (2**i) * base + latents.MAP_PAD]
                                for i, m in enumerate(map_strips)]
                out, halo = gen(z_sub, maps_sub, halo=halo, pos=GridPos(c, r == 0, c == 0))
                subs.append(out)
            halo = {
                name: rotate_rows(finalize_row(s, gen.outer_padding))
                for name, s in halo.items()
            }
            rows.append(torch.stack(subs))
        yield r0, n, _assemble_band(torch.stack(rows), kept_rows, (gw - 1) * P, as_uint8)


@torch.no_grad()
def generate_canvas(
    gen: ResidualPatchGenerator,
    generator: Optional[torch.Generator] = None,
    output_resolution_height: int = 384,
    output_resolution_width: int = 384,
    num_images: int = 1,
    z_full: Optional[torch.Tensor] = None,
    maps_full: Optional[List[torch.Tensor]] = None,
    progress: bool = False,
    row_group: Optional[int] = None,
    wire: str = "f32",
) -> np.ndarray:
    """Raster-scan patch-by-patch generation of an (out_h, out_w) canvas on
    the generator's device.

    Returns a host array (N, out_h, out_w, img_ch): float32 in [-1, 1] for
    ``wire='f32'``, uint8 for ``wire='u8'`` (quantised on the device).
    ``z_full`` (and for an SSM generator ``maps_full``, one map per layer)
    may be passed (e.g. to compare with the one-pass oracle); otherwise they
    are drawn with ``generator`` (a torch.Generator on the generator's
    device, or None for the global one), z first. ``row_group``: canvas
    rows painted per band (None: all body rows in one band); it bounds how
    many sub-images are held on the device at once.
    """
    if wire not in ("f32", "u8"):
        raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r}")
    (steps_h, steps_w, tot_h, tot_w), z_full, maps_full = canvas_latents(
        gen, generator, output_resolution_height, output_resolution_width, num_images, z_full,
        maps_full)
    P, gh = gen.patch_resolution, gen.num_patches_h
    as_uint8 = wire == "u8"
    canvas = torch.zeros(
        (z_full.shape[0], tot_h * P, tot_w * P, gen.img_ch),
        dtype=torch.uint8 if as_uint8 else torch.float32,
        device=z_full.device,
    )
    row_stride = (gh - 1) * P
    for r0, n, band in raster_bands(gen, z_full, maps_full, steps_h, steps_w,
                                    row_group or steps_h, as_uint8):
        canvas[:, r0 * row_stride : r0 * row_stride + band.shape[1]] = band.to(canvas.dtype)
        if progress:
            print(f"  rows {r0 + 1}-{r0 + n}/{steps_h} ({steps_w} sub-images each)", flush=True)

    out = canvas[:, :output_resolution_height, :output_resolution_width]
    return out.cpu().numpy()


@torch.no_grad()
def generate_one_pass(
    gen: ResidualPatchGenerator,
    z_full: torch.Tensor,
    total_patches_h: int = 3,
    total_patches_w: int = 3,
    maps_full: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """One-pass oracle: the generator run once over the whole canvas grid,
    what the patch-by-patch engine must reproduce (``maps_full``: an SSM
    generator's full-canvas maps). Returns (N, H, W, C) on the generator's
    device, in the generator's dtype."""
    device = next(gen.parameters()).device
    maps = None if maps_full is None else [m.to(device) for m in maps_full]
    out, _ = gen(z_full.to(device), maps, grid=(total_patches_h, total_patches_w))
    return out
