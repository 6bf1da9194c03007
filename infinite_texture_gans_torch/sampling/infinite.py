"""Infinite-canvas generation engine (halo-cache raster scan).

Port of ``infinite_texture_gans_tpu/sampling/infinite.py``. The canvas is
generated sub-image by sub-image in raster order; each local-padding conv
site carries its halo cache (``ops/padding.py``) from step to step, so the
result equals one pass of the generator over the whole canvas
(:func:`generate_one_pass`, the correctness definition). The reference's
``lax.scan`` over a canvas row (``_row_impl``, ``_row_group_scan``)
becomes :class:`RasterRow`: a row's ``steps_w`` sub-image steps on static
buffers (the row's z and map strips, every site's halo cache), which it
finalises and rotates in place. On the card a kind of row (the first,
the rest) runs eagerly the first time it comes up, is captured as a CUDA
graph the second time, cached on the generator, and is one replay from
then on; on the CPU the same row function runs eagerly. Each canvas row is
overlap-trimmed and painted into its band on the device (re-generated right patch-columns and bottom
patch-rows are dropped, the reference's crop protocol), and the finished
canvas crosses to the host in one copy. An SSM generator's maps are
windowed like z, one window per layer. :func:`raster_bands` is the scan
itself; ``sampling/stream.py`` streams its bands into a PNG instead.
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional

import numpy as np
import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.graphs import CountedGraph, on_side_stream
from infinite_texture_gans_torch.ops.padding import GridPos, finalize_row, init_halo_state
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


def _paint_row(dst: torch.Tensor, subs: torch.Tensor, kept_cols: int, as_uint8: bool) -> None:
    """Overlap trimming of one canvas row's sub-images ``subs`` (steps_w, N,
    gh*P, gw*P, C), painted into ``dst`` (N, kept_rows, canvas_w, C), a
    slice of its band: each sub-image's top-left (kept_rows, kept_cols)
    and the last one's right part."""
    steps_w, kept_rows = subs.shape[0], dst.shape[1]
    kept = subs[:, :, :kept_rows]
    if as_uint8:
        kept = _to_uint8(kept)
    dst[:, :, : steps_w * kept_cols].unflatten(2, (steps_w, kept_cols)).copy_(
        kept[:, :, :, :kept_cols].permute(1, 2, 0, 3, 4))
    dst[:, :, steps_w * kept_cols :] = kept[-1, :, :, kept_cols:]


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


class RasterRow:
    """One canvas row of the raster on static buffers: ``z`` and ``maps``
    (the row's latent strip and an SSM generator's map strips, one per
    layer), ``halo`` (every site's cache) and :meth:`run`, the row's
    ``steps_w`` sub-images from them, which writes the finalised, rotated
    cache back into the same tensors and returns the sub-images (steps_w,
    N, gh*P, gw*P, C).

    :meth:`row` loads a strip and runs the row: eagerly, or with
    ``graphed`` (the card) as a replay of the CUDA graph of its kind (the
    first row, the rest). A kind's first row runs eagerly on a side stream
    (the warm-up), its second is captured and replayed, and every later one
    is a replay, so a kind that comes up once (the first row of a canvas,
    every row of a one-row canvas) is never captured. The graphs stay with
    this object, which :meth:`cached` keeps on the generator, so the rows of
    a later canvas of the same width replay them. A replay's sub-images
    live until the next."""

    def __init__(self, gen: ResidualPatchGenerator, num_images: int, steps_w: int):
        dev = next(gen.parameters()).device
        gh, gw, base = gen.num_patches_h, gen.num_patches_w, gen.base_res
        tot_w = steps_w * (gw - 1) + 1
        self.gen, self.steps_w = gen, steps_w
        self.z = torch.empty((num_images, gh * base + latents.Z_PAD,
                              tot_w * base + latents.Z_PAD, gen.z_dim), device=dev)
        self.maps = None
        if gen.type_norm == "SSM":
            self.maps = [torch.empty((num_images, gh * (2**i) * base + latents.MAP_PAD,
                                      tot_w * (2**i) * base + latents.MAP_PAD, gen.map_dim),
                                     device=dev)
                         for i in range(gen.n_layers_G)]
        self.halo = init_halo_state(gen.site_specs(), num_images, gh, gw, tot_w, dtype=gen.dtype,
                                    device=dev)
        self.graphs = {}  # first_row -> (CountedGraph, its sub-images)
        self.warm = set()  # the kinds of row run once, eagerly
        self.weights = self._weights()

    def _weights(self):
        return [t.data_ptr() for t in (*self.gen.parameters(), *self.gen.buffers())]

    @classmethod
    def cached(cls, gen: ResidualPatchGenerator, num_images: int, steps_w: int) -> "RasterRow":
        """The generator's row for (N, steps_w), made anew if its weights
        moved to other storage since its graphs were captured."""
        rows = gen.__dict__.setdefault("raster_rows", {})
        row = rows.get((num_images, steps_w))
        if row is None or row.weights != row._weights():
            row = rows[(num_images, steps_w)] = cls(gen, num_images, steps_w)
        return row

    def start(self) -> None:
        """A new canvas: the row buffers' border cells must start at zero."""
        for site in self.halo.values():
            site.row_write.zero_()

    def load(self, strip: torch.Tensor, map_strips: Optional[List[torch.Tensor]]) -> None:
        self.z.copy_(strip)
        if self.maps is not None:
            for buf, m in zip(self.maps, map_strips):
                buf.copy_(m)

    def _store_halo(self, halo) -> None:
        """The row's final cache into the static one, finalised and rotated:
        ``row_read`` <- the finished row buffer, ``row_write`` <- 0."""
        for name, s in halo.items():
            site = self.halo[name]
            finalize_row(s, self.gen.outer_padding)
            site.v.copy_(s.v)
            site.row_read.copy_(s.row_write)
            site.row_write.zero_()

    def sub_image(self, c: int, first_row: bool, halo):
        """Sub-image ``c`` of the loaded row from the cache ``halo``:
        (its image, the updated cache). The wavefront engine
        (``parallel/wavefront.py``) steps a row through it one sub-image at
        a time."""
        gen, gw, base = self.gen, self.gen.num_patches_w, self.gen.base_res
        c0 = c * (gw - 1) * base
        z_sub = self.z[:, :, c0 : c0 + gw * base + latents.Z_PAD]
        maps_sub = None
        if self.maps is not None:
            maps_sub = [m[:, :, c * (gw - 1) * (2**i) * base :
                          c * (gw - 1) * (2**i) * base + gw * (2**i) * base + latents.MAP_PAD]
                        for i, m in enumerate(self.maps)]
        return gen(z_sub, maps_sub, halo=halo, pos=GridPos(c, first_row, c == 0))

    @torch.no_grad()
    def run(self, first_row: bool) -> torch.Tensor:
        halo = dict(self.halo)
        subs = []
        for c in range(self.steps_w):
            out, halo = self.sub_image(c, first_row, halo)
            subs.append(out)
        self._store_halo(halo)
        return torch.stack(subs)

    def row(self, first_row: bool, strip: torch.Tensor,
            map_strips: Optional[List[torch.Tensor]], graphed: bool) -> torch.Tensor:
        self.load(strip, map_strips)
        if not graphed:
            return self.run(first_row)
        if first_row not in self.graphs:
            with torch.cuda.device(self.z.device):
                if first_row not in self.warm:
                    self.warm.add(first_row)
                    return on_side_stream(lambda: self.run(first_row))
                graph = CountedGraph()
                self.graphs[first_row] = (graph, graph.capture(lambda: self.run(first_row)))
        graph, subs = self.graphs[first_row]
        graph.replay()
        return subs


def raster_bands(gen: ResidualPatchGenerator, z_full: torch.Tensor,
                 maps_full: Optional[List[torch.Tensor]], steps_h: int, steps_w: int,
                 row_group: int, as_uint8: bool, graphs: bool = True):
    """The raster scan, one group of canvas rows at a time (``dispatch_groups``):
    yields (r0, n, band): canvas rows r0 .. r0+n-1 of sub-images, laid out
    as band (N, rows, tot_w*P, C) on the device, their kept pixel rows
    (uint8 with ``as_uint8``) from canvas pixel row ``r0 * (gh-1) * P`` on.
    The halo cache lives from the first group to the last. On the card a
    row whose kind came up before is a CUDA graph replay
    (:class:`RasterRow`) unless ``graphs`` is False, the eager form the
    checks compare with."""
    P, gh, gw = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w
    graphed = graphs and z_full.is_cuda
    n_img = z_full.shape[0]
    rows = RasterRow.cached(gen, n_img, steps_w) if graphed else RasterRow(gen, n_img, steps_w)
    rows.start()
    width = (steps_w * (gw - 1) + 1) * P
    for r0, n, kept_rows in dispatch_groups(steps_h, gh, P, row_group):
        band = None
        for i, r in enumerate(range(r0, r0 + n)):
            strip, map_strips = latents.row_strips(z_full, maps_full, r, gen.base_res, gh)
            subs = rows.row(r == 0, strip, map_strips, graphed)
            if band is None:
                band = torch.empty((n_img, n * kept_rows, width, subs.shape[-1]),
                                   dtype=torch.uint8 if as_uint8 else subs.dtype,
                                   device=subs.device)
            _paint_row(band[:, i * kept_rows : (i + 1) * kept_rows], subs, (gw - 1) * P,
                       as_uint8)
        yield r0, n, band


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
    graphs: bool = True,
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
    many canvas rows are held on the device at once. ``graphs``: on the
    card a row whose kind came up before is a CUDA graph replay; False
    runs every row eagerly (the form the checks compare with).
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
                                    row_group or steps_h, as_uint8, graphs):
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


@torch.no_grad()
def sample_from_gen_patch_by_patch_train(gen: ResidualPatchGenerator,
                                         generator: Optional[torch.Generator] = None,
                                         num_images: int = 8) -> torch.Tensor:
    """Training-time fake sampling: one eval-mode forward of the (gh x gw)
    training grid on ``build_train_z`` (and, for an SSM generator,
    ``build_train_maps``) drawn from ``generator`` in that order, on the
    generator's device (one patch per image for a zeros-padding generator);
    returns the merged fakes (N, gh*P, gw*P, C)."""
    device = next(gen.parameters()).device
    gh, gw, base = gen.num_patches_h, gen.num_patches_w, gen.base_res
    kw = dict(device=device, padding_mode=gen.padding_mode)
    z = latents.build_train_z(generator, num_images, gen.z_dim, base, gh, gw, **kw)
    maps = None
    if gen.type_norm == "SSM":
        maps = latents.build_train_maps(generator, num_images, gen.map_dim, gen.n_layers_G, base,
                                        gh, gw, **kw)
    out, _ = gen(z, maps)
    return out
