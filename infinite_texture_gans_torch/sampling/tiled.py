"""Zeros-padding sampling and tiled inference.

Port of ``infinite_texture_gans_tpu/sampling/tiled.py``: ``sample_from_gen``
(:20), one pass of a ``padding_mode='zeros'`` generator over a latent of any
size, and ``tile_process`` (:54), the tiling that runs the generator on
overlapping latent tiles and stitches their outputs: the seams it leaves
are the ones local padding exists to remove, kept for comparison. Both run
as the generator is built; a zeros generator runs NHWC throughout and
launches none of the port's kernels.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.sampling.latents import build_train_maps, build_train_z


@torch.no_grad()
def sample_from_gen(gen: ResidualPatchGenerator, generator: Optional[torch.Generator] = None,
                    num_images: int = 1, base_res: Optional[int] = None, tiles: bool = False,
                    z: Optional[torch.Tensor] = None,
                    maps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Zeros-padding sampling: one latent (N, base, base, z_dim) through
    ``gen`` (eval mode), or through :func:`tile_process` with ``tiles``
    (tile 32, pad 16, scale 2^(n_layers_G-1)). ``z`` and ``maps`` may be
    passed in; otherwise they are drawn from ``generator`` on ``gen``'s
    device. Returns the float32 image (N, base*S, base*S, img_ch) in
    [-1, 1] on that device."""
    if gen.padding_mode != "zeros":
        raise ValueError("sample_from_gen samples a padding_mode='zeros' generator; a local "
                         "one takes the raster engine (sampling/infinite.py)")
    if z is None:  # the zeros-mode draws: one patch of base x base latents per image
        dev = next(gen.parameters()).device
        base = base_res if base_res is not None else gen.base_res
        z = build_train_z(generator, num_images, gen.z_dim, base, 1, 1, device=dev,
                          padding_mode="zeros")
        if gen.type_norm == "SSM":
            maps = build_train_maps(generator, num_images, gen.map_dim, gen.n_layers_G, base,
                                    1, 1, device=dev, padding_mode="zeros")
    if tiles:
        return tile_process(gen, z, maps, scale=2 ** (gen.n_layers_G - 1), tile_size=32,
                            tile_pad=16)
    return gen(z, maps)[0].float()


@torch.no_grad()
def tile_process(gen: ResidualPatchGenerator, z: torch.Tensor,
                 maps: Optional[List[torch.Tensor]] = None, scale: int = 4,
                 tile_size: int = 32, tile_pad: int = 8) -> torch.Tensor:
    """Crop the latent ``z`` (N, H, W, z_dim) into tiles of ``tile_size``
    with ``tile_pad`` of context on each side, run ``gen`` per tile and
    stitch each tile's own region of the output into one float32 tensor
    (N, H*scale, W*scale, img_ch) allocated up front on z's device. An SSM
    generator's ``maps`` are cropped with the tile at each layer's scale
    (the reference's tiling takes none)."""
    n, height, width, _ = z.shape
    out = torch.empty((n, height * scale, width * scale, gen.img_ch), dtype=torch.float32,
                      device=z.device)
    for y in range(math.ceil(height / tile_size)):
        for x in range(math.ceil(width / tile_size)):
            in_x0, in_y0 = x * tile_size, y * tile_size
            in_x1, in_y1 = min(in_x0 + tile_size, width), min(in_y0 + tile_size, height)
            px0, py0 = max(in_x0 - tile_pad, 0), max(in_y0 - tile_pad, 0)
            px1, py1 = min(in_x1 + tile_pad, width), min(in_y1 + tile_pad, height)
            tile_maps = None
            if maps is not None:
                tile_maps = [m[:, py0 * 2**i : py1 * 2**i, px0 * 2**i : px1 * 2**i]
                             for i, m in enumerate(maps)]
            tile, _ = gen(z[:, py0:py1, px0:px1], tile_maps)
            ty0, tx0 = (in_y0 - py0) * scale, (in_x0 - px0) * scale
            th, tw = (in_y1 - in_y0) * scale, (in_x1 - in_x0) * scale
            out[:, in_y0 * scale : in_y0 * scale + th, in_x0 * scale : in_x0 * scale + tw] = \
                tile[:, ty0 : ty0 + th, tx0 : tx0 + tw]
    return out
