"""Full-canvas latent and SSM maps, and their per-step windows (NHWC).

Port of ``infinite_texture_gans_tpu/sampling/latents.py``. The full-canvas
latent and maps are materialised once; sub-image inputs are overlapping
views of them, so re-generated boundary patches see identical inputs across
generation steps. The z pad is 2 (one valid 3x3 conv consumes it), the map
pad 4 (the SSM embed's two valid convs). Everything is drawn with an
explicit ``torch.Generator`` on an explicit device; its numbers differ from
``jax.random``'s for the same seed, so tests pass ``z_full``/``maps_full``
in.
"""

from __future__ import annotations

from typing import List, Optional

import torch

Z_PAD = 2
MAP_PAD = 4


def build_z_full(
    generator: Optional[torch.Generator],
    num_images: int,
    z_dim: int,
    base_res: int,
    total_patches_h: int,
    total_patches_w: int,
    device="cuda",
) -> torch.Tensor:
    """Standard-normal (N, tot_h*base+2, tot_w*base+2, z_dim) float32 latent.
    ``generator`` must live on ``device``."""
    shape = (
        num_images,
        total_patches_h * base_res + Z_PAD,
        total_patches_w * base_res + Z_PAD,
        z_dim,
    )
    return torch.randn(shape, generator=generator, device=device)


def build_train_z(generator: Optional[torch.Generator], num_images: int, z_dim: int,
                  base_res: int, gh: int, gw: int, device="cuda") -> torch.Tensor:
    """Training latent (N, gh*base+2, gw*base+2, z_dim), standard normal:
    the reference's ``build_train_z``. ``generator`` must live on
    ``device``."""
    return build_z_full(generator, num_images, z_dim, base_res, gh, gw, device=device)


def build_maps_full(generator: Optional[torch.Generator], num_images: int, map_dim: int,
                    n_layers_G: int, base_res: int, total_patches_h: int, total_patches_w: int,
                    device="cuda") -> List[torch.Tensor]:
    """Per-layer full-canvas SSM maps, maps[i] standard normal of shape
    (N, tot_h*r+4, tot_w*r+4, map_dim) with r = 2^i*base, drawn in layer
    order. ``generator`` must live on ``device``."""
    return [
        torch.randn((num_images, total_patches_h * (2**i) * base_res + MAP_PAD,
                     total_patches_w * (2**i) * base_res + MAP_PAD, map_dim),
                    generator=generator, device=device)
        for i in range(n_layers_G)
    ]


def build_train_maps(generator: Optional[torch.Generator], num_images: int, map_dim: int,
                     n_layers_G: int, base_res: int, gh: int, gw: int,
                     device="cuda") -> List[torch.Tensor]:
    """Training-time merged SSM maps, one per layer, 4 px oversized: the
    reference's ``build_train_maps``. ``generator`` must live on
    ``device``."""
    return build_maps_full(generator, num_images, map_dim, n_layers_G, base_res, gh, gw,
                           device=device)


def slice_sub_z(z_full: torch.Tensor, r: int, c: int, base_res: int, gh: int, gw: int):
    """Overlapping sub-image latent window for canvas step (r, c): offset
    (r*(gh-1)*base, c*(gw-1)*base), size (gh*base+2, gw*base+2)."""
    r0 = r * (gh - 1) * base_res
    c0 = c * (gw - 1) * base_res
    return z_full[:, r0 : r0 + gh * base_res + Z_PAD, c0 : c0 + gw * base_res + Z_PAD, :]


def slice_sub_maps(maps_full, r: int, c: int, base_res: int, gh: int, gw: int):
    """Overlapping sub-image map windows for canvas step (r, c), one per
    layer."""
    out = []
    for i, m in enumerate(maps_full):
        res = (2**i) * base_res
        r0, c0 = r * (gh - 1) * res, c * (gw - 1) * res
        out.append(m[:, r0 : r0 + gh * res + MAP_PAD, c0 : c0 + gw * res + MAP_PAD])
    return out


def row_strips(z_full: torch.Tensor, maps_full, r: int, base_res: int, gh: int):
    """Full-width latent and map strips for canvas row ``r`` (stride
    (gh-1)*res, height gh*res + pad). Returns (z strip, list of map strips
    or None)."""
    r0 = r * (gh - 1) * base_res
    z_strip = z_full[:, r0 : r0 + gh * base_res + Z_PAD]
    if maps_full is None:
        return z_strip, None
    maps_strips = []
    for i, m in enumerate(maps_full):
        res = (2**i) * base_res
        maps_strips.append(m[:, r * (gh - 1) * res : r * (gh - 1) * res + gh * res + MAP_PAD])
    return z_strip, maps_strips
