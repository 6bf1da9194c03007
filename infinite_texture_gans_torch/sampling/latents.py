"""Full-canvas latent and its per-step windows (NHWC).

Port of the z part of ``infinite_texture_gans_tpu/sampling/latents.py``.
The full-canvas latent is materialised once; sub-image inputs are
overlapping views of it, so re-generated boundary patches see identical z
across generation steps. The z pad is 2 (one valid 3x3 conv consumes it).
Latents are drawn with an explicit ``torch.Generator``; its numbers differ
from ``jax.random``'s for the same seed, so tests pass ``z_full`` in.
"""

from __future__ import annotations

from typing import Optional

import torch

Z_PAD = 2


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


def slice_sub_z(z_full: torch.Tensor, r: int, c: int, base_res: int, gh: int, gw: int):
    """Overlapping sub-image latent window for canvas step (r, c): offset
    (r*(gh-1)*base, c*(gw-1)*base), size (gh*base+2, gw*base+2)."""
    r0 = r * (gh - 1) * base_res
    c0 = c * (gw - 1) * base_res
    return z_full[:, r0 : r0 + gh * base_res + Z_PAD, c0 : c0 + gw * base_res + Z_PAD, :]


def row_strips(z_full: torch.Tensor, r: int, base_res: int, gh: int) -> torch.Tensor:
    """Full-width latent strip for canvas row ``r`` (stride (gh-1)*base,
    height gh*base + 2)."""
    r0 = r * (gh - 1) * base_res
    return z_full[:, r0 : r0 + gh * base_res + Z_PAD]
