"""Patch-grid layout transforms on NHWC tensors.

Port of ``infinite_texture_gans_tpu/ops/grid.py``: the canonical layout is
the merged grid ``(N, gh*H, gw*W, C)``; the patch view ``(N*gh*gw, H, W, C)``
is a reshape/permute used where an op is per patch (self-attention).
"""

from __future__ import annotations

import torch


def patches_to_grid(patches: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(N*gh*gw, H, W, C) row-major patches -> merged (N, gh*H, gw*W, C)."""
    n = patches.shape[0] // (gh * gw)
    h, w, c = patches.shape[1:]
    x = patches.reshape(n, gh, gw, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, gh * h, gw * w, c)


def grid_to_patches(x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Merged (N, gh*H, gw*W, C) -> (N*gh*gw, H, W, C) row-major patches."""
    n, hm, wm, c = x.shape
    h, w = hm // gh, wm // gw
    x = x.reshape(n, gh, h, gw, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * gh * gw, h, w, c)


def merge_patches_into_image(patches: torch.Tensor, num_rows: int = 3,
                             num_cols: int = 3) -> torch.Tensor:
    """The reference's name for :func:`patches_to_grid`."""
    return patches_to_grid(patches, num_rows, num_cols)


def crop_images(img: torch.Tensor, cropping_size_h: int, cropping_size_w: int,
                stride: int) -> torch.Tensor:
    """Sliding-window crops of (N, H, W, C) into (N*P, ch, cw, C), the
    windows row-major within each image and allowed to overlap
    (``stride`` below the size): one strided view of ``img``, copied once by
    the reshape."""
    n, _, _, c = img.shape
    win = img.unfold(1, cropping_size_h, stride).unfold(2, cropping_size_w, stride)
    # (N, rows, cols, C, ch, cw) -> (N, rows, cols, ch, cw, C)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(-1, cropping_size_h, cropping_size_w, c)


def crop_image(img: torch.Tensor, cropping_size_h: int, cropping_size_w: int,
               stride: int) -> torch.Tensor:
    """:func:`crop_images` of one (H, W, C) image: (P, ch, cw, C)."""
    return crop_images(img[None], cropping_size_h, cropping_size_w, stride)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of merged NHWC activations."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, 1, w, 1, c).expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)
