"""Seam metrics (numpy copy of ``infinite_texture_gans_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np


def seam_mse(img: np.ndarray, patch_res: int, width: int = 2) -> float:
    """Mean squared discontinuity across patch boundaries.

    For every interior patch boundary, compares the ``width``-pixel bands on
    either side (line k on one side paired with line k on the other, counted
    outward from the seam); returns the mean over all vertical and
    horizontal boundaries. img: (N, H, W, C) in [-1, 1]. Accumulates in
    float64 whatever the input dtype.
    """
    img = np.asarray(img, dtype=np.float64)
    n, h, w, c = img.shape
    width = max(1, int(width))
    diffs = []
    for x in range(patch_res, w, patch_res):
        wb = min(width, x, w - x)
        a = img[:, :, x - wb : x, :][:, :, ::-1, :]
        b = img[:, :, x : x + wb, :]
        diffs.append(np.mean((a - b) ** 2))
    for y in range(patch_res, h, patch_res):
        wb = min(width, y, h - y)
        a = img[:, y - wb : y, :, :][:, ::-1, :, :]
        b = img[:, y : y + wb, :, :]
        diffs.append(np.mean((a - b) ** 2))
    return float(np.mean(diffs)) if diffs else 0.0


def adjacent_mse_baseline(img: np.ndarray) -> float:
    """MSE between all adjacent pixel lines: the natural image-gradient level
    that seam_mse is compared with (a seam shows as seam_mse >> baseline)."""
    img = np.asarray(img, dtype=np.float64)
    dx = np.mean((img[:, :, 1:, :] - img[:, :, :-1, :]) ** 2)
    dy = np.mean((img[:, 1:, :, :] - img[:, :-1, :, :]) ** 2)
    return float((dx + dy) / 2)
