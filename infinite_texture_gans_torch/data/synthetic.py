"""A deterministic synthetic texture for tests and benchmarks.

Copy of ``infinite_texture_gans_tpu/data/synthetic.py`` (numpy only): a
multi-scale noise texture of the size of the reference's sample textures
(``datasets/241.jpg`` is 614x440), the same bytes for the same seed.
"""

from __future__ import annotations

import numpy as np


def make_texture(h: int = 440, w: int = 614, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8 multi-scale noise texture."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for scale, amp in [(4, 0.5), (16, 0.3), (64, 0.2)]:
        noise = rng.normal(size=(h // scale + 2, w // scale + 2, 3)).astype(np.float32)
        # bilinear upsample to full size
        ys = np.linspace(0, noise.shape[0] - 1.001, h)
        xs = np.linspace(0, noise.shape[1] - 1.001, w)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        up = (
            noise[y0][:, x0] * (1 - fy) * (1 - fx)
            + noise[y0][:, x0 + 1] * (1 - fy) * fx
            + noise[y0 + 1][:, x0] * fy * (1 - fx)
            + noise[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += amp * up
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def write_texture(path: str, h: int = 440, w: int = 614, seed: int = 0) -> str:
    from PIL import Image

    Image.fromarray(make_texture(h, w, seed)).save(path)
    return path
