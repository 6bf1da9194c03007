"""Single-image training data, sampled on the device.

Port of ``infinite_texture_gans_tpu/data/datasets.py``: ``_load_image``,
``SingleImageDataset`` (:26-103) and the on-device crop sampler
(``DeviceCropSampler`` / ``sample_crops_body``, :254-290, :482-506). The
uint8 texture is held on the device once; every step draws a batch of
random crops there with an explicit ``torch.Generator`` and normalises them
to [-1, 1] (the reference's RandomCrop + ToTensor + Normalize(0.5, 0.5)).
The dataset is virtual: its length is ``--sampling``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _load_image(path: str, ext: str) -> np.ndarray:
    """Decode an image file to (H, W, C) uint8. ``.txt`` holds a
    whitespace-separated grid of values in [0, 1] (binary geological
    images)."""
    if ext == "txt" or path.endswith(".txt"):
        arr = np.loadtxt(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return (arr * 255.0).clip(0, 255).astype(np.uint8)
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


class SingleImageDataset:
    """One texture image; every sample is a random (or center) crop."""

    def __init__(self, path: str, ext: str = "jpg", center_crop: Optional[int] = None,
                 random_crop: Optional[int] = None, sampling: Optional[int] = 8000):
        self.img = _load_image(path, ext)
        self.center_crop = center_crop
        self.random_crop = random_crop
        self.sampling = sampling
        if center_crop:
            self.img = _center_crop(self.img, center_crop)

    def __len__(self) -> int:
        return self.sampling if self.sampling else 10000

    @property
    def img_ch(self) -> int:
        return self.img.shape[-1]


def normalize(batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1]."""
    return batch_u8.to(torch.float32) / 127.5 - 1.0


class DeviceCropSampler:
    """The texture on ``device`` as (H, W, C) uint8; :meth:`sample` draws a
    (batch, crop, crop, C) float32 batch there."""

    def __init__(self, dataset: SingleImageDataset, device):
        self.img = torch.from_numpy(np.array(dataset.img)).to(device)
        self.random_crop = dataset.random_crop

    def sample(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``generator`` lives on the sampler's device."""
        h, w, c = self.img.shape
        if not self.random_crop:
            return normalize(self.img).expand(batch_size, h, w, c).contiguous()
        s = self.random_crop
        dev = self.img.device
        tops = torch.randint(0, h - s + 1, (batch_size,), generator=generator, device=dev)
        lefts = torch.randint(0, w - s + 1, (batch_size,), generator=generator, device=dev)
        ar = torch.arange(s, device=dev)
        rows = (tops[:, None] + ar)[:, :, None]
        cols = (lefts[:, None] + ar)[:, None, :]
        return normalize(self.img[rows, cols])
