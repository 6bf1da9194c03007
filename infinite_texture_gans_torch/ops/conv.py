"""Convolution primitive on NHWC tensors (eval forward).

Port of the forward of ``infinite_texture_gans_tpu/ops/conv.py: Conv``. The
reference stores HWIO kernels; here the weight is a PyTorch OIHW parameter
(``weights.from_jax_variables`` transposes), and the NHWC activation is
viewed as channels-last NCHW, so ``F.conv2d`` reads it without a copy.
Blocks 1-3 and the start conv run through here, as the reference leaves
them to XLA. Spectral norm and the orthogonal init wait for the training
slice: an eval generator is rebuilt with SN off and loads its weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """Stride-1 NHWC conv with bias; ``padding`` is a symmetric zero pad, as
    in the reference."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(
            torch.zeros(features, in_features, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, Cin) -> (N, H', W', Cout) in x's dtype."""
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, self.padding).permute(0, 2, 3, 1)


def conv3x3(in_features: int, features: int, padding: int = 1) -> Conv:
    return Conv(in_features, features, 3, padding)


def conv1x1(in_features: int, features: int) -> Conv:
    return Conv(in_features, features, 1, 0)
