"""Generator building blocks (eval forward).

Port of ``infinite_texture_gans_tpu/models/layers.py`` for the eval-mode BN
generator: ``activation_fn``, ``BNFold``, ``ConvLP``, ``Attention``,
``PatchAttention`` and ``ResBlockGenerator`` (BN branch). Submodule and
parameter names follow the reference's flax paths (``conv1.conv.weight``,
``bn1.scale``, ``bn1.mean`` ...), so ``weights.from_jax_variables`` maps a
flax tree onto them leaf by leaf.

Two layouts, as in the reference: merged-grid NHWC for the wide blocks, and
channels-major (N, C, H, W) for the small-channel tail, where the BN fold
and ReLU run inside the conv kernels of ``ops/kernels.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.conv import conv1x1, conv3x3
from infinite_texture_gans_torch.ops.grid import grid_to_patches, patches_to_grid
from infinite_texture_gans_torch.ops.padding import GridPos, SiteState, halo_pad_step, local_pad


def activation_fn(leak: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """LeakyReLU(leak) if leak > 0 else ReLU."""
    if leak > 0:
        return lambda x: F.leaky_relu(x, leak)
    return torch.relu


class BNFold(nn.Module):
    """Eval-mode BatchNorm (epsilon 1e-5) with the reference's variable
    names: parameters ``scale``/``bias``, running statistics ``mean``/``var``
    as buffers. ``forward`` normalises NHWC activations; :meth:`fold` returns
    the per-channel float32 ``(scale, shift)`` that the channels-major conv
    kernels apply themselves."""

    epsilon = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        return inv, self.bias.float() - self.mean.float() * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = (x.float() - self.mean.float()) * mul + self.bias.float()
        return y.to(x.dtype)


class ConvLP(nn.Module):
    """3x3 conv with local padding (reference ``conv2d_lp``, 'local' mode):
    outer edge/zero padding of the merged grid in one pass, the halo cache
    at patch-by-patch inference. ``pre_padded`` (the start conv): the input
    already carries a 1px halo of real values. With
    ``chw_fold=(scale, shift, relu)`` the input is channels-major and the BN
    fold + activation run inside the K1/K2 kernels.
    """

    def __init__(self, in_features: int, features: int,
                 outer_padding: str = "replicate", pre_padded: bool = False):
        super().__init__()
        self.outer_padding = outer_padding
        self.pre_padded = pre_padded
        self.conv = conv3x3(in_features, features, padding=0)

    def forward(self, x: torch.Tensor, halo: Optional[SiteState] = None,
                pos: Optional[GridPos] = None, *, grid: tuple[int, int] = (3, 3),
                chw_fold=None):
        gh, gw = grid
        if chw_fold is not None:
            scale, shift, relu = chw_fold
            w, b = self.conv.weight, self.conv.bias
            if halo is not None:
                return kernels.chw_halo_step(
                    x, w, b, scale, shift, relu, self.outer_padding, halo, pos, gh, gw
                )
            return kernels.conv3x3_chw(x, w, b, scale, shift, relu, self.outer_padding), halo
        if self.pre_padded:
            padded = x
        elif halo is None:
            padded = local_pad(x, 1, self.outer_padding)
        else:
            padded, halo = halo_pad_step(x, halo, pos, gh, gw, self.outer_padding)
        return self.conv(padded), halo


def _max_pool2_nhwc(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Attention(nn.Module):
    """SAGAN self-attention on NHWC patches (reference ``Attention``): 2x2
    max-pooled keys/values, learnable scalar gate ``gamma``."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.theta = conv1x1(c, c // 8)
        self.phi = conv1x1(c, c // 8)
        self.g = conv1x1(c, c // 2)
        self.o = conv1x1(c // 2, c)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        theta = self.theta(x).reshape(b, h * w, c // 8)
        phi = _max_pool2_nhwc(self.phi(x)).reshape(b, (h * w) // 4, c // 8)
        g = _max_pool2_nhwc(self.g(x)).reshape(b, (h * w) // 4, c // 2)
        beta = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
        o = self.o((beta @ g).reshape(b, h, w, c // 2))
        return (self.gamma.to(x.dtype) * o + x).to(x.dtype)


class PatchAttention(nn.Module):
    """Attention on a merged grid: split into patches, attend per patch,
    merge back."""

    def __init__(self, channels: int):
        super().__init__()
        self.attn = Attention(channels)

    def forward(self, x: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        gh, gw = grid
        return patches_to_grid(self.attn(grid_to_patches(x, gh, gw)), gh, gw)


class ResBlockGenerator(nn.Module):
    """Pre-activation generator residual block, BN norm (reference
    ``ResBlockGenerator``): BN-act-convLP-BN-act-convLP with a 1x1 shortcut
    when the channel count changes."""

    def __init__(self, in_features: int, features: int, leak: float = 0.0,
                 outer_padding: str = "replicate"):
        super().__init__()
        self.leak = leak
        self.bn1 = BNFold(in_features)
        self.conv1 = ConvLP(in_features, features, outer_padding)
        self.bn2 = BNFold(features)
        self.conv2 = ConvLP(features, features, outer_padding)
        self.conv3 = conv1x1(in_features, features) if in_features != features else None

    def forward(self, x: torch.Tensor, halo1: Optional[SiteState] = None,
                halo2: Optional[SiteState] = None, pos: Optional[GridPos] = None, *,
                grid: tuple[int, int] = (3, 3), chw: bool = False):
        if chw:
            # channels-major tail (the generator gates it to leak 0): the BN
            # folds and ReLUs run inside the conv kernels, the shortcut conv
            # and the residual add in one K3 launch
            out, halo1 = self.conv1(x, halo1, pos, grid=grid, chw_fold=(*self.bn1.fold(), True))
            out, halo2 = self.conv2(out, halo2, pos, grid=grid, chw_fold=(*self.bn2.fold(), True))
            if self.conv3 is None:
                return out + x, halo1, halo2
            y = kernels.conv1x1_chw_add(x, self.conv3.weight, self.conv3.bias, out)
            return y, halo1, halo2
        act = activation_fn(self.leak)
        out, halo1 = self.conv1(act(self.bn1(x)), halo1, pos, grid=grid)
        out, halo2 = self.conv2(act(self.bn2(out)), halo2, pos, grid=grid)
        sc = self.conv3(x) if self.conv3 is not None else x
        return out + sc, halo1, halo2
