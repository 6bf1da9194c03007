"""Generator building blocks.

Port of ``infinite_texture_gans_tpu/models/layers.py`` for the BN
generator, eval and train: ``activation_fn``, ``BNFold`` (which also serves
as the NHWC ``nn.BatchNorm``), ``ConvLP``, ``Attention``,
``PatchAttention`` and ``ResBlockGenerator`` (BN branch; in training also
the subpixel-fused up-conv branch of ``--fuse_up auto``). Submodule
and parameter names follow the reference's flax paths
(``conv1.conv.weight``, ``bn1.scale``, ``bn1.mean`` ...), so
``weights.from_jax_variables`` maps a flax tree onto them leaf by leaf.

Two layouts, as in the reference: merged-grid NHWC for the wide blocks, and
channels-major (N, C, H, W) for the small-channel tail, where the BN fold
and ReLU run inside the conv kernels of ``ops/kernels.py``. In training the
tail's BatchNorms take their batch moments from the producing kernel's
per-channel sums (``stats`` = (Σy, Σy², count)), as the reference's do.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.conv import conv1x1, conv3x3
from infinite_texture_gans_torch.ops.grid import grid_to_patches, patches_to_grid
from infinite_texture_gans_torch.ops.padding import GridPos, SiteState, halo_pad_step, local_pad


def activation_fn(leak: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """LeakyReLU(leak) if leak > 0 else ReLU. ReLU's gradient,
    where(y > 0, g, 0), is the reference's ``_relu_saved_y`` rule."""
    if leak > 0:
        return lambda x: F.leaky_relu(x, leak)
    return torch.relu


# (Σy, Σy², count) of a producer's stored output: a BatchNorm's batch moments
Stats = Tuple[torch.Tensor, torch.Tensor, int]


class BNFold(nn.Module):
    """BatchNorm (momentum 0.9, epsilon 1e-5) with the reference's variable
    names: parameters ``scale``/``bias``, running statistics ``mean``/``var``
    as buffers.

    ``forward`` normalises NHWC activations like flax's ``nn.BatchNorm``:
    batch moments (variance clipped at 0) and a running-stat update in train
    mode, the running statistics in eval. :meth:`fold` (eval) and
    :meth:`train_fold` (train, the reference's ``BNFold`` :121-170) return
    the per-channel float32 ``(scale, shift)`` that the channels-major conv
    kernels apply themselves."""

    epsilon = 1e-5
    momentum = 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._affine(self.mean.float(), self.var.float())

    def _affine(self, m: torch.Tensor, v: torch.Tensor):
        inv = torch.rsqrt(v + self.epsilon) * self.scale.float()
        return inv, self.bias.float() - m * inv

    def _update_running(self, m: torch.Tensor, v: torch.Tensor) -> None:
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * m)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * v)

    def train_fold(self, x_chw: torch.Tensor, stats: Optional[Stats]):
        """Train-mode fold of a channels-major input: batch moments from the
        producer's ``stats`` (which may come from before a nearest-2x
        upsample: mean and E[x²] are unchanged by it) or, without them, from
        ``x_chw`` itself; updates the running statistics."""
        if stats is not None:
            s1, s2, cnt = stats
            m = s1 / cnt
            v = s2 / cnt - m * m
        else:
            xf = x_chw.float()
            m = xf.mean(dim=(0, 2, 3))
            v = (xf * xf).mean(dim=(0, 2, 3)) - m * m
        self._update_running(m, v)
        return self._affine(m, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            m = xf.mean(dim=(0, 1, 2))
            v = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - m * m, min=0.0)
            self._update_running(m, v)
        else:
            m, v = self.mean.float(), self.var.float()
        mul = torch.rsqrt(v + self.epsilon) * self.scale.float()
        y = (x.float() - m) * mul + self.bias.float()
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
    when the channel count changes. ``forward`` is the eval block (with the
    raster engine's halo sites); :meth:`forward_train` the train block."""

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

    def forward_train(self, x: torch.Tensor, *, grid: tuple[int, int] = (3, 3),
                      chw: bool = False, in_stats: Optional[Stats] = None,
                      fuse_up: bool = False):
        """Train-mode block (batch statistics, running-stat updates).
        Returns (y, stats of y or None).

        Channels-major (the reference's unfused tail branch, :637-673): bn1
        folds from ``in_stats``, conv1 (K5) also returns the sums bn2 folds
        from, and the shortcut conv + residual add (K3) returns the block
        output's sums for the next BatchNorm. With ``fuse_up`` (the fused
        branch, :586-636) ``x`` arrives at half resolution: upsample -> bn1
        -> ReLU -> conv1 run as one K9 launch, the 1x1 shortcut runs at half
        resolution (it commutes with the upsample) and K10 joins its
        upsample with the residual. NHWC (:683-719): flax-style train-mode
        BatchNorms and XLA-style convs; no stats."""
        if chw:
            n = x.shape[0]
            outer = self.conv1.outer_padding
            sc1, sh1 = self.bn1.train_fold(x, in_stats)
            w1, b1 = self.conv1.conv.weight, self.conv1.conv.bias
            conv1 = kernels.upconv3x3_chw if fuse_up else kernels.conv3x3_chw
            out, s1, s2 = conv1(x, w1, b1, sc1, sh1, True, outer, want_stats=True)
            sc2, sh2 = self.bn2.train_fold(out, (s1, s2, n * out.shape[2] * out.shape[3]))
            w2, b2 = self.conv2.conv.weight, self.conv2.conv.bias
            out = kernels.conv3x3_chw(out, w2, b2, sc2, sh2, True, outer)
            if fuse_up:
                s_half = x if self.conv3 is None else kernels.conv1x1_chw(
                    x, self.conv3.weight, self.conv3.bias)
                y, s1, s2 = kernels.upsample2_chw_add(s_half, out, want_stats=True)
                return y, (s1, s2, n * y.shape[2] * y.shape[3])
            if self.conv3 is None:
                return out + x, None
            y, s1, s2 = kernels.conv1x1_chw_add(x, self.conv3.weight, self.conv3.bias, out,
                                                want_stats=True)
            return y, (s1, s2, n * y.shape[2] * y.shape[3])
        act = activation_fn(self.leak)
        out, _ = self.conv1(act(self.bn1(x)), grid=grid)
        out, _ = self.conv2(act(self.bn2(out)), grid=grid)
        sc = self.conv3(x) if self.conv3 is not None else x
        return out + sc, None
