"""Generator building blocks.

Port of ``infinite_texture_gans_tpu/models/layers.py`` for the BN and SSM
generators, eval and train: ``activation_fn``, ``StatsBN`` (the
parameter-free BatchNorm), ``BNFold`` (which also serves as the NHWC
``nn.BatchNorm``, the discriminator's among them), ``InstanceNorm``,
``StochasticSpatialModulation``, ``ConvLP``, ``Attention``,
``PatchAttention``, ``ResBlockGenerator`` (BN and SSM branches, and the
subpixel-fused up-conv branch of BN blocks: in training under ``--fuse_up
auto``, at eval under ``all``), and the discriminator zoo's NHWC blocks
``ResBlockDiscriminator`` and ``OptimizedBlock``. With ``sn`` every conv of the NHWC
branches is spectrally normalised (``ops/conv.py``), its vectors refreshed
when the caller passes ``update_sn``; the channels-major branches take the
raw weights, and the generator's gate keeps a spectrally normalised model
off them, as the reference's does. Submodule and parameter names follow
the reference's flax paths (``conv1.conv.weight``, ``bn1.scale``,
``bn1.mean``, ``bn1.bn.mean``, ``bn1.mlp_shared.weight`` ...), so
``weights.from_jax_variables`` maps a flax tree onto them leaf by leaf.

``padding_mode='zeros'`` (the reference's default, :189, :264, :313, :350,
:512-714) pads every 3x3 conv of a patch with one ring of zeros, the SSM
embed's two convs included: no grid merge, no halo, all NHWC.

Two layouts, as in the reference: merged-grid NHWC for the wide blocks, and
channels-major (N, C, H, W) for the small-channel tail, where the BN fold
and ReLU run inside the conv kernels of ``ops/kernels.py`` and the SSM
gamma|beta come from K15 (``ops/ssm.py``). In training the tail's norms
take their batch moments from the producing kernel's per-channel sums
(``stats`` = (Σy, Σy², count)), as the reference's do.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infinite_texture_gans_torch.ops import kernels, ssm
from infinite_texture_gans_torch.ops.conv import conv1x1, conv3x3, ssm_embed_init_
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


class StatsBN(nn.Module):
    """Parameter-free BatchNorm (momentum 0.9, epsilon 1e-5) with the
    reference's variable names: running statistics ``mean``/``var`` as
    buffers, no affine parameters. The NHWC ``forward`` is flax's
    ``nn.BatchNorm(use_scale=False, use_bias=False)`` (batch moments with the
    variance clipped at 0 and a running-stat update in train mode, the
    running statistics in eval); :meth:`chw` is the reference's ``_StatsBN``
    (:414-453) on channels-major input, whose train-mode moments come from a
    producer's ``stats`` where given. The SSM norm's ``bn``, and the base of
    :class:`BNFold`."""

    epsilon = 1e-5
    momentum = 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def _update_running(self, m: torch.Tensor, v: torch.Tensor) -> None:
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * m)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * v)

    def train_moments(self, x_chw: torch.Tensor, stats: Optional[Stats]):
        """Train-mode (mean, var) of a channels-major input, float32: from the
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
        return m, v

    def _nhwc_moments(self, x: torch.Tensor, train: Optional[bool] = None):
        if not (self.training if train is None else train):
            return self.mean.float(), self.var.float()
        xf = x.float()
        m = xf.mean(dim=(0, 1, 2))
        v = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - m * m, min=0.0)
        self._update_running(m, v)
        return m, v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, v = self._nhwc_moments(x)
        return ((x.float() - m) * torch.rsqrt(v + self.epsilon)).to(x.dtype)

    def chw(self, x_chw: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        """(x - mean) / sqrt(var + eps) per channel (dim 1) in float32,
        rounded to x's dtype."""
        if self.training:
            m, v = self.train_moments(x_chw, stats)
        else:
            m, v = self.mean.float(), self.var.float()
        inv = torch.rsqrt(v + self.epsilon)
        return ((x_chw.float() - m.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)).to(x_chw.dtype)


class BNFold(StatsBN):
    """BatchNorm (momentum 0.9, epsilon 1e-5) with the reference's variable
    names: parameters ``scale``/``bias``, running statistics ``mean``/``var``
    as buffers.

    ``forward`` normalises NHWC activations like flax's ``nn.BatchNorm``:
    batch moments (variance clipped at 0, the biased one kept as the running
    ``var``) and a running-stat update in train mode, the running statistics
    in eval; ``train`` overrides the module's mode (the discriminator's
    norms under the gradient penalty's frozen critic). :meth:`fold` (eval) and
    :meth:`train_fold` (train, the reference's ``BNFold`` :121-170) return
    the per-channel float32 ``(scale, shift)`` that the channels-major conv
    kernels apply themselves."""

    def __init__(self, channels: int):
        super().__init__(channels)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._affine(self.mean.float(), self.var.float())

    def _affine(self, m: torch.Tensor, v: torch.Tensor):
        inv = torch.rsqrt(v + self.epsilon) * self.scale.float()
        return inv, self.bias.float() - m * inv

    def train_fold(self, x_chw: torch.Tensor, stats: Optional[Stats]):
        """Train-mode fold of a channels-major input (moments as
        :meth:`StatsBN.train_moments`); updates the running statistics."""
        return self._affine(*self.train_moments(x_chw, stats))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        m, v = self._nhwc_moments(x, train)
        mul = torch.rsqrt(v + self.epsilon) * self.scale.float()
        y = (x.float() - m) * mul + self.bias.float()
        return y.to(x.dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm without affine parameters (the reference's
    ``InstanceNorm``, :780-789): each image's channels normalised over H
    and W of NHWC x with the biased variance, epsilon 1e-5; in float32,
    rounded to x's dtype. No variables."""

    epsilon = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m = xf.mean(dim=(1, 2), keepdim=True)
        v = (xf - m).square().mean(dim=(1, 2), keepdim=True)
        return ((xf - m) * torch.rsqrt(v + self.epsilon)).to(x.dtype)


class StochasticSpatialModulation(nn.Module):
    """The SSM norm (reference ``StochasticSpatialModulation`` :302-411):
    parameter-free BatchNorm ``bn``, then a per-pixel (1 + gamma)·BN(x) +
    beta whose gamma|beta come from the layer's random map through
    ``mlp_shared`` (3x3 valid, map_dim -> 128), ReLU and ``embed`` (3x3
    valid, 128 -> 2C, the reference's init quirk: :func:`ssm_embed_init_`).
    The map arrives 4 px oversized (local padding: both convs are valid);
    in zeros mode it is x's size and both convs pad one ring of zeros.

    ``forward`` is the NHWC branch (:380-394): x (N, H, W, C), maps (N, H+4,
    W+4, md); the reference's convs cast its float32 maps to the compute
    dtype, and so do these (x's dtype). :meth:`chw` is the channels-major
    branch (:339, :374-379): x (N, C, H, W), the maps permuted to (N, md,
    H+4, W+4) and cast to x's dtype, through K15 (``ops/ssm.py``). With
    ``sn`` both convs are spectrally normalised in the NHWC branch
    (:380-394)."""

    def __init__(self, channels: int, map_dim: int, hidden: int = 128,
                 padding_mode: str = "local", sn: bool = False):
        super().__init__()
        self.channels = channels
        self.bn = StatsBN(channels)
        p = 1 if padding_mode == "zeros" else 0
        self.mlp_shared = conv3x3(map_dim, hidden, padding=p, sn=sn)
        self.embed = conv3x3(hidden, 2 * channels, padding=p, sn=sn)
        ssm_embed_init_(self.embed.weight, channels)

    def forward(self, x: torch.Tensor, maps: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        out = self.bn(x)
        actv = torch.relu(self.mlp_shared(maps.to(x.dtype), update_sn))
        gamma, beta = self.embed(actv, update_sn).split(self.channels, dim=-1)
        return (1 + gamma) * out + beta

    def chw(self, x: torch.Tensor, maps: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        out = self.bn.chw(x, stats)
        m = maps.detach().permute(0, 3, 1, 2).to(x.dtype).contiguous()
        if tuple(m.shape[2:]) != (x.shape[2] + 4, x.shape[3] + 4):
            raise ValueError(f"maps {tuple(maps.shape)} are not 4 px larger than x {tuple(x.shape)}")
        embed = ssm.ssm_embed(m, self.mlp_shared.weight, self.mlp_shared.bias,
                              self.embed.weight, self.embed.bias)
        gamma, beta = embed.split(self.channels, dim=1)
        # the channel slices can hand their strides on; the kernels take contiguous x
        return ((1 + gamma) * out + beta).contiguous()


class ConvLP(nn.Module):
    """3x3 conv with local or zero padding (reference ``conv2d_lp``).
    'local': outer edge/zero padding of the merged grid in one pass, the
    halo cache at patch-by-patch inference; ``pre_padded`` (the start
    conv): the input already carries a 1px halo of real values. 'zeros':
    an ordinary pad-1 conv of each image (``pre_padded`` and the halo do
    not apply). With
    ``chw_fold=(scale, shift, relu)`` the input is channels-major and the BN
    fold + activation run inside the K1/K2 kernels. With ``fuse_up`` too
    (the reference's ``fuse_up_w_true``, :215-234) the channels-major input
    is at half resolution and the nearest-2x upsample runs inside the
    kernel: K14 at a raster step (the site's cache is at half resolution),
    K9 without a halo site. ``sn``: the NHWC conv spectrally normalised,
    its vectors refreshed under ``update_sn``.
    """

    def __init__(self, in_features: int, features: int,
                 outer_padding: str = "replicate", pre_padded: bool = False,
                 padding_mode: str = "local", sn: bool = False):
        super().__init__()
        self.outer_padding = outer_padding
        self.pre_padded = pre_padded
        self.zeros = padding_mode == "zeros"
        self.conv = conv3x3(in_features, features, padding=1 if self.zeros else 0, sn=sn)

    def forward(self, x: torch.Tensor, halo: Optional[SiteState] = None,
                pos: Optional[GridPos] = None, *, grid: tuple[int, int] = (3, 3),
                chw_fold=None, fuse_up: bool = False, update_sn: bool = False):
        gh, gw = grid
        if chw_fold is not None:
            scale, shift, relu = chw_fold
            w, b = self.conv.weight, self.conv.bias
            if fuse_up:
                if halo is not None:
                    return kernels.chw_upconv_halo_step(
                        x, w, b, scale, shift, relu, self.outer_padding, halo, pos, gh, gw
                    )
                return kernels.upconv3x3_chw(x, w, b, scale, shift, relu, self.outer_padding), halo
            if halo is not None:
                return kernels.chw_halo_step(
                    x, w, b, scale, shift, relu, self.outer_padding, halo, pos, gh, gw
                )
            return kernels.conv3x3_chw(x, w, b, scale, shift, relu, self.outer_padding), halo
        if self.zeros:
            return self.conv(x, update_sn), halo
        if self.pre_padded:
            padded = x
        elif halo is None:
            padded = local_pad(x, 1, self.outer_padding)
        else:
            padded, halo = halo_pad_step(x, halo, pos, gh, gw, self.outer_padding)
        return self.conv(padded, update_sn), halo


def _max_pool2_nhwc(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Attention(nn.Module):
    """SAGAN self-attention on NHWC patches (reference ``Attention``): 2x2
    max-pooled keys/values, learnable scalar gate ``gamma``; ``sn``
    normalises its four 1x1 convs."""

    def __init__(self, channels: int, sn: bool = False):
        super().__init__()
        c = channels
        self.theta = conv1x1(c, c // 8, sn)
        self.phi = conv1x1(c, c // 8, sn)
        self.g = conv1x1(c, c // 2, sn)
        self.o = conv1x1(c // 2, c, sn)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        b, h, w, c = x.shape
        theta = self.theta(x, update_sn).reshape(b, h * w, c // 8)
        phi = _max_pool2_nhwc(self.phi(x, update_sn)).reshape(b, (h * w) // 4, c // 8)
        g = _max_pool2_nhwc(self.g(x, update_sn)).reshape(b, (h * w) // 4, c // 2)
        beta = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
        o = self.o((beta @ g).reshape(b, h, w, c // 2), update_sn)
        return (self.gamma.to(x.dtype) * o + x).to(x.dtype)


class PatchAttention(nn.Module):
    """Attention on a merged grid: split into patches, attend per patch,
    merge back."""

    def __init__(self, channels: int, sn: bool = False):
        super().__init__()
        self.attn = Attention(channels, sn)

    def forward(self, x: torch.Tensor, grid: tuple[int, int], update_sn: bool = False) -> torch.Tensor:
        gh, gw = grid
        return patches_to_grid(self.attn(grid_to_patches(x, gh, gw), update_sn), gh, gw)


def identity_fold(x: torch.Tensor):
    """The conv kernels' BN fold that leaves x as it is, then the ReLU: the
    SSM blocks modulate outside the kernels (the reference's ``(ones, zeros,
    False)`` after its own ReLU, the same values and gradient)."""
    c = x.shape[1]
    return (torch.ones(c, device=x.device), torch.zeros(c, device=x.device), True)


class ResBlockGenerator(nn.Module):
    """Pre-activation generator residual block (reference
    ``ResBlockGenerator`` :501-719): norm-act-convLP-norm-act-convLP with a
    1x1 shortcut when the channel count changes. The norm is BN
    (:class:`BNFold`) or SSM (:class:`StochasticSpatialModulation`, which
    also gives the shortcut its own ``bn3`` and takes the layer's ``maps``).
    ``sn`` normalises every conv (NHWC only), refreshed under ``update_sn``.
    ``forward`` is the eval block (with the raster engine's halo sites);
    :meth:`forward_train` the train block."""

    def __init__(self, in_features: int, features: int, leak: float = 0.0,
                 outer_padding: str = "replicate", type_norm: str = "BN", map_dim: int = 1,
                 padding_mode: str = "local", sn: bool = False):
        super().__init__()
        self.leak = leak
        self.ssm = type_norm == "SSM"
        learnable_sc = in_features != features
        if self.ssm:
            ssm_ = lambda c: StochasticSpatialModulation(c, map_dim, padding_mode=padding_mode,  # noqa: E731
                                                         sn=sn)
            self.bn1 = ssm_(in_features)
            self.bn2 = ssm_(features)
            self.bn3 = ssm_(in_features) if learnable_sc else None
        else:
            self.bn1 = BNFold(in_features)
            self.bn2 = BNFold(features)
        self.conv1 = ConvLP(in_features, features, outer_padding, padding_mode=padding_mode, sn=sn)
        self.conv2 = ConvLP(features, features, outer_padding, padding_mode=padding_mode, sn=sn)
        self.conv3 = conv1x1(in_features, features, sn) if learnable_sc else None

    def _norm(self, bn: nn.Module, x: torch.Tensor, maps: Optional[torch.Tensor],
              update_sn: bool) -> torch.Tensor:
        return bn(x, maps, update_sn) if self.ssm else bn(x)

    def _forward_nhwc(self, x, maps, halo1, halo2, pos, grid, update_sn=False):
        act = activation_fn(self.leak)
        out, halo1 = self.conv1(act(self._norm(self.bn1, x, maps, update_sn)), halo1, pos,
                                grid=grid, update_sn=update_sn)
        out, halo2 = self.conv2(act(self._norm(self.bn2, out, maps, update_sn)), halo2, pos,
                                grid=grid, update_sn=update_sn)
        sc = x
        if self.conv3 is not None:
            sc = self.conv3(self.bn3(x, maps, update_sn) if self.ssm else x, update_sn)
        return out + sc, halo1, halo2

    def forward(self, x: torch.Tensor, halo1: Optional[SiteState] = None,
                halo2: Optional[SiteState] = None, pos: Optional[GridPos] = None, *,
                grid: tuple[int, int] = (3, 3), chw: bool = False,
                maps: Optional[torch.Tensor] = None, fuse_up: bool = False,
                update_sn: bool = False):
        if not chw:
            return self._forward_nhwc(x, maps, halo1, halo2, pos, grid, update_sn)
        # channels-major tail (the generator gates it to leak 0). BN: the
        # folds and ReLUs run inside the conv kernels. SSM (:562-585): the
        # modulation runs outside them (its gamma|beta from K15), the conv
        # takes the identity fold. The shortcut conv and the residual add
        # run in one K3 launch.
        if self.ssm:
            a = self.bn1.chw(x, maps)
            out, halo1 = self.conv1(a, halo1, pos, grid=grid, chw_fold=identity_fold(a))
            a = self.bn2.chw(out, maps)
            out, halo2 = self.conv2(a, halo2, pos, grid=grid, chw_fold=identity_fold(a))
        elif fuse_up:
            # the fused BN branch at eval (``fuse_up='all'``, :586-636): x
            # at half resolution; upsample -> bn1 -> ReLU -> conv1 in one
            # K14 (raster) or K9 (one pass) launch, the 1x1 shortcut at half
            # resolution, and K10 joins its upsample with the residual on
            # both engines (the reference's raster adds up2(s) in XLA: the
            # same sum, rounded once)
            out, halo1 = self.conv1(x, halo1, pos, grid=grid, chw_fold=(*self.bn1.fold(), True),
                                    fuse_up=True)
            out, halo2 = self.conv2(out, halo2, pos, grid=grid, chw_fold=(*self.bn2.fold(), True))
            s_half = x if self.conv3 is None else kernels.conv1x1_chw(
                x, self.conv3.weight, self.conv3.bias)
            return kernels.upsample2_chw_add(s_half, out), halo1, halo2
        else:
            out, halo1 = self.conv1(x, halo1, pos, grid=grid, chw_fold=(*self.bn1.fold(), True))
            out, halo2 = self.conv2(out, halo2, pos, grid=grid, chw_fold=(*self.bn2.fold(), True))
        if self.conv3 is None:
            return out + x, halo1, halo2
        sc = self.bn3.chw(x, maps) if self.ssm else x
        y = kernels.conv1x1_chw_add(sc, self.conv3.weight, self.conv3.bias, out)
        return y, halo1, halo2

    def forward_train(self, x: torch.Tensor, *, grid: tuple[int, int] = (3, 3),
                      chw: bool = False, in_stats: Optional[Stats] = None,
                      fuse_up: bool = False, maps: Optional[torch.Tensor] = None,
                      update_sn: bool = False):
        """Train-mode block (batch statistics, running-stat updates).
        Returns (y, stats of y or None).

        Channels-major (the reference's unfused tail branch, :637-673): bn1
        folds from ``in_stats``, conv1 (K5) also returns the sums bn2 folds
        from, and the shortcut conv + residual add (K3) returns the block
        output's sums for the next BatchNorm. SSM (:562-585, :653-674): the
        same order with the SSM norms (bn1 and the shortcut's bn3 take
        ``in_stats``, bn2 conv1's sums) and identity-folded convs. With
        ``fuse_up`` (the fused BN branch, :586-636) ``x`` arrives at half
        resolution: upsample -> bn1 -> ReLU -> conv1 run as one K9 launch,
        the 1x1 shortcut runs at half resolution (it commutes with the
        upsample) and K10 joins its upsample with the residual. NHWC
        (:676-719): flax-style train-mode norms and XLA-style convs (the
        SN vectors refreshed under ``update_sn``); no stats."""
        if not chw:
            return self._forward_nhwc(x, maps, None, None, None, grid, update_sn)[0], None
        n = x.shape[0]
        outer = self.conv1.outer_padding
        w1, b1 = self.conv1.conv.weight, self.conv1.conv.bias
        w2, b2 = self.conv2.conv.weight, self.conv2.conv.bias
        if self.ssm:
            a = self.bn1.chw(x, maps, in_stats)
            out, s1, s2 = kernels.conv3x3_chw(a, w1, b1, *identity_fold(a), outer, want_stats=True)
            a = self.bn2.chw(out, maps, (s1, s2, n * out.shape[2] * out.shape[3]))
            out = kernels.conv3x3_chw(a, w2, b2, *identity_fold(a), outer)
            sc = self.bn3.chw(x, maps, in_stats) if self.conv3 is not None else x
        else:
            sc1, sh1 = self.bn1.train_fold(x, in_stats)
            conv1 = kernels.upconv3x3_chw if fuse_up else kernels.conv3x3_chw
            out, s1, s2 = conv1(x, w1, b1, sc1, sh1, True, outer, want_stats=True)
            sc2, sh2 = self.bn2.train_fold(out, (s1, s2, n * out.shape[2] * out.shape[3]))
            out = kernels.conv3x3_chw(out, w2, b2, sc2, sh2, True, outer)
            sc = x
            if fuse_up:
                s_half = x if self.conv3 is None else kernels.conv1x1_chw(
                    x, self.conv3.weight, self.conv3.bias)
                y, s1, s2 = kernels.upsample2_chw_add(s_half, out, want_stats=True)
                return y, (s1, s2, n * y.shape[2] * y.shape[3])
        if self.conv3 is None:
            return out + x, None
        y, s1, s2 = kernels.conv1x1_chw_add(sc, self.conv3.weight, self.conv3.bias, out,
                                            want_stats=True)
        return y, (s1, s2, n * y.shape[2] * y.shape[3])


def avg_pool2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool of NHWC x (odd edges dropped, as flax's
    ``avg_pool`` with VALID padding)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ResBlockDiscriminator(nn.Module):
    """SNGAN discriminator residual block (the reference's
    ``ResBlockDiscriminator``, :722-757), NHWC: [BN] act conv3x3 [BN] act
    conv3x3 [avg-pool], plus a 1x1 shortcut (then pooled) when the width
    changes or the block downsamples. ``bn`` adds flax-style BatchNorms
    (:class:`BNFold`); ``sn`` normalises every conv."""

    def __init__(self, in_features: int, features: int, downsample: bool = False,
                 leak: float = 0.0, sn: bool = True, bn: bool = False):
        super().__init__()
        self.act, self.downsample = activation_fn(leak), downsample
        self.bn1 = BNFold(in_features) if bn else None
        self.conv1 = conv3x3(in_features, features, sn=sn)
        self.bn2 = BNFold(features) if bn else None
        self.conv2 = conv3x3(features, features, sn=sn)
        learnable_sc = in_features != features or downsample
        self.conv3 = conv1x1(in_features, features, sn) if learnable_sc else None

    def forward(self, x: torch.Tensor, update_sn: bool = False,
                train: Optional[bool] = None) -> torch.Tensor:
        h = x if self.bn1 is None else self.bn1(x, train)
        h = self.conv1(self.act(h), update_sn)
        if self.bn2 is not None:
            h = self.bn2(h, train)
        h = self.conv2(self.act(h), update_sn)
        if self.downsample:
            h = avg_pool2_nhwc(h)
        sc = x
        if self.conv3 is not None:
            sc = self.conv3(sc, update_sn)
            if self.downsample:
                sc = avg_pool2_nhwc(sc)
        return h + sc


class OptimizedBlock(nn.Module):
    """The SNGAN discriminator's first block (the reference's
    ``OptimizedBlock``, :760-777), NHWC: conv3x3 act conv3x3 avg-pool, plus
    avg-pool then a 1x1 conv on the shortcut."""

    def __init__(self, in_features: int, features: int, leak: float = 0.0, sn: bool = True):
        super().__init__()
        self.act = activation_fn(leak)
        self.conv1 = conv3x3(in_features, features, sn=sn)
        self.conv2 = conv3x3(features, features, sn=sn)
        self.conv3 = conv1x1(in_features, features, sn)

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        h = self.conv2(self.act(self.conv1(x, update_sn)), update_sn)
        return avg_pool2_nhwc(h) + self.conv3(avg_pool2_nhwc(x), update_sn)
