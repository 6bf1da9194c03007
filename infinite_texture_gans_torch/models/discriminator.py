"""Discriminators: the PatchGAN the training pipeline uses, and the model
zoo.

Port of ``infinite_texture_gans_tpu/models/discriminator.py:
PatchDiscriminator`` (:60-152) with its ``StemConv4x4`` (:27-58), NHWC: a
4x4 / stride-2 conv (img_ch -> base_ch) + LeakyReLU(0.2), then
n_layers_D - 1 convs doubling the channels (cap 512), stride 2 except the
last (stride 1), each followed by the optional norm (``norm_layer``:
'batch', flax's ``nn.BatchNorm`` with momentum 0.9 and epsilon 1e-5 as
``layers.BNFold``, or 'instance', ``layers.InstanceNorm``; :137-148) and
the LeakyReLU, and a 4x4 / stride-1 conv to one logit map. Spectral norm
optional (``SN``).

``forward(x, update_sn=False, chw_in=False, train=None)``: ``train`` (the
module's mode by default) makes the BatchNorms use their batch statistics
and update the running ones; ``train=False`` uses the running averages
(the gradient penalty's frozen critic). With ``chw_in`` the image
arrives channels-major (N, 3, H, W), the layout the generator's tail emits,
and conv0 runs the K13 stem kernel (``kernels.conv4x4s2_stem_chw``); an
NHWC image (the real crops) takes ``F.conv2d``, as the reference takes
XLA's conv there (its ``stem_pallas`` is 'off').

The zoo (the reference's ``ResDiscriminator``, ``DCDiscriminator`` and
``SNDiscriminator``, :155-277): NHWC, ``F.conv2d`` throughout, module names
following the flax paths so JAX variables load with ``strict=True``. The
training pipeline wires only the PatchGAN (``config.check_train_args``
refuses the others, as the reference does); the zoo is a library. PyTorch
modules are built with their input widths, which flax infers at init: the
image channels (``img_ch``), the class inputs of ``ResDiscriminator``'s
conditioning (``n_classes`` wide for 'concat' and 'proj', one spatial
channel for 'conv1x1' and 'conv3x3') and ``SNDiscriminator``'s input size
(``in_res``, 64 as in the reference) for its ``fc``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from infinite_texture_gans_torch.models.layers import (
    Attention,
    BNFold,
    InstanceNorm,
    OptimizedBlock,
    ResBlockDiscriminator,
    activation_fn,
)
from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.conv import Conv, Dense

NORM_LAYERS = (None, "batch", "instance")


class PatchDiscriminator(nn.Module):
    """Submodule names follow the reference's flax tree (``conv0`` ...
    ``conv{n_layers_D-1}``, ``norm1`` ... ``norm{n_layers_D-1}``,
    ``conv_out``); ``dtype`` is the compute type (parameters stay
    float32)."""

    def __init__(self, base_ch: int = 64, n_layers_D: int = 4, img_ch: int = 3, SN: bool = False,
                 norm_layer: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm_layer not in NORM_LAYERS:
            raise ValueError(f"norm_layer must be one of {NORM_LAYERS}, got {norm_layer!r}")
        self.dtype, self.norm_layer = dtype, norm_layer
        self.conv0 = Conv(img_ch, base_ch, 4, padding=1, strides=2, sn=SN)
        nf = base_ch
        for n in range(1, n_layers_D):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_D - 1 else 2
            self.add_module(f"conv{n}", Conv(prev, nf, 4, padding=1, strides=stride, sn=SN))
            if norm_layer is not None:
                self.add_module(f"norm{n}", BNFold(nf) if norm_layer == "batch" else InstanceNorm())
        self.n_layers_D = n_layers_D
        self.conv_out = Conv(nf, 1, 4, padding=1, strides=1, sn=SN)

    def stem_takes_chw(self, x: torch.Tensor) -> bool:
        """The reference's ``_stem_ok_chw``: a 3-channel image of even size."""
        return x.shape[1] == 3 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0

    def forward(self, x: torch.Tensor, update_sn: bool = False, chw_in: bool = False,
                train: Optional[bool] = None):
        if chw_in and not self.stem_takes_chw(x):
            x, chw_in = x.permute(0, 2, 3, 1), False
        if chw_in:
            k = self.conv0.kernel(update_sn)
            # the compute type's rounding of the weights, as the reference's
            # astype(dtype) before the stem
            h = kernels.conv4x4s2_stem_chw(x.to(self.dtype).contiguous(),
                                           k.to(self.dtype).float(),
                                           self.conv0.bias.to(self.dtype).float())
        else:
            h = self.conv0(x.to(self.dtype), update_sn)
        h = F.leaky_relu(h, 0.2)
        for n in range(1, self.n_layers_D):
            h = getattr(self, f"conv{n}")(h, update_sn)
            if self.norm_layer == "batch":
                h = getattr(self, f"norm{n}")(h, train)
            elif self.norm_layer == "instance":
                h = getattr(self, f"norm{n}")(h)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h, update_sn)


COND_METHODS = ("concat", "proj", "conv1x1", "conv3x3")


class ResDiscriminator(nn.Module):
    """SNGAN residual discriminator with class conditioning (the
    reference's ``ResDiscriminator``, :155-223): ``block1`` (an
    ``OptimizedBlock``), optional ``attention``, ``block2``-``block4``
    downsampling, ``block5``, the activation summed over space, ``fc``.
    With ``n_classes`` > 0 the forward takes ``y``: 'concat' embeds it
    (``embed_y``, Dense) into an 8x8 map joined after block 3 (a 64^2
    input); 'conv1x1' / 'conv3x3' convolve it, as a (w, w, 1) map of the
    block-4 output's size, into ``4 * base_ch`` channels joined after block
    4; 'proj' adds ``<embed_y(y), h>`` to the logit. Each method narrows the
    blocks around its join as the reference does."""

    def __init__(self, base_ch: int = 32, n_classes: int = 0, leak: float = 0.0,
                 att: bool = False, cond_method: str = "concat", SN: bool = True,
                 SN_y: bool = False, img_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cond_method not in COND_METHODS:
            raise ValueError(f"cond_method must be one of {COND_METHODS}, got {cond_method!r}")
        ch, cond = base_ch, n_classes > 0
        self.n_classes, self.cond_method, self.dtype = n_classes, cond_method, dtype
        self.act = activation_fn(leak)
        block = dict(leak=leak, sn=SN)
        self.block1 = OptimizedBlock(img_ch, ch, leak, SN)
        self.attention = Attention(ch, SN) if att else None
        self.block2 = ResBlockDiscriminator(ch, ch * 2, downsample=True, **block)
        ch3 = ch * 2 if cond and cond_method == "concat" else ch * 4
        self.block3 = ResBlockDiscriminator(ch * 2, ch3, downsample=True, **block)
        in4 = ch3
        if cond and cond_method == "concat":
            self.embed_y = Dense(n_classes, ch * 2 * 8 * 8, sn=SN_y)
            in4 += ch * 2
        ch4 = ch * 4 if cond and cond_method != "proj" else ch * 8
        self.block4 = ResBlockDiscriminator(in4, ch4, downsample=True, **block)
        in5 = ch4
        if cond and cond_method in ("conv1x1", "conv3x3"):
            k = 1 if cond_method == "conv1x1" else 3
            self.embed_y = Conv(1, ch * 4, k, padding=k // 2, sn=SN_y)
            in5 += ch * 4
        self.block5 = ResBlockDiscriminator(in5, ch * 16, downsample=False, **block)
        self.fc = Dense(ch * 16, 1, sn=SN)
        if cond and cond_method == "proj":
            self.embed_y = Dense(n_classes, ch * 16, sn=SN_y)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                update_sn: bool = False, train: Optional[bool] = None) -> torch.Tensor:
        """x (N, H, W, img_ch) -> (N, 1) logits; ``y`` exactly when
        ``n_classes`` > 0."""
        if (y is not None) != (self.n_classes > 0):
            raise ValueError(f"y is required exactly when n_classes > 0 (n_classes "
                             f"{self.n_classes}, y {'given' if y is not None else 'None'})")
        h = self.block1(x.to(self.dtype), update_sn)
        if self.attention is not None:
            h = self.attention(h, update_sn)
        h = self.block2(h, update_sn, train)
        h = self.block3(h, update_sn, train)
        if y is not None and self.cond_method == "concat":
            h_y = self.embed_y(y.to(h.dtype), update_sn).reshape(h.shape[0], 8, 8, -1)
            h = torch.cat([h, h_y], dim=-1)
        h = self.block4(h, update_sn, train)
        if y is not None and self.cond_method in ("conv1x1", "conv3x3"):
            w = h.shape[1]
            h_y = self.embed_y(y.to(h.dtype).reshape(-1, w, w, 1), update_sn)
            h = torch.cat([h, h_y], dim=-1)
        h = self.block5(h, update_sn, train)
        h = self.act(h).sum(dim=(1, 2))
        out = self.fc(h, update_sn)
        if y is not None and self.cond_method == "proj":
            e = self.embed_y(y.to(h.dtype), update_sn)
            out = out + (e * h).sum(dim=1, keepdim=True)
        return out


class DCDiscriminator(nn.Module):
    """DCGAN discriminator (the reference's ``DCDiscriminator``, :226-246):
    4x4 / stride-2 convs without bias (``conv0`` ... ``conv{n_layers}``),
    BatchNorm (``bn1`` ...) and LeakyReLU(0.2) after each but the first's
    norm, then ``final``, a 4x4 valid conv to ``img_ch`` channels, flattened."""

    def __init__(self, base_ch: int = 64, n_layers: int = 3, img_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dtype = n_layers, dtype
        self.conv0 = Conv(img_ch, base_ch, 4, padding=1, strides=2, use_bias=False)
        ch = base_ch
        for n in range(1, n_layers + 1):
            self.add_module(f"conv{n}", Conv(ch, ch * 2, 4, padding=1, strides=2,
                                             use_bias=False))
            ch *= 2
            self.add_module(f"bn{n}", BNFold(ch))
        self.final = Conv(ch, img_ch, 4, padding=0, strides=1, use_bias=False)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                update_sn: bool = False) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x.to(self.dtype)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(h), train)
            h = F.leaky_relu(h, 0.2)
        return self.final(h).reshape(-1)


class SNDiscriminator(nn.Module):
    """Plain SNGAN discriminator (the reference's ``SNDiscriminator``,
    :249-277): ``conv1`` ... ``conv7`` alternating 3x3 / stride 1 and 4x4 /
    stride 2 (widths ch, ch, 2ch, 2ch, 4ch, 4ch, 8ch), each followed by
    LeakyReLU(``leak``), then ``fc`` over the flattened NHWC map of an
    ``in_res``^2 input (8x8 at the reference's 64)."""

    def __init__(self, base_ch: int = 64, leak: float = 0.1, SN: bool = False,
                 img_ch: int = 3, in_res: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.leak = dtype, leak
        ch = base_ch
        widths = (ch, ch, ch * 2, ch * 2, ch * 4, ch * 4, ch * 8)
        cin = img_ch
        for i, f in enumerate(widths, start=1):
            k = 3 if i % 2 else 4
            self.add_module(f"conv{i}", Conv(cin, f, k, padding=1, strides=1 if k == 3 else 2,
                                             sn=SN))
            cin = f
        self.fc = Dense(ch * 8 * (in_res // 8) ** 2, 1, sn=SN)

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        m = x.to(self.dtype)
        for i in range(1, 8):
            m = F.leaky_relu(getattr(self, f"conv{i}")(m, update_sn), self.leak)
        return self.fc(m.reshape(m.shape[0], -1), update_sn)
