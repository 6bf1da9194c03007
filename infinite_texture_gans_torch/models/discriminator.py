"""PatchDiscriminator — the training pipeline's discriminator.

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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from infinite_texture_gans_torch.models.layers import BNFold, InstanceNorm
from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.conv import Conv

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
