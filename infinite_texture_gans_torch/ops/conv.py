"""Convolution primitive on NHWC tensors, with spectral normalisation.

Port of ``infinite_texture_gans_tpu/ops/conv.py``: ``spectral_normalize``,
``sn_kernel``, ``Conv`` and ``Dense`` (:33-163), and the SSM embed's init
(``models/layers.py:283-299``). The reference stores HWIO kernels;
here the weight is a PyTorch OIHW parameter (``weights.from_jax_variables``
transposes), and the NHWC activation is viewed as channels-last NCHW, so
``F.conv2d`` reads it without a copy. The generator's NHWC blocks, the start
conv and the discriminator's convs run through here, as the reference
leaves them to XLA.

Spectral norm keeps the power-iteration vectors ``u`` (O,) and ``v``
(kh*kw*I,) as buffers, updated only when the caller passes ``update_sn``
(train mode). ``v`` is indexed in the reference's HWIO order, so the
buffers load from and save to its ``spectral`` collection unchanged. A
``Dense`` weight is PyTorch's (out, in), the transpose of the reference's
(in, out) kernel; its ``v`` has the in-features' order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SN_EPS = 1e-12


def sn_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW weight -> (O, kh*kw*I), the reference's ``kernel.reshape(-1,
    O).T`` of the HWIO kernel; a Dense (O, I) weight is that matrix already
    (the reference's (I, O) kernel transposed)."""
    if weight.dim() == 2:
        return weight
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor, update: bool,
                       n_iter: int = 1, eps: float = SN_EPS):
    """Returns (weight / sigma, u', v'), as the reference's
    ``spectral_normalize``: with ``update`` one power iteration refreshes
    (u, v) from the weight; sigma = u^T W v is differentiated with respect to
    the weight only."""
    w_mat = sn_matrix(weight)
    with torch.no_grad():
        # copies: sigma's graph must not hold the buffers a later call updates in place
        u_, v_ = u.clone(), v.clone()
        if update:
            wd = w_mat.detach()
            for _ in range(n_iter):
                v_ = wd.t() @ u_
                v_ = v_ / (torch.linalg.vector_norm(v_) + eps)
                u_ = wd @ v_
                u_ = u_ / (torch.linalg.vector_norm(u_) + eps)
    sigma = torch.dot(u_, w_mat @ v_)
    return weight / sigma, u_, v_


def unit_normal(n: int, generator: torch.Generator = None) -> torch.Tensor:
    """A normalised standard-normal vector: the power-iteration vectors'
    initial value (the reference draws its own with ``jax.random``)."""
    u = torch.randn(n, generator=generator)
    return u / (torch.linalg.vector_norm(u) + SN_EPS)


class _SNWeight(nn.Module):
    """A weight with an optional bias and optional spectral norm: the
    power-iteration vectors in the buffers ``u`` (O,) and ``v`` (the
    weight's other elements), initialised orthogonally on the (O, -1) view,
    as the reference's ``orthogonal(column_axis=-1)`` draws (other random
    numbers: tests carry the reference's weights over)."""

    def __init__(self, shape, use_bias: bool, sn: bool):
        super().__init__()
        self.sn = sn
        self.weight = nn.Parameter(torch.empty(*shape))
        nn.init.orthogonal_(self.weight)
        self.bias = nn.Parameter(torch.zeros(shape[0])) if use_bias else None
        if sn:
            self.register_buffer("u", unit_normal(shape[0]))
            self.register_buffer("v", unit_normal(self.weight[0].numel()))

    def kernel(self, update_sn: bool = False) -> torch.Tensor:
        """The float32 weight the layer uses: spectrally normalised when
        ``sn``, refreshing ``u``/``v`` in place when ``update_sn``."""
        if not self.sn:
            return self.weight
        w, u, v = spectral_normalize(self.weight, self.u, self.v, update_sn)
        if update_sn:
            self.u.copy_(u)
            self.v.copy_(v)
        return w


class Conv(_SNWeight):
    """NHWC conv with a bias (unless ``use_bias`` is False), stride and a
    symmetric zero ``padding``, as in the reference; with ``sn`` the weight
    is spectrally normalised on every call (:func:`spectral_normalize`)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 padding: int = 1, strides: int = 1, sn: bool = False, use_bias: bool = True):
        super().__init__((features, in_features, kernel_size, kernel_size), use_bias, sn)
        self.padding, self.strides = padding, strides

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        """x (N, H, W, Cin) -> (N, H', W', Cout) in x's dtype."""
        w = self.kernel(update_sn).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.strides, self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(_SNWeight):
    """Linear layer with orthogonal init and optional spectral norm (the
    reference's ``Dense``): x (..., in) -> (..., features) in x's dtype."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 sn: bool = False):
        super().__init__((features, in_features), use_bias, sn)

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        w = self.kernel(update_sn).to(x.dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))


def ssm_embed_init_(weight: torch.Tensor, in_channel: int) -> torch.Tensor:
    """The SSM embed init of the reference (``models/layers.py:283-299``,
    its quirk kept): on the (2C, hidden, 3, 3) weight, the input-channel
    slice ``[:, :min(C, hidden)]`` is initialised orthogonally and every
    other input channel is zero (the slice was meant to split gamma from
    beta, but cuts input channels). PyTorch's draws, not jax.random's."""
    cut = min(in_channel, weight.shape[1])
    sub = torch.empty(weight.shape[0], cut, *weight.shape[2:])
    nn.init.orthogonal_(sub)
    with torch.no_grad():
        weight.zero_()
        weight[:, :cut] = sub
    return weight


def conv3x3(in_features: int, features: int, padding: int = 1, sn: bool = False) -> Conv:
    return Conv(in_features, features, 3, padding, sn=sn)


def conv1x1(in_features: int, features: int, sn: bool = False) -> Conv:
    return Conv(in_features, features, 1, 0, sn=sn)
