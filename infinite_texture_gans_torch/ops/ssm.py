"""K15, the SSM embed chain: wrapper, plain versions and its Function.

Counterpart of ``infinite_texture_gans_tpu/ops/pallas_ssm.py``. The
stochastic spatial modulation predicts a per-pixel gamma|beta from a random
map through two valid 3x3 convs with a ReLU between (reference
``models/layers.py:203-234``)::

    maps (N, md, H+4, W+4) -> conv3x3(w1, b1) -> ReLU -> conv3x3(w2, b2)
                           -> (N, 2C, H, W)

- :func:`ssm_embed` (forward, csrc/ssm_embed_chw.cu): replaces
  pallas_ssm.py:343 ``ssm_embed_fwd_call``;
- :func:`ssm_embed_bwd` (dW2, db2, dW1, db1; the same source, two
  launches): replaces pallas_ssm.py:392 ``ssm_embed_bwd_call``.

The maps are random latents with no trainable producer, so their cotangent
is zero by contract (pallas_ssm.py:472-475) and is not computed. The
reference's default backward (``bwd_impl='xla'``) was chosen by TPU
measurement; it differentiates the same chain, so the port's kernel backward
gives the same numbers. The kernels compute in float32 and store the output
in the maps' dtype; weights are OIHW float32. The launches count in
``kernels.LAUNCHES`` under ``ssm_embed`` and ``ssm_embed_bwd``, one per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.kernels import (
    _bf16,
    _check_act,
    _check_param,
    _f32,
    _lib,
    _on_cuda,
    _raise_on,
    _stream,
)


def _check(maps, w1, b1, w2):
    if maps.dim() != 4:
        raise ValueError(f"maps: expected (N, md, H+4, W+4), got shape {tuple(maps.shape)}")
    n, md, hm, wm = maps.shape
    if hm < 5 or wm < 5:
        raise ValueError(f"maps: {hm}x{wm} leaves no output of two valid 3x3 convs")
    _check_act("maps", maps, (n, md, hm, wm))
    hid, co = w1.shape[0], w2.shape[0]
    _check_param("w1", w1, (hid, md, 3, 3))
    _check_param("b1", b1, (hid,))
    _check_param("w2", w2, (co, hid, 3, 3))
    return n, md, hid, co, hm - 4, wm - 4


def ssm_embed_plain(maps, w1, b1, w2, b2):
    """Plain PyTorch version of :func:`ssm_embed`: two valid ``F.conv2d``
    with a ReLU between, in float32, rounded once to the maps' dtype (the
    reference's ``ssm_embed_chw_reference``, pallas_ssm.py:567)."""
    a = torch.relu(F.conv2d(maps.float(), w1.float(), b1.float()))
    return F.conv2d(a, w2.float(), b2.float()).to(maps.dtype)


def _fwd(maps, w1, b1, w2, b2):
    n, md, hid, co, h, w = _check(maps, w1, b1, w2)
    _check_param("b2", b2, (co,))
    if not _on_cuda(maps, w1, b1, w2, b2):
        return ssm_embed_plain(maps, w1, b1, w2, b2)
    y = torch.empty((n, co, h, w), dtype=maps.dtype, device=maps.device)
    w2c = w2.detach().float().permute(1, 2, 3, 0).contiguous()  # (hid, 3, 3, Co)
    with torch.cuda.device(maps.device):
        rc = _lib().itg_ssm_embed_fwd(
            maps.data_ptr(), _f32(w1).data_ptr(), _f32(b1).data_ptr(), w2c.data_ptr(),
            _f32(b2).data_ptr(), y.data_ptr(), n, md, hid, h, w, co, _bf16(maps), _stream(maps),
        )
    _raise_on(rc, "ssm_embed")
    kernels.LAUNCHES["ssm_embed"] += 1
    return y


def ssm_embed_bwd(maps, w1, b1, w2, g):
    """K15 backward: the weight-side gradients of :func:`ssm_embed` from the
    output cotangent ``g`` (N, Co, H, W), float32 sums over (N, H, W).
    dW2/db2 are ``g`` against the recomputed hidden activation; d_pre, the
    transposed stage-2 conv of ``g`` masked by hidden > 0 (the mask
    recomputed with the forward's rounding), against the maps gives dW1/db1.
    Returns (dW2 (Co, hid, 3, 3), db2 (Co,), dW1 (hid, md, 3, 3), db1 (hid,))."""
    n, md, hid, co, h, w = _check(maps, w1, b1, w2)
    _check_act("g", g, (n, co, h, w))
    if g.dtype != maps.dtype:
        raise TypeError(f"g dtype {g.dtype} != maps dtype {maps.dtype}")
    if not _on_cuda(maps, w1, b1, w2, g):
        return ssm_embed_bwd_plain(maps, w1, b1, w2, g)
    dw2 = torch.zeros((co, hid, 3, 3), dtype=torch.float32, device=maps.device)
    db2 = torch.zeros(co, dtype=torch.float32, device=maps.device)
    dw1 = torch.zeros((hid, md, 3, 3), dtype=torch.float32, device=maps.device)
    db1 = torch.zeros(hid, dtype=torch.float32, device=maps.device)
    w2o = w2.detach().float().permute(0, 2, 3, 1).contiguous()  # (Co, 3, 3, hid)
    with torch.cuda.device(maps.device):
        rc = _lib().itg_ssm_embed_bwd(
            maps.data_ptr(), _f32(w1).data_ptr(), _f32(b1).data_ptr(), w2o.data_ptr(),
            g.data_ptr(), dw2.data_ptr(), db2.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            n, md, hid, h, w, co, _bf16(maps), _stream(maps),
        )
    _raise_on(rc, "ssm_embed_bwd")
    kernels.LAUNCHES["ssm_embed_bwd"] += 1
    return dw2, db2, dw1, db1


def ssm_embed_bwd_plain(maps, w1, b1, w2, g):
    """Plain PyTorch version of :func:`ssm_embed_bwd`: autograd of
    :func:`ssm_embed_plain`'s chain in float32."""
    with torch.enable_grad():
        params = [t.detach().float().requires_grad_() for t in (w1, b1, w2)]
        b2 = torch.zeros(w2.shape[0], device=w2.device, requires_grad=True)
        a = torch.relu(F.conv2d(maps.detach().float(), params[0], params[1]))
        y = F.conv2d(a, params[2], b2)
        dw1, db1, dw2, db2 = torch.autograd.grad(y, (*params, b2), g.float())
    return dw2, db2, dw1, db1


class _SsmEmbed(torch.autograd.Function):
    """K15 forward; backward K15's kernel, skipped where autograd needs no
    weight gradient. The maps get no gradient (None)."""

    @staticmethod
    def forward(ctx, maps, w1, b1, w2, b2):
        ctx.save_for_backward(maps, w1, b1, w2)
        return _fwd(maps, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        maps, w1, b1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[1:]):
            return None, None, None, None, None
        dw2, db2, dw1, db1 = ssm_embed_bwd(maps, w1, b1, w2, g.contiguous())
        return (None, dw1 if need[1] else None, db1 if need[2] else None,
                dw2 if need[3] else None, db2 if need[4] else None)


def ssm_embed(maps, w1, b1, w2, b2):
    """K15: y = conv3x3_valid(ReLU(conv3x3_valid(maps, w1) + b1), w2) + b2.

    ``maps`` (N, md, H+4, W+4) float32 or bfloat16, contiguous; w1 (hid, md,
    3, 3), b1 (hid,), w2 (Co, hid, 3, 3), b2 (Co,) float32. Returns (N, Co,
    H, W) in the maps' dtype. Every output sums its (hidden channel, tap)
    products in one fixed order, so equal maps windows give equal bits
    wherever they lie on a canvas. The reference emits a 128-lane padded
    width with a replicate edge fill; the port has no lane padding, so there
    is no fill. Differentiable in the weights and biases; the maps'
    cotangent is zero by contract (None)."""
    return _SsmEmbed.apply(maps, w1, b1, w2, b2)
