"""The channels-major kernels: wrappers, plain versions and launch counts.

Counterpart of ``infinite_texture_gans_tpu/ops/pallas_conv.py``. Every
function of the reference that reaches a Pallas kernel on the generation
path or on the training step (``--fuse_up auto`` and ``off``, BN and SSM)
has a hand-written CUDA kernel in ``csrc/``:

- K1/K5 ``conv3x3_chw`` (forward, with the optional per-channel Σy, Σy²
  of ``conv3x3_chw_stats`` / ``conv3x3_chw_p``): replaces pallas_conv.py:395
  ``_conv3x3_chw_fwd`` (csrc/conv3x3_chw.cu);
- K2 ``chw_halo_step``, whose kernel wrapper is ``conv3x3_chw_halo``:
  replaces pallas_conv.py:539 ``_conv3x3_chw_fwd_halo`` (the same
  csrc/conv3x3_chw.cu, given the cached borders);
- K6 ``conv3x3_chw_dx``: pallas_conv.py:775 ``_conv3x3_chw_dx``; K7
  ``conv3x3_chw_dw``: :888 ``_conv3x3_chw_dw``; K8 ``bn_corr``: :1061
  ``_bn_corr`` (csrc/conv3x3_chw_bwd.cu);
- K3 ``conv1x1_chw`` / ``conv1x1_chw_add`` (optionally with stats, the
  ``conv1x1_chw_add_stats`` / ``conv1x1_chw_add_p`` forms): replaces
  pallas_conv.py:2311 ``_conv1x1_chw_fwd``; its dW ``conv1x1_chw_dw``:
  :2361 ``_conv1x1_chw_dw`` (csrc/conv1x1_chw.cu);
- K4 ``upsample2_chw``: pallas_conv.py:2540 ``_up2_fwd_call``; its adjoint
  ``upsample2_chw_bwd``: :2560 ``_up2_bwd_call`` (csrc/upsample2_chw.cu);
- K9 ``upconv3x3_chw``, the subpixel-fused upsample -> BN fold -> ReLU ->
  3x3 conv of ``upconv3x3_chw_p`` (optionally with stats): forward :1457
  ``_upconv3x3_fwd``, ``upconv3x3_chw_dx`` :1642 ``_upconv3x3_dx``,
  ``upconv3x3_chw_dw`` :1777 ``_upconv3x3_dw`` (csrc/upconv3x3_chw.cu);
- K10 ``upsample2_chw_add``: :2199 ``upsample2_chw_add_p``, the fused
  block's up2(shortcut) + residual (+ stats) (csrc/upsample2_chw.cu);
- K13 ``conv4x4s2_stem_chw``: the discriminator's conv0, forward
  ``stem_fwd`` :2769 ``_stem_fwd_call``, ``stem_dw`` :2840 ``_stem_dw_call``,
  ``stem_dx`` :2977 ``_stem_dx_call`` (csrc/stem4x4s2.cu).

The SSM embed chain K15 (``pallas_ssm.py:343/:392``) lives in
``ops/ssm.py`` (csrc/ssm_embed_chw.cu); its launches count here too, under
``ssm_embed`` and ``ssm_embed_bwd``.

The port carries no lane padding, so the reference's padded-carry forms
(K11 ``conv1x1_chw_add_p``, ``conv1x1_chw_p``, K12 ``upsample2_chw_p``,
``conv3x3_chw_p``) are the plain forms at ``w_true == width``, and K9/K10
take unpadded widths.

Activations are channels-major (N, C, H, W), float32 or bfloat16; the
kernels compute in float32 and store in the activation type. Weights are
OIHW float32. Every wrapper checks device, dtype, shape and contiguity. For
a CPU tensor it runs the plain PyTorch version beside it; for a CUDA tensor
it launches its kernel on the current stream, raises if the launch reports
an error, and adds one to its entry in :data:`LAUNCHES`. The differentiable
functions (``conv3x3_chw``, ``upconv3x3_chw``, ``conv1x1_chw(_add)``,
``upsample2_chw``, ``upsample2_chw_add``, ``conv4x4s2_stem_chw``) are
``torch.autograd.Function``s whose backward
calls the backward wrappers, skipping the inputs autograd does not need.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from infinite_texture_gans_torch.ops.padding import GridPos, SiteState

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {
    "conv3x3_chw": 0,
    "chw_halo_step": 0,
    "conv3x3_chw_dx": 0,
    "conv3x3_chw_dw": 0,
    "bn_corr": 0,
    "conv1x1_chw": 0,
    "conv1x1_chw_dw": 0,
    "upsample2_chw": 0,
    "upsample2_chw_bwd": 0,
    "upconv3x3_chw": 0,
    "upconv3x3_chw_dx": 0,
    "upconv3x3_chw_dw": 0,
    "upsample2_chw_add": 0,
    "stem_fwd": 0,
    "stem_dw": 0,
    "stem_dx": 0,
    # K15, the SSM embed chain (ops/ssm.py)
    "ssm_embed": 0,
    "ssm_embed_bwd": 0,
}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises for a mix or another device type."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_act(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32 or bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_param(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_floating_point():
        raise TypeError(f"{name}: dtype {t.dtype} is not floating point")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {tuple(shape)}")


def _check_same_dtype(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    if t.dtype != ref.dtype:
        raise TypeError(f"{name} dtype {t.dtype} != {ref.dtype}")


def _check_padding(outer_padding: str) -> bool:
    if outer_padding not in ("replicate", "constant"):
        raise ValueError(f"outer_padding must be 'replicate' or 'constant', got {outer_padding!r}")
    return outer_padding == "constant"


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from infinite_texture_gans_torch.ops._build import library

    return library()


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _zeros_f32(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=like.device)


def _chan(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1) float32, for broadcasting over (N, C, H, W)."""
    return v.float().reshape(1, -1, 1, 1)


def prenorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """act(scale * x + shift) per channel (dim 1), in float32, rounded to
    x's dtype: the post-norm values the conv kernels read and the halo cache
    holds."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    a = x.float() * scale.float().reshape(shape) + shift.float().reshape(shape)
    if relu:
        a = torch.relu(a)
    return a.to(x.dtype)


def _stats_plain(y: torch.Tensor):
    """Per-channel Σy and Σy² (float32) of the stored output, over (N, H, W)."""
    yf = y.float()
    return yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))


def _with_stats_ct(g: torch.Tensor, y: torch.Tensor, gs1, gs2) -> torch.Tensor:
    """The cotangent ``g`` of a producer's output ``y`` with the cotangents
    of its stats (Σy, Σy²) folded in by K8 where there are any."""
    if gs1 is None and gs2 is None:
        return g.contiguous()
    co = g.shape[1]
    alpha = gs1 if gs1 is not None else _zeros_f32(co, g)
    beta2 = 2.0 * gs2 if gs2 is not None else _zeros_f32(co, g)
    return bn_corr(g.contiguous(), y, alpha, beta2)


# ---------------------------------------------------------------------------
# K1 / K2 / K5: BN fold -> ReLU -> border -> 3x3 conv (+ stats)
# (csrc/conv3x3_chw.cu)


def _check_conv3x3(x, w, b, scale, shift) -> None:
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    co = w.shape[0]
    _check_act("x", x, (n, c, h, wd))
    _check_param("w", w, (co, c, 3, 3))
    _check_param("b", b, (co,))
    _check_param("scale", scale, (c,))
    _check_param("shift", shift, (c,))


def _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False):
    n, c, h, wd = x.shape
    co = w.shape[0]
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if want_stats:
        s1, s2 = _zeros_f32(co, x), _zeros_f32(co, x)
    wf, bf, sc, sh = _f32(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            _ptr(top), _ptr(left), y.data_ptr(), _ptr(s1), _ptr(s2),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "conv3x3_chw")
    return y, s1, s2


def _conv3x3_fwd(x, w, b, scale, shift, relu, outer_padding, want_stats):
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    if not _on_cuda(x, w, b, scale, shift):
        out = conv3x3_chw_plain(x, w, b, scale, shift, relu, outer_padding, want_stats)
        return out if want_stats else (out, None, None)
    out = _launch_conv3x3(x, w, b, scale, shift, relu, zeros, None, None, want_stats)
    LAUNCHES["conv3x3_chw"] += 1
    return out


class _Conv3x3Chw(torch.autograd.Function):
    """K1/K5 forward; backward K8 (when the stats have cotangents), K6, K7."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, relu, outer_padding, want_stats):
        ctx.set_materialize_grads(False)
        y, s1, s2 = _conv3x3_fwd(x, w, b, scale, shift, relu, outer_padding, want_stats)
        ctx.relu, ctx.outer_padding, ctx.want_stats = relu, outer_padding, want_stats
        ctx.save_for_backward(x, w, scale, shift, y if want_stats else None)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, g, gs1=None, gs2=None):
        x, w, scale, shift, y = ctx.saved_tensors
        if g is None:  # only the stats have cotangents
            g = torch.zeros_like(y)
        g = _with_stats_ct(g, y, gs1, gs2) if ctx.want_stats else g.contiguous()
        need = ctx.needs_input_grad
        dx = dw = db = dsc = dsh = None
        if need[0] or need[3] or need[4]:
            dx, dsc, dsh = conv3x3_chw_dx(x, g, w, scale, shift, ctx.relu, ctx.outer_padding)
        if need[1] or need[2]:
            dw, db = conv3x3_chw_dw(x, g, scale, shift, ctx.relu, ctx.outer_padding)
        return dx, dw, db, dsc, dsh, None, None, None


def conv3x3_chw(x, w, b, scale, shift, relu: bool = True,
                outer_padding: str = "replicate", want_stats: bool = False):
    """K1: y = conv3x3(pad1(act(scale*x + shift))) + b on (N, C, H, W).

    w (Co, C, 3, 3); b (Co,); scale/shift (C,) are a folded BatchNorm
    (ones/zeros and relu=False for a plain padded conv). The outer pad is
    replicate or zeros ('constant') and is applied post-norm. With
    ``want_stats`` (K5) returns (y, Σy, Σy²), the float32 per-channel sums
    of the stored y over (N, H, W): the next BatchNorm's batch moments.
    Differentiable in x, w, b, scale, shift and through the stats."""
    return _Conv3x3Chw.apply(x, w, b, scale, shift, relu, outer_padding, want_stats)


def conv3x3_chw_plain(x, w, b, scale, shift, relu: bool = True,
                      outer_padding: str = "replicate", want_stats: bool = False):
    """Plain PyTorch version of :func:`conv3x3_chw` (F.pad + F.conv2d)."""
    a = prenorm(x, scale, shift, relu).float()
    mode = "replicate" if outer_padding == "replicate" else "constant"
    a = F.pad(a, (1, 1, 1, 1), mode=mode)
    y = F.conv2d(a, w.float(), b.float()).to(x.dtype)
    if want_stats:
        return (y, *_stats_plain(y))
    return y


def conv3x3_chw_halo(x, w, b, scale, shift, relu: bool, outer_padding: str,
                     top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """K2's kernel: :func:`conv3x3_chw` whose padded input takes its top row
    (N, C, W+2, corners included) and left column (N, C, H) post-norm from
    the caller where given; every other border cell is the own edge
    (replicate) or zero."""
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    n, c, h, wd = x.shape
    if top is not None:
        _check_act("top", top, (n, c, wd + 2))
        _check_same_dtype("top", top, x)
    if left is not None:
        _check_act("left", left, (n, c, h))
        _check_same_dtype("left", left, x)
    if not _on_cuda(x, w, b, scale, shift, top, left):
        return conv3x3_chw_halo_plain(x, w, b, scale, shift, relu, outer_padding, top, left)
    y, _, _ = _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left)
    LAUNCHES["chw_halo_step"] += 1
    return y


def conv3x3_chw_halo_plain(x, w, b, scale, shift, relu: bool, outer_padding: str,
                           top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """Plain PyTorch version of :func:`conv3x3_chw_halo` (the border
    assembly of ``ops/padding.py: halo_pad_step`` on post-norm values, then
    F.conv2d)."""
    a = prenorm(x, scale, shift, relu)
    zeros = outer_padding == "constant"
    edge = torch.zeros_like(a[..., :1])
    if left is None:
        left_col = edge if zeros else a[..., :1]
    else:
        left_col = left.unsqueeze(-1)
    mid = torch.cat([left_col, a, edge if zeros else a[..., -1:]], dim=3)
    row = torch.zeros_like(mid[:, :, :1])
    top_row = top.unsqueeze(2) if top is not None else (row if zeros else mid[:, :, :1])
    padded = torch.cat([top_row, mid, row if zeros else mid[:, :, -1:]], dim=2)
    return F.conv2d(padded.float(), w.float(), b.float()).to(x.dtype)


def halo_borders(x: torch.Tensor, site: SiteState, pos: GridPos, gw: int):
    """The cached post-norm (top, left) borders of one raster step,
    channels-major in x's dtype; None on the first row / column, where the
    kernel uses the own edge."""
    wm = x.shape[3]
    offset = (gw - 1) * (wm // gw) * pos.col
    top = None
    if not pos.first_row:
        read = site.row_read[:, 0, offset : offset + wm + 2, :]  # (N, Wm+2, C)
        top = read.permute(0, 2, 1).to(x.dtype).contiguous()
    left = None
    if not pos.first_col:
        left = site.v[:, :, 0, :].permute(0, 2, 1).to(x.dtype).contiguous()  # (N, C, Hm)
    return top, left


def chw_halo_step(x, w, b, scale, shift, relu: bool, outer_padding: str,
                  site: SiteState, pos: GridPos, gh: int, gw: int):
    """K2: one raster step of a channels-major local-padded conv.

    ``x`` (N, C, Hm, Wm) is the raw conv input (BN fold and ReLU run in the
    kernel); ``site`` is the engine's NHWC-format halo cache and holds
    post-norm values, as the NHWC path's (ops/padding.py) does. Returns
    (y, updated SiteState); ``row_write`` is updated in place."""
    hm, wm = x.shape[2:]
    hp, wp = hm // gh, wm // gw
    top, left = halo_borders(x, site, pos, gw)
    y = conv3x3_chw_halo(x, w, b, scale, shift, relu, outer_padding, top, left)

    # cache updates (post-norm, NHWC buffer format)
    col = x[:, :, :, (gw - 1) * wp - 1 : (gw - 1) * wp]  # (N, C, Hm, 1)
    v_new = prenorm(col, scale, shift, relu).permute(0, 2, 3, 1).to(site.v.dtype)
    row = x[:, :, (gh - 1) * hp - 1, :]  # (N, C, Wm)
    row_pn = prenorm(row, scale, shift, relu).permute(0, 2, 1)  # (N, Wm, C)
    offset = (gw - 1) * wp * pos.col
    site.row_write[:, 0, offset + 1 : offset + 1 + wm, :] = row_pn.to(site.row_write.dtype)
    return y, SiteState(v=v_new, row_read=site.row_read, row_write=site.row_write)


# ---------------------------------------------------------------------------
# K6 / K7 / K8: the 3x3 conv's backward (csrc/conv3x3_chw_bwd.cu)


def _check_bwd(x, g, co, scale, shift, up: int = 1):
    """x (N, C, H, W) and its conv's cotangent g (N, Co, up·H, up·W)."""
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"x, g: expected (N, C, H, W), got {tuple(x.shape)}, {tuple(g.shape)}")
    n, c, h, wd = x.shape
    _check_act("x", x, (n, c, h, wd))
    _check_act("g", g, (n, co, up * h, up * wd))
    _check_same_dtype("g", g, x)
    _check_param("scale", scale, (c,))
    _check_param("shift", shift, (c,))


def conv3x3_chw_dx(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """K6: the input-side gradient of :func:`conv3x3_chw`.

    ``g`` (N, Co, H, W) is the cotangent of y. da = conv3x3ᵀ(g) on the
    padded grid, with the gradient that lands on the padded border folded
    back onto the edge rows and columns (replicate; corners twice) or
    dropped (zeros); da is masked by the ReLU of ``scale*x + shift``.
    Returns (dx = da·scale in x's dtype, d(scale) = Σ da·x, d(shift) = Σ da),
    the sums in float32 over (N, H, W)."""
    zeros = _check_padding(outer_padding)
    co = w.shape[0]
    _check_bwd(x, g, co, scale, shift)
    _check_param("w", w, (co, x.shape[1], 3, 3))
    if not _on_cuda(x, g, w, scale, shift):
        return conv3x3_chw_dx_plain(x, g, w, scale, shift, relu, outer_padding)
    n, c, h, wd = x.shape
    dx = torch.empty_like(x)
    dsc, dsh = _zeros_f32(c, x), _zeros_f32(c, x)
    wf, sc, sh = _f32(w), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw_dx(
            x.data_ptr(), g.data_ptr(), wf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            dx.data_ptr(), dsc.data_ptr(), dsh.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "conv3x3_chw_dx")
    LAUNCHES["conv3x3_chw_dx"] += 1
    return dx, dsc, dsh


def _fold_border(d: torch.Tensor) -> torch.Tensor:
    """(N, C, H+2, W+2) gradient of a replicate-padded array -> (N, C, H, W):
    the border rows and columns add onto the edge they copy."""
    d = d.clone()
    d[..., 1] += d[..., 0]
    d[..., -2] += d[..., -1]
    d[..., 1, :] += d[..., 0, :]
    d[..., -2, :] += d[..., -1, :]
    return d[..., 1:-1, 1:-1]


def conv3x3_chw_dx_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`conv3x3_chw_dx`
    (F.conv_transpose2d, then the border fold)."""
    dpad = F.conv_transpose2d(g.float(), w.float())  # (N, C, H+2, W+2)
    if outer_padding == "replicate":
        da = _fold_border(dpad)
    else:
        da = dpad[..., 1:-1, 1:-1]
    xf = x.float()
    if relu:
        da = da * ((xf * _chan(scale) + _chan(shift)) > 0)
    dx = (da * _chan(scale)).to(x.dtype)
    return dx, (da * xf).sum(dim=(0, 2, 3)), da.sum(dim=(0, 2, 3))


def conv3x3_chw_dw(x, g, scale, shift, relu: bool, outer_padding: str):
    """K7: the weight-side gradient of :func:`conv3x3_chw`:
    dW[o, c, ky, kx] = Σ g[o] · A[c] shifted by the tap, where A is the
    padded post-norm input the forward read, and db = Σ g; float32 sums
    over (N, H, W). Returns (dW (Co, C, 3, 3), db (Co,))."""
    zeros = _check_padding(outer_padding)
    co = g.shape[1]
    _check_bwd(x, g, co, scale, shift)
    if not _on_cuda(x, g, scale, shift):
        return conv3x3_chw_dw_plain(x, g, scale, shift, relu, outer_padding)
    n, c, h, wd = x.shape
    dw = torch.zeros((co, c, 3, 3), dtype=torch.float32, device=x.device)
    db = _zeros_f32(co, x)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw_dw(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "conv3x3_chw_dw")
    LAUNCHES["conv3x3_chw_dw"] += 1
    return dw, db


def conv3x3_chw_dw_plain(x, g, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`conv3x3_chw_dw` (one einsum per tap)."""
    a = prenorm(x, scale, shift, relu).float()
    mode = "replicate" if outer_padding == "replicate" else "constant"
    a = F.pad(a, (1, 1, 1, 1), mode=mode)
    gf = g.float()
    h, wd = x.shape[2:]
    taps = [torch.einsum("nohw,nchw->oc", gf, a[:, :, ky : ky + h, kx : kx + wd])
            for ky in range(3) for kx in range(3)]
    dw = torch.stack(taps, dim=-1).reshape(g.shape[1], x.shape[1], 3, 3)
    return dw, gf.sum(dim=(0, 2, 3))


def bn_corr(g, y, alpha, beta2):
    """K8: g + (alpha[c] + beta2[c]·y) in float32, stored in g's dtype: the
    cotangents of a producer's BN statistics (alpha = dL/dΣy, beta2 =
    2·dL/dΣy²) folded into the gradient of its output y."""
    if g.dim() != 4:
        raise ValueError(f"g: expected (N, C, H, W), got shape {tuple(g.shape)}")
    c = g.shape[1]
    _check_act("g", g, tuple(g.shape))
    _check_act("y", y, tuple(g.shape))
    _check_same_dtype("y", y, g)
    _check_param("alpha", alpha, (c,))
    _check_param("beta2", beta2, (c,))
    if not _on_cuda(g, y, alpha, beta2):
        return bn_corr_plain(g, y, alpha, beta2)
    n, _, h, wd = g.shape
    out = torch.empty_like(g)
    a, b2 = _f32(alpha), _f32(beta2)
    with torch.cuda.device(g.device):
        rc = _lib().itg_bn_corr(
            g.data_ptr(), y.data_ptr(), a.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n * c, c, h * wd, _bf16(g), _stream(g),
        )
    _raise_on(rc, "bn_corr")
    LAUNCHES["bn_corr"] += 1
    return out


def bn_corr_plain(g, y, alpha, beta2):
    """Plain PyTorch version of :func:`bn_corr`."""
    return (g.float() + (_chan(alpha) + _chan(beta2) * y.float())).to(g.dtype)


# ---------------------------------------------------------------------------
# K3: 1x1 conv + bias (+ residual) (+ stats), and its dW (csrc/conv1x1_chw.cu)


def _conv1x1_fwd(x, w, b, res, want_stats):
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    co = w.shape[0]
    _check_act("x", x, (n, c, h, wd))
    _check_param("w", w.reshape(co, -1), (co, c))
    _check_param("b", b, (co,))
    if res is not None:
        _check_act("res", res, (n, co, h, wd))
        _check_same_dtype("res", res, x)
    if c > 768:
        raise ValueError(f"conv1x1_chw: C={c} exceeds the kernel's 768-channel limit")
    if not _on_cuda(x, w, b, res):
        out = conv1x1_chw_plain(x, w, b, res, want_stats)
        return out if want_stats else (out, None, None)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if want_stats:
        s1, s2 = _zeros_f32(co, x), _zeros_f32(co, x)
    wf, bf = _f32(w.reshape(co, c)), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), _ptr(res), y.data_ptr(),
            _ptr(s1), _ptr(s2), n, c, h * wd, co, _bf16(x), _stream(x),
        )
    _raise_on(rc, "conv1x1_chw")
    LAUNCHES["conv1x1_chw"] += 1
    return y, s1, s2


class _Conv1x1Chw(torch.autograd.Function):
    """K3 forward (+ stats); backward K8, dx by K3 with Wᵀ, dW by K3-dW."""

    @staticmethod
    def forward(ctx, x, w, b, res, want_stats):
        ctx.set_materialize_grads(False)
        y, s1, s2 = _conv1x1_fwd(x, w, b, res, want_stats)
        ctx.want_stats = want_stats
        ctx.save_for_backward(x, w, y if want_stats else None)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, g, gs1=None, gs2=None):
        x, w, y = ctx.saved_tensors
        co, c = w.shape[0], x.shape[1]
        if g is None:  # only the stats have cotangents
            g = torch.zeros_like(y)
        g = _with_stats_ct(g, y, gs1, gs2) if ctx.want_stats else g.contiguous()
        need = ctx.needs_input_grad
        dx = dw = db = None
        if need[0]:
            # the forward kernel with transposed weights and no bias, as the
            # reference's _conv1x1_bwd_rule does
            wt = w.reshape(co, c).t()
            dx, _, _ = _conv1x1_fwd(g, wt, torch.zeros(c, dtype=torch.float32, device=g.device),
                                    None, False)
        if need[1] or need[2]:
            dwm, db = conv1x1_chw_dw(x, g)
            dw = dwm.reshape(w.shape)
        return dx, dw, db, (g if need[3] else None), None


def conv1x1_chw(x, w, b) -> torch.Tensor:
    """K3: y = W x + b per pixel on (N, C, H, W); w (Co, C, 1, 1) or (Co, C)."""
    return _Conv1x1Chw.apply(x, w, b, None, False)


def conv1x1_chw_add(x, w, b, res, want_stats: bool = False):
    """K3 with the residual add fused: y = W x + b + res (the ResBlock
    shortcut plus ``out + shortcut``). With ``want_stats`` returns
    (y, Σy, Σy²) like :func:`conv3x3_chw`."""
    return _Conv1x1Chw.apply(x, w, b, res, want_stats)


def conv1x1_chw_plain(x, w, b, res=None, want_stats: bool = False):
    """Plain PyTorch version of :func:`conv1x1_chw` / :func:`conv1x1_chw_add`."""
    co, c = w.shape[0], x.shape[1]
    y = F.conv2d(x.float(), w.float().reshape(co, c, 1, 1), b.float())
    if res is not None:
        y = y + res.float()
    y = y.to(x.dtype)
    if want_stats:
        return (y, *_stats_plain(y))
    return y


def conv1x1_chw_dw(x, g):
    """K3-dW: dW[o, c] = Σ g[o]·x[c] and db[o] = Σ g[o], float32 sums over
    (N, H, W). Returns (dW (Co, C), db (Co,))."""
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"x, g: expected (N, C, H, W), got {tuple(x.shape)}, {tuple(g.shape)}")
    n, c, h, wd = x.shape
    co = g.shape[1]
    _check_act("x", x, (n, c, h, wd))
    _check_act("g", g, (n, co, h, wd))
    _check_same_dtype("g", g, x)
    if c * co > 4096 or c + co > 96:
        raise ValueError(f"conv1x1_chw_dw: C={c}, Co={co} exceed the kernel's limits "
                         "(C*Co <= 4096, C+Co <= 96)")
    if not _on_cuda(x, g):
        return conv1x1_chw_dw_plain(x, g)
    dw = torch.zeros((co, c), dtype=torch.float32, device=x.device)
    db = _zeros_f32(co, x)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw_dw(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, c, h * wd, co, _bf16(x), _stream(x),
        )
    _raise_on(rc, "conv1x1_chw_dw")
    LAUNCHES["conv1x1_chw_dw"] += 1
    return dw, db


def conv1x1_chw_dw_plain(x, g):
    """Plain PyTorch version of :func:`conv1x1_chw_dw`."""
    gf = g.float()
    return torch.einsum("nohw,nchw->oc", gf, x.float()), gf.sum(dim=(0, 2, 3))


# ---------------------------------------------------------------------------
# K4: nearest-2x upsample and its adjoint (csrc/upsample2_chw.cu)


def _upsample2_fwd(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    _check_act("x", x, tuple(x.shape))
    if not _on_cuda(x):
        return upsample2_chw_plain(x)
    n, c, h, wd = x.shape
    y = torch.empty((n, c, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upsample2_chw(x.data_ptr(), y.data_ptr(), n * c, h, wd, _bf16(x), _stream(x))
    _raise_on(rc, "upsample2_chw")
    LAUNCHES["upsample2_chw"] += 1
    return y


class _Upsample2Chw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _upsample2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2_chw_bwd(g.contiguous())


def upsample2_chw(x: torch.Tensor) -> torch.Tensor:
    """K4: y[n, c, 2i+a, 2j+b] = x[n, c, i, j] on (N, C, H, W);
    differentiable (backward :func:`upsample2_chw_bwd`)."""
    return _Upsample2Chw.apply(x)


def upsample2_chw_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample2_chw`."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def upsample2_chw_bwd(g: torch.Tensor) -> torch.Tensor:
    """K4's adjoint: dx[i, j] = (g[2i, 2j] + g[2i, 2j+1]) + (g[2i+1, 2j] +
    g[2i+1, 2j+1]), summed in float32 in that order (the reference's
    column pair-sum, then row pair-sum) and stored in g's dtype."""
    if g.dim() != 4 or g.shape[2] % 2 or g.shape[3] % 2:
        raise ValueError(f"g: expected (N, C, 2H, 2W), got shape {tuple(g.shape)}")
    _check_act("g", g, tuple(g.shape))
    if not _on_cuda(g):
        return upsample2_chw_bwd_plain(g)
    n, c, h2, w2 = g.shape
    dx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        rc = _lib().itg_upsample2_chw_bwd(g.data_ptr(), dx.data_ptr(), n * c, h2 // 2, w2 // 2,
                                          _bf16(g), _stream(g))
    _raise_on(rc, "upsample2_chw_bwd")
    LAUNCHES["upsample2_chw_bwd"] += 1
    return dx


def upsample2_chw_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample2_chw_bwd`."""
    gf = g.float()
    top = gf[:, :, 0::2, 0::2] + gf[:, :, 0::2, 1::2]
    bot = gf[:, :, 1::2, 0::2] + gf[:, :, 1::2, 1::2]
    return (top + bot).to(g.dtype)


# ---------------------------------------------------------------------------
# K9: nearest-2x -> BN fold -> ReLU -> border -> 3x3 conv as one
# half-resolution pass, and its backward (csrc/upconv3x3_chw.cu); K10: the
# fused block's up2(shortcut) + residual (+ stats) (csrc/upsample2_chw.cu)

# The phase algebra (the reference's _upconv_selectors, pallas_conv.py:1254):
# output row 2i + d reads half-res rows i - 1 + d + t, t in {0, 1}, through
# the combined row taps K0 | K1 + K2 (d = 0) and K0 + K1 | K2 (d = 1); the
# same on columns. Built from slices and adds of the weights on their own
# device, so that a wrapper copies nothing from the host (and can be
# captured in a CUDA graph).


def _combine(w: torch.Tensor, axis: int) -> torch.Tensor:
    """A 3-tap axis -> the 4 slots (d, t) = (0, 0), (0, 1), (1, 0), (1, 1)."""
    k0, k1, k2 = w.unbind(axis)
    return torch.stack([k0, k1 + k2, k0 + k1, k2], dim=axis)


def _uncombine(d: torch.Tensor, axis: int) -> torch.Tensor:
    """The transpose of :func:`_combine`: 4 slots -> 3 taps."""
    s0, s1, s2, s3 = d.unbind(axis)
    return torch.stack([s0 + s2, s1 + s2, s1 + s3], dim=axis)


def _upconv_phase_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> (Co, C, 16) float32: the four output phases' combined
    2x2 kernels, tap index ((di*2 + dj)*2 + r)*2 + s, which the forward
    kernel reads."""
    co, c = w.shape[:2]
    wc = _combine(_combine(w.detach().float(), 2), 3)  # (Co, C, (di, r), (dj, s))
    return wc.reshape(co, c, 2, 2, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(co, c, 16).contiguous()


def _upconv_dx_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> (Co, C, 4, 4) float32 wt with dA[p, q] =
    Σ_o Σ_uv wt[o, :, u, v]·g[o, 2p-1+u, 2q-1+v]: the stride-2 transposed
    form the dx kernel gathers with (full-res row 2p-1+u reaches half-res
    row p through the taps K2, K1 + K2, K0 + K1, K0 for u = 0..3)."""
    def taps4(a, axis):
        k0, k1, k2 = a.unbind(axis)
        return torch.stack([k2, k1 + k2, k0 + k1, k0], dim=axis)

    return taps4(taps4(w.detach().float(), 2), 3).contiguous()


def _upconv_unpack_dw(dwc: torch.Tensor) -> torch.Tensor:
    """(Co, C, 16) per-phase-tap weight gradients -> (Co, C, 3, 3): the
    transpose of :func:`_upconv_phase_weights`."""
    co, c = dwc.shape[:2]
    d = dwc.reshape(co, c, 2, 2, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(co, c, 4, 4)
    return _uncombine(_uncombine(d, 2), 3)


def _upconv_fwd(x, w, b, scale, shift, relu, outer_padding, want_stats):
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    if not _on_cuda(x, w, b, scale, shift):
        out = upconv3x3_chw_plain(x, w, b, scale, shift, relu, outer_padding, want_stats)
        return out if want_stats else (out, None, None)
    n, c, h, wd = x.shape
    co = w.shape[0]
    y = torch.empty((n, co, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if want_stats:
        s1, s2 = _zeros_f32(co, x), _zeros_f32(co, x)
    wc, bf, sc, sh = _upconv_phase_weights(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw(
            x.data_ptr(), wc.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            y.data_ptr(), _ptr(s1), _ptr(s2),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "upconv3x3_chw")
    LAUNCHES["upconv3x3_chw"] += 1
    return y, s1, s2


class _UpConv3x3Chw(torch.autograd.Function):
    """K9 forward (+ stats); backward K8 (when the stats have cotangents),
    K9 dx, K9 dW."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, relu, outer_padding, want_stats):
        ctx.set_materialize_grads(False)
        y, s1, s2 = _upconv_fwd(x, w, b, scale, shift, relu, outer_padding, want_stats)
        ctx.relu, ctx.outer_padding, ctx.want_stats = relu, outer_padding, want_stats
        ctx.save_for_backward(x, w, scale, shift, y if want_stats else None)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, g, gs1=None, gs2=None):
        x, w, scale, shift, y = ctx.saved_tensors
        if g is None:  # only the stats have cotangents
            g = torch.zeros_like(y)
        g = _with_stats_ct(g, y, gs1, gs2) if ctx.want_stats else g.contiguous()
        need = ctx.needs_input_grad
        dx = dw = db = dsc = dsh = None
        if need[0] or need[3] or need[4]:
            dx, dsc, dsh = upconv3x3_chw_dx(x, g, w, scale, shift, ctx.relu, ctx.outer_padding)
        if need[1] or need[2]:
            dw, db = upconv3x3_chw_dw(x, g, scale, shift, ctx.relu, ctx.outer_padding)
        return dx, dw, db, dsc, dsh, None, None, None


def upconv3x3_chw(x, w, b, scale, shift, relu: bool = True,
                  outer_padding: str = "replicate", want_stats: bool = False):
    """K9: y = conv3x3(pad1(up2(act(scale*x + shift)))) + b, x (N, C, H, W)
    at half resolution -> y (N, Co, 2H, 2W), run as four half-resolution
    phase convs with combined 2x2 kernels (the reference's
    ``upconv3x3_chw_p``). Arguments as :func:`conv3x3_chw`; the outer pad is
    replicate or zeros, post-norm. With ``want_stats`` returns (y, Σy, Σy²)
    of the stored y. Differentiable in x, w, b, scale, shift and through the
    stats. Equals :func:`upconv3x3_chw_plain` up to the regrouped float
    additions of the combined kernels."""
    return _UpConv3x3Chw.apply(x, w, b, scale, shift, relu, outer_padding, want_stats)


def upconv3x3_chw_plain(x, w, b, scale, shift, relu: bool = True,
                        outer_padding: str = "replicate", want_stats: bool = False):
    """Plain PyTorch version of :func:`upconv3x3_chw`: the unfused pair,
    :func:`upsample2_chw_plain` then :func:`conv3x3_chw_plain` (independent
    of the phase algebra)."""
    return conv3x3_chw_plain(upsample2_chw_plain(x), w, b, scale, shift, relu, outer_padding,
                             want_stats)


def upconv3x3_chw_dx(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """K9 dx: the input-side gradient of :func:`upconv3x3_chw` from ``g``
    (N, Co, 2H, 2W). da is the transposed conv of g summed over each 2x2
    child block, with the replicate border folds (corners twice) on the
    half-res slab or none (zeros), masked by the ReLU of ``scale*x + shift``.
    Returns (dx = da·scale in x's dtype, d(scale) = Σ da·x, d(shift) = Σ da),
    the sums in float32 over (N, H, W)."""
    zeros = _check_padding(outer_padding)
    co = w.shape[0]
    _check_bwd(x, g, co, scale, shift, up=2)
    _check_param("w", w, (co, x.shape[1], 3, 3))
    if not _on_cuda(x, g, w, scale, shift):
        return upconv3x3_chw_dx_plain(x, g, w, scale, shift, relu, outer_padding)
    n, c, h, wd = x.shape
    dx = torch.empty_like(x)
    dsc, dsh = _zeros_f32(c, x), _zeros_f32(c, x)
    wt, sc, sh = _upconv_dx_weights(w), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw_dx(
            x.data_ptr(), g.data_ptr(), wt.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            dx.data_ptr(), dsc.data_ptr(), dsh.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "upconv3x3_chw_dx")
    LAUNCHES["upconv3x3_chw_dx"] += 1
    return dx, dsc, dsh


def upconv3x3_chw_dx_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`upconv3x3_chw_dx`: the pair's
    :func:`conv3x3_chw_dx_plain` on up2(x) in float32, then
    :func:`upsample2_chw_bwd_plain`, rounded once to x's dtype."""
    dx, dsc, dsh = conv3x3_chw_dx_plain(upsample2_chw_plain(x).float(), g, w, scale, shift, relu,
                                        outer_padding)
    return upsample2_chw_bwd_plain(dx).to(x.dtype), dsc, dsh


def upconv3x3_chw_dw(x, g, scale, shift, relu: bool, outer_padding: str):
    """K9 dW: dW (Co, C, 3, 3) and db (Co,) of :func:`upconv3x3_chw`, float32
    sums over (N, 2H, 2W). The kernel sums per phase tap (Co, C, 16) from the
    half-res slab; the wrapper folds them back to the 3x3 taps."""
    zeros = _check_padding(outer_padding)
    co = g.shape[1]
    _check_bwd(x, g, co, scale, shift, up=2)
    if not _on_cuda(x, g, scale, shift):
        return upconv3x3_chw_dw_plain(x, g, scale, shift, relu, outer_padding)
    n, c, h, wd = x.shape
    dwc = torch.zeros((co, c, 16), dtype=torch.float32, device=x.device)
    db = _zeros_f32(co, x)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw_dw(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), dwc.data_ptr(),
            db.data_ptr(), n, c, h, wd, co, int(relu), int(zeros), _bf16(x), _stream(x),
        )
    _raise_on(rc, "upconv3x3_chw_dw")
    LAUNCHES["upconv3x3_chw_dw"] += 1
    return _upconv_unpack_dw(dwc), db


def upconv3x3_chw_dw_plain(x, g, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`upconv3x3_chw_dw`: the pair's
    :func:`conv3x3_chw_dw_plain` on up2(x)."""
    return conv3x3_chw_dw_plain(upsample2_chw_plain(x), g, scale, shift, relu, outer_padding)


def _up2add_fwd(x, res, want_stats):
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    _check_act("x", x, (n, c, h, wd))
    _check_act("res", res, (n, c, 2 * h, 2 * wd))
    _check_same_dtype("res", res, x)
    if not _on_cuda(x, res):
        out = upsample2_chw_add_plain(x, res, want_stats)
        return out if want_stats else (out, None, None)
    y = torch.empty_like(res)
    s1 = s2 = None
    if want_stats:
        s1, s2 = _zeros_f32(c, x), _zeros_f32(c, x)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upsample2_chw_add(
            x.data_ptr(), res.data_ptr(), y.data_ptr(), _ptr(s1), _ptr(s2),
            n * c, c, h, wd, _bf16(x), _stream(x),
        )
    _raise_on(rc, "upsample2_chw_add")
    LAUNCHES["upsample2_chw_add"] += 1
    return y, s1, s2


class _Upsample2ChwAdd(torch.autograd.Function):
    """K10 forward (+ stats); backward K8 (when the stats have cotangents),
    then dx by K4's adjoint and dres = the corrected cotangent (the
    reference's _up2add_bwd_rule)."""

    @staticmethod
    def forward(ctx, x, res, want_stats):
        ctx.set_materialize_grads(False)
        y, s1, s2 = _up2add_fwd(x, res, want_stats)
        ctx.want_stats = want_stats
        ctx.save_for_backward(y if want_stats else None)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, g, gs1=None, gs2=None):
        (y,) = ctx.saved_tensors
        if g is None:  # only the stats have cotangents
            g = torch.zeros_like(y)
        g = _with_stats_ct(g, y, gs1, gs2) if ctx.want_stats else g.contiguous()
        need = ctx.needs_input_grad
        return (upsample2_chw_bwd(g) if need[0] else None), (g if need[1] else None), None


def upsample2_chw_add(x, res, want_stats: bool = False):
    """K10: y = up2(x) + res, x (N, C, H, W), res (N, C, 2H, 2W) of the same
    dtype: the fused up-conv block's upsampled half-res shortcut joined with
    its residual. With ``want_stats`` returns (y, Σy, Σy²) of the stored y.
    The reference's ``upsample2_chw_add_p`` also fills the 128-lane pad
    columns of a padded carry; the port has no padding, so there is no fill.
    Differentiable in x and res and through the stats."""
    return _Upsample2ChwAdd.apply(x, res, want_stats)


def upsample2_chw_add_plain(x, res, want_stats: bool = False):
    """Plain PyTorch version of :func:`upsample2_chw_add`."""
    y = upsample2_chw_plain(x) + res
    if want_stats:
        return (y, *_stats_plain(y))
    return y


# ---------------------------------------------------------------------------
# K13: the discriminator stem, 4x4 / stride 2 / zero pad 1 (csrc/stem4x4s2.cu)


def _check_stem(x, w):
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    _check_act("x", x, (n, c, h, wd))
    if h % 2 or wd % 2:
        raise ValueError(f"stem: H and W must be even, got {h}x{wd}")
    if c > 4:
        raise ValueError(f"stem: C={c} exceeds the kernel's 4-channel limit")
    _check_param("w", w, (w.shape[0], c, 4, 4))


def stem_fwd(x, w, b):
    """K13 forward: y = conv4x4/s2/pad1(x) + b with x channels-major
    (N, C, H, W) and y NHWC (N, H/2, W/2, Co), in x's dtype."""
    _check_stem(x, w)
    co = w.shape[0]
    _check_param("b", b, (co,))
    if not _on_cuda(x, w, b):
        return stem_fwd_plain(x, w, b)
    n, c, h, wd = x.shape
    y = torch.empty((n, h // 2, wd // 2, co), dtype=x.dtype, device=x.device)
    wf, bf = _f32(w), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_fwd(x.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(),
                                 n, c, h, wd, co, _bf16(x), _stream(x))
    _raise_on(rc, "stem_fwd")
    LAUNCHES["stem_fwd"] += 1
    return y


def stem_fwd_plain(x, w, b):
    """Plain PyTorch version of :func:`stem_fwd`."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def stem_dw(x, g):
    """K13 dW: dW[o, c, ky, kx] = Σ g[n, i, j, o]·x[n, c, 2i+ky-1, 2j+kx-1]
    (zero outside the image) and db = Σ g, float32 sums. ``g`` NHWC."""
    _check_stem(x, torch.empty(g.shape[-1], x.shape[1], 4, 4))
    n, c, h, wd = x.shape
    co = g.shape[-1]
    _check_act("g", g, (n, h // 2, wd // 2, co))
    _check_same_dtype("g", g, x)
    if not _on_cuda(x, g):
        return stem_dw_plain(x, g)
    dw = torch.zeros((co, c, 4, 4), dtype=torch.float32, device=x.device)
    db = _zeros_f32(co, x)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                n, c, h, wd, co, _bf16(x), _stream(x))
    _raise_on(rc, "stem_dw")
    LAUNCHES["stem_dw"] += 1
    return dw, db


def stem_dw_plain(x, g):
    """Plain PyTorch version of :func:`stem_dw` (one einsum per tap)."""
    xp = F.pad(x.float(), (1, 1, 1, 1))
    gf = g.float()
    h2, w2 = g.shape[1:3]
    taps = [torch.einsum("nhwo,nchw->oc", gf, xp[:, :, ky : ky + 2 * h2 : 2, kx : kx + 2 * w2 : 2])
            for ky in range(4) for kx in range(4)]
    dw = torch.stack(taps, dim=-1).reshape(g.shape[-1], x.shape[1], 4, 4)
    return dw, gf.sum(dim=(0, 1, 2))


def stem_dx(g, w):
    """K13 dx: the image-side gradient, channels-major (N, C, 2·H2, 2·W2)
    in g's dtype, from the NHWC cotangent ``g`` (N, H2, W2, Co)."""
    if g.dim() != 4:
        raise ValueError(f"g: expected (N, H2, W2, Co), got shape {tuple(g.shape)}")
    n, h2, w2, co = g.shape
    _check_act("g", g, (n, h2, w2, co))
    c = w.shape[1]
    _check_param("w", w, (co, c, 4, 4))
    if c > 4:
        raise ValueError(f"stem: C={c} exceeds the kernel's 4-channel limit")
    if not _on_cuda(g, w):
        return stem_dx_plain(g, w)
    dx = torch.empty((n, c, 2 * h2, 2 * w2), dtype=g.dtype, device=g.device)
    wf = _f32(w)
    with torch.cuda.device(g.device):
        rc = _lib().itg_stem_dx(g.data_ptr(), wf.data_ptr(), dx.data_ptr(),
                                n, c, 2 * h2, 2 * w2, co, _bf16(g), _stream(g))
    _raise_on(rc, "stem_dx")
    LAUNCHES["stem_dx"] += 1
    return dx


def stem_dx_plain(g, w):
    """Plain PyTorch version of :func:`stem_dx` (F.conv_transpose2d)."""
    gc = g.float().permute(0, 3, 1, 2)
    return F.conv_transpose2d(gc, w.float(), stride=2, padding=1).to(g.dtype)


class _StemChw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return stem_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad
        dx = dw = db = None
        if need[0]:
            dx = stem_dx(g, w)
        if need[1] or need[2]:
            dw, db = stem_dw(x, g)
        return dx, dw, db


def conv4x4s2_stem_chw(x, w, b):
    """K13: the discriminator's conv0 on a channels-major image,
    (N, C, H, W) -> NHWC (N, H/2, W/2, Co); w (Co, C, 4, 4) is the
    (spectrally normalised) kernel. Differentiable: dx by :func:`stem_dx`,
    dW/db by :func:`stem_dw`, each only when autograd needs it."""
    return _StemChw.apply(x, w, b)
