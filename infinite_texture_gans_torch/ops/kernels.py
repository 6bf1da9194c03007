"""The generator tail's kernels: wrappers, plain versions and launch counts.

Counterpart of ``infinite_texture_gans_tpu/ops/pallas_conv.py`` for the eval
forward. Four functions of the reference reach a Pallas kernel on the
generation path; each has a hand-written CUDA kernel in ``csrc/``:

- K1 ``conv3x3_chw``: replaces pallas_conv.py:344 ``_conv3x3_chw_fwd``
  (csrc/conv3x3_chw.cu);
- K2 ``chw_halo_step``, whose kernel wrapper is ``conv3x3_chw_halo``:
  replaces pallas_conv.py:482 ``_conv3x3_chw_fwd_halo`` (the same
  csrc/conv3x3_chw.cu, given the cached borders);
- K3 ``conv1x1_chw`` / ``conv1x1_chw_add``: replaces pallas_conv.py:2276
  ``_conv1x1_chw_fwd`` (csrc/conv1x1_chw.cu);
- K4 ``upsample2_chw``: replaces pallas_conv.py:2535 ``_up2_fwd_call``
  (csrc/upsample2_chw.cu).

Activations are channels-major (N, C, H, W), float32 or bfloat16; the
kernels compute in float32 and store in the activation type. Weights are
OIHW. Every wrapper checks device, dtype, shape and contiguity. For a CPU
tensor it runs the plain PyTorch version beside it; for a CUDA tensor it
launches its kernel on the current stream, raises if the launch reports an
error, and adds one to its entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from infinite_texture_gans_torch.ops.padding import GridPos, SiteState

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"conv3x3_chw": 0, "chw_halo_step": 0, "conv1x1_chw": 0, "upsample2_chw": 0}

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


def prenorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """act(scale * x + shift) per channel (dim 1), in float32, rounded to
    x's dtype: the post-norm values the conv kernels read and the halo cache
    holds."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    a = x.float() * scale.float().reshape(shape) + shift.float().reshape(shape)
    if relu:
        a = torch.relu(a)
    return a.to(x.dtype)


# ---------------------------------------------------------------------------
# K1 / K2: BN fold -> ReLU -> border -> 3x3 conv (csrc/conv3x3_chw.cu)


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


def _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left) -> torch.Tensor:
    n, c, h, wd = x.shape
    co = w.shape[0]
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    wf, bf, sc, sh = _f32(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            top.data_ptr() if top is not None else None,
            left.data_ptr() if left is not None else None,
            y.data_ptr(), n, c, h, wd, co, int(relu), int(zeros),
            int(x.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(rc, "conv3x3_chw")
    return y


def conv3x3_chw(x, w, b, scale, shift, relu: bool = True,
                outer_padding: str = "replicate") -> torch.Tensor:
    """K1: y = conv3x3(pad1(act(scale*x + shift))) + b on (N, C, H, W).

    w (Co, C, 3, 3); b (Co,); scale/shift (C,) are a folded eval BatchNorm
    (ones/zeros and relu=False for a plain padded conv). The outer pad is
    replicate or zeros ('constant') and is applied post-norm."""
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    if not _on_cuda(x, w, b, scale, shift):
        return conv3x3_chw_plain(x, w, b, scale, shift, relu, outer_padding)
    y = _launch_conv3x3(x, w, b, scale, shift, relu, zeros, None, None)
    LAUNCHES["conv3x3_chw"] += 1
    return y


def conv3x3_chw_plain(x, w, b, scale, shift, relu: bool = True,
                      outer_padding: str = "replicate") -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_chw` (F.pad + F.conv2d)."""
    a = prenorm(x, scale, shift, relu).float()
    mode = "replicate" if outer_padding == "replicate" else "constant"
    a = F.pad(a, (1, 1, 1, 1), mode=mode)
    return F.conv2d(a, w.float(), b.float()).to(x.dtype)


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
    if left is not None:
        _check_act("left", left, (n, c, h))
    for name, t in (("top", top), ("left", left)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
    if not _on_cuda(x, w, b, scale, shift, top, left):
        return conv3x3_chw_halo_plain(x, w, b, scale, shift, relu, outer_padding, top, left)
    y = _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left)
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
# K3: 1x1 conv + bias (+ residual) (csrc/conv1x1_chw.cu)


def _conv1x1(x, w, b, res):
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    co = w.shape[0]
    _check_act("x", x, (n, c, h, wd))
    _check_param("w", w.reshape(co, -1), (co, c))
    _check_param("b", b, (co,))
    if res is not None:
        _check_act("res", res, (n, co, h, wd))
        if res.dtype != x.dtype:
            raise TypeError(f"res dtype {res.dtype} != x dtype {x.dtype}")
    if c > 768:
        raise ValueError(f"conv1x1_chw: C={c} exceeds the kernel's 768-channel limit")
    if not _on_cuda(x, w, b, res):
        return conv1x1_chw_plain(x, w, b, res)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    wf, bf = _f32(w.reshape(co, c)), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(),
            res.data_ptr() if res is not None else None, y.data_ptr(),
            n, c, h * wd, co, int(x.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(rc, "conv1x1_chw")
    LAUNCHES["conv1x1_chw"] += 1
    return y


def conv1x1_chw(x, w, b) -> torch.Tensor:
    """K3: y = W x + b per pixel on (N, C, H, W); w (Co, C, 1, 1) or (Co, C)."""
    return _conv1x1(x, w, b, None)


def conv1x1_chw_add(x, w, b, res) -> torch.Tensor:
    """K3 with the residual add fused: y = W x + b + res (the ResBlock
    shortcut plus ``out + shortcut``)."""
    return _conv1x1(x, w, b, res)


def conv1x1_chw_plain(x, w, b, res=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv1x1_chw` / :func:`conv1x1_chw_add`."""
    co, c = w.shape[0], x.shape[1]
    y = F.conv2d(x.float(), w.float().reshape(co, c, 1, 1), b.float())
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# K4: nearest-2x upsample (csrc/upsample2_chw.cu)


def upsample2_chw(x: torch.Tensor) -> torch.Tensor:
    """K4: y[n, c, 2i+a, 2j+b] = x[n, c, i, j] on (N, C, H, W)."""
    if x.dim() != 4:
        raise ValueError(f"x: expected (N, C, H, W), got shape {tuple(x.shape)}")
    _check_act("x", x, tuple(x.shape))
    if not _on_cuda(x):
        return upsample2_chw_plain(x)
    n, c, h, wd = x.shape
    y = torch.empty((n, c, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upsample2_chw(
            x.data_ptr(), y.data_ptr(), n * c, h, wd,
            int(x.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(rc, "upsample2_chw")
    LAUNCHES["upsample2_chw"] += 1
    return y


def upsample2_chw_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample2_chw`."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
