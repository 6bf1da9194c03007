"""The channels-major kernels: wrappers, plain versions and launch counts.

Counterpart of ``infinite_texture_gans_tpu/ops/pallas_conv.py``. Every
function of the reference that reaches a Pallas kernel (generation under
every ``--fuse_up``, the training step under ``auto`` and ``off``, BN and
SSM) has a hand-written CUDA kernel in ``csrc/``:

- K1/K5 ``conv3x3_chw`` (forward, with the optional per-channel Σy, Σy²
  of ``conv3x3_chw_stats`` / ``conv3x3_chw_p``): replaces pallas_conv.py:395
  ``_conv3x3_chw_fwd`` (csrc/conv3x3_fwd_f32.cu; in bf16: csrc/chw_fwd_tc.cu);
- K2 ``chw_halo_step``, whose kernel wrapper is ``conv3x3_chw_halo``:
  replaces pallas_conv.py:539 ``_conv3x3_chw_fwd_halo`` (the same two
  sources, given the cached borders);
- K6 ``conv3x3_chw_dx``: pallas_conv.py:775 ``_conv3x3_chw_dx``
  (csrc/conv3x3_dx_f32.cu, on :func:`conv3x3_dx_f32_plan`'s grid; in bf16:
  csrc/chw_dx_tc.cu); K7 ``conv3x3_chw_dw``: :888 ``_conv3x3_chw_dw``
  (csrc/conv3x3_dw_f32.cu, on :func:`conv3x3_dw_f32_plan`'s grid; in bf16:
  csrc/chw_dw_tc.cu); K8 ``bn_corr``: :1061 ``_bn_corr``
  (csrc/conv3x3_chw_bwd.cu);
- K3 ``conv1x1_chw`` / ``conv1x1_chw_add`` (optionally with stats, the
  ``conv1x1_chw_add_stats`` / ``conv1x1_chw_add_p`` forms, and the dx form
  with Wᵀ): replaces pallas_conv.py:2311 ``_conv1x1_chw_fwd``; its dW
  ``conv1x1_chw_dw``: :2361 ``_conv1x1_chw_dw`` (csrc/conv1x1_chw.cu, the
  dW in csrc/conv1x1_dw_f32.cu; both in bf16: csrc/conv1x1_tc.cu);
- K4 ``upsample2_chw``: pallas_conv.py:2540 ``_up2_fwd_call``; its adjoint
  ``upsample2_chw_bwd``: :2560 ``_up2_bwd_call`` (csrc/upsample2_chw.cu);
- K9 ``upconv3x3_chw``, the subpixel-fused upsample -> BN fold -> ReLU ->
  3x3 conv of ``upconv3x3_chw_p`` (optionally with stats): forward :1457
  ``_upconv3x3_fwd``, ``upconv3x3_chw_dx`` :1642 ``_upconv3x3_dx``,
  ``upconv3x3_chw_dw`` :1777 ``_upconv3x3_dw`` (csrc/upconv_fwd_f32.cu, on
  :func:`upconv_f32_plan`'s grid, the dx in csrc/upconv_dx_f32.cu, the dW in
  csrc/upconv_dw_f32.cu, on :func:`upconv_dw_f32_plan`'s grid; the forward in
  bf16: csrc/upconv_fwd_tc.cu; the dx in bf16: csrc/chw_dx_tc.cu; the dW in
  bf16: csrc/upconv_dw_tc.cu);
- K14 ``chw_upconv_halo_step``, whose kernel wrapper is
  ``upconv3x3_chw_halo``: K9's forward in the raster engine under
  ``--fuse_up all``, replaces :2019 ``_upconv3x3_fwd_halo`` (the same two
  sources, given the cached half-res borders);
- K10 ``upsample2_chw_add``: :2199 ``upsample2_chw_add_p``, the fused
  block's up2(shortcut) + residual (+ stats) (csrc/upsample2_chw.cu);
- K13 ``conv4x4s2_stem_chw``: the discriminator's conv0, forward
  ``stem_fwd`` :2769 ``_stem_fwd_call``, ``stem_dw`` :2840 ``_stem_dw_call``,
  ``stem_dx`` :2977 ``_stem_dx_call`` (in float32 csrc/stem_fwd_f32.cu,
  csrc/stem_dw_f32.cu and csrc/stem_dx_f32.cu; in bf16 csrc/stem_fwd_tc.cu,
  csrc/stem_dw_tc.cu and csrc/stem_dx_tc.cu).

The SSM embed chain K15 (``pallas_ssm.py:343/:392``) lives in
``ops/ssm.py`` (csrc/ssm_embed_chw.cu); its launches count here too, under
``ssm_embed`` and ``ssm_embed_bwd``.

K1 and K2 route by the activations' dtype, with no fallback: bfloat16 takes
one tensor-core kernel body for both (``csrc/chw_fwd_tc.cu``, entry point
``itg_conv3x3_chw_tc``: an implicit GEMM on mma.sync with every output
channel in one block, the weights rounded to bf16 as the reference rounds
them, pallas_conv.py:615/:949/:999/:1093, K5's sums in a fixed order; its
plain versions ``conv3x3_chw_tc_plain`` and ``conv3x3_chw_halo_tc_plain``
apply the same rounding), float32 the CUDA-core kernel
(``itg_conv3x3_chw``, on :func:`conv3x3_f32_plan`'s grid). K9's forward
and K14 route the same way: bfloat16
takes one tensor-core body for both (``csrc/upconv_fwd_tc.cu``, entry point
``itg_upconv3x3_chw_tc``: K1's implicit GEMM at half resolution, four phase
B operands with the combined 2x2 weights rounded to bf16 as the reference
rounds them, pallas_conv.py:1819/:2094, the phase row a grid axis, whole
full-res rows stored, the sums in a fixed order; plain versions
``upconv3x3_chw_tc_plain`` and ``upconv3x3_chw_halo_tc_plain``), float32
``itg_upconv3x3_chw`` (K1's scheme at half resolution: 8 half-res pixels x
TO output channels x 4 phases a thread, on :func:`upconv_f32_plan`'s grid,
the sums in a fixed order). The two input-side gradients K6 and K9 dx route by
the activations' dtype the same way: bfloat16 takes one tensor-core kernel body
(``csrc/chw_dx_tc.cu``, entry points ``itg_conv3x3_chw_dx_tc`` and
``itg_upconv3x3_chw_dx_tc``: implicit GEMMs on mma.sync, the weights rounded
to bf16 as the reference rounds them, pallas_conv.py:971 and :1637-1639;
their plain versions ``conv3x3_chw_dx_tc_plain`` and
``upconv3x3_chw_dx_tc_plain`` apply the same rounding), float32 the
CUDA-core kernels (``itg_conv3x3_chw_dx``: 16-pixel runs x 7 input channels
a thread, on :func:`conv3x3_dx_f32_plan`'s grid, the border folds on the g
values in registers; ``itg_upconv3x3_chw_dx``), both with fixed-order
partial sums. K7 routes the same way: bfloat16 takes
``itg_conv3x3_chw_dw_tc`` (mma.sync on pixel-major staged post-norm tiles,
fixed-order partial sums; its operands are bf16 values, so it needs no
rounded plain version), float32 ``itg_conv3x3_chw_dw`` (persistent blocks
on :func:`conv3x3_dw_f32_plan`'s grid, chunks through a cp.async ring, 3 x
13 channel tiles a row tap, fixed-order partial sums). K13's forward routes the same way: bfloat16 takes
``itg_stem_fwd_tc`` (an implicit GEMM on mma.sync straight from the staged
image rows, NHWC rows written 16 bytes a lane; the weights and bias rounded
to bf16 as the reference rounds them, pallas_conv.py:3041/:3045, its plain
version ``stem_fwd_tc_plain``), float32 ``itg_stem_fwd``. The two weight
gradients K9 dW and K13 dW route the same way: bfloat16 takes
``itg_upconv3x3_chw_dw_tc`` (csrc/upconv_dw_tc.cu: K7's body at half
resolution, the 16 phase taps as row addresses of one staged post-norm
slab, g's full-res rows split by column parity into four B operands) and
``itg_stem_dw_tc`` (csrc/stem_dw_tc.cu: one GEMM of the 16 C taps by the
output channels over the pixels, B straight from g's NHWC rows, A from
stride-2 shifted copies of the image rows), both with fixed-order
per-block partials and no atomics; their operands are bf16 values, so
their plain versions are ``upconv3x3_chw_dw_plain`` and ``stem_dw_plain``
themselves; float32 ``itg_upconv3x3_chw_dw`` (K7's scheme with the 16 phase
taps: persistent blocks on :func:`upconv_dw_f32_plan`'s grid, 2 x 4 channel
tiles a phase row, fixed-order partials folded to 3 x 3 by the last launch)
and ``itg_stem_dw`` (csrc/stem_dw_f32.cu: persistent blocks on
:func:`stem_dw_f32_plan`'s grid, 8 output channels x 4 C taps a lane,
fixed-order partials). K13 dx
routes the same way: bfloat16 takes ``itg_stem_dx_tc`` (csrc/stem_dx_tc.cu:
one mma.sync accumulator for the four sub-pixel phases of dx, each of the 9
shifts of g a row address of one staged tile, the weights rounded to bf16 as
the reference rounds them, pallas_conv.py:3071, by a pack launch; its plain
version ``stem_dx_tc_plain``), float32 ``itg_stem_dx``. K3 (forward,
with its residual and stats, and its dx form) and K3-dW route the same way:
bfloat16 takes ``itg_conv1x1_chw_tc`` (mma.sync on the channels-major x
slab read through ldmatrix.trans, every output channel up to 64 in one
block, W and b rounded to bf16 as the reference rounds them,
pallas_conv.py:2389-2390; its plain version ``conv1x1_chw_tc_plain``) and
``itg_conv1x1_chw_dw_tc`` (mma.sync on channels-major x and g tiles as they
lie in device memory, fixed-order partial sums; its operands are bf16
values, so its plain version is ``conv1x1_chw_dw_plain`` itself), float32
``itg_conv1x1_chw`` and ``itg_conv1x1_chw_dw`` (persistent blocks on
:func:`conv1x1_dw_f32_plan`'s grid, fixed-order partial sums), the exactness
route of step parity. :data:`ROUTE_LAUNCHES` counts the launches of each entry point.

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

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from infinite_texture_gans_torch.ops.padding import (
    GridPos,
    LanePos,
    SiteState,
    lane_read_row,
    lane_write_row,
)

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
    "chw_upconv_halo_step": 0,
    "upsample2_chw_add": 0,
    "stem_fwd": 0,
    "stem_dw": 0,
    "stem_dx": 0,
    # K15, the SSM embed chain (ops/ssm.py)
    "ssm_embed": 0,
    "ssm_embed_bwd": 0,
}

# launches per C entry point of K1/K2, K6, K7, K9/K14's forward, K9 dx,
# K9 dW, K13's forward, K13 dW, K13 dx, K3 and K3-dW: the bf16 tensor-core
# route and the f32 CUDA-core one (not cleared by reset_launches)
ROUTE_LAUNCHES = {"itg_conv3x3_chw_tc": 0, "itg_conv3x3_chw": 0,
                  "itg_conv3x3_chw_dx_tc": 0, "itg_conv3x3_chw_dx": 0,
                  "itg_conv3x3_chw_dw_tc": 0, "itg_conv3x3_chw_dw": 0,
                  "itg_upconv3x3_chw_tc": 0, "itg_upconv3x3_chw": 0,
                  "itg_upconv3x3_chw_dx_tc": 0, "itg_upconv3x3_chw_dx": 0,
                  "itg_upconv3x3_chw_dw_tc": 0, "itg_upconv3x3_chw_dw": 0,
                  "itg_stem_fwd_tc": 0, "itg_stem_fwd": 0,
                  "itg_stem_dw_tc": 0, "itg_stem_dw": 0,
                  "itg_stem_dx_tc": 0, "itg_stem_dx": 0,
                  "itg_conv1x1_chw_tc": 0, "itg_conv1x1_chw": 0,
                  "itg_conv1x1_chw_dw_tc": 0, "itg_conv1x1_chw_dw": 0}

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
# (bf16: csrc/chw_fwd_tc.cu; f32: csrc/conv3x3_fwd_f32.cu)


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


def _check_borders(x, top: Optional[torch.Tensor], left: Optional[torch.Tensor]) -> None:
    """The raster engine's cached borders of x (N, C, H, W): top (N, C, W+2),
    left (N, C, H), each in x's dtype, or None."""
    n, c, h, wd = x.shape
    if top is not None:
        _check_act("top", top, (n, c, wd + 2))
        _check_same_dtype("top", top, x)
    if left is not None:
        _check_act("left", left, (n, c, h))
        _check_same_dtype("left", left, x)


# The tensor-core route's tiling (csrc/chw_fwd_tc.cu): M = a tile of 8 (or
# 4, as the entry point picks from the shape) rows x 32 output pixels, N =
# the output channels padded to NO x 8 (one template per NO), K = (tap,
# input channel) with the input channels padded to NC x 8 per tap (NC up to
# 16). With stats, each of at most FWD_TC_MAX_BLOCKS persistent blocks (the
# C file's kMaxBlocks) writes its partial sums.
FWD_TC_NO = (1, 2, 4, 7, 8)
FWD_TC_MAX_NC = 16
FWD_TC_MAX_BLOCKS = 1024


def _tc_plan(c: int, co: int, what: str) -> tuple[int, int]:
    nc = -(-c // 8)
    no = next((o for o in FWD_TC_NO if 8 * o >= co), None)
    if nc > FWD_TC_MAX_NC or no is None:
        raise ValueError(f"the tensor-core {what} takes C <= {8 * FWD_TC_MAX_NC} and "
                         f"Co <= {8 * FWD_TC_NO[-1]}, got C={c}, Co={co}")
    return nc, no


def fwd_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(NC, NO) of the tensor-core forward for C input and Co output
    channels: the fewest 8-channel groups that hold C, and the fewest of
    FWD_TC_NO that hold Co. Raises for C > 128 or Co > 64 (every shape the
    models' eval gate admits, cin <= 128 with cout <= G_ch <= 64, is
    inside)."""
    return _tc_plan(c, co, "conv3x3 forward")


def pack_fwd_weights(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the tensor-core forward's weight packing (which its
    C entry point runs on the card): w (Co, C, 3, 3) -> bf16 (8 NO, 3, 3,
    8 NC), the B operand, wp[o, ky, kx, c] = w[o, c, ky, kx] rounded to
    bf16, zero past Co and C."""
    co, c = w.shape[:2]
    nc, no = fwd_tc_plan(c, co)
    wp = F.pad(w.detach().float(), (0, 0, 0, 0, 0, 8 * nc - c, 0, 8 * no - co))
    return wp.permute(0, 2, 3, 1).to(torch.bfloat16, memory_format=torch.contiguous_format)


# K1/K2's float32 route (csrc/conv3x3_fwd_f32.cu): a thread computes 16
# pixels of a row x TO output channels (TO one of CONV3X3_F32_TO), a warp
# (a group) a 16 x 32 tile's TO channels, a block G groups (G one of
# CONV3X3_F32_G) over one tile; a tile's channel chunks, its tiles and the
# images are the grid's axes. TO is 7, or 3 where Co <= 3 or where 7 would
# leave fewer than CONV3X3_F32_MIN_WARPS_PER_SM warps an SM (the wide eval
# layers at N = 1); a block takes as many groups as it can, so the input
# tile is staged and folded for as many channels at once as possible.
CONV3X3_F32_TO = (7, 3)
CONV3X3_F32_G = (4, 2, 1)
CONV3X3_F32_TILE = (16, 32)
CONV3X3_F32_MIN_WARPS_PER_SM = 4


class Conv3x3F32Plan(NamedTuple):
    to: int  # output channels of a thread
    groups: int  # ceil(Co / to)
    g: int  # groups a block
    chunks: int  # ceil(groups / g): the grid's second axis
    tiles_h: int  # ceil(H / 16) x ceil(W / 32) tiles an image
    tiles_w: int
    part_rows: int  # N x tiles: rows of the (part_rows, 2, Co) float32 partials of K5's sums


def conv3x3_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> Conv3x3F32Plan:
    """The float32 K1/K2 kernel's launch for x (N, C, H, W) and Co output
    channels on a card of ``sms`` SMs: TO (7; 3 where Co <= 3 or where 7
    leaves fewer than CONV3X3_F32_MIN_WARPS_PER_SM warps an SM), the groups
    a block (the most of CONV3X3_F32_G no larger than the groups), the tiles
    and the partials' rows. Raises for an empty shape, N > 65535 (the grid's
    third axis) or a plane of 2^31 pixels or more."""
    if min(n, c, co, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"conv3x3_chw (float32) takes 1 <= N <= 65535, 1 <= C, Co, H, W and "
                         f"H W < 2^31, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    return Conv3x3F32Plan(*_row_run_split(n, co, h, w, sms))


def _row_run_split(n: int, split: int, h: int, w: int, sms: int) -> tuple:
    """K1's and K6's split of ``split`` channels (K1's output, K6's input)
    over 16-pixel runs: the channels a thread (7; 3 where split <= 3 or where
    7 leaves fewer than CONV3X3_F32_MIN_WARPS_PER_SM warps an SM), the groups,
    the groups a block, the chunks, the 16 x 32 tiles and their count."""
    tiles_h, tiles_w = -(-h // CONV3X3_F32_TILE[0]), -(-w // CONV3X3_F32_TILE[1])
    tiles = n * tiles_h * tiles_w
    per = CONV3X3_F32_TO[0]
    if split <= CONV3X3_F32_TO[1] or tiles * -(-split // per) < CONV3X3_F32_MIN_WARPS_PER_SM * sms:
        per = CONV3X3_F32_TO[1]
    groups = -(-split // per)
    g = next(g for g in CONV3X3_F32_G if g <= groups or g == 1)
    return per, groups, g, -(-groups // g), tiles_h, tiles_w, tiles


def _fwd_cuda_cores(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False):
    """K1/K2 (/K5) on the CUDA cores (``itg_conv3x3_chw``): the float32 route
    (the C function takes bf16 too), on :func:`conv3x3_f32_plan`'s grid; with
    stats, the tiles' partial sums added in one fixed order by a second
    launch."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    plan = conv3x3_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    part = s1 = s2 = None
    if want_stats:
        part = torch.empty((plan.part_rows, 2, co), dtype=torch.float32, device=x.device)
        s1 = torch.empty(co, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    wf, bf, sc, sh = _f32(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            _ptr(top), _ptr(left), y.data_ptr(), _ptr(part), _ptr(s1), _ptr(s2),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), plan.to, plan.g, _stream(x),
        )
    _raise_on(rc, "itg_conv3x3_chw")
    ROUTE_LAUNCHES["itg_conv3x3_chw"] += 1
    return y, s1, s2


def _fwd_tensor_cores(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False,
                      up=False):
    """K1/K2 (/K5) on the tensor cores (``itg_conv3x3_chw_tc``), bf16: the
    entry point packs the weights (as :func:`pack_fwd_weights`), runs the
    persistent kernel and, with stats, sums the per-block partials in one
    order. With ``up``, K9/K14 the same way (``itg_upconv3x3_chw_tc``,
    :func:`pack_upconv_weights`): x at half resolution, y (N, Co, 2H, 2W)."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    if up:
        entry, (nc, no), s = "itg_upconv3x3_chw_tc", upconv_tc_plan(c, co), 2
        wp_shape, rows = (4, 8 * no, 4, 8 * nc), UPCONV_TC_MAX_BLOCKS
    else:
        entry, (nc, no), s = "itg_conv3x3_chw_tc", fwd_tc_plan(c, co), 1
        wp_shape, rows = (8 * no, 3, 3, 8 * nc), FWD_TC_MAX_BLOCKS
    y = torch.empty((n, co, s * h, s * wd), dtype=x.dtype, device=x.device)
    wp = torch.empty(wp_shape, dtype=torch.bfloat16, device=x.device)
    part = s1 = s2 = None
    if want_stats:
        part = torch.empty((rows, 2, co), dtype=torch.float32, device=x.device)
        s1 = torch.empty(co, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    wf, bf, sc, sh = _f32(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = getattr(_lib(), entry)(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            _ptr(top), _ptr(left), wp.data_ptr(), y.data_ptr(), _ptr(part), _ptr(s1), _ptr(s2),
            n, c, h, wd, co, int(relu), int(zeros), nc, no, _stream(x),
        )
    _raise_on(rc, entry)
    ROUTE_LAUNCHES[entry] += 1
    return y, s1, s2


def _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False):
    """K1/K2 (/K5) on the card, routed by dtype: bf16 on the tensor cores,
    float32 on the CUDA cores."""
    route = _fwd_tensor_cores if x.dtype == torch.bfloat16 else _fwd_cuda_cores
    return route(x, w, b, scale, shift, relu, zeros, top, left, want_stats)


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
    Differentiable in x, w, b, scale, shift and through the stats. On the
    card bf16 takes the tensor-core kernel (the weights rounded to bf16: its
    plain version is :func:`conv3x3_chw_tc_plain`), float32 the CUDA-core
    one."""
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


def conv3x3_chw_tc_plain(x, w, b, scale, shift, relu: bool = True,
                         outer_padding: str = "replicate", want_stats: bool = False):
    """Plain version of K1's bf16 tensor-core route: :func:`conv3x3_chw_plain`
    with the weights rounded to bf16 (the reference's bf16 rounding,
    pallas_conv.py:615), float32 sums."""
    return conv3x3_chw_plain(x, w.detach().to(torch.bfloat16), b, scale, shift, relu,
                             outer_padding, want_stats)


def conv3x3_chw_halo(x, w, b, scale, shift, relu: bool, outer_padding: str,
                     top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """K2's kernel: :func:`conv3x3_chw` whose padded input takes its top row
    (N, C, W+2, corners included) and left column (N, C, H) post-norm from
    the caller where given; every other border cell is the own edge
    (replicate) or zero. Routed as :func:`conv3x3_chw` (bf16's plain
    version: :func:`conv3x3_chw_halo_tc_plain`)."""
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    _check_borders(x, top, left)
    if not _on_cuda(x, w, b, scale, shift, top, left):
        return conv3x3_chw_halo_plain(x, w, b, scale, shift, relu, outer_padding, top, left)
    y, _, _ = _launch_conv3x3(x, w, b, scale, shift, relu, zeros, top, left)
    LAUNCHES["chw_halo_step"] += 1
    return y


def _halo_padded(x, scale, shift, relu: bool, outer_padding: str,
                 top: Optional[torch.Tensor], left: Optional[torch.Tensor]) -> torch.Tensor:
    """The post-norm input with its one-pixel border, (N, C, H+2, W+2) in
    x's dtype: the border assembly of ``ops/padding.py: halo_pad_step``, the
    top row and left column from the cache where given."""
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
    return torch.cat([top_row, mid, row if zeros else mid[:, :, -1:]], dim=2)


def conv3x3_chw_halo_plain(x, w, b, scale, shift, relu: bool, outer_padding: str,
                           top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """Plain PyTorch version of :func:`conv3x3_chw_halo` (the bordered
    post-norm input, then F.conv2d)."""
    padded = _halo_padded(x, scale, shift, relu, outer_padding, top, left)
    return F.conv2d(padded.float(), w.float(), b.float()).to(x.dtype)


def conv3x3_chw_halo_tc_plain(x, w, b, scale, shift, relu: bool, outer_padding: str,
                              top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """Plain version of K2's bf16 tensor-core route:
    :func:`conv3x3_chw_halo_plain` with the weights rounded to bf16."""
    return conv3x3_chw_halo_plain(x, w.detach().to(torch.bfloat16), b, scale, shift, relu,
                                  outer_padding, top, left)


def halo_borders(x: torch.Tensor, site: SiteState, pos: GridPos, gw: int):
    """The cached post-norm (top, left) borders of one raster step,
    channels-major in x's dtype; None on the first row / column, where the
    kernel uses the own edge (:func:`lane_halo_borders` for a
    :class:`LanePos`)."""
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


def lane_halo_borders(x: torch.Tensor, scale, shift, relu: bool, outer_padding: str,
                      site: SiteState, pos: LanePos, gw: int):
    """:func:`halo_borders` with one position per batch element (the
    batched-diagonal engine): (top (N, C, Wm+2), left (N, C, Hm)) for every
    element, each from its own window of the cache or, on its first row or
    column, its own edge as the kernel would border it (post-norm x's edge
    for replicate, zeros for constant; a first row's top corners from its
    left column and its last value), so one kernel call borders each
    element as its own raster step would."""
    wm = x.shape[3]
    zeros = outer_padding == "constant"
    own_left = x.new_zeros(x.shape[:3]) if zeros else prenorm(x[..., 0], scale, shift, relu)
    cached_left = site.v[:, :, 0, :].permute(0, 2, 1).to(x.dtype)
    left = torch.where(pos.first_col[:, None, None], own_left, cached_left)
    if zeros:
        own_top = x.new_zeros(x.shape[:2] + (wm + 2,))
    else:
        row = prenorm(x[:, :, 0, :], scale, shift, relu)  # (N, C, Wm)
        own_top = torch.cat([left[:, :, :1], row, row[:, :, -1:]], dim=2)
    cached_top = lane_read_row(site.row_read, pos, (gw - 1) * (wm // gw), wm + 2)
    top = torch.where(pos.first_row[:, None, None], own_top,
                      cached_top.permute(0, 2, 1).to(x.dtype))
    return top.contiguous(), left.contiguous()


def _borders(x, scale, shift, relu: bool, outer_padding: str, site: SiteState, pos, gw: int):
    if isinstance(pos, LanePos):
        return lane_halo_borders(x, scale, shift, relu, outer_padding, site, pos, gw)
    return halo_borders(x, site, pos, gw)


def chw_halo_step(x, w, b, scale, shift, relu: bool, outer_padding: str,
                  site: SiteState, pos: GridPos, gh: int, gw: int):
    """K2: one raster step of a channels-major local-padded conv.

    ``x`` (N, C, Hm, Wm) is the raw conv input (BN fold and ReLU run in the
    kernel); ``site`` is the engine's NHWC-format halo cache and holds
    post-norm values, as the NHWC path's (ops/padding.py) does. Returns
    (y, updated SiteState); ``row_write`` is updated in place. ``pos`` may be
    a :class:`LanePos` (one position per batch element)."""
    top, left = _borders(x, scale, shift, relu, outer_padding, site, pos, gw)
    y = conv3x3_chw_halo(x, w, b, scale, shift, relu, outer_padding, top, left)
    return y, _halo_update(x, scale, shift, relu, site, pos, gh, gw)


def _halo_update(x, scale, shift, relu: bool, site: SiteState, pos: GridPos, gh: int,
                 gw: int) -> SiteState:
    """The cache update of one raster step (post-norm, NHWC buffer format):
    ``v`` from merged column (gw-1)*Wp - 1 of ``x`` (N, C, Hm, Wm), and merged
    row (gh-1)*Hp - 1 written into ``row_write`` in place; for a
    :class:`LanePos`, each active element's at its own column."""
    hm, wm = x.shape[2:]
    hp, wp = hm // gh, wm // gw
    col = x[:, :, :, (gw - 1) * wp - 1 : (gw - 1) * wp]  # (N, C, Hm, 1)
    v_new = prenorm(col, scale, shift, relu).permute(0, 2, 3, 1).to(site.v.dtype)
    row = x[:, :, (gh - 1) * hp - 1, :]  # (N, C, Wm)
    row_pn = prenorm(row, scale, shift, relu).permute(0, 2, 1)  # (N, Wm, C)
    if isinstance(pos, LanePos):
        v_new = torch.where(pos.active[:, None, None, None], v_new, site.v)
        lane_write_row(site.row_write, pos, (gw - 1) * wp, row_pn)
        return SiteState(v=v_new, row_read=site.row_read, row_write=site.row_write)
    offset = (gw - 1) * wp * pos.col
    site.row_write[:, 0, offset + 1 : offset + 1 + wm, :] = row_pn.to(site.row_write.dtype)
    return SiteState(v=v_new, row_read=site.row_read, row_write=site.row_write)


# ---------------------------------------------------------------------------
# K6 / K7 / K8: the 3x3 conv's backward (csrc/conv3x3_dx_f32.cu,
# csrc/conv3x3_dw_f32.cu, csrc/conv3x3_chw_bwd.cu; bf16: csrc/chw_dx_tc.cu,
# csrc/chw_dw_tc.cu)


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


# The tensor-core route's tiling (csrc/chw_dx_tc.cu): N = the input channels
# padded to NT x 8, K = (tap, output channel) with the output channels padded
# to NO x 8 per tap; one template per NT and NO. At most DX_TC_MAX_BLOCKS
# persistent blocks write per-block partial sums.
DX_TC_NT = (1, 2, 4, 7, 8)
DX_TC_NO = (1, 2, 4)
DX_TC_MAX_BLOCKS = 1024


def dx_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(NT, NO) of the tensor-core dx kernels for C input and Co output
    channels: the fewest 8-channel groups of DX_TC_NT and DX_TC_NO that hold
    them. Raises for C > 64 or Co > 32 (every training shape of the models'
    channels-major tail, cin <= 64, is inside)."""
    nt = next((t for t in DX_TC_NT if 8 * t >= c), None)
    no = next((o for o in DX_TC_NO if 8 * o >= co), None)
    if nt is None or no is None:
        raise ValueError(f"the tensor-core dx kernels take C <= {8 * DX_TC_NT[-1]} and "
                         f"Co <= {8 * DX_TC_NO[-1]}, got C={c}, Co={co}")
    return nt, no


def pack_dx_weights(w: torch.Tensor, up: bool) -> torch.Tensor:
    """Plain version of the tensor-core dx kernels' weight packing (which
    their C entry points run on the card): w (Co, C, 3, 3) -> bf16 (8 NT, T,
    T, 8 NO), the B operand, wp[c, u, v, o] = w4[o, c, u, v] zero past C and
    Co, where w4 is K6's flipped 3x3 kernel (T = 3: the transposed conv's
    taps (2 - ky, 2 - kx)) or, with ``up``, K9 dx's combined 4x4 one
    (:func:`_upconv_dx_weights`, combined in float32 and then rounded)."""
    co, c = w.shape[:2]
    nt, no = dx_tc_plan(c, co)
    w4 = _upconv_dx_weights(w) if up else w.detach().float().flip((2, 3))
    w4 = F.pad(w4, (0, 0, 0, 0, 0, 8 * nt - c, 0, 8 * no - co))
    return w4.permute(1, 2, 3, 0).to(torch.bfloat16, memory_format=torch.contiguous_format)


# K6's float32 route (csrc/conv3x3_dx_f32.cu): K1's tiling with the roles of
# C and Co swapped (_row_run_split). A thread owns 16 pixels of a row x CC
# input channels (CC one of CONV3X3_F32_TO: 7, or 3 where C <= 3 or where 7
# would leave fewer than CONV3X3_F32_MIN_WARPS_PER_SM warps an SM), a warp (a
# group) a 16 x 32 tile of da and CC channels, a block the most of
# CONV3X3_F32_G groups no larger than the groups, so g is staged once for all
# of them; a tile's channel chunks, its tiles and the images are the grid's
# axes. The loop over output channels runs exactly Co times.


class Conv3x3DxF32Plan(NamedTuple):
    cc: int  # input channels of a thread
    groups: int  # ceil(C / cc)
    g: int  # groups a block
    chunks: int  # ceil(groups / g): the grid's second axis
    tiles_h: int  # ceil(H / 16) x ceil(W / 32) tiles an image
    tiles_w: int
    part_rows: int  # N x tiles: rows of the (part_rows, 2C) float32 partials of d(scale), d(shift)


def conv3x3_dx_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> Conv3x3DxF32Plan:
    """The float32 K6 kernel's launch for x (N, C, H, W) and Co output
    channels on a card of ``sms`` SMs: CC (7; 3 where C <= 3 or where 7
    leaves fewer than CONV3X3_F32_MIN_WARPS_PER_SM warps an SM), the groups a
    block (the most of CONV3X3_F32_G no larger than the groups), the tiles
    and the partials' rows; the entry point launches this grid. Raises for an
    empty shape, N > 65535 (the grid's third axis) or a plane of 2^31 pixels
    or more."""
    if min(n, c, co, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"conv3x3_chw_dx (float32) takes 1 <= N <= 65535, 1 <= C, Co, H, W and "
                         f"H W < 2^31, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    return Conv3x3DxF32Plan(*_row_run_split(n, c, h, w, sms))


def _dx_cuda_cores(x, g, wf, scale, shift, relu: bool, zeros: bool):
    """K6 on the CUDA cores (``itg_conv3x3_chw_dx``; wf (Co, C, 3, 3)): the
    float32 route (the C function takes bf16 too), on
    :func:`conv3x3_dx_f32_plan`'s grid; the tiles' partial sums of d(scale)
    and d(shift) are added in one fixed order by a second launch."""
    n, c, h, wd = x.shape
    co = wf.shape[0]
    plan = conv3x3_dx_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    dx = torch.empty_like(x)
    part = torch.empty((plan.part_rows, 2 * c), dtype=torch.float32, device=x.device)
    dsc = torch.empty(c, dtype=torch.float32, device=x.device)
    dsh = torch.empty_like(dsc)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw_dx(
            x.data_ptr(), g.data_ptr(), wf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            dx.data_ptr(), part.data_ptr(), dsc.data_ptr(), dsh.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), plan.cc, plan.g, _stream(x),
        )
    _raise_on(rc, "itg_conv3x3_chw_dx")
    ROUTE_LAUNCHES["itg_conv3x3_chw_dx"] += 1
    return dx, dsc, dsh


# K9 dx's float32 route (csrc/upconv_dx_f32.cu): a thread owns 2 x 2 half-res
# pixels x CC input channels (CC one of UPCONV_DX_F32_CC; 13 divides the
# flagship's 26 and 52), a block of two warps an 8 x 32 half-res tile and one
# group of CC input channels; the groups are a grid axis, and the channels
# past C in the last group are zero weights. UPCONV_DX_F32_COST: the kernel's
# time per input channel of each CC relative to CC 8's, as
# f32_route_study.py's plan table reads them on an H100 at the Experiment-1
# shapes (CC 13 about 1.2x: more registers a thread).
UPCONV_DX_F32_CC = (8, 13)
UPCONV_DX_F32_COST = {8: 1.0, 13: 1.2}
UPCONV_DX_F32_TILE = (8, 32)


class UpconvDxF32Plan(NamedTuple):
    cc: int  # input channels of a thread
    groups: int  # ceil(C / cc): the input-channel split, the grid's first axis
    tiles_h: int  # ceil(H / 8) x ceil(W / 32) tiles an image
    tiles_w: int
    part_rows: int  # N x tiles: rows of the (part_rows, 2C) float32 partials
    wq_numel: int  # Co x groups x 16 x cc rounded up to 4: the packed weights


def upconv_dx_f32_plan(n: int, c: int, co: int, h: int, w: int) -> UpconvDxF32Plan:
    """The float32 K9 dx kernel's launch for x (N, C, H, W) at half
    resolution and Co output channels: CC, the one of UPCONV_DX_F32_CC with
    the least UPCONV_DX_F32_COST over the padded channels (ties to the
    larger), the input-channel groups, the 8 x 32 tiles and the scratch
    sizes; the entry point launches this grid. Raises for an empty shape or
    N > 65535 (the grid's second axis)."""
    if min(n, c, co, h, w) < 1 or n > 65535:
        raise ValueError(f"upconv3x3_chw_dx (float32) takes 1 <= N <= 65535 and 1 <= C, Co, H, "
                         f"W, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    cc = min(UPCONV_DX_F32_CC, key=lambda k: (-(-c // k) * k * UPCONV_DX_F32_COST[k], -k))
    groups = -(-c // cc)
    tiles_h, tiles_w = -(-h // UPCONV_DX_F32_TILE[0]), -(-w // UPCONV_DX_F32_TILE[1])
    return UpconvDxF32Plan(cc, groups, tiles_h, tiles_w, n * tiles_h * tiles_w,
                           co * groups * 16 * (-(-cc // 4) * 4))


def _upconv_dx_cuda_cores(x, g, w, scale, shift, relu: bool, zeros: bool):
    """K9 dx on the CUDA cores (``itg_upconv3x3_chw_dx``): the float32 route
    (the C function takes bf16 too). The entry point packs the stride-2
    weights of :func:`_upconv_dx_weights` per channel group, runs the kernel
    on :func:`upconv_dx_f32_plan`'s grid and adds its per-block partial sums
    in a fixed order."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    plan = upconv_dx_f32_plan(n, c, co, h, wd)
    dx = torch.empty_like(x)
    wq = torch.empty(plan.wq_numel, dtype=torch.float32, device=x.device)
    part = torch.empty((plan.part_rows, 2 * c), dtype=torch.float32, device=x.device)
    dsc = torch.empty(c, dtype=torch.float32, device=x.device)
    dsh = torch.empty_like(dsc)
    wf, sc, sh = _f32(w), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw_dx(
            x.data_ptr(), g.data_ptr(), wf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            wq.data_ptr(), dx.data_ptr(), part.data_ptr(), dsc.data_ptr(), dsh.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), plan.cc, plan.groups,
            plan.tiles_h, plan.tiles_w, _stream(x),
        )
    _raise_on(rc, "itg_upconv3x3_chw_dx")
    ROUTE_LAUNCHES["itg_upconv3x3_chw_dx"] += 1
    return dx, dsc, dsh


def _dx_tensor_cores(entry: str, x, g, w, scale, shift, relu: bool, zeros: bool):
    """K6 (``itg_conv3x3_chw_dx_tc``) or K9 dx (``itg_upconv3x3_chw_dx_tc``)
    on the tensor cores, bf16, from the (Co, C, 3, 3) float32 weights (the
    entry point packs them, as :func:`pack_dx_weights` does)."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    nt, no = dx_tc_plan(c, co)
    taps = 4 if entry == "itg_upconv3x3_chw_dx_tc" else 3
    dx = torch.empty_like(x)
    dsc = torch.empty(c, dtype=torch.float32, device=x.device)
    dsh = torch.empty_like(dsc)
    wp = torch.empty((8 * nt, taps, taps, 8 * no), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((DX_TC_MAX_BLOCKS, 2, c), dtype=torch.float32, device=x.device)
    wf, sc, sh = _f32(w), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = getattr(_lib(), entry)(
            x.data_ptr(), g.data_ptr(), wf.data_ptr(), sc.data_ptr(), sh.data_ptr(), wp.data_ptr(),
            dx.data_ptr(), part.data_ptr(), dsc.data_ptr(), dsh.data_ptr(),
            n, c, h, wd, co, int(relu), int(zeros), nt, no, DX_TC_MAX_BLOCKS, _stream(x),
        )
    _raise_on(rc, entry)
    ROUTE_LAUNCHES[entry] += 1
    return dx, dsc, dsh


def conv3x3_chw_dx(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """K6: the input-side gradient of :func:`conv3x3_chw`.

    ``g`` (N, Co, H, W) is the cotangent of y. da = conv3x3ᵀ(g) on the
    padded grid, with the gradient that lands on the padded border folded
    back onto the edge rows and columns (replicate; corners twice) or
    dropped (zeros); da is masked by the ReLU of ``scale*x + shift``.
    Returns (dx = da·scale in x's dtype, d(scale) = Σ da·x, d(shift) = Σ da),
    the sums in float32 over (N, H, W). On the card bf16 takes the
    tensor-core kernel (the weights rounded to bf16: its plain version is
    :func:`conv3x3_chw_dx_tc_plain`), float32 the CUDA-core one."""
    zeros = _check_padding(outer_padding)
    co = w.shape[0]
    _check_bwd(x, g, co, scale, shift)
    _check_param("w", w, (co, x.shape[1], 3, 3))
    if not _on_cuda(x, g, w, scale, shift):
        return conv3x3_chw_dx_plain(x, g, w, scale, shift, relu, outer_padding)
    if x.dtype == torch.bfloat16:
        out = _dx_tensor_cores("itg_conv3x3_chw_dx_tc", x, g, w, scale, shift, relu, zeros)
    else:
        out = _dx_cuda_cores(x, g, _f32(w), scale, shift, relu, zeros)
    LAUNCHES["conv3x3_chw_dx"] += 1
    return out


def _fold_border(d: torch.Tensor) -> torch.Tensor:
    """(N, C, H+2, W+2) gradient of a replicate-padded array -> (N, C, H, W):
    the border rows and columns add onto the edge they copy."""
    d = d.clone()
    d[..., 1] += d[..., 0]
    d[..., -2] += d[..., -1]
    d[..., 1, :] += d[..., 0, :]
    d[..., -2, :] += d[..., -1, :]
    return d[..., 1:-1, 1:-1]


def _dx_from_padded(dpad, x, scale, shift, relu: bool, outer_padding: str):
    """The dx kernels' epilogue on the float32 gradient of the padded
    post-norm input, dpad (N, C, H+2, W+2): the border folded (replicate) or
    dropped (zeros), the ReLU mask, dx = da·scale in x's dtype, Σ da·x, Σ da."""
    if outer_padding == "replicate":
        da = _fold_border(dpad)
    else:
        da = dpad[..., 1:-1, 1:-1]
    xf = x.float()
    if relu:
        da = da * ((xf * _chan(scale) + _chan(shift)) > 0)
    dx = (da * _chan(scale)).to(x.dtype)
    return dx, (da * xf).sum(dim=(0, 2, 3)), da.sum(dim=(0, 2, 3))


def conv3x3_chw_dx_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`conv3x3_chw_dx`
    (F.conv_transpose2d, then the border fold)."""
    dpad = F.conv_transpose2d(g.float(), w.float())  # (N, C, H+2, W+2)
    return _dx_from_padded(dpad, x, scale, shift, relu, outer_padding)


def conv3x3_chw_dx_tc_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain version of K6's bf16 tensor-core route: :func:`conv3x3_chw_dx_plain`
    with the weights rounded to bf16 (the reference's bf16 rounding,
    pallas_conv.py:971), float32 sums."""
    return conv3x3_chw_dx_plain(x, g, w.detach().to(torch.bfloat16), scale, shift, relu,
                                outer_padding)


# The tensor-core dW route's tiling (csrc/chw_dw_tc.cu): M = the input
# channels padded to MT x 16, N = the output channels padded to NO x 8; one
# template per MT and NO. Its persistent blocks (at most DW_TC_BLOCKS_PER_SM
# per SM, as its shared memory and registers hold them) write per-block
# partial sums.
DW_TC_MT = (1, 2, 4)
DW_TC_NO = (1, 2, 4)
DW_TC_BLOCKS_PER_SM = 2


def _dw_tiles(c: int, co: int, what: str) -> tuple[int, int]:
    mt = next((t for t in DW_TC_MT if 16 * t >= c), None)
    no = next((o for o in DW_TC_NO if 8 * o >= co), None)
    if mt is None or no is None:
        raise ValueError(f"the tensor-core {what} takes C <= {16 * DW_TC_MT[-1]} and "
                         f"Co <= {8 * DW_TC_NO[-1]}, got C={c}, Co={co}")
    return mt, no


def dw_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(MT, NO) of the tensor-core dW kernel for C input and Co output
    channels: the fewest 16-channel tiles of DW_TC_MT and 8-channel tiles of
    DW_TC_NO that hold them. Raises for C > 64 or Co > 32, the dx route's
    limits (every training shape of the models' channels-major tail is
    inside)."""
    return _dw_tiles(c, co, "dW kernel")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K7's float32 route (csrc/conv3x3_dw_f32.cu): persistent blocks, one an SM,
# each walking a contiguous range of chunks (rows output rows x 32 columns of
# one image) through a double buffer of cp.async stages. A thread owns
# CONV3X3_DW_F32_TILE (3 output x 13 input channels) at one row tap; a block
# holds up to CONV3X3_DW_F32_MAX_TILES of them (27 output x 52 input
# channels: every training shape of the tail) in each of its pixel slots, a
# power of two of them, as many as CONV3X3_DW_F32_THREADS threads hold.
# Wider layers split the channels over the grid's second axis. The chunk's
# rows are the one of CONV3X3_DW_F32_ROWS (whose two stages fit the shared
# memory, with a run of 8 pixels for every slot) with the least
# ceil(chunks / blocks) x (rows + CONV3X3_DW_F32_CHUNK_COST): the busiest
# block's chunks, each costing its rows and a fixed part (staging, the BN
# fold, two barriers) worth about two rows, as f32_route_study.py's plan
# table reads them on an H100 at the float32 training shapes. A block's
# partial is one row of Co C 9 + Co floats (dW, then db).
CONV3X3_DW_F32_TILE = (3, 13)
CONV3X3_DW_F32_MAX_TILES = (9, 4)
CONV3X3_DW_F32_COLS = 32
CONV3X3_DW_F32_RUN = 8
CONV3X3_DW_F32_ROWS = (8, 12, 16, 24, 32)
CONV3X3_DW_F32_CHUNK_COST = 2
CONV3X3_DW_F32_THREADS = 256
CONV3X3_DW_F32_SMEM = 232448  # bytes of shared memory a block may take on an H100
CONV3X3_DW_F32_STAGES = 2


class Conv3x3DwF32Plan(NamedTuple):
    tiles_o: int  # a block's output tiles of 3 channels
    tiles_c: int  # its input tiles of 13
    slots: int  # pixel slots a block: a power of two, slots x tiles_o x tiles_c x 3 <= 256
    threads: int  # slots x tiles_o x tiles_c x 3, rounded up to a warp
    rows: int  # output rows a chunk
    chunks: int  # N x ceil(H / rows) x ceil(W / 32)
    channel_blocks: int  # ceil(C / 52) x ceil(Co / 27): the grid's second axis
    blocks: int  # the grid's first axis: min(chunks, SMs / channel blocks), at least 1
    part_entries: int  # Co C 9 + Co: a block's partial row


def conv3x3_dw_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> Conv3x3DwF32Plan:
    """The float32 K7 kernel's launch for x (N, C, H, W) and g (N, Co, H, W) on
    a card of ``sms`` SMs: the block's channel tiles, its pixel slots and
    threads, the chunk's rows, the chunks and the grid; the entry point
    launches this grid. Raises for an empty shape, N > 65535
    (as K6's grid) or a plane of 2^31 pixels or more."""
    if min(n, c, co, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"conv3x3_chw_dw (float32) takes 1 <= N <= 65535, 1 <= C, Co, H, W and "
                         f"H W < 2^31, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    (to, tc), (mo, mc) = CONV3X3_DW_F32_TILE, CONV3X3_DW_F32_MAX_TILES
    tiles_o, tiles_c = min(-(-co // to), mo), min(-(-c // tc), mc)
    per_slot = tiles_o * tiles_c * 3
    slots = 1 << (CONV3X3_DW_F32_THREADS // per_slot).bit_length() - 1
    channel_blocks = -(-c // (tc * mc)) * -(-co // (to * mo))
    cols, stages = CONV3X3_DW_F32_COLS, CONV3X3_DW_F32_STAGES

    def layout(rows):  # (chunks, blocks, the stages' and the scales' bytes)
        chunks = n * -(-h // rows) * -(-w // cols)
        # a stage: rows + 2 rows of x (its ring) and rows rows of g, each row
        # its channels side by side, 35 (x) and 33 (g) floats apart
        stage = 4 * ((rows + 2) * tc * tiles_c * (cols + 3) + rows * to * tiles_o * (cols + 1))
        return chunks, max(1, min(chunks, sms // channel_blocks)), stages * stage + 8 * tc * mc

    fits = [r for r in CONV3X3_DW_F32_ROWS
            if slots * CONV3X3_DW_F32_RUN <= r * cols and layout(r)[2] <= CONV3X3_DW_F32_SMEM]
    rows = min(fits or CONV3X3_DW_F32_ROWS[:1],
               key=lambda r: (-(-layout(r)[0] // layout(r)[1]) * (r + CONV3X3_DW_F32_CHUNK_COST), r))
    chunks, blocks, _ = layout(rows)
    return Conv3x3DwF32Plan(tiles_o, tiles_c, slots, -(-slots * per_slot // 32) * 32, rows,
                            chunks, channel_blocks, blocks, co * c * 9 + co)


def _dw_cuda_cores(x, g, scale, shift, relu: bool, zeros: bool):
    """K7 on the CUDA cores (``itg_conv3x3_chw_dw``): the float32 route (the
    C function takes bf16 too): persistent blocks on
    :func:`conv3x3_dw_f32_plan`'s grid write float32 partials of dW and db, a
    second launch sums them in one order."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    plan = conv3x3_dw_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    dw = torch.empty((co, c, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((plan.blocks, plan.part_entries), dtype=torch.float32, device=x.device)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw_dw(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, c, h, wd, co, int(relu), int(zeros), _bf16(x),
            plan.blocks, plan.slots, plan.rows, _stream(x),
        )
    _raise_on(rc, "itg_conv3x3_chw_dw")
    ROUTE_LAUNCHES["itg_conv3x3_chw_dw"] += 1
    return dw, db


def _dw_tensor_cores(x, g, scale, shift, relu: bool, zeros: bool):
    """K7 on the tensor cores (``itg_conv3x3_chw_dw_tc``), bf16: persistent
    blocks write float32 partials, a second launch sums them in one order."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    mt, no = dw_tc_plan(c, co)
    cap = DW_TC_BLOCKS_PER_SM * _sm_count(x.device.index)
    dw = torch.empty((co, c, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    # per block: the C fragments of 9 MT (tap, m16 tile) pairs x NO n8 tiles,
    # then db (8 NO)
    part = torch.empty((cap, 9 * mt * no * 128 + 8 * no), dtype=torch.float32, device=x.device)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv3x3_chw_dw_tc(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, c, h, wd, co, int(relu), int(zeros), mt, no, cap,
            _stream(x),
        )
    _raise_on(rc, "itg_conv3x3_chw_dw_tc")
    ROUTE_LAUNCHES["itg_conv3x3_chw_dw_tc"] += 1
    return dw, db


def conv3x3_chw_dw(x, g, scale, shift, relu: bool, outer_padding: str):
    """K7: the weight-side gradient of :func:`conv3x3_chw`:
    dW[o, c, ky, kx] = Σ g[o] · A[c] shifted by the tap, where A is the
    padded post-norm input the forward read, and db = Σ g; float32 sums
    over (N, H, W). Returns (dW (Co, C, 3, 3), db (Co,)). On the card bf16
    takes the tensor-core kernel (both operands are bf16 values, so its
    plain version is :func:`conv3x3_chw_dw_plain` itself), float32 the
    CUDA-core one."""
    zeros = _check_padding(outer_padding)
    co = g.shape[1]
    _check_bwd(x, g, co, scale, shift)
    if not _on_cuda(x, g, scale, shift):
        return conv3x3_chw_dw_plain(x, g, scale, shift, relu, outer_padding)
    if x.dtype == torch.bfloat16:
        out = _dw_tensor_cores(x, g, scale, shift, relu, zeros)
    else:
        out = _dw_cuda_cores(x, g, scale, shift, relu, zeros)
    LAUNCHES["conv3x3_chw_dw"] += 1
    return out


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
# K3: 1x1 conv + bias (+ residual) (+ stats), and its dW
# (bf16: csrc/conv1x1_tc.cu; f32: csrc/conv1x1_chw.cu)


# The tensor-core forward's plan (csrc/conv1x1_tc.cu): K = the input
# channels padded to 16 KS (C <= CONV1X1_TC_MAX_C, the C file's kMaxC), N =
# the output channels padded to 8 NO (at most 64 a block, a grid axis past
# that). With stats, each of at most CONV1X1_TC_MAX_BLOCKS blocks along the
# pixels (the C file's kMaxBlocks) writes its partial sums.
CONV1X1_TC_MAX_C = 768
CONV1X1_TC_MAX_BLOCKS = 1024


def conv1x1_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(KS, NO) of the tensor-core 1x1 conv for C input and Co output
    channels: the fewest 16-channel k16 steps that hold C and 8-channel
    groups that hold Co. Raises for C > 768, the CUDA-core kernel's limit
    too (any Co)."""
    if not 1 <= c <= CONV1X1_TC_MAX_C or co < 1:
        raise ValueError(f"conv1x1_chw: C={c} exceeds the kernel's {CONV1X1_TC_MAX_C}-channel "
                         f"limit (or Co={co} < 1)")
    return -(-c // 16), -(-co // 8)


def pack_conv1x1_weights(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the B operand the tensor-core 1x1 conv stages (and
    writes out where its entry point is given ``wp``): w (Co, C) or (Co, C,
    1, 1) -> bf16 (8 NO, 16 KS), wp[o, c] = w[o, c] rounded to bf16, zero
    past Co and C."""
    co = w.shape[0]
    wm = w.detach().float().reshape(co, -1)
    ks, no = conv1x1_tc_plan(wm.shape[1], co)
    wp = F.pad(wm, (0, 16 * ks - wm.shape[1], 0, 8 * no - co))
    return wp.to(torch.bfloat16).contiguous()


def _conv1x1_cuda_cores(x, w, b, res, want_stats=False):
    """K3 on the CUDA cores (``itg_conv1x1_chw``): the float32 route (the C
    function takes bf16 too). w (Co, C) or (Co, C, 1, 1)."""
    n, c, h, wd = x.shape
    co = w.shape[0]
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
    _raise_on(rc, "itg_conv1x1_chw")
    ROUTE_LAUNCHES["itg_conv1x1_chw"] += 1
    return y, s1, s2


def _conv1x1_tensor_cores(x, w, b, res, want_stats=False):
    """K3 on the tensor cores (``itg_conv1x1_chw_tc``), bf16: W and b rounded
    to bf16 in the kernel (:func:`pack_conv1x1_weights`), float32 sums, y
    rounded once; with stats, per-block partial sums added in one order by a
    second launch."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    part = s1 = s2 = None
    if want_stats:
        part = torch.empty((CONV1X1_TC_MAX_BLOCKS, 2, co), dtype=torch.float32, device=x.device)
        s1 = torch.empty(co, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    wf, bf = _f32(w.reshape(co, c)), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw_tc(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), _ptr(res), None, y.data_ptr(),
            _ptr(part), _ptr(s1), _ptr(s2), n, c, h * wd, co, _stream(x),
        )
    _raise_on(rc, "itg_conv1x1_chw_tc")
    ROUTE_LAUNCHES["itg_conv1x1_chw_tc"] += 1
    return y, s1, s2


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
    conv1x1_tc_plan(c, co)
    if not _on_cuda(x, w, b, res):
        out = conv1x1_chw_plain(x, w, b, res, want_stats)
        return out if want_stats else (out, None, None)
    route = _conv1x1_tensor_cores if x.dtype == torch.bfloat16 else _conv1x1_cuda_cores
    out = route(x, w, b, res, want_stats)
    LAUNCHES["conv1x1_chw"] += 1
    return out


class _Conv1x1Chw(torch.autograd.Function):
    """K3 forward (+ stats); backward K8 (when the stats have cotangents), dx
    by K3 with Wᵀ and a zero bias, dW by K3-dW; each routed by dtype as the
    forward (bf16: the tensor cores, Wᵀ rounded to bf16 there as the
    reference rounds it)."""

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
    """K3: y = W x + b per pixel on (N, C, H, W); w (Co, C, 1, 1) or (Co, C).
    On the card bf16 takes the tensor-core kernel (W and b rounded to bf16:
    its plain version is :func:`conv1x1_chw_tc_plain`), float32 the
    CUDA-core one."""
    return _Conv1x1Chw.apply(x, w, b, None, False)


def conv1x1_chw_add(x, w, b, res, want_stats: bool = False):
    """K3 with the residual add fused: y = W x + b + res (the ResBlock
    shortcut plus ``out + shortcut``). With ``want_stats`` returns
    (y, Σy, Σy²) like :func:`conv3x3_chw`. Routed as :func:`conv1x1_chw`."""
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


def conv1x1_chw_tc_plain(x, w, b, res=None, want_stats: bool = False):
    """Plain version of K3's bf16 tensor-core route: :func:`conv1x1_chw_plain`
    with W and b rounded to bf16 (the reference's bf16 rounding,
    pallas_conv.py:2389-2390), float32 sums, y rounded once."""
    return conv1x1_chw_plain(x, w.detach().to(torch.bfloat16), b.detach().to(torch.bfloat16),
                             res, want_stats)


# The tensor-core dW's plan (csrc/conv1x1_tc.cu): M = the input channels
# padded to 16 MT, N = the output channels padded to 8 NO, one template per
# (MT, NO) pair that C + Co <= 96 allows. Its persistent blocks (at most
# CONV1X1_DW_TC_BLOCKS_PER_SM per SM) write per-block partial sums.
CONV1X1_DW_TC_MT = (1, 2, 4, 6)
CONV1X1_DW_TC_NO = (1, 2, 4, 8, 12)
CONV1X1_DW_TC_BLOCKS_PER_SM = 2


def conv1x1_dw_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(MT, NO) of the tensor-core dW for C input and Co output channels:
    the fewest 16-channel tiles of CONV1X1_DW_TC_MT and 8-channel tiles of
    CONV1X1_DW_TC_NO that hold them. Raises outside C * Co <= 4096 and C + Co
    <= 96, the CUDA-core kernel's limits too."""
    if c < 1 or co < 1 or c * co > 4096 or c + co > 96:
        raise ValueError(f"conv1x1_chw_dw: C={c}, Co={co} exceed the kernel's limits "
                         "(C*Co <= 4096, C+Co <= 96)")
    mt = next(t for t in CONV1X1_DW_TC_MT if 16 * t >= c)
    no = next(o for o in CONV1X1_DW_TC_NO if 8 * o >= co)
    return mt, no


# K3-dW's float32 route (csrc/conv1x1_dw_f32.cu): persistent blocks,
# CONV1X1_DW_F32_BLOCKS_PER_SM an SM (256 threads with 7 x 13 register
# tiles), each walking a contiguous range of 64-pixel chunks; a block's
# partial is one row of Co C + Co floats (dW, then db).
CONV1X1_DW_F32_CHUNK = 64
CONV1X1_DW_F32_BLOCKS_PER_SM = 1


class Conv1x1DwF32Plan(NamedTuple):
    chunks: int  # N x ceil(HW / 64)
    blocks: int  # the grid: min(chunks, the blocks the card holds)
    part_entries: int  # Co C + Co: a block's partial row


def conv1x1_dw_f32_plan(n: int, c: int, co: int, hw: int, sms: int = 132) -> Conv1x1DwF32Plan:
    """The float32 K3-dW kernel's grid for x (N, C, HW) and g (N, Co, HW) on a
    card of ``sms`` SMs: the 64-pixel chunks, the blocks (as many as the
    card holds, no more than the chunks) and a partial row's entries.
    Raises outside C * Co <= 4096 and C + Co <= 96, or for an empty shape."""
    if min(n, c, co, hw) < 1 or c * co > 4096 or c + co > 96:
        raise ValueError(f"conv1x1_chw_dw: N={n}, C={c}, Co={co}, HW={hw} exceed the kernel's "
                         "limits (C*Co <= 4096, C+Co <= 96, none empty)")
    chunks = n * -(-hw // CONV1X1_DW_F32_CHUNK)
    return Conv1x1DwF32Plan(chunks, min(chunks, CONV1X1_DW_F32_BLOCKS_PER_SM * sms),
                            co * c + co)


def _conv1x1_dw_cuda_cores(x, g):
    """K3-dW on the CUDA cores (``itg_conv1x1_chw_dw``): the float32 route
    (the C function takes bf16 too): persistent blocks on
    :func:`conv1x1_dw_f32_plan`'s grid write float32 partials, a second
    launch sums them in one order."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    plan = conv1x1_dw_f32_plan(n, c, co, h * wd, _sm_count(x.device.index))
    dw = torch.empty((co, c), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((plan.blocks, plan.part_entries), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw_dw(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, c, h * wd, co, _bf16(x), plan.blocks, _stream(x),
        )
    _raise_on(rc, "itg_conv1x1_chw_dw")
    ROUTE_LAUNCHES["itg_conv1x1_chw_dw"] += 1
    return dw, db


def _conv1x1_dw_tensor_cores(x, g):
    """K3-dW on the tensor cores (``itg_conv1x1_chw_dw_tc``), bf16:
    persistent blocks write float32 partials, a second launch sums them in
    one order."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    mt, no = conv1x1_dw_tc_plan(c, co)
    cap = CONV1X1_DW_TC_BLOCKS_PER_SM * _sm_count(x.device.index)
    dw = torch.empty((co, c), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    # per block: the C fragments of MT x NO m16n8 tiles, then db (8 NO)
    part = torch.empty((cap, 128 * mt * no + 8 * no), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_conv1x1_chw_dw_tc(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, c, h * wd, co, mt, no, cap, _stream(x),
        )
    _raise_on(rc, "itg_conv1x1_chw_dw_tc")
    ROUTE_LAUNCHES["itg_conv1x1_chw_dw_tc"] += 1
    return dw, db


def conv1x1_chw_dw(x, g):
    """K3-dW: dW[o, c] = Σ g[o]·x[c] and db[o] = Σ g[o], float32 sums over
    (N, H, W). Returns (dW (Co, C), db (Co,)). On the card bf16 takes the
    tensor-core kernel (both operands are bf16 values, so its plain version
    is :func:`conv1x1_chw_dw_plain` itself), float32 the CUDA-core one."""
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"x, g: expected (N, C, H, W), got {tuple(x.shape)}, {tuple(g.shape)}")
    n, c, h, wd = x.shape
    co = g.shape[1]
    _check_act("x", x, (n, c, h, wd))
    _check_act("g", g, (n, co, h, wd))
    _check_same_dtype("g", g, x)
    conv1x1_dw_tc_plan(c, co)
    if not _on_cuda(x, g):
        return conv1x1_chw_dw_plain(x, g)
    if x.dtype == torch.bfloat16:
        out = _conv1x1_dw_tensor_cores(x, g)
    else:
        out = _conv1x1_dw_cuda_cores(x, g)
    LAUNCHES["conv1x1_chw_dw"] += 1
    return out


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
# half-resolution pass, and its backward (float32: csrc/upconv_fwd_f32.cu,
# csrc/upconv_dx_f32.cu, csrc/upconv_dw_f32.cu); K10: the
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


# K9 / K14's tensor-core route (csrc/upconv_fwd_tc.cu): K1's tiling at half
# resolution, the phase row a grid axis; per phase, K = the four slots x
# the input channels padded to NC x 8; N = the output channels padded to
# NO x 8. With stats, each of at most UPCONV_TC_MAX_BLOCKS blocks (the C
# file's kMaxBlocks) writes its partial sums.
UPCONV_TC_MAX_BLOCKS = 1024


def upconv_tc_plan(c: int, co: int) -> tuple[int, int]:
    """(NC, NO) of the tensor-core up-conv forward (K9, K14) for C input and
    Co output channels, as :func:`fwd_tc_plan`. Raises for C > 128 or Co >
    64 (the tail gates keep every fused block inside)."""
    return _tc_plan(c, co, "up-conv forward")


def pack_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the tensor-core up-conv's weight packing (which its
    C entry point runs on the card): w (Co, C, 3, 3) -> bf16 (4, 8 NO, 4,
    8 NC), the B operands, wp[p, o, slot, c] = phase p's combined 2x2
    kernel (:func:`_upconv_phase_weights`, float32) rounded to bf16, zero
    past Co and C."""
    co, c = w.shape[:2]
    nc, no = upconv_tc_plan(c, co)
    wc = F.pad(_upconv_phase_weights(w).reshape(co, c, 4, 4),
               (0, 0, 0, 0, 0, 8 * nc - c, 0, 8 * no - co))
    return wc.permute(2, 0, 3, 1).to(torch.bfloat16, memory_format=torch.contiguous_format)


# K9/K14's float32 route (csrc/upconv_fwd_f32.cu): K1's scheme at half
# resolution. A thread owns 8 half-res pixels of a row x TO output channels x
# the 4 phases; a warp (a group) an 8 x 32 half-res tile and TO channels; a
# block G groups over one tile (the most of UPCONV_F32_G that the groups
# fill), which share one staged, normalised slab. TO is 2 unless that leaves
# fewer than UPCONV_F32_MIN_WARPS_PER_SM warps an SM (the N = 1 eval layers
# at 48^2 and 96^2 take 1). On an H100, f32_route_study.py's plan table read
# (TO, G) = (2, 4) the fastest at every Experiment-1 and eval shape but 52 ->
# 26 at 96^2 N = 1, where the planned (1, 4) is; at 104 -> 52 at 48^2 (N = 1)
# the four-warp rule's (1, 4) reads 11% over (2, 4). Four channels a thread
# (221 registers against 128) read 11-12% slower at the Experiment-1 shapes.
UPCONV_F32_TO = (2, 1)
UPCONV_F32_G = (4, 2, 1)
UPCONV_F32_TILE = (8, 32)
UPCONV_F32_MIN_WARPS_PER_SM = 4


class UpconvF32Plan(NamedTuple):
    to: int  # output channels of a thread
    groups: int  # ceil(Co / to)
    g: int  # groups a block
    chunks: int  # ceil(groups / g): the grid's second axis
    tiles_h: int  # ceil(H / 8) x ceil(W / 32) half-res tiles an image
    tiles_w: int
    part_rows: int  # N x tiles: rows of the (part_rows, 2, Co) float32 partials of the sums
    wp_numel: int  # chunks x C x 16 x g x to: the packed combined weights


def upconv_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> UpconvF32Plan:
    """The float32 K9/K14 kernel's launch for x (N, C, H, W) at half
    resolution and Co output channels on a card of ``sms`` SMs: TO (2, or 1
    where 2 leaves fewer than UPCONV_F32_MIN_WARPS_PER_SM warps an SM), the
    groups a block (the most of UPCONV_F32_G no larger than the groups), the
    tiles, the partials' rows and the packed weights' size. Raises for an
    empty shape, N > 65535 (the grid's third axis), a plane of 2^31 pixels or
    more, or more than 65535 channel chunks (the grid's second axis)."""
    if min(n, c, co, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"upconv3x3_chw (float32) takes 1 <= N <= 65535, 1 <= C, Co, H, W and "
                         f"H W < 2^31, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    tiles_h, tiles_w = -(-h // UPCONV_F32_TILE[0]), -(-w // UPCONV_F32_TILE[1])
    tiles = n * tiles_h * tiles_w
    to = next((t for t in UPCONV_F32_TO
               if tiles * -(-co // t) >= UPCONV_F32_MIN_WARPS_PER_SM * sms), UPCONV_F32_TO[-1])
    groups = -(-co // to)
    g = next(g for g in UPCONV_F32_G if g <= groups or g == 1)
    chunks = -(-groups // g)
    if chunks > 65535:
        raise ValueError(f"upconv3x3_chw (float32) takes at most {65535 * g * to} output "
                         f"channels here, got Co={co}")
    return UpconvF32Plan(to, groups, g, chunks, tiles_h, tiles_w, tiles, chunks * c * 16 * g * to)


def _upconv_cuda_cores(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False):
    """K9/K14 on the CUDA cores (``itg_upconv3x3_chw``): the float32 route
    (the C function takes bf16 too), on :func:`upconv_f32_plan`'s grid: a
    pack launch combines the phase kernels, then the kernel; with stats, the
    tiles' partial sums added in one fixed order by a last launch."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    plan = upconv_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    y = torch.empty((n, co, 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
    part = s1 = s2 = None
    if want_stats:
        part = torch.empty((plan.part_rows, 2, co), dtype=torch.float32, device=x.device)
        s1 = torch.empty(co, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    wp = torch.empty(plan.wp_numel, dtype=torch.float32, device=x.device)
    wf, bf, sc, sh = _f32(w), _f32(b), _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw(
            x.data_ptr(), wf.data_ptr(), bf.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            _ptr(top), _ptr(left), wp.data_ptr(), y.data_ptr(), _ptr(part), _ptr(s1), _ptr(s2),
            n, c, h, wd, co, int(relu), int(zeros), _bf16(x), plan.to, plan.g, _stream(x),
        )
    _raise_on(rc, "itg_upconv3x3_chw")
    ROUTE_LAUNCHES["itg_upconv3x3_chw"] += 1
    return y, s1, s2


def _launch_upconv(x, w, b, scale, shift, relu, zeros, top, left, want_stats=False):
    """K9/K14 on the card, routed by dtype: bf16 on the tensor cores, float32
    on the CUDA cores."""
    if x.dtype == torch.bfloat16:
        return _fwd_tensor_cores(x, w, b, scale, shift, relu, zeros, top, left, want_stats,
                                 up=True)
    return _upconv_cuda_cores(x, w, b, scale, shift, relu, zeros, top, left, want_stats)


def _upconv_fwd(x, w, b, scale, shift, relu, outer_padding, want_stats):
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    if not _on_cuda(x, w, b, scale, shift):
        out = upconv3x3_chw_plain(x, w, b, scale, shift, relu, outer_padding, want_stats)
        return out if want_stats else (out, None, None)
    out = _launch_upconv(x, w, b, scale, shift, relu, zeros, None, None, want_stats)
    LAUNCHES["upconv3x3_chw"] += 1
    return out


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
    additions of the combined kernels. On the card bf16 takes the
    tensor-core kernel (the combined weights rounded to bf16: its plain
    version is :func:`upconv3x3_chw_tc_plain`), float32 the CUDA-core
    one."""
    return _UpConv3x3Chw.apply(x, w, b, scale, shift, relu, outer_padding, want_stats)


def upconv3x3_chw_plain(x, w, b, scale, shift, relu: bool = True,
                        outer_padding: str = "replicate", want_stats: bool = False):
    """Plain PyTorch version of :func:`upconv3x3_chw`: the unfused pair,
    :func:`upsample2_chw_plain` then :func:`conv3x3_chw_plain` (independent
    of the phase algebra)."""
    return conv3x3_chw_plain(upsample2_chw_plain(x), w, b, scale, shift, relu, outer_padding,
                             want_stats)


def _upconv_rounding(a_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the bf16 route's rounding of the combined phase weights adds to
    y: each phase's 2x2 conv of the padded post-norm half-res slab ``a_pad``
    (N, C, H+2, W+2, float32) with bf16(wc) - wc, float32 (N, Co, 2H, 2W);
    zero where every combined weight is a bf16 value."""
    co, c = w.shape[:2]
    wc = _upconv_phase_weights(w)
    d = (wc.to(torch.bfloat16).float() - wc).reshape(co, c, 2, 2, 2, 2)
    n, _, hp, wp = a_pad.shape
    h, wd = hp - 2, wp - 2
    y = a_pad.new_zeros(n, co, 2 * h, 2 * wd)
    for di in range(2):
        for dj in range(2):
            # phase (di, dj) reads slab rows i - 1 + di + r: padded rows i + di + r
            y[:, :, di::2, dj::2] = F.conv2d(a_pad[:, :, di:di + h + 1, dj:dj + wd + 1],
                                             d[:, :, di, dj])
    return y


def upconv3x3_chw_tc_plain(x, w, b, scale, shift, relu: bool = True,
                           outer_padding: str = "replicate", want_stats: bool = False):
    """Plain version of K9's bf16 tensor-core route: the combined phase
    weights rounded to bf16 after combining (the reference's bf16 rounding,
    pallas_conv.py:1819), float32 sums, y rounded once. Written as
    :func:`upconv3x3_chw_plain`'s float32 conv plus :func:`_upconv_rounding`
    (the phase form is that conv with the combined weights), so that on
    combined weights that are bf16 values it is the plain version bit for
    bit."""
    mode = "replicate" if outer_padding == "replicate" else "constant"
    a_up = F.pad(prenorm(upsample2_chw_plain(x), scale, shift, relu).float(), (1, 1, 1, 1),
                 mode=mode)
    a_pad = F.pad(prenorm(x, scale, shift, relu).float(), (1, 1, 1, 1), mode=mode)
    y = (F.conv2d(a_up, w.float(), b.float()) + _upconv_rounding(a_pad, w)).to(x.dtype)
    if want_stats:
        return (y, *_stats_plain(y))
    return y


def upconv3x3_chw_halo(x, w, b, scale, shift, relu: bool, outer_padding: str,
                       top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """K14's kernel: :func:`upconv3x3_chw` (no stats) whose padded half-res
    input takes its top row (N, C, Wh+2, corners included) and left column
    (N, C, Hh) post-norm from the caller where given; every other border
    cell is the own edge (replicate) or zero. x (N, C, Hh, Wh) raw at half
    resolution -> y (N, Co, 2Hh, 2Wh). Routed as :func:`upconv3x3_chw`
    (bf16's plain version: :func:`upconv3x3_chw_halo_tc_plain`)."""
    zeros = _check_padding(outer_padding)
    _check_conv3x3(x, w, b, scale, shift)
    _check_borders(x, top, left)
    if not _on_cuda(x, w, b, scale, shift, top, left):
        return upconv3x3_chw_halo_plain(x, w, b, scale, shift, relu, outer_padding, top, left)
    y, _, _ = _launch_upconv(x, w, b, scale, shift, relu, zeros, top, left)
    LAUNCHES["chw_upconv_halo_step"] += 1
    return y


def upconv3x3_chw_halo_plain(x, w, b, scale, shift, relu: bool, outer_padding: str,
                             top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """Plain PyTorch version of :func:`upconv3x3_chw_halo`, independent of
    the phase algebra: the bordered post-norm half-res slab, nearest-2x,
    one full-res ring cropped (the full-res border is the half-res one
    doubled), then F.conv2d in float32."""
    padded = _halo_padded(x, scale, shift, relu, outer_padding, top, left)
    up = upsample2_chw_plain(padded)[..., 1:-1, 1:-1]
    return F.conv2d(up.float(), w.float(), b.float()).to(x.dtype)


def upconv3x3_chw_halo_tc_plain(x, w, b, scale, shift, relu: bool, outer_padding: str,
                                top: Optional[torch.Tensor], left: Optional[torch.Tensor]):
    """Plain version of K14's bf16 tensor-core route:
    :func:`upconv3x3_chw_halo_plain` plus :func:`_upconv_rounding` on the
    same bordered slab (the combined weights rounded to bf16,
    pallas_conv.py:2094)."""
    padded = _halo_padded(x, scale, shift, relu, outer_padding, top, left)
    up = upsample2_chw_plain(padded)[..., 1:-1, 1:-1]
    y = F.conv2d(up.float(), w.float(), b.float()) + _upconv_rounding(padded.float(), w)
    return y.to(x.dtype)


def chw_upconv_halo_step(x, w, b, scale, shift, relu: bool, outer_padding: str,
                         site: SiteState, pos: GridPos, gh: int, gw: int):
    """K14: one raster step of a fused up-conv block's conv1 (``--fuse_up
    all``): nearest-2x -> BN fold -> ReLU -> local-padded 3x3 conv of the
    raw half-res input ``x`` (N, C, Hm, Wm). The site's halo cache holds
    post-norm values at HALF resolution (the fused block's conv1 site spec
    is halved, ``models/generator.py: generator_site_specs``): the unfused
    site's full-res halo row and column are these doubled, so the borders
    and the cache update are :func:`chw_halo_step`'s on the half-res grid.
    Returns (y (N, Co, 2Hm, 2Wm), updated SiteState); ``row_write`` is
    updated in place. ``pos`` may be a :class:`LanePos`."""
    top, left = _borders(x, scale, shift, relu, outer_padding, site, pos, gw)
    y = upconv3x3_chw_halo(x, w, b, scale, shift, relu, outer_padding, top, left)
    return y, _halo_update(x, scale, shift, relu, site, pos, gh, gw)


def upconv3x3_chw_dx(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """K9 dx: the input-side gradient of :func:`upconv3x3_chw` from ``g``
    (N, Co, 2H, 2W). da is the transposed conv of g summed over each 2x2
    child block, with the replicate border folds (corners twice) on the
    half-res slab or none (zeros), masked by the ReLU of ``scale*x + shift``.
    Returns (dx = da·scale in x's dtype, d(scale) = Σ da·x, d(shift) = Σ da),
    the sums in float32 over (N, H, W). On the card bf16 takes the
    tensor-core kernel (the combined 4x4 weights rounded to bf16: its plain
    version is :func:`upconv3x3_chw_dx_tc_plain`), float32 the CUDA-core one."""
    zeros = _check_padding(outer_padding)
    co = w.shape[0]
    _check_bwd(x, g, co, scale, shift, up=2)
    _check_param("w", w, (co, x.shape[1], 3, 3))
    if not _on_cuda(x, g, w, scale, shift):
        return upconv3x3_chw_dx_plain(x, g, w, scale, shift, relu, outer_padding)
    if x.dtype == torch.bfloat16:
        out = _dx_tensor_cores("itg_upconv3x3_chw_dx_tc", x, g, w, scale, shift, relu, zeros)
    else:
        out = _upconv_dx_cuda_cores(x, g, w, scale, shift, relu, zeros)
    LAUNCHES["upconv3x3_chw_dx"] += 1
    return out


def upconv3x3_chw_dx_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`upconv3x3_chw_dx`: the pair's
    :func:`conv3x3_chw_dx_plain` on up2(x) in float32, then
    :func:`upsample2_chw_bwd_plain`, rounded once to x's dtype."""
    dx, dsc, dsh = conv3x3_chw_dx_plain(upsample2_chw_plain(x).float(), g, w, scale, shift, relu,
                                        outer_padding)
    return upsample2_chw_bwd_plain(dx).to(x.dtype), dsc, dsh


def upconv3x3_chw_dx_tc_plain(x, g, w, scale, shift, relu: bool, outer_padding: str):
    """Plain version of K9 dx's bf16 tensor-core route: the phase form the
    kernel computes, the stride-2 conv of g with the combined 4x4 weights
    rounded to bf16 after combining (pallas_conv.py:1637-1639) on the padded
    half-res grid, then :func:`conv3x3_chw_dx_plain`'s border fold, mask and
    sums, in float32."""
    wt = _upconv_dx_weights(w).to(torch.bfloat16).float()
    dpad = F.conv2d(g.float(), wt.transpose(0, 1), stride=2, padding=3)  # (N, C, H+2, W+2)
    return _dx_from_padded(dpad, x, scale, shift, relu, outer_padding)


# K9 dW's tensor-core route (csrc/upconv_dw_tc.cu): K7's tiling at half
# resolution, M = the input channels padded to MT x 16, N = the output
# channels padded to NO x 8, one template per MT and NO. A block keeps both
# phase rows where all 16 phase taps of every m16 tile fit its 8 warps (MT x
# NO <= 8), else the phase row di is a grid axis (the C file's phase_rows).
# Its persistent blocks (at most UPCONV_DW_TC_BLOCKS_PER_SM per SM and
# phase row) write per-block partial sums.
UPCONV_DW_TC_BLOCKS_PER_SM = 2


def upconv_dw_tc_plan(c: int, co: int) -> tuple[int, int, int]:
    """(MT, NO, PH) of the tensor-core K9 dW kernel for C input and Co
    output channels: K7's tiles (:func:`dw_tc_plan`) and the phase rows a
    block takes (2 where MT x NO <= 8, else 1). Raises for C > 64 or Co > 32
    (every training shape of the fused up-conv is inside)."""
    mt, no = _dw_tiles(c, co, "up-conv dW kernel")
    return mt, no, 2 if mt * no <= 8 else 1


def upconv_dw_tc_part_entries(mt: int, no: int, ph: int) -> int:
    """Floats of one block's partial (the C file's part_entries): the C
    fragments of 2 PH MT (phase, m16 tile) pairs x 4 taps x NO n8 tiles in
    fragment order, then db (8 NO)."""
    return 2 * ph * mt * 4 * no * 128 + 8 * no


# K9 dW's float32 route (csrc/upconv_dw_f32.cu): K7's scheme with the 16
# phase taps. Persistent blocks, one an SM, each walking a contiguous range
# of chunks (rows half-res rows x 32 columns of one image) through a double
# buffer of cp.async stages. A thread owns UPCONV_DW_F32_TILE (2 output x 4
# input channels) at one phase row di (8 taps); a block holds up to
# UPCONV_DW_F32_MAX_TILES of them (32 output x 52 input channels: every
# training shape of the fused up-conv) for both phase rows in each of its
# pixel slots, a power of two of them, as many as UPCONV_DW_F32_THREADS
# threads hold and at most the 32 runs of an 8-row chunk. (4 output channels
# a thread, 256 threads a block, read 17% slower at 52 -> 26 on an H100:
# f32_route_study.py.) Wider layers split the channels over the grid's
# second axis. The chunk's rows are the one of UPCONV_DW_F32_ROWS (whose two
# stages fit the shared memory, with a run of 8 pixels for every slot) with
# the least ceil(chunks / blocks) x (rows + UPCONV_DW_F32_CHUNK_COST): the
# busiest block's chunks, each costing its rows and a fixed part (staging,
# the BN fold, two barriers) worth about one row, as f32_route_study.py's
# plan table reads them on an H100 at the Experiment-1 shapes. A block's
# partial is one row of Co C 16 + Co floats (dW per phase tap, then db); the
# last launch folds the taps to 3 x 3.
UPCONV_DW_F32_TILE = (2, 4)
UPCONV_DW_F32_MAX_TILES = (16, 13)
UPCONV_DW_F32_COLS = 32
UPCONV_DW_F32_RUN = 8
UPCONV_DW_F32_ROWS = (1, 2, 4, 8)
UPCONV_DW_F32_CHUNK_COST = 1
UPCONV_DW_F32_THREADS = 512
UPCONV_DW_F32_STAGES = 2


class UpconvDwF32Plan(NamedTuple):
    tiles_o: int  # a block's output tiles of 2 channels
    tiles_c: int  # its input tiles of 4
    slots: int  # pixel slots a block: a power of two, slots x tiles_o x tiles_c x 2 <= 512,
    # at most the 32 runs of an 8-row chunk
    threads: int  # slots x tiles_o x tiles_c x 2, rounded up to a warp
    rows: int  # half-res rows a chunk
    chunks: int  # N x ceil(H / rows) x ceil(W / 32)
    channel_blocks: int  # ceil(C / 52) x ceil(Co / 32): the grid's second axis
    blocks: int  # the grid's first axis: min(chunks, SMs / channel blocks), at least 1
    part_entries: int  # Co C 16 + Co: a block's partial row


def upconv_dw_stage_bytes(rows: int, tiles_o: int, tiles_c: int) -> int:
    """Bytes of one cp.async stage of the float32 K9 dW kernel: rows + 2
    half-res rows of x (its ring) and 2 rows full-res rows of g, each row its
    channels side by side, 35 (x) and 65 (g) floats apart."""
    (to, tc), cols = UPCONV_DW_F32_TILE, UPCONV_DW_F32_COLS
    return 4 * ((rows + 2) * tc * tiles_c * (cols + 3) + 2 * rows * to * tiles_o * (2 * cols + 1))


def upconv_dw_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> UpconvDwF32Plan:
    """The float32 K9 dW kernel's launch for x (N, C, H, W) at half
    resolution and g (N, Co, 2H, 2W) on a card of ``sms`` SMs: the block's
    channel tiles, its pixel slots and threads, the chunk's rows, the chunks
    and the grid; the entry point launches this grid. Raises for an empty
    shape, N > 65535 or a half-res plane of 2^31 pixels or more."""
    if min(n, c, co, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"upconv3x3_chw_dw (float32) takes 1 <= N <= 65535, 1 <= C, Co, H, W "
                         f"and H W < 2^31, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    (to, tc), (mo, mc) = UPCONV_DW_F32_TILE, UPCONV_DW_F32_MAX_TILES
    tiles_o, tiles_c = min(-(-co // to), mo), min(-(-c // tc), mc)
    per_slot = tiles_o * tiles_c * 2
    cols = UPCONV_DW_F32_COLS
    slots = min(1 << (UPCONV_DW_F32_THREADS // per_slot).bit_length() - 1,
                max(UPCONV_DW_F32_ROWS) * cols // UPCONV_DW_F32_RUN)
    channel_blocks = -(-c // (tc * mc)) * -(-co // (to * mo))
    extra = 4 * (2 * tc * mc + to * mo)  # the scales and shifts, phase row 1's db

    def layout(rows):  # (chunks, blocks, the stages' and the extras' bytes)
        chunks = n * -(-h // rows) * -(-w // cols)
        return (chunks, max(1, min(chunks, sms // channel_blocks)),
                UPCONV_DW_F32_STAGES * upconv_dw_stage_bytes(rows, tiles_o, tiles_c) + extra)

    fits = [r for r in UPCONV_DW_F32_ROWS
            if slots * UPCONV_DW_F32_RUN <= r * cols and layout(r)[2] <= CONV3X3_DW_F32_SMEM]
    rows = min(fits or UPCONV_DW_F32_ROWS[:1],
               key=lambda r: (-(-layout(r)[0] // layout(r)[1]) * (r + UPCONV_DW_F32_CHUNK_COST), r))
    chunks, blocks, _ = layout(rows)
    return UpconvDwF32Plan(tiles_o, tiles_c, slots, -(-slots * per_slot // 32) * 32, rows,
                           chunks, channel_blocks, blocks, co * c * 16 + co)


def _upconv_dw_cuda_cores(x, g, scale, shift, relu: bool, zeros: bool):
    """K9 dW on the CUDA cores (``itg_upconv3x3_chw_dw``): the float32 route
    (the C function takes bf16 too): persistent blocks on
    :func:`upconv_dw_f32_plan`'s grid write float32 partials per phase tap
    and db, a second launch sums them in one order and folds the taps; dW
    (Co, C, 3, 3), db."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    plan = upconv_dw_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    dw = torch.empty((co, c, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((plan.blocks, plan.part_entries), dtype=torch.float32, device=x.device)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw_dw(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, c, h, wd, co, int(relu), int(zeros), _bf16(x),
            plan.blocks, plan.slots, plan.rows, _stream(x),
        )
    _raise_on(rc, "itg_upconv3x3_chw_dw")
    ROUTE_LAUNCHES["itg_upconv3x3_chw_dw"] += 1
    return dw, db


def _upconv_dw_tensor_cores(x, g, scale, shift, relu: bool, zeros: bool):
    """K9 dW on the tensor cores (``itg_upconv3x3_chw_dw_tc``), bf16:
    persistent blocks write float32 partials, a second launch sums them in
    one order; dwc (Co, C, 16) per phase tap, db."""
    n, c, h, wd = x.shape
    co = g.shape[1]
    mt, no, ph = upconv_dw_tc_plan(c, co)
    cap = UPCONV_DW_TC_BLOCKS_PER_SM * _sm_count(x.device.index)
    dwc = torch.empty((co, c, 16), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((2 // ph * cap, upconv_dw_tc_part_entries(mt, no, ph)),
                       dtype=torch.float32, device=x.device)
    sc, sh = _f32(scale), _f32(shift)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upconv3x3_chw_dw_tc(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), sh.data_ptr(), part.data_ptr(),
            dwc.data_ptr(), db.data_ptr(), n, c, h, wd, co, int(relu), int(zeros), mt, no, cap,
            _stream(x),
        )
    _raise_on(rc, "itg_upconv3x3_chw_dw_tc")
    ROUTE_LAUNCHES["itg_upconv3x3_chw_dw_tc"] += 1
    return dwc, db


def upconv3x3_chw_dw(x, g, scale, shift, relu: bool, outer_padding: str):
    """K9 dW: dW (Co, C, 3, 3) and db (Co,) of :func:`upconv3x3_chw`, float32
    sums over (N, 2H, 2W). The kernels sum per phase tap from the half-res
    slab. On the card bf16 takes the tensor-core kernel (both operands are
    bf16 values, so its plain version is :func:`upconv3x3_chw_dw_plain`
    itself), whose (Co, C, 16) taps the wrapper folds back to 3x3; float32
    the CUDA-core one, which folds them in its last launch."""
    zeros = _check_padding(outer_padding)
    co = g.shape[1]
    _check_bwd(x, g, co, scale, shift, up=2)
    if not _on_cuda(x, g, scale, shift):
        return upconv3x3_chw_dw_plain(x, g, scale, shift, relu, outer_padding)
    if x.dtype == torch.bfloat16:
        dwc, db = _upconv_dw_tensor_cores(x, g, scale, shift, relu, zeros)
        dw = _upconv_unpack_dw(dwc)
    else:
        dw, db = _upconv_dw_cuda_cores(x, g, scale, shift, relu, zeros)
    LAUNCHES["upconv3x3_chw_dw"] += 1
    return dw, db


def upconv3x3_chw_dw_plain(x, g, scale, shift, relu: bool, outer_padding: str):
    """Plain PyTorch version of :func:`upconv3x3_chw_dw`: the pair's
    :func:`conv3x3_chw_dw_plain` on up2(x)."""
    return conv3x3_chw_dw_plain(upsample2_chw_plain(x), g, scale, shift, relu, outer_padding)


# K10's plan (csrc/upsample2_chw.cu): a thread takes one 16-byte vector of
# an x row (its pair's four output chunks shared with the neighbouring
# lane, so a row's vectors lie along threadIdx.x, an even count), one x row
# at a time, or two where whole blocks of two rows a thread still leave
# UP2ADD_BLOCKS_PER_SM blocks an SM. A block takes a chunk of one plane's
# rows, at most UP2ADD_THREADS threads (the C file's kAddThreads); chunks
# are cut as small as that many blocks need (down to one row: blocks of a
# few threads at N = 1). On an H100 many small blocks moved the bytes
# faster than fewer large ones (k10_plan_study.py).
UP2ADD_THREADS = 64
UP2ADD_BLOCKS_PER_SM = 8


class Up2AddPlan(NamedTuple):
    bx: int  # threads along a row's vectors (even)
    by: int  # threads along the rows
    rows: int  # x rows a thread takes at once (1 or 2)
    chunk: int  # x rows a block takes
    grid: tuple  # (row chunks, planes or at most 65535: the blocks loop over the rest)
    part_rows: int  # rows of the (part_rows, 2C) float32 partials with stats: N x row chunks


def upsample2_add_plan(n: int, c: int, h: int, w: int, elem_bytes: int = 2, sms: int = 132,
                       threads: int = UP2ADD_THREADS,
                       blocks_per_sm: int = UP2ADD_BLOCKS_PER_SM) -> Up2AddPlan:
    """K10's launch for x (N, C, H, W) of ``elem_bytes``-byte elements on a
    card of ``sms`` SMs: the block (at most ``threads``), the rows a thread
    takes at once, the x rows of a block, the grid (at least
    ``blocks_per_sm`` blocks an SM where the rows allow) and the rows of
    the stats' partials. Raises for an empty x or H * W >= 2^29 (the
    kernel's 32-bit plane indices)."""
    if min(n, c, h, w) < 1 or h * w >= 1 << 29:
        raise ValueError(f"upsample2_chw_add takes 1 <= N, C, H, W and H * W < 2^29, "
                         f"got {(n, c, h, w)}")
    nvec = -(-w // (16 // elem_bytes))
    bx = min(nvec + nvec % 2, threads)
    by_max = threads // bx
    fill = n * c * h // (blocks_per_sm * sms)  # x rows a block may take
    rows = 2 if fill >= 2 * by_max else 1
    chunk = min(2 * by_max if rows == 2 else max(1, min(by_max, fill)), h)
    chunks = -(-h // chunk)
    chunk = -(-h // chunks)  # the same chunks, balanced
    return Up2AddPlan(bx, -(-chunk // rows), rows, chunk, (chunks, min(n * c, 65535)),
                      n * chunks)


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
    plan = upsample2_add_plan(n, c, h, wd, x.element_size(), _sm_count(x.device.index))
    y = torch.empty_like(res)
    part = s1 = s2 = None
    if want_stats:
        part = torch.empty((plan.part_rows, 2 * c), dtype=torch.float32, device=x.device)
        s1 = torch.empty(c, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        rc = _lib().itg_upsample2_chw_add(
            x.data_ptr(), res.data_ptr(), y.data_ptr(), _ptr(part), _ptr(s1), _ptr(s2),
            n * c, c, h, wd, plan.bx, plan.by, plan.rows, plan.chunk, _bf16(x), _stream(x),
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
    Differentiable in x and res and through the stats.

    On the card one launch moves 16-byte vectors (x once, res and y in
    whole 32-byte sectors; element by element where a row is ragged or
    unaligned) over the grid of :func:`upsample2_add_plan`, adding in
    float32 with one rounding at the store, so y is bit-equal to
    :func:`upsample2_chw_add_plain`. With stats each block writes its sums
    of the stored y and y² (one fixed order) as partials, and a second
    launch adds them in one fixed order: two calls give the same bits, and
    no atomics."""
    return _Upsample2ChwAdd.apply(x, res, want_stats)


def upsample2_chw_add_plain(x, res, want_stats: bool = False):
    """Plain PyTorch version of :func:`upsample2_chw_add`."""
    y = upsample2_chw_plain(x) + res
    if want_stats:
        return (y, *_stats_plain(y))
    return y


# ---------------------------------------------------------------------------
# K13: the discriminator stem, 4x4 / stride 2 / zero pad 1 (in float32 the
# forward: csrc/stem_fwd_f32.cu, dW: csrc/stem_dw_f32.cu, dx:
# csrc/stem_dx_f32.cu; in bf16 csrc/stem_fwd_tc.cu, csrc/stem_dw_tc.cu,
# csrc/stem_dx_tc.cu)


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


# The tensor-core route (csrc/stem_fwd_tc.cu): N = every output channel,
# padded to 8-channel groups with zero weight rows, K = one k16 step (the
# 4 x 4 taps) per input channel. STEM_TC_MAX_CO is the C file's kMaxCo: the
# widest Co whose block (the NHWC output tile, the weights) fits in a
# block's shared memory at C = 4.
STEM_TC_MAX_CO = 512


def stem_chw_takes(dtype: torch.dtype, co: int) -> bool:
    """Whether K13's route for ``dtype`` takes ``co`` output channels: the
    bf16 tensor-core route up to STEM_TC_MAX_CO, the float32 CUDA-core route
    any. The discriminator sends a stem that no route takes down its NHWC
    path (``models/discriminator.py: stem_takes_chw``)."""
    return dtype != torch.bfloat16 or co <= STEM_TC_MAX_CO


def stem_tc_plan(c: int, co: int) -> int:
    """The number of 8-channel groups (NO, Co padded up to 8 NO) of the
    tensor-core stem forward for C input and Co output channels. Raises for
    C outside 1..4 or Co outside 1..STEM_TC_MAX_CO (a block's shared
    memory)."""
    if not 1 <= c <= 4 or not 1 <= co <= STEM_TC_MAX_CO:
        raise ValueError(f"the tensor-core stem forward takes 1 <= C <= 4 and 1 <= Co <= "
                         f"{STEM_TC_MAX_CO} (a block's shared memory), got C={c}, Co={co}")
    return -(-co // 8)


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the tensor-core stem's B operand, which each block
    of the kernel builds in shared memory: w (Co, C, 4, 4) -> bf16 (8 NO,
    16 C), row o holding w[o, c, ky, kx] at column 16 c + 4 ky + kx, zero
    past Co."""
    co, c = w.shape[:2]
    no = stem_tc_plan(c, co)
    wp = F.pad(w.detach().float().reshape(co, 16 * c), (0, 0, 0, 8 * no - co))
    return wp.to(torch.bfloat16)


# K13's float32 forward (csrc/stem_fwd_f32.cu): a tile is 8 output rows x 32
# columns x 64 output channels of one image; the kernel's blocks stay on the
# card, STEM_F32_BLOCKS_PER_SM an SM (its __launch_bounds__), and walk the
# tiles of one channel chunk.
STEM_F32_TILE = (8, 32, 64)
STEM_F32_BLOCKS_PER_SM = 3


class StemF32Plan(NamedTuple):
    tiles: int  # N x row bands x column tiles
    chunks: int  # ceil(Co / 64): the grid's second axis
    blocks: int  # the grid's first axis: min(tiles, the blocks of a chunk the card holds)


def stem_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> StemF32Plan:
    """The float32 stem forward's grid for x (N, C, H, W) and Co output
    channels on a card of ``sms`` SMs: its tiles, channel chunks and the
    blocks of a chunk, as many as the card holds at once beside the other
    chunks' and no more than there are tiles. Raises for C outside 1..4, an
    odd or empty H or W, Co < 1 or N < 1."""
    if not 1 <= c <= 4 or h < 2 or w < 2 or h % 2 or w % 2 or co < 1 or n < 1:
        raise ValueError(f"the float32 stem forward takes 1 <= C <= 4, even H, W >= 2, Co >= 1 "
                         f"and N >= 1, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    rows, cols, width = STEM_F32_TILE
    tiles = n * -(-(h // 2) // rows) * -(-(w // 2) // cols)
    chunks = -(-co // width)
    return StemF32Plan(tiles, chunks, min(tiles, -(-STEM_F32_BLOCKS_PER_SM * sms // chunks)))


def _stem_fwd_cuda_cores(x, w, b):
    """K13's forward on the CUDA cores (``itg_stem_fwd``): the float32 route
    (the C function takes bf16 too), on :func:`stem_f32_plan`'s grid."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    plan = stem_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    y = torch.empty((n, h // 2, wd // 2, co), dtype=x.dtype, device=x.device)
    wf, bf = _f32(w), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_fwd(x.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(),
                                 n, c, h, wd, co, _bf16(x), plan.blocks, _stream(x))
    _raise_on(rc, "itg_stem_fwd")
    ROUTE_LAUNCHES["itg_stem_fwd"] += 1
    return y


def _stem_fwd_tensor_cores(x, w, b):
    """K13's forward on the tensor cores (``itg_stem_fwd_tc``), bf16: the
    kernel rounds w and b to bf16 (as :func:`pack_stem_weights`)."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    stem_tc_plan(c, co)
    y = torch.empty((n, h // 2, wd // 2, co), dtype=x.dtype, device=x.device)
    wf, bf = _f32(w), _f32(b)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_fwd_tc(x.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(),
                                    n, c, h, wd, co, _stream(x))
    _raise_on(rc, "itg_stem_fwd_tc")
    ROUTE_LAUNCHES["itg_stem_fwd_tc"] += 1
    return y


def stem_fwd(x, w, b):
    """K13 forward: y = conv4x4/s2/pad1(x) + b with x channels-major
    (N, C, H, W) and y NHWC (N, H/2, W/2, Co), in x's dtype. On the card
    bf16 takes the tensor-core kernel (w and b rounded to bf16: its plain
    version is :func:`stem_fwd_tc_plain`), float32 the CUDA-core one."""
    _check_stem(x, w)
    co = w.shape[0]
    _check_param("b", b, (co,))
    if not _on_cuda(x, w, b):
        return stem_fwd_plain(x, w, b)
    route = _stem_fwd_tensor_cores if x.dtype == torch.bfloat16 else _stem_fwd_cuda_cores
    y = route(x, w, b)
    LAUNCHES["stem_fwd"] += 1
    return y


def stem_fwd_plain(x, w, b):
    """Plain PyTorch version of :func:`stem_fwd`."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def stem_fwd_tc_plain(x, w, b):
    """Plain version of K13's bf16 tensor-core route: :func:`stem_fwd_plain`
    with w and b rounded to bf16 first (the products of bf16 values are
    exact in float32; the sums are float32, y is rounded once)."""
    wr = w.detach().to(torch.bfloat16).float()
    br = b.detach().to(torch.bfloat16).float()
    return stem_fwd_plain(x, wr, br)


# K13 dW's tensor-core route (csrc/stem_dw_tc.cu): M = the 16 C taps (an m16
# tile per input channel), N = the output channels, up to STEM_DW_TC_CO_BLOCK
# per block (more split across the grid), K = the pixels. Its persistent
# blocks (at most STEM_DW_TC_BLOCKS_PER_SM per SM) write per-block partial
# sums in dW's own layout.
STEM_DW_TC_CO_BLOCK = 64
STEM_DW_TC_BLOCKS_PER_SM = 3


def stem_dw_tc_plan(c: int, co: int) -> int:
    """The number of STEM_DW_TC_CO_BLOCK-channel chunks (the grid's second
    axis) of the tensor-core stem dW for C input and Co output channels.
    Raises for C outside 1..4 or Co outside 1..STEM_TC_MAX_CO (the forward's
    --D_ch limit)."""
    if not 1 <= c <= 4 or not 1 <= co <= STEM_TC_MAX_CO:
        raise ValueError(f"the tensor-core stem dW takes 1 <= C <= 4 and 1 <= Co <= "
                         f"{STEM_TC_MAX_CO}, got C={c}, Co={co}")
    return -(-co // STEM_DW_TC_CO_BLOCK)


# K13 dW's float32 route (csrc/stem_dw_f32.cu): persistent blocks, one an SM
# for each chunk of STEM_DW_F32_CO output channels (the grid's second axis),
# each walking a contiguous range of chunks (rows output rows x
# STEM_DW_F32_COLS columns of one image) through a double buffer of
# cp.async stages. A block's warps are its pixel slots, STEM_DW_F32_SLOTS
# of them (8 at C = 4: 32 C + 8 sums a thread); a slot takes runs of
# STEM_DW_F32_RUN pixels along a row. The chunk's rows are the one of
# STEM_DW_F32_ROWS (whose two stages fit the shared memory, with a run for
# every slot) with the least ceil(chunks / blocks) x (runs a slot a chunk x
# STEM_DW_F32_RUN + STEM_DW_F32_CHUNK_COST): the busiest slot's pixels, each
# chunk costing a fixed part (staging, two barriers, the window's first
# columns) worth STEM_DW_F32_CHUNK_COST pixels, as f32_route_study.py's plan
# table reads them on an H100 at the float32 training shapes. A block's
# partial is one row of Co 16 C + Co floats (dW, then db).
STEM_DW_F32_CO = 64
STEM_DW_F32_COLS = 32
STEM_DW_F32_RUN = 16
STEM_DW_F32_SLOTS = 12
STEM_DW_F32_ROWS = (2, 3, 4, 6, 8, 12)
STEM_DW_F32_CHUNK_COST = 16
STEM_DW_F32_XS = 68  # floats a staged x row


class StemDwF32Plan(NamedTuple):
    slots: int  # warps a block: its pixel slots
    rows: int  # output rows a chunk
    chunks: int  # N x ceil(H/2 / rows) x ceil(W/2 / 32)
    channel_blocks: int  # ceil(Co / 64): the grid's second axis
    blocks: int  # the grid's first axis: min(chunks, SMs / channel blocks), at least 1
    part_entries: int  # Co 16 C + Co: a block's partial row


def stem_dw_f32_plans(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> list:
    """Every plan the float32 K13 dW planner chooses from for x (N, C, H, W)
    and g (N, H/2, W/2, Co) on a card of ``sms`` SMs: one for each chunk
    height of STEM_DW_F32_ROWS that gives every slot a run and whose two
    stages fit the shared memory. Raises for C outside 1..4, an odd or empty
    H or W, Co < 1, N < 1 or a plane of 2^31 pixels or more."""
    if not 1 <= c <= 4 or h < 2 or w < 2 or h % 2 or w % 2 or co < 1 or n < 1 or h * w >= 2**31:
        raise ValueError(f"the float32 stem dW takes 1 <= C <= 4, even H, W >= 2, H W < 2^31, "
                         f"Co >= 1 and N >= 1, got N={n}, C={c}, Co={co}, H={h}, W={w}")
    slots = 8 if c == 4 else STEM_DW_F32_SLOTS
    runs = STEM_DW_F32_COLS // STEM_DW_F32_RUN
    channel_blocks = -(-co // STEM_DW_F32_CO)
    blocks_cap = max(1, sms // channel_blocks)
    plans = []
    for rows in STEM_DW_F32_ROWS:
        stage = 4 * (c * (2 * rows + 2) * STEM_DW_F32_XS + rows * STEM_DW_F32_COLS * STEM_DW_F32_CO)
        if slots > rows * runs or 2 * stage > CONV3X3_DW_F32_SMEM:
            continue
        chunks = n * -(-(h // 2) // rows) * -(-(w // 2) // STEM_DW_F32_COLS)
        plans.append(StemDwF32Plan(slots, rows, chunks, channel_blocks, min(chunks, blocks_cap),
                                   co * 16 * c + co))
    return plans


def stem_dw_f32_plan(n: int, c: int, co: int, h: int, w: int, sms: int = 132) -> StemDwF32Plan:
    """The float32 K13 dW kernel's launch for x (N, C, H, W) and g (N, H/2,
    W/2, Co) on a card of ``sms`` SMs: the block's slots, the chunk's rows,
    the chunks and the grid (the least busy slot of :func:`stem_dw_f32_plans`;
    the smaller chunk on a tie); the entry point launches this grid. Raises
    as :func:`stem_dw_f32_plans`."""
    runs = STEM_DW_F32_COLS // STEM_DW_F32_RUN

    def cost(p):
        per_slot = -(-p.rows * runs // p.slots) * STEM_DW_F32_RUN
        return -(-p.chunks // p.blocks) * (per_slot + STEM_DW_F32_CHUNK_COST), p.rows

    return min(stem_dw_f32_plans(n, c, co, h, w, sms), key=cost)


def _stem_dw_cuda_cores(x, g):
    """K13 dW on the CUDA cores (``itg_stem_dw``): the float32 route (the C
    function takes bf16 too): persistent blocks on
    :func:`stem_dw_f32_plan`'s grid write float32 partials of dW and db, a
    second launch sums them in one order."""
    n, c, h, wd = x.shape
    co = g.shape[-1]
    plan = stem_dw_f32_plan(n, c, co, h, wd, _sm_count(x.device.index))
    dw = torch.empty((co, c, 4, 4), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((plan.blocks, plan.part_entries), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_dw(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), n, c, h, wd, co, _bf16(x), plan.blocks, plan.slots,
                                plan.rows, _stream(x))
    _raise_on(rc, "itg_stem_dw")
    ROUTE_LAUNCHES["itg_stem_dw"] += 1
    return dw, db


def _stem_dw_tensor_cores(x, g):
    """K13 dW on the tensor cores (``itg_stem_dw_tc``), bf16: persistent
    blocks write float32 partials, a second launch sums them in one order."""
    n, c, h, wd = x.shape
    co = g.shape[-1]
    stem_dw_tc_plan(c, co)
    cap = STEM_DW_TC_BLOCKS_PER_SM * _sm_count(x.device.index)
    dw = torch.empty((co, c, 4, 4), dtype=torch.float32, device=x.device)
    db = torch.empty(co, dtype=torch.float32, device=x.device)
    part = torch.empty((cap, co * (16 * c + 1)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().itg_stem_dw_tc(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                   db.data_ptr(), n, c, h, wd, co, cap, _stream(x))
    _raise_on(rc, "itg_stem_dw_tc")
    ROUTE_LAUNCHES["itg_stem_dw_tc"] += 1
    return dw, db


def stem_dw(x, g):
    """K13 dW: dW[o, c, ky, kx] = Σ g[n, i, j, o]·x[n, c, 2i+ky-1, 2j+kx-1]
    (zero outside the image) and db = Σ g, float32 sums. ``g`` NHWC. On the
    card bf16 takes the tensor-core kernel (both operands are bf16 values,
    so its plain version is :func:`stem_dw_plain` itself), float32 the
    CUDA-core one."""
    _check_stem(x, torch.empty(g.shape[-1], x.shape[1], 4, 4))
    n, c, h, wd = x.shape
    co = g.shape[-1]
    _check_act("g", g, (n, h // 2, wd // 2, co))
    _check_same_dtype("g", g, x)
    if not _on_cuda(x, g):
        return stem_dw_plain(x, g)
    route = _stem_dw_tensor_cores if x.dtype == torch.bfloat16 else _stem_dw_cuda_cores
    out = route(x, g)
    LAUNCHES["stem_dw"] += 1
    return out


def stem_dw_plain(x, g):
    """Plain PyTorch version of :func:`stem_dw` (one einsum per tap)."""
    xp = F.pad(x.float(), (1, 1, 1, 1))
    gf = g.float()
    h2, w2 = g.shape[1:3]
    taps = [torch.einsum("nhwo,nchw->oc", gf, xp[:, :, ky : ky + 2 * h2 : 2, kx : kx + 2 * w2 : 2])
            for ky in range(4) for kx in range(4)]
    dw = torch.stack(taps, dim=-1).reshape(g.shape[-1], x.shape[1], 4, 4)
    return dw, gf.sum(dim=(0, 1, 2))


# K13 dx's tensor-core route (csrc/stem_dx_tc.cu): dx row r = 2p + py and
# column s = 2q + px; M = 16 phase columns q of one phase row p, N = (py, px,
# c) with c padded to 4 (two n8 tiles, one per py), K = the output channels,
# STEM_DX_TC_CO_CHUNK a stage. Each of the 9 shifts (di, dj) of g is a row
# address of one staged tile; its pack launch writes the 12 B operands
# (:func:`pack_stem_dx_weights`).
STEM_DX_TC_CO_CHUNK = 32


def stem_dx_tc_plan(c: int, co: int) -> int:
    """The number of STEM_DX_TC_CO_CHUNK-channel chunks of g (Co padded up
    with zero weights) of the tensor-core stem dx for C input and Co output
    channels. Raises for C outside 1..4 or Co outside 1..STEM_TC_MAX_CO (the
    forward's --D_ch limit)."""
    if not 1 <= c <= 4 or not 1 <= co <= STEM_TC_MAX_CO:
        raise ValueError(f"the tensor-core stem dx takes 1 <= C <= 4 and 1 <= Co <= "
                         f"{STEM_TC_MAX_CO}, got C={c}, Co={co}")
    return -(-co // STEM_DX_TC_CO_CHUNK)


def pack_stem_dx_weights(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the tensor-core stem dx's weight packing (which its C
    entry point runs on the card): w (Co, C, 4, 4) -> bf16 (12, 8, Co padded
    to STEM_DX_TC_CO_CHUNK), the B operand u = 6 py + 3 a + dj + 1 of the dx
    row parity py, the g row shift di = py - 1 + a and column shift dj, row
    n = 4 px + c: w[o, c, 3 - py - 2a, px + 1 - 2 dj] where that column tap
    lies in 0..3, zero elsewhere and past C and Co."""
    co, c = w.shape[:2]
    cop = STEM_DX_TC_CO_CHUNK * stem_dx_tc_plan(c, co)
    wf = w.detach().float()
    wp = torch.zeros((12, 8, cop), dtype=torch.float32, device=w.device)
    for py in range(2):
        for a in range(2):
            for dj in (-1, 0, 1):
                for px in range(2):
                    kx = px + 1 - 2 * dj
                    if 0 <= kx < 4:
                        u, ky = 6 * py + 3 * a + dj + 1, 3 - py - 2 * a
                        wp[u, 4 * px : 4 * px + c, :co] = wf[:, :, ky, kx].t()
    return wp.to(torch.bfloat16)


def _stem_dx_cuda_cores(g, w):
    """K13 dx on the CUDA cores (``itg_stem_dx``): the float32 route (the C
    function takes bf16 too, with w unrounded)."""
    n, h2, w2, co = g.shape
    c = w.shape[1]
    dx = torch.empty((n, c, 2 * h2, 2 * w2), dtype=g.dtype, device=g.device)
    wf = _f32(w)
    with torch.cuda.device(g.device):
        rc = _lib().itg_stem_dx(g.data_ptr(), wf.data_ptr(), dx.data_ptr(),
                                n, c, 2 * h2, 2 * w2, co, _bf16(g), _stream(g))
    _raise_on(rc, "itg_stem_dx")
    ROUTE_LAUNCHES["itg_stem_dx"] += 1
    return dx


def _stem_dx_tensor_cores(g, w):
    """K13 dx on the tensor cores (``itg_stem_dx_tc``), bf16: the entry point
    packs w (rounded to bf16, as :func:`pack_stem_dx_weights`), then runs the
    kernel."""
    n, h2, w2, co = g.shape
    c = w.shape[1]
    chunks = stem_dx_tc_plan(c, co)
    dx = torch.empty((n, c, 2 * h2, 2 * w2), dtype=g.dtype, device=g.device)
    wp = torch.empty((12, 8, STEM_DX_TC_CO_CHUNK * chunks), dtype=torch.bfloat16,
                     device=g.device)
    wf = _f32(w)
    with torch.cuda.device(g.device):
        rc = _lib().itg_stem_dx_tc(g.data_ptr(), wf.data_ptr(), wp.data_ptr(), dx.data_ptr(),
                                   n, c, 2 * h2, 2 * w2, co, _stream(g))
    _raise_on(rc, "itg_stem_dx_tc")
    ROUTE_LAUNCHES["itg_stem_dx_tc"] += 1
    return dx


def stem_dx(g, w):
    """K13 dx: the image-side gradient, channels-major (N, C, 2·H2, 2·W2)
    in g's dtype, from the NHWC cotangent ``g`` (N, H2, W2, Co). On the card
    bf16 takes the tensor-core kernel (w rounded to bf16: its plain version
    is :func:`stem_dx_tc_plain`), float32 the CUDA-core one."""
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
    route = _stem_dx_tensor_cores if g.dtype == torch.bfloat16 else _stem_dx_cuda_cores
    dx = route(g, w)
    LAUNCHES["stem_dx"] += 1
    return dx


def stem_dx_plain(g, w):
    """Plain PyTorch version of :func:`stem_dx` (F.conv_transpose2d)."""
    gc = g.float().permute(0, 3, 1, 2)
    return F.conv_transpose2d(gc, w.float(), stride=2, padding=1).to(g.dtype)


def stem_dx_tc_plain(g, w):
    """Plain version of K13 dx's bf16 tensor-core route: :func:`stem_dx_plain`
    with w rounded to bf16 first (the products of bf16 values are exact in
    float32; the sums are float32, dx is rounded once)."""
    return stem_dx_plain(g, w.detach().to(torch.bfloat16).float())


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
