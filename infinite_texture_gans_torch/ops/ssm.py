"""K15, the SSM embed chain: wrapper, plain versions and its Function.

Counterpart of ``infinite_texture_gans_tpu/ops/pallas_ssm.py``. The
stochastic spatial modulation predicts a per-pixel gamma|beta from a random
map through two valid 3x3 convs with a ReLU between (reference
``models/layers.py:203-234``)::

    maps (N, md, H+4, W+4) -> conv3x3(w1, b1) -> ReLU -> conv3x3(w2, b2)
                           -> (N, 2C, H, W)

- :func:`ssm_embed` (forward): replaces pallas_ssm.py:343
  ``ssm_embed_fwd_call``;
- :func:`ssm_embed_bwd` (dW2, db2, dW1, db1): replaces pallas_ssm.py:392
  ``ssm_embed_bwd_call``.

The route on the card depends on the maps' dtype alone, with no fallback:

- **bfloat16** takes the tensor-core kernels of ``csrc/ssm_embed_tc.cu``
  (``itg_ssm_embed_tc_fwd``, ``itg_ssm_embed_tc_bwd``): implicit GEMMs on
  Hopper's wgmma with bf16 operands and float32 sums. As in the reference kernel,
  the hidden activation and d_pre are rounded to bf16 (pallas_ssm.py:143-147,
  :295) and w2 is cast to it (:490-493); stage 1 keeps float32 weights.
  The backward sums its partials in a fixed order, so two calls give the
  same bits. A call these kernels cannot launch raises. Their backward's
  plain version is :func:`ssm_embed_bwd_tc_plain`, which applies the same
  roundings.
- **float32** takes the CUDA-core kernels of ``csrc/ssm_embed_chw.cu``
  (``itg_ssm_embed_fwd``, ``itg_ssm_embed_bwd``), which round nothing but the
  output: the exactness route of step parity and the f32 raster. The
  forward runs on :func:`fwd_f32_plan`'s grid, the backward on
  :func:`bwd_f32_plan`'s launches, whose partials are summed in a fixed
  order too, so two calls give the same bits.
- CPU tensors take the plain versions.

``ROUTE_LAUNCHES`` counts the launches of each C entry point. The maps are
random latents with no trainable producer, so their cotangent is zero by
contract (pallas_ssm.py:472-475) and is not computed. The reference's
default backward (``bwd_impl='xla'``) was chosen by TPU measurement; it
differentiates the same chain, so the port's kernel backward gives the same
numbers. Weights are OIHW float32; the output has the maps' dtype. The
launches count in ``kernels.LAUNCHES`` under ``ssm_embed`` and
``ssm_embed_bwd``, one per call whatever the route.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.kernels import (
    CONV3X3_DW_F32_SMEM,
    _check_act,
    _check_param,
    _f32,
    _lib,
    _on_cuda,
    _raise_on,
    _sm_count,
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


# launches per C entry point: the bf16 tensor-core route and the f32 CUDA-core one
ROUTE_LAUNCHES = {"itg_ssm_embed_tc_fwd": 0, "itg_ssm_embed_tc_bwd": 0,
                  "itg_ssm_embed_fwd": 0, "itg_ssm_embed_bwd": 0}

# The tensor-core kernels' tiling, as csrc/ssm_embed_tc.cu has it: forward
# output blocks of NT x 8 channels (one template per NT: 56 and 104 take the
# models' Co of 52, 104 and 208, zero weights pad any other), 32 hidden
# channels per forward chunk, 16 per dW2 block, 16 output channels per d_act
# chunk, 128 hidden channels per d_act block, 8 x 16 pixels per backward tile.
TC_NT = (7, 13)
TC_KC, TC_WC, TC_OC, TC_HB = 32, 16, 16, 128
TC_TILE = (8, 16)
# blocks the backward's launches aim for: two per SM of a 132-SM H100. A
# constant, not the card's count, so the partials (and the bits) depend on
# the shapes alone.
TC_BLOCKS = 264


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tc_plan(co: int) -> tuple[int, int]:
    """(NT, blocks): the output-channel block of NT x 8 channels that pads
    Co least, the wider on a tie, and the number of such blocks."""
    return min(((nt, _cdiv(co, 8 * nt)) for nt in TC_NT),
               key=lambda p: (p[1] * p[0] * 8, p[1]))


def tc_shares(n: int, h: int, w: int, hid: int, co: int) -> tuple[int, int]:
    """The backward's fixed shares of tiles: (S1 for d_act on the (H+2) x
    (W+2) hidden grid, S2 for dW2 on the H x W output grid, whose blocks
    take 16 hidden channels and 64 output channels, or 128 past Co 64)."""
    th, tw = TC_TILE
    tiles1 = n * _cdiv(h + 2, th) * _cdiv(w + 2, tw)
    tiles2 = n * _cdiv(h, th) * _cdiv(w, tw)
    oblocks = _cdiv(co, 64 if co <= 64 else 128)
    s1 = min(tiles1, max(1, TC_BLOCKS // _cdiv(hid, TC_HB)))
    s2 = min(tiles2, max(1, TC_BLOCKS // (_cdiv(hid, TC_WC) * oblocks)))
    return s1, s2


# The float32 route's backward (csrc/ssm_embed_chw.cu), three launches. (1)
# d_act, d_pre and the dW1 / db1 partials: a block per (16 x 32 tile of the
# (H+2) x (W+2) hidden grid, F32_HB hidden channels, image), a partial row
# per tile. (2) dW2 and db2: persistent blocks, F32_BLOCK2 (4 output x 8
# hidden channels) register tiles at each row tap, up to F32_MAX_TILES2 of
# them in a block (52 output x 32 hidden channels; more split over the
# grid's second axis) in each of its pixel slots, a power of two of them, as
# many as F32_THREADS2 threads hold and the chunk has runs of 8 pixels for;
# s2 blocks for each channel block, one an SM, each walking a contiguous
# range of chunks (rows2 output rows x 32 columns). The chunk's rows2 is the
# one of F32_ROWS2 (whose two stages fit the shared memory) with the least
# ceil(chunks / s2) x (rows2 + F32_CHUNK_COST2): the busiest block's
# chunks, each costing its rows and a fixed part (its hidden activation's
# two halo rows, staging, three barriers) worth about F32_CHUNK_COST2 rows.
# (3) The partials summed in one fixed order.
F32_HB = 32
F32_TILE1 = (16, 32)
F32_BLOCK2 = (4, 8)
F32_MAX_TILES2 = (13, 4)
F32_THREADS2 = 384
F32_COLS2 = 32
F32_RUN2 = 8
F32_ROWS2 = (2, 4, 6, 8)
F32_CHUNK_COST2 = 2


# The float32 route's forward (csrc/ssm_embed_chw.cu): a block per (16 x 32
# output tile, F32_FWD_CO x warps output channels, image), a warp per 8
# channels; each chunk of F32_FWD_KC hidden channels is computed once a
# block. The plan takes the block width of F32_FWD_WARPS with the least
# cost: the busiest SM's blocks (all resident at once) x a block's work
# (its active warps' FMAs plus F32_FWD_HIDDEN warps' worth of hidden
# activation) over the warps that issue in parallel, at most F32_FWD_ISSUE
# an SM. So a grid of fewer, wider blocks wins where each SM gets one
# anyway (the eval sub-image's 96^2 sites), as the card reads it
# (f32_route_study.py's plan table).
F32_FWD_TILE = (16, 32)
F32_FWD_CO = 8
F32_FWD_KC = 8
F32_FWD_WARPS = (4, 2, 1)
F32_FWD_HIDDEN = 0.5
F32_FWD_ISSUE = 4


class SsmFwdF32Plan(NamedTuple):
    warps: int  # warps a block: F32_FWD_CO output channels each
    tiles: int  # N x the output's 16 x 32 tiles
    channel_blocks: int  # the grid's second axis: ceil(Co / (8 warps))
    blocks: int  # tiles x channel_blocks
    smem: int  # bytes of dynamic shared memory a block


def _fwd_smem(md: int, warps: int) -> int:
    """Bytes of shared memory of a forward block: two stages of a chunk's
    hidden activation (18 x 36 floats a channel) and of its w2 slice (9 rows
    a channel of 8 x warps floats, padded to 8 or 24 modulo 32), the maps
    tile (20 x 36 a map channel) and 4 floats of slack its last window
    reads past."""
    wrow = 8 * warps + (0 if warps % 2 else 8)
    th, tw = F32_FWD_TILE
    return 4 * (2 * F32_FWD_KC * (th + 2) * 36 + 2 * F32_FWD_KC * 9 * wrow
                + md * (th + 4) * (tw + 4) + 4)


def fwd_f32_plans(n: int, md: int, hid: int, h: int, w: int, co: int, sms: int = 132) -> list:
    """Every plan the float32 K15 forward's planner chooses from for maps
    (N, md, H+4, W+4), hid hidden and Co output channels on a card of
    ``sms`` SMs: one for each block width of F32_FWD_WARPS whose shared
    memory fits the card's. Raises for an empty shape, N > 65535 or a map_dim
    whose shared memory exceeds the card's."""
    if min(n, md, hid, h, w, co) < 1 or n > 65535:
        raise ValueError(f"ssm_embed (float32) takes 1 <= N <= 65535 and md, hid, H, W, Co >= 1, "
                         f"got N={n}, md={md}, hid={hid}, H={h}, W={w}, Co={co}")
    th, tw = F32_FWD_TILE
    tiles = n * _cdiv(h, th) * _cdiv(w, tw)
    plans = []
    for warps in F32_FWD_WARPS:
        smem = _fwd_smem(md, warps)
        if smem > CONV3X3_DW_F32_SMEM:
            continue
        cb = _cdiv(co, F32_FWD_CO * warps)
        plans.append(SsmFwdF32Plan(warps, tiles, cb, tiles * cb, smem))
    if not plans:
        raise ValueError(f"ssm_embed (float32): map_dim {md} exceeds the shared memory of a block "
                         f"({_fwd_smem(md, 1)} bytes)")
    return plans


@lru_cache(maxsize=64)
def fwd_f32_plan(n: int, md: int, hid: int, h: int, w: int, co: int,
                 sms: int = 132) -> SsmFwdF32Plan:
    """The float32 K15 forward's grid for maps (N, md, H+4, W+4), hid hidden
    and Co output channels on a card of ``sms`` SMs: the plan of
    :func:`fwd_f32_plans` with the least cost (see F32_FWD_HIDDEN), the more
    warps a block on a tie, kept for each shape. Every plan gives the same
    bits. Raises as :func:`fwd_f32_plans`."""
    groups = _cdiv(co, F32_FWD_CO)

    def cost(p):
        busiest = _cdiv(p.blocks, sms)
        work = groups / p.channel_blocks + F32_FWD_HIDDEN
        return busiest * work / min(F32_FWD_ISSUE, busiest * p.warps), -p.warps

    return min(fwd_f32_plans(n, md, hid, h, w, co, sms), key=cost)


class SsmBwdF32Plan(NamedTuple):
    s1: int  # part1 rows: N x the hidden grid's tiles
    slots2: int  # dW2's pixel slots a block
    rows2: int  # output rows a dW2 chunk
    chunks2: int  # N x ceil(H / rows2) x ceil(W / 32)
    channel_blocks2: int  # dW2's grid second axis: hidden x output channel blocks
    s2: int  # part2 rows: dW2's blocks for each channel block


def _bwd1_smem(md: int) -> int:
    """Bytes of shared memory of the backward's first launch: two stages of
    4 output channels' g tiles (18 x 36 floats) and flipped w2 (9 x 32),
    the maps tile (18 x 36 a map channel), w1 and b1."""
    return 4 * (2 * (4 * 18 * 36 + 4 * 9 * F32_HB) + md * 18 * 36 + F32_HB * (9 * md + 1))


def bwd_f32_plans(n: int, md: int, hid: int, h: int, w: int, co: int, sms: int = 132) -> list:
    """Every plan the float32 K15 backward's planner chooses from for maps
    (N, md, H+4, W+4), hid hidden and Co output channels on a card of
    ``sms`` SMs: one for each dW2 chunk height of F32_ROWS2 whose two stages
    fit the shared memory. Raises for an empty shape, N > 65535 or a map_dim
    whose first launch's shared memory exceeds the card's."""
    if min(n, md, hid, h, w, co) < 1 or n > 65535:
        raise ValueError(f"ssm_embed_bwd (float32) takes 1 <= N <= 65535 and md, hid, H, W, Co "
                         f">= 1, got N={n}, md={md}, hid={hid}, H={h}, W={w}, Co={co}")
    if _bwd1_smem(md) > CONV3X3_DW_F32_SMEM:
        raise ValueError(f"ssm_embed_bwd (float32): map_dim {md} exceeds the shared memory of "
                         f"its first launch ({_bwd1_smem(md)} bytes)")
    th, tw = F32_TILE1
    s1 = n * _cdiv(h + 2, th) * _cdiv(w + 2, tw)
    (to, tc), (mo, mc) = F32_BLOCK2, F32_MAX_TILES2
    tiles_o, tiles_c = min(_cdiv(co, to), mo), min(_cdiv(hid, tc), mc)
    channel_blocks = _cdiv(_cdiv(co, to), mo) * _cdiv(_cdiv(hid, tc), mc)
    per_slot = tiles_o * tiles_c * 3
    plans = []
    for rows in F32_ROWS2:
        slots = 1
        while 2 * slots * per_slot <= F32_THREADS2 and 2 * slots <= rows * F32_COLS2 // F32_RUN2:
            slots *= 2
        ars, grs = tc * tiles_c * (F32_COLS2 + 3), to * tiles_o * (F32_COLS2 + 1)
        stage = 4 * ((rows + 2) * ars + rows * grs + md * (rows + 4) * (F32_COLS2 + 4))
        if 2 * stage > CONV3X3_DW_F32_SMEM:
            continue
        chunks = n * _cdiv(h, rows) * _cdiv(w, F32_COLS2)
        plans.append(SsmBwdF32Plan(s1, slots, rows, chunks, channel_blocks,
                                   max(1, min(chunks, sms // channel_blocks))))
    if not plans:
        raise ValueError(f"ssm_embed_bwd (float32): map_dim {md} leaves no dW2 chunk that fits "
                         "the shared memory")
    return plans


def bwd_f32_plan(n: int, md: int, hid: int, h: int, w: int, co: int, sms: int = 132) -> SsmBwdF32Plan:
    """The float32 K15 backward's launches for maps (N, md, H+4, W+4), hid
    hidden and Co output channels on a card of ``sms`` SMs (the least
    ceil(chunks / s2) x (rows2 + F32_CHUNK_COST2) of :func:`bwd_f32_plans`,
    the smaller chunk on a tie): part1's and part2's rows and dW2's chunks
    and grid. Raises as :func:`bwd_f32_plans`."""
    return min(bwd_f32_plans(n, md, hid, h, w, co, sms),
               key=lambda p: (_cdiv(p.chunks2, p.s2) * (p.rows2 + F32_CHUNK_COST2), p.rows2))


def pack_w2_fwd(w2: torch.Tensor) -> torch.Tensor:
    """w2 (Co, hid, 3, 3) -> bf16 (blocks, hid chunks, 9, 2, NT, 2, 8, 8): w2
    as wgmma's K-major B core matrices, w2[o, c, tap] at [o // NB][c // 32]
    [tap][(c % 32) // 16][(o % NB) // 8][(c % 16) // 8][o % 8][c % 8], NB =
    8 NT, zero past Co and hid."""
    co, hid = w2.shape[:2]
    nt, ncb = tc_plan(co)
    nch = _cdiv(hid, TC_KC)
    w = F.pad(w2.detach().reshape(co, hid, 9), (0, 0, 0, nch * TC_KC - hid, 0, ncb * 8 * nt - co))
    w = w.view(ncb, nt, 8, nch, 2, 2, 8, 9)  # o -> (block, ng, oi), c -> (chunk, ks, kh, ci)
    return w.permute(0, 3, 7, 4, 1, 5, 2, 6).to(torch.bfloat16, memory_format=torch.contiguous_format)


def pack_w2_dact(w2: torch.Tensor) -> torch.Tensor:
    """w2 (Co, hid, 3, 3) -> bf16 (hid blocks, Co chunks, 9, 16, 2, 8, 8): the
    flipped taps of the transposed conv as wgmma's K-major B core matrices,
    w2[o, c, 2 - sy, 2 - sx] at [c // 128][o // 16][sy * 3 + sx][(c % 128) // 8]
    [(o % 16) // 8][c % 8][o % 8], zero past Co and hid."""
    co, hid = w2.shape[:2]
    noc, nhb = _cdiv(co, TC_OC), _cdiv(hid, TC_HB)
    w = w2.detach().reshape(co, hid, 9).flip(2)  # tap 3 sy + sx takes 8 - (3 sy + sx)
    w = F.pad(w, (0, 0, 0, nhb * TC_HB - hid, 0, noc * TC_OC - co))
    w = w.view(noc, 2, 8, nhb, TC_HB // 8, 8, 9)  # o -> (chunk, kh, oi), c -> (block, cg, ci)
    return w.permute(3, 0, 6, 4, 1, 5, 2).to(torch.bfloat16, memory_format=torch.contiguous_format)


def _launch(entry: str, *args) -> int:
    rc = getattr(_lib(), entry)(*args)
    if rc == 0:
        ROUTE_LAUNCHES[entry] += 1
    return rc


def _fwd(maps, w1, b1, w2, b2):
    n, md, hid, co, h, w = _check(maps, w1, b1, w2)
    _check_param("b2", b2, (co,))
    if not _on_cuda(maps, w1, b1, w2, b2):
        return ssm_embed_plain(maps, w1, b1, w2, b2)
    y = torch.empty((n, co, h, w), dtype=maps.dtype, device=maps.device)
    with torch.cuda.device(maps.device):
        if maps.dtype == torch.bfloat16:
            rc = _launch(
                "itg_ssm_embed_tc_fwd", maps.data_ptr(), _f32(w1).data_ptr(),
                _f32(b1).data_ptr(), pack_w2_fwd(w2).data_ptr(), _f32(b2).data_ptr(),
                y.data_ptr(), n, md, hid, h, w, co, tc_plan(co)[0], _stream(maps),
            )
        else:
            plan = fwd_f32_plan(n, md, hid, h, w, co, _sm_count(maps.device.index))
            rc = _launch(
                "itg_ssm_embed_fwd", maps.data_ptr(), _f32(w1).data_ptr(), _f32(b1).data_ptr(),
                _f32(w2).data_ptr(), _f32(b2).data_ptr(), y.data_ptr(), n, md, hid, h, w, co,
                plan.warps, _stream(maps),
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
    dev = maps.device
    dw2 = torch.empty((co, hid, 3, 3), dtype=torch.float32, device=dev)
    db2 = torch.empty(co, dtype=torch.float32, device=dev)
    dw1 = torch.empty((hid, md, 3, 3), dtype=torch.float32, device=dev)
    db1 = torch.empty(hid, dtype=torch.float32, device=dev)
    tc = maps.dtype == torch.bfloat16
    if tc:
        s1, s2 = tc_shares(n, h, w, hid, co)
    else:
        plan = bwd_f32_plan(n, md, hid, h, w, co, _sm_count(dev.index))
        s1, s2 = plan.s1, plan.s2
    # the launches' partial sums, added in a fixed order by their last launch
    part1 = torch.empty((s1, hid, 9 * md + 1), dtype=torch.float32, device=dev)
    part2 = torch.empty((s2, co, hid, 9), dtype=torch.float32, device=dev)
    partb2 = torch.empty((s2, co), dtype=torch.float32, device=dev)
    outs = (part1.data_ptr(), part2.data_ptr(), partb2.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            dw1.data_ptr(), db1.data_ptr())
    with torch.cuda.device(dev):
        if tc:
            rc = _launch(
                "itg_ssm_embed_tc_bwd", maps.data_ptr(), _f32(w1).data_ptr(), _f32(b1).data_ptr(),
                pack_w2_dact(w2).data_ptr(), g.data_ptr(), *outs, n, md, hid, h, w, co, s1, s2,
                _stream(maps),
            )
        else:
            rc = _launch(
                "itg_ssm_embed_bwd", maps.data_ptr(), _f32(w1).data_ptr(), _f32(b1).data_ptr(),
                _f32(w2).data_ptr(), g.data_ptr(), *outs, n, md, hid, h, w, co, s2, plan.rows2,
                _stream(maps),
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


def _pre_f32(maps, w1, b1):
    """The bf16 route's float32 pre-activation, summed as its kernels sum it
    (``hidden_pre_at`` in csrc/ssm_embed_tc.cu): one fma per (map channel,
    tap) in that order, then the bias. Each step is exact in float64 and
    rounded once to float32, as an fma is."""
    m, w = maps.detach().double(), w1.detach().double()
    n, md, hm, wm = m.shape
    acc = torch.zeros((n, w.shape[0], hm - 2, wm - 2), dtype=torch.float32, device=m.device)
    for k in range(md):
        for dy in range(3):
            for dx in range(3):
                tap = m[:, k : k + 1, dy : dy + hm - 2, dx : dx + wm - 2]
                acc = (acc.double() + tap * w[:, k, dy, dx].view(1, -1, 1, 1)).float()
    return (acc.double() + b1.detach().double().view(1, -1, 1, 1)).float()


def ssm_embed_bwd_tc_plain(maps, w1, b1, w2, g):
    """Plain version of the bf16 tensor-core route of :func:`ssm_embed_bwd`:
    its chain with the route's roundings, in float64 between them, returned
    as float32. The pre-activation is the route's float32 one
    (:func:`_pre_f32`), so the rounded hidden activation and the ReLU mask
    are the kernels' own; the hidden activation, w2 and d_pre are rounded
    to bf16 (pallas_ssm.py:143-147, :490-493, :295), and db1 sums the
    rounded d_pre that dW1 takes. Without the roundings the sums move by
    about 2^-9 of their size, far more than a float32 reduction does."""
    r = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    m, gd = maps.detach().double(), g.detach().double()
    pre = _pre_f32(maps, w1, b1)
    a = r(torch.relu(pre))
    dw2 = torch.nn.grad.conv2d_weight(a, w2.shape, gd)
    d_pre = r(torch.nn.grad.conv2d_input(a.shape, r(w2.detach()), gd) * (pre > 0))
    dw1 = torch.nn.grad.conv2d_weight(m, w1.shape, d_pre)
    return tuple(t.float() for t in (dw2, gd.sum(dim=(0, 2, 3)), dw1, d_pre.sum(dim=(0, 2, 3))))


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
