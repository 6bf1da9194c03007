"""The plain side of K9 dW's tensor-core route (``upconv3x3_chw_dw`` in
bf16), on the CPU: the route's plan and its refusal above the limit, the
claim that the route needs no rounded plain version, a plain emulation of
the kernel's per-block partials and their fixed-order reduction, and the
plain version against the JAX reference's K9 dW in interpret mode. Inputs
are numpy arrays drawn from a seed.

The route multiplies bf16 g by the bf16 post-norm half-res slab A; both are
bf16 values, so every product is exact in float32, and
``upconv3x3_chw_dw_plain`` on bf16 tensors (the 3x3 dW of the upsampled
slab) is the function the kernel computes per phase tap and the wrapper
folds, up to the order of its float32 sums: held here to a float64 phase
form of the same bf16 operands at 1e-6 of max|ref|. Against JAX the inputs
lie on a bf16 grid (x and g small integers times 2^-4, scale powers of two,
shift multiples of 2^-4), so the bf16 operands are exact and the float32
reference computes the same products: 1e-4 of the largest reference entry,
as ``chip_smoke.py`` holds the kernel (SUM_TOL)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

EXACT_TOL = 1e-6
SUM_TOL = 1e-4
# the fused blocks' (C, Co) pairs of the Experiment-1 `auto` step, then ragged
# ones (C past an m16 tile, Co no multiple of 8)
PAIRS = [(52, 26), (26, 13), (13, 3), (17, 9)]
# the kernel's half-res tile (csrc/upconv_dw_tc.cu: kTH; csrc/chw_dw_tc.cuh: kTW)
TH, TW = 4, 32


def _close(got, ref, tol, name=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    limit = tol * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= limit, (name, err, limit)


def _grid_case(seed, n, c, co, h, w):
    """x (n, c, h, w) half-res and g (n, co, 2h, 2w) (small integers x 2^-4),
    scale (powers of two), shift (multiples of 2^-4): every post-norm value
    and every g is exact in bf16."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c, h, w)) / 16).astype(np.float32)
    g = (rng.integers(-16, 17, (n, co, 2 * h, 2 * w)) / 16).astype(np.float32)
    sc = (2.0 ** rng.integers(-1, 2, c)).astype(np.float32)
    sh = (rng.integers(-8, 9, c) / 16).astype(np.float32)
    return x, g, sc, sh


def _bf16_case(seed, n, c, co, h, w):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((n, co, 2 * h, 2 * w)).astype(np.float32)).bfloat16()
    sc = torch.from_numpy((1 + 0.3 * rng.standard_normal(c)).astype(np.float32))
    sh = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    return x, g, sc, sh


def _slab64(x, sc, sh, outer):
    """The padded post-norm half-res slab A in float64: prenorm rounded to
    x's dtype, then a replicate or zero ring."""
    mode = "replicate" if outer == "replicate" else "constant"
    return F.pad(tk.prenorm(x, sc, sh, True).double(), (1, 1, 1, 1), mode=mode)


def _phase_taps(a, gd, rows=None, cols=None):
    """dwc (Co, C, 16) of the phase form in float64 over half-res pixels
    (i, j) in ``rows`` x ``cols`` (all by default): entry ((di 2 + dj) 2 +
    r) 2 + s sums g[o, 2i + di, 2j + dj] A[c, i + di + r, j + dj + s]."""
    h, w = a.shape[2] - 2, a.shape[3] - 2
    rows = rows or (0, h)
    cols = cols or (0, w)
    i0, i1 = rows
    j0, j1 = cols
    out = []
    for di in range(2):
        for dj in range(2):
            gp = gd[:, :, 2 * i0 + di:2 * i1:2, 2 * j0 + dj:2 * j1:2]
            for r in range(2):
                for s in range(2):
                    ap = a[:, :, i0 + di + r:i1 + di + r, j0 + dj + s:j1 + dj + s]
                    out.append(torch.einsum("nohw,nchw->oc", gp, ap))
    return torch.stack(out, dim=-1)


@pytest.mark.parametrize("c,co,want", [(52, 26, (4, 4, 1)), (26, 13, (2, 2, 2)),
                                       (13, 3, (1, 1, 2)), (26, 26, (2, 4, 2)),
                                       (64, 32, (4, 4, 1)), (64, 16, (4, 2, 2)),
                                       (17, 9, (2, 2, 2)), (16, 32, (1, 4, 2))])
def test_upconv_dw_tc_plan(c, co, want):
    """M pads C to 16 MT, N pads Co to 8 NO; a block keeps both phase rows
    where MT NO <= 8, else the phase row is a grid axis."""
    assert tk.upconv_dw_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(65, 13), (13, 33), (104, 52)])
def test_upconv_dw_tc_plan_refuses_wider(c, co):
    with pytest.raises(ValueError, match="up-conv dW kernel takes C <= 64 and Co <= 32"):
        tk.upconv_dw_tc_plan(c, co)


def test_upconv_dw_tc_plan_matches_kernel():
    """The plan's phase rows, partial size and tile are the C files' rules."""
    csrc = Path(tk.__file__).parents[1] / "csrc"
    src = (csrc / "upconv_dw_tc.cu").read_text()
    assert re.search(r"phase_rows\(int mt, int no\) \{ return mt \* no <= 8 \? 2 : 1; \}", src)
    assert "return 2 * phase_rows(mt, no) * mt * 4 * no * 128 + 8 * no;" in src
    assert re.search(rf"constexpr int kTH = {TH};", src)
    assert re.search(rf"constexpr int kTW = {TW};", (csrc / "chw_dw_tc.cuh").read_text())


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", PAIRS)
def test_upconv_dw_plain_bf16_is_exact_product_sum(outer, c, co):
    """upconv3x3_chw_dw_plain on bf16 tensors against the phase form in
    float64 of the same bf16 operands (A = prenorm rounded to bf16, g),
    folded to 3x3: the route needs no rounding twin, and the fold is the
    transpose of the phase weights."""
    x, g, sc, sh = _bf16_case(c * 100 + co, 2, c, co, 5, 7)
    dw, db = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    ref = tk._upconv_unpack_dw(_phase_taps(_slab64(x, sc, sh, outer), g.double()))
    assert dw.dtype == db.dtype == torch.float32
    _close(dw, ref, EXACT_TOL, "dW")
    _close(db, g.double().sum(dim=(0, 2, 3)), EXACT_TOL, "db")


def _fragment_slots(c, co, mt, no, ph_local, tap):
    """Entry of the kernel's per-block partial (csrc/upconv_dw_tc.cu,
    fragment order) that holds (o, c) of (local phase, tap), as (Co, C)."""
    cc = np.arange(c)[None, :]
    oo = np.arange(co)[:, None]
    p = ph_local * mt + cc // 16
    row, col = cc % 16, oo % 8
    e = (row // 8) * 2 + col % 2
    lane = (row % 8) * 4 + col // 2
    return ((((p * 4 + tap) * no + oo // 8) * 4 + e) * 32 + lane).astype(np.int64)


def _reduce_like_kernel(part, c, co, mt, no):
    """The reduce launch's mapping (upconv_dw_tc_reduce_kernel) on float64
    partials (gy, blocks, entries): dwc (Co, C, 16) and db (Co,)."""
    gy = part.shape[0]
    efrag = part.shape[2] - 8 * no
    dwc = np.full((co, c, 16), np.nan)
    for row0 in range(gy):
        sums = part[row0].sum(axis=0)
        for e in range(efrag):
            lane, q, j = e % 32, (e // 32) % 4, (e // 128) % no
            tap, p = (e // (128 * no)) % 4, e // (512 * no)
            ph = (2 * row0 if gy == 2 else 0) + p // mt
            cc = 16 * (p % mt) + lane // 4 + 8 * (q >> 1)
            o = 8 * j + 2 * (lane % 4) + (q & 1)
            if cc < c and o < co:
                dwc[o, cc, ph * 4 + tap] = sums[e]
    db = part[:, :, efrag:efrag + co].sum(axis=(0, 1))
    return dwc, db


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co,n,h,w,blocks", [(52, 26, 2, 9, 37, 3), (26, 13, 1, 6, 40, 2),
                                               (13, 3, 2, 4, 30, 5)])
def test_upconv_dw_tc_partials_emulation(outer, c, co, n, h, w, blocks):
    """A plain emulation of the kernel's bookkeeping: tile t (image, kTH x kTW
    half-res corner) goes to block t % blocks of each phase-row block; each
    block's (phase, tap) sums land in fragment order, db after them; the
    reduce launch's mapping (fixed order over the blocks) gives back dwc per
    phase tap and db, which fold to the plain version."""
    x, g, sc, sh = _bf16_case(c + co + h, n, c, co, h, w)
    mt, no, ph = tk.upconv_dw_tc_plan(c, co)
    gy, entries = 2 // ph, tk.upconv_dw_tc_part_entries(mt, no, ph)
    efrag = entries - 8 * no
    a, gd = _slab64(x, sc, sh, outer), g.double()
    tiles_h, tiles_w = -(-h // TH), -(-w // TW)
    part = np.zeros((gy, blocks, entries))
    for t in range(n * tiles_h * tiles_w):
        img, h0, w0 = t // (tiles_h * tiles_w), (t // tiles_w) % tiles_h * TH, t % tiles_w * TW
        rows, cols = (h0, min(h0 + TH, h)), (w0, min(w0 + TW, w))
        taps = _phase_taps(a[img:img + 1], gd[img:img + 1], rows, cols).numpy()
        for k in range(16):
            di, dj, tap = k // 8, (k // 4) % 2, k % 4
            by = di if gy == 2 else 0
            local = dj if gy == 2 else 2 * di + dj
            np.add.at(part[by, t % blocks], _fragment_slots(c, co, mt, no, local, tap), taps[..., k])
        for by in range(gy):
            g_rows = gd[img, :, 2 * rows[0]:2 * rows[1], 2 * cols[0]:2 * cols[1]]
            if gy == 2:
                g_rows = g_rows[:, by::2]
            part[by, t % blocks, efrag:efrag + co] += g_rows.sum(dim=(1, 2)).numpy()
    dwc, db = _reduce_like_kernel(part, c, co, mt, no)
    assert not np.isnan(dwc).any()
    dw_ref, db_ref = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    _close(tk._upconv_unpack_dw(torch.from_numpy(dwc)), dw_ref, EXACT_TOL, "dW")
    _close(db, db_ref, EXACT_TOL, "db")


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", PAIRS[:2])
def test_upconv_dw_plain_bf16_matches_jax(outer, c, co):
    """K9 dW: dW and db of the reference's upconv3x3_chw_p VJP (float32,
    interpret mode, a 128-lane carry with an edge fill and a zero cotangent in
    the pad columns) against the plain version on bf16 tensors of the same
    grid values."""
    w_true = 8
    x, g, sc, sh = _grid_case(c + co, 2, c, co, 8, w_true)
    k = np.zeros((3, 3, c, co), np.float32)
    b = np.zeros((co,), np.float32)
    wp = pc._round_up_128(w_true)
    x_pad = np.concatenate([x, np.repeat(x[..., -1:], wp - w_true, axis=-1)], axis=-1)

    def f(k_, b_):
        return pc.upconv3x3_chw_p(jnp.asarray(x_pad), k_, b_, jnp.asarray(sc), jnp.asarray(sh),
                                  True, outer, w_true, False)

    y, vjp = jax.vjp(f, jnp.asarray(k), jnp.asarray(b))
    g_pad = np.zeros(y.shape, np.float32)
    g_pad[..., :2 * w_true] = g
    jdk, jdb = vjp(jnp.asarray(g_pad))
    dw, db = tk.upconv3x3_chw_dw_plain(torch.from_numpy(x).bfloat16(),
                                       torch.from_numpy(g).bfloat16(), torch.from_numpy(sc),
                                       torch.from_numpy(sh), True, outer)
    _close(dw, np.transpose(np.asarray(jdk), (3, 2, 0, 1)), SUM_TOL, "dW")
    _close(db, jdb, SUM_TOL, "db")


def test_upconv_dw_on_cpu_takes_plain_version():
    """A CPU tensor runs the plain version, in either dtype, and counts no
    launch on either route."""
    x, g, sc, sh = _bf16_case(3, 1, 13, 3, 4, 6)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        got = tk.upconv3x3_chw_dw(x.to(dtype), g.to(dtype), sc, sh, True, "replicate")
        ref = tk.upconv3x3_chw_dw_plain(x.to(dtype), g.to(dtype), sc, sh, True, "replicate")
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tk.LAUNCHES["upconv3x3_chw_dw"] == 0
    assert tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_dw_tc"] == tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_dw"] == 0
