"""The plain side of the tensor-core route of K9's forward (``upconv3x3_chw``,
with its sums) and K14 (``upconv3x3_chw_halo``), on the CPU in float32: the
route's plan, the weight packing the kernel reads, the plain versions with
the route's rounding (``*_tc_plain``) against today's plain versions, and
against the JAX reference's ``upconv3x3_chw_p`` and
``chw_upconv_halo_step`` in interpret mode. Inputs are numpy arrays drawn
from a seed.

Where the rounded plain versions are held to today's bit for bit, the
weights are small integers times 2^-4: their combined 2x2 sums of up to
four are then bf16 values, and the route's rounding changes nothing.
Against JAX, the reference's combined weights are rounded to bf16 after
combining, as its own bf16 path rounds them
(``_pack_w_upconv(w).astype(x.dtype)``), and the port is given the
unrounded weights; tolerances as ``tests/test_torch_fwd_tc.py``'s (float32
sums taken in another order): y to ATOL + RTOL |ref|, the sums to SUM_TOL
of max|ref|."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infinite_texture_gans_tpu.ops import padding as jpad
from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import _build
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import padding as tpad
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

ATOL, RTOL = 2e-4, 1e-4
SUM_TOL = 1e-4
BORDERS = {"none": (False, False), "top": (True, False), "left": (False, True),
           "both": (True, True)}
HALO_POSITIONS = [(True, True, 0), (True, False, 1), (False, True, 0), (False, False, 1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, n, c, co, h, w, grid=False):
    """Half-res x (n, c, h, w), OIHW weights (small integers times 2^-4 with
    ``grid``, else Gaussian), bias, BN fold scale/shift, post-norm-like
    borders top (n, c, w + 2) and left (n, c, h); float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    if grid:
        k = (rng.integers(-8, 9, (co, c, 3, 3)) / 16).astype(np.float32)
    else:
        k = f(co, c, 3, 3, a=(9 * c) ** -0.5)
    return dict(x=f(n, c, h, w), k=k, b=f(co, a=0.1), sc=1 + f(c, a=0.3), sh=f(c, a=0.3),
                top=np.maximum(f(n, c, w + 2), 0), left=np.maximum(f(n, c, h), 0))


def _args(d):
    return [_t(d[k]) for k in ("x", "k", "b", "sc", "sh")]


@pytest.mark.parametrize("c,co,want", [(3, 3, (1, 1)), (26, 13, (4, 2)), (52, 26, (7, 4)),
                                       (104, 52, (13, 7)), (128, 64, (16, 8)), (65, 57, (9, 8))])
def test_upconv_tc_plan(c, co, want):
    """K pads C to 8 NC per slot; N pads Co to 8 NO, NO one of FWD_TC_NO."""
    assert tk.upconv_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(129, 13), (13, 65)])
def test_upconv_tc_plan_refuses_wider(c, co):
    with pytest.raises(ValueError, match="up-conv forward takes C <= 128 and Co <= 64"):
        tk.upconv_tc_plan(c, co)


@pytest.mark.parametrize("c,co", [(3, 3), (13, 5), (26, 13), (104, 52), (11, 19)])
def test_pack_upconv_weights_round_trip(c, co):
    """The B operands are the combined phase weights rounded to bf16 after
    combining, phase-major, zero in the padding of C and Co."""
    w = _t(np.random.default_rng(c * 100 + co).standard_normal((co, c, 3, 3)).astype(np.float32))
    wp = tk.pack_upconv_weights(w)
    nc, no = tk.upconv_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert tuple(wp.shape) == (4, 8 * no, 4, 8 * nc)
    assert not wp[:, co:].any() and not wp[..., c:].any()
    want = tk._upconv_phase_weights(w).reshape(co, c, 4, 4).to(torch.bfloat16)
    assert torch.equal(wp[:, :co, :, :c].permute(1, 3, 0, 2), want)


def _source():
    return (Path(tk.__file__).parents[1] / "csrc" / "upconv_fwd_tc.cu").read_text()


def test_upconv_tc_partials_rows_match_kernel():
    """The partials the wrapper allocates with stats have a row for every
    block the entry point may launch: UPCONV_TC_MAX_BLOCKS is the C file's
    kMaxBlocks."""
    rows = re.search(r"constexpr int kMaxBlocks = (\d+);", _source())
    assert rows and int(rows.group(1)) == tk.UPCONV_TC_MAX_BLOCKS


def test_upconv_tc_entry_point_signature():
    """The ctypes binding of ``itg_upconv3x3_chw_tc`` takes the C entry
    point's parameters in order: pointers, then ints, then the stream."""
    params = re.search(r'extern "C" int itg_upconv3x3_chw_tc\(([^)]*)\)', _source()).group(1)
    kinds = [ctypes.c_void_p if "*" in q else ctypes.c_int for q in params.split(",")]
    assert kinds == _build.SIGNATURES["itg_upconv3x3_chw_tc"]


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", [(3, 3), (13, 5), (26, 13)])
def test_upconv3x3_tc_plain_equals_plain(outer, want_stats, c, co):
    """On weights whose combined sums are bf16 values the rounded plain
    version is today's, y (and both sums) bit for bit."""
    args = _args(_case(c + co, 2, c, co, 5, 7, grid=True))
    got = tk.upconv3x3_chw_tc_plain(*args, True, outer, want_stats=want_stats)
    ref = tk.upconv3x3_chw_plain(*args, True, outer, want_stats=want_stats)
    for a, r in zip(*((got, ref) if want_stats else ((got,), (ref,)))):
        assert torch.equal(a, r)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("borders", list(BORDERS))
def test_upconv3x3_halo_tc_plain_equals_plain(outer, borders):
    d = _case(7, 2, 13, 5, 6, 11, grid=True)
    t_, l_ = BORDERS[borders]
    top, left = (_t(d["top"]) if t_ else None), (_t(d["left"]) if l_ else None)
    got = tk.upconv3x3_chw_halo_tc_plain(*_args(d), True, outer, top, left)
    assert torch.equal(got, tk.upconv3x3_chw_halo_plain(*_args(d), True, outer, top, left))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_upconv_tc_plain_is_the_rounded_phase_form(outer):
    """Off the bf16 grid the rounded plain version moves away from today's
    by about the combined weights' rounding (2^-9 relative each), and it is
    the phase form itself (four 2x2 convs of the padded half-res slab with
    the combined weights rounded to bf16) up to float32 regrouping."""
    x, w, b, sc, sh = _args(_case(3, 1, 26, 13, 6, 9))
    got = tk.upconv3x3_chw_tc_plain(x, w, b, sc, sh, True, outer)
    ref = tk.upconv3x3_chw_plain(x, w, b, sc, sh, True, outer)
    err = float((got - ref).abs().max())
    assert 0 < err <= 2.0**-7 * float(ref.abs().max())
    a_pad = F.pad(tk.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode=outer)
    wc = tk._upconv_phase_weights(w).to(torch.bfloat16).float().reshape(13, 26, 2, 2, 2, 2)
    phase = torch.empty_like(got)
    for di in range(2):
        for dj in range(2):
            phase[:, :, di::2, dj::2] = F.conv2d(a_pad[:, :, di:di + 7, dj:dj + 10],
                                                 wc[:, :, di, dj], b)
    torch.testing.assert_close(got, phase, rtol=0, atol=1e-5 * float(phase.abs().max()))


@pytest.fixture
def jax_rounds_combined_weights(monkeypatch):
    """The reference's combined up-conv weights rounded to bf16 after
    combining, as its bf16 path rounds them, in a float32 run."""
    pack = pc._pack_w_upconv
    monkeypatch.setattr(pc, "_pack_w_upconv",
                        lambda w: pack(w).astype(jnp.bfloat16).astype(jnp.float32))


def _lane_pad(a, w_true):
    """(…, w_true) -> (…, round_up_128(w_true)) with the edge value repeated,
    the reference's padded carry."""
    wp = pc._round_up_128(w_true)
    return np.concatenate([a, np.repeat(a[..., -1:], wp - w_true, axis=-1)], axis=-1)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_upconv3x3_tc_plain_matches_jax(jax_rounds_combined_weights, outer):
    """K9 forward and its sums: the reference's upconv3x3_chw_p with the
    combined weights rounded against the rounded plain version."""
    w_true = 12
    d = _case(11, 2, 5, 4, 6, w_true)
    jargs = [jnp.asarray(_lane_pad(d["x"], w_true)), jnp.asarray(np.transpose(d["k"], (2, 3, 1, 0)))]
    jargs += [jnp.asarray(d[k]) for k in ("b", "sc", "sh")]
    args = _args(d)
    y_ref = pc.upconv3x3_chw_p(*jargs, True, outer, w_true, False)
    _close(tk.upconv3x3_chw_tc_plain(*args, True, outer), np.asarray(y_ref)[..., : 2 * w_true])
    jy, js1, js2 = pc.upconv3x3_chw_p(*jargs, True, outer, w_true, True)
    y, s1, s2 = tk.upconv3x3_chw_tc_plain(*args, True, outer, want_stats=True)
    _close(y, np.asarray(jy)[..., : 2 * w_true])
    for got, ref in ((s1, js1), (s2, js2)):
        _close(got, ref, atol=SUM_TOL * float(np.abs(np.asarray(ref)).max()), rtol=0)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", HALO_POSITIONS)
def test_upconv3x3_halo_tc_plain_matches_jax(jax_rounds_combined_weights, outer, first_row,
                                             first_col, col):
    """K14: one raster step of the reference's chw_upconv_halo_step (the
    combined weights rounded) against the rounded plain version on the
    half-res borders the port's cache hands it."""
    gh = gw = 3
    rng = np.random.default_rng(1)
    c, co, hm, wm, tot_w = 3, 2, 6, 12, 7
    x = rng.standard_normal((1, c, hm, wm)).astype(np.float32)
    site = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, hm, 1, c), (1, 1, tot_w * 4 + 2, c), (1, 1, tot_w * 4 + 2, c))]
    d = _case(13, 1, c, co, hm, wm)
    jpos = jpad.GridPos(col=jnp.int32(col), first_row=jnp.bool_(first_row),
                        first_col=jnp.bool_(first_col))
    y_ref, _ = pc.chw_upconv_halo_step(
        jnp.asarray(x), jnp.asarray(np.transpose(d["k"], (2, 3, 1, 0))),
        *(jnp.asarray(d[k]) for k in ("b", "sc", "sh")), True, outer,
        jpad.SiteState(*(jnp.asarray(a) for a in site)), jpos, gh, gw)
    top, left = tk.halo_borders(_t(x), tpad.SiteState(*(_t(a) for a in site)),
                                tpad.GridPos(col, first_row, first_col), gw)
    _, w, b, sc, sh = _args(d)
    _close(tk.upconv3x3_chw_halo_tc_plain(_t(x), w, b, sc, sh, True, outer, top, left), y_ref)


def test_upconv_on_cpu_takes_plain_version():
    """A CPU tensor runs the plain version, in either dtype, K9 and K14, and
    counts no launch on either route."""
    d = _case(5, 1, 7, 5, 4, 9)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, w, b, sc, sh = _args(d)
    top, left = _t(d["top"]), _t(d["left"])
    for dtype in (torch.float32, torch.bfloat16):
        xd, td, ld = x.to(dtype), top.to(dtype), left.to(dtype)
        assert torch.equal(tk.upconv3x3_chw(xd, w, b, sc, sh, True),
                           tk.upconv3x3_chw_plain(xd, w, b, sc, sh, True))
        assert torch.equal(tk.upconv3x3_chw_halo(xd, w, b, sc, sh, True, "replicate", td, ld),
                           tk.upconv3x3_chw_halo_plain(xd, w, b, sc, sh, True, "replicate", td,
                                                       ld))
    assert tk.LAUNCHES["upconv3x3_chw"] == tk.LAUNCHES["chw_upconv_halo_step"] == 0
    assert tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_tc"] == tk.ROUTE_LAUNCHES["itg_upconv3x3_chw"] == 0
