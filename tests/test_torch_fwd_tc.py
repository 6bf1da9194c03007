"""The plain side of the tensor-core route of K1 (``conv3x3_chw``, with K5's
sums) and K2 (``conv3x3_chw_halo``), on the CPU in float32: the route's plan,
the weight packing the kernel reads, the plain versions
with the route's rounding (``*_tc_plain``) against today's plain versions,
and against the JAX reference's K1, K5 and K2 in interpret mode. Inputs are
numpy arrays drawn from a seed.

Where the rounded plain versions are held to today's bit for bit, the
weights are small integers times 2^-4, which are exact in bf16: the route's
rounding then changes nothing. Against JAX, the reference is given the
weights rounded to bf16, as its own bf16 path rounds them
(``_pack_w_partial(w).astype(x.dtype)``), and the port the unrounded ones,
at ``tests/test_torch_kernels.py``'s tolerances."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import padding as jpad
from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import _build
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import padding as tpad
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

# the tolerance of tests/test_torch_kernels.py: f32 sums taken in another order
ATOL, RTOL = 2e-4, 1e-4
SUM_TOL = 1e-4
HALO_POSITIONS = [(True, True, 0), (True, False, 1), (False, True, 0), (False, False, 1),
                  (False, False, 2)]
BORDERS = {"none": (False, False), "top": (True, False), "left": (False, True),
           "both": (True, True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _bf16_grid(a):
    """float32 ``a`` rounded to bf16 (round to nearest even) and back."""
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16).float().numpy()


def _case(seed, n, c, co, h, w, grid=False):
    """x (n, c, h, w), HWIO weights (small integers times 2^-4 with ``grid``,
    else Gaussian), bias, BN fold scale/shift, and post-norm-like borders
    top (n, c, w + 2) and left (n, c, h); float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    if grid:
        k = (rng.integers(-8, 9, (3, 3, c, co)) / 16).astype(np.float32)
    else:
        k = f(3, 3, c, co, a=(9 * c) ** -0.5)
    return dict(x=f(n, c, h, w), k=k, b=f(co, a=0.1), sc=1 + f(c, a=0.3), sh=f(c, a=0.3),
                top=np.maximum(f(n, c, w + 2), 0), left=np.maximum(f(n, c, h), 0))


def _args(d):
    return [_t(d["x"]), _oihw(d["k"]), _t(d["b"]), _t(d["sc"]), _t(d["sh"])]


@pytest.mark.parametrize("c,co,want", [(3, 3, (1, 1)), (13, 13, (2, 2)), (13, 3, (2, 1)),
                                       (26, 26, (4, 4)), (52, 26, (7, 4)), (104, 52, (13, 7)),
                                       (128, 64, (16, 8)), (65, 57, (9, 8))])
def test_fwd_tc_plan(c, co, want):
    """K pads C to 8 NC per tap (any NC up to 16); N pads Co to 8 NO, NO of
    FWD_TC_NO (one template each)."""
    assert tk.fwd_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(129, 13), (13, 65)])
def test_fwd_tc_plan_refuses_wider(c, co):
    with pytest.raises(ValueError, match="C <= 128 and Co <= 64"):
        tk.fwd_tc_plan(c, co)


@pytest.mark.parametrize("c,co", [(3, 3), (13, 13), (26, 3), (104, 52), (11, 19), (128, 64)])
def test_pack_fwd_weights_round_trip(c, co):
    """Unpacking the B operand gives the weights rounded to bf16, zero in the
    padding of C and Co."""
    w = _t(np.random.default_rng(c * 100 + co).standard_normal((co, c, 3, 3)).astype(np.float32))
    wp = tk.pack_fwd_weights(w)
    nc, no = tk.fwd_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert tuple(wp.shape) == (8 * no, 3, 3, 8 * nc)
    assert not wp[co:].any() and not wp[..., c:].any()
    assert torch.equal(wp[:co, :, :, :c].permute(0, 3, 1, 2), w.to(torch.bfloat16))


def _entry_source():
    return (Path(tk.__file__).parents[1] / "csrc" / "chw_fwd_tc.cu").read_text()


def test_fwd_tc_partials_rows_match_kernel():
    """The partials the wrapper allocates with stats have a row for every
    block the entry point may launch: FWD_TC_MAX_BLOCKS is the C file's
    kMaxBlocks."""
    rows = re.search(r"constexpr int kMaxBlocks = (\d+);", _entry_source())
    assert rows and int(rows.group(1)) == tk.FWD_TC_MAX_BLOCKS


def test_fwd_tc_entry_point_signature():
    """The ctypes binding of ``itg_conv3x3_chw_tc`` takes the C entry point's
    parameters in order: pointers, then ints, then the stream."""
    params = re.search(r'extern "C" int itg_conv3x3_chw_tc\(([^)]*)\)', _entry_source()).group(1)
    kinds = [ctypes.c_void_p if "*" in q else ctypes.c_int for q in params.split(",")]
    assert kinds == _build.SIGNATURES["itg_conv3x3_chw_tc"]


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", [(3, 3), (13, 13), (26, 3)])
def test_conv3x3_tc_plain_equals_plain(outer, c, co):
    """On bf16-exact weights the rounded plain version is today's, y and
    both sums bit for bit."""
    x, w, b, sc, sh = _args(_case(c + co, 2, c, co, 7, 9, grid=True))
    got = tk.conv3x3_chw_tc_plain(x, w, b, sc, sh, True, outer, want_stats=True)
    ref = tk.conv3x3_chw_plain(x, w, b, sc, sh, True, outer, want_stats=True)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("borders", list(BORDERS))
def test_conv3x3_halo_tc_plain_equals_plain(outer, borders):
    d = _case(7, 2, 13, 5, 6, 11, grid=True)
    t_, l_ = BORDERS[borders]
    top, left = (_t(d["top"]) if t_ else None), (_t(d["left"]) if l_ else None)
    got = tk.conv3x3_chw_halo_tc_plain(*_args(d), True, outer, top, left)
    assert torch.equal(got, tk.conv3x3_chw_halo_plain(*_args(d), True, outer, top, left))


def test_tc_plain_rounds_weights():
    """Off the bf16 grid the rounded plain version differs from today's, by
    about the weights' rounding (2^-9 relative each) carried through the sum."""
    x, w, b, sc, sh = _args(_case(3, 1, 26, 13, 8, 10))
    got = tk.conv3x3_chw_tc_plain(x, w, b, sc, sh, True)
    ref = tk.conv3x3_chw_plain(x, w, b, sc, sh, True)
    err = float((got - ref).abs().max())
    assert 0 < err <= 2.0**-7 * float(ref.abs().max())
    assert torch.equal(got, tk.conv3x3_chw_plain(x, w.to(torch.bfloat16), b, sc, sh, True))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_conv3x3_tc_plain_matches_jax(outer):
    """K1 and K5: y, Σy, Σy² of the reference's conv3x3_chw and
    conv3x3_chw_stats (given the bf16-rounded weights) against the rounded
    plain version."""
    d = _case(11, 2, 5, 4, 8, 12)
    jargs = [jnp.asarray(d["x"]), jnp.asarray(_bf16_grid(d["k"]))] + [
        jnp.asarray(d[k]) for k in ("b", "sc", "sh")]
    x, w, b, sc, sh = _args(d)
    _close(tk.conv3x3_chw_tc_plain(x, w, b, sc, sh, True, outer),
           pc.conv3x3_chw(*jargs, True, outer))
    jy, js1, js2 = pc.conv3x3_chw_stats(*jargs, True, outer)
    y, s1, s2 = tk.conv3x3_chw_tc_plain(x, w, b, sc, sh, True, outer, want_stats=True)
    _close(y, jy)
    for got, ref in ((s1, js1), (s2, js2)):
        _close(got, ref, atol=SUM_TOL * float(np.abs(np.asarray(ref)).max()), rtol=0)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", HALO_POSITIONS)
def test_conv3x3_halo_tc_plain_matches_jax(outer, first_row, first_col, col):
    """K2: one raster step of the reference's chw_halo_step (given the
    bf16-rounded weights) against the rounded plain version on the borders
    the port's cache hands it."""
    gh = gw = 3
    rng = np.random.default_rng(12)
    c, co, hm, wm, wtot = 3, 2, 12, 12, 28
    x = rng.standard_normal((1, c, hm, wm)).astype(np.float32)
    site = tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, hm, 1, c), (1, 1, wtot + 2, c), (1, 1, wtot + 2, c)))
    d = _case(13, 1, c, co, hm, wm)
    jpos = jpad.GridPos(col=jnp.int32(col), first_row=jnp.bool_(first_row),
                        first_col=jnp.bool_(first_col))
    y_ref, _ = pc.chw_halo_step(
        jnp.asarray(x), jnp.asarray(_bf16_grid(d["k"])), jnp.asarray(d["b"]),
        jnp.asarray(d["sc"]), jnp.asarray(d["sh"]), True, outer,
        jpad.SiteState(*(jnp.asarray(a) for a in site)), jpos, gh, gw)
    top, left = tk.halo_borders(_t(x), tpad.SiteState(*(_t(a) for a in site)),
                                tpad.GridPos(col, first_row, first_col), gw)
    _, w, b, sc, sh = _args(d)
    _close(tk.conv3x3_chw_halo_tc_plain(_t(x), w, b, sc, sh, True, outer, top, left), y_ref)
