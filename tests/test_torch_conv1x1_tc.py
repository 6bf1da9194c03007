"""The plain side of the tensor-core routes of K3 (``conv1x1_chw`` and
``conv1x1_chw_add``, with the stats and the dx form) and K3-dW
(``conv1x1_chw_dw``), on the CPU: the plans and their refusals, the weight
packing the kernel stages, the rounded plain version (``conv1x1_chw_tc_plain``)
against today's plain version and against the JAX reference's K3 and K3-dW in
interpret mode, and the choice of C entry point by dtype. Inputs are numpy
arrays drawn from a seed.

Against JAX, the reference is given W and b rounded to bf16 (its own bf16
path rounds them, ``wm.astype(x.dtype)``, pallas_conv.py:2389-2390) and the
port the unrounded ones, at ``tests/test_torch_fwd_tc.py``'s tolerances
(f32 sums in another order). Where the rounded plain version is held to
today's bit for bit, W and b are small integers times 2^-4, which bf16 holds
exactly. K3-dW's operands are bf16 values, so its plain version is the
function the kernel computes: held to a float64 einsum of the same operands
at 1e-6, and to JAX on bf16-exact inputs at 1e-4 of the largest entry."""

import contextlib
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import _build
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

ATOL, RTOL = 2e-4, 1e-4
SUM_TOL = 1e-4
EXACT_TOL = 1e-6
SOURCE = Path(tk.__file__).parents[1] / "csrc" / "conv1x1_tc.cu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_grid(a):
    """float32 ``a`` rounded to bf16 (round to nearest even) and back."""
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16).float().numpy()


def _case(seed, n, c, co, h, w, grid=False):
    """x (n, c, h, w), W (co, c), b (co), res (n, co, h, w), float32 numpy;
    W and b small integers times 2^-4 with ``grid``."""
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    if grid:
        wm = (rng.integers(-8, 9, (co, c)) / 16).astype(np.float32)
        b = (rng.integers(-8, 9, co) / 16).astype(np.float32)
    else:
        wm, b = f(co, c, a=c ** -0.5), f(co, a=0.1)
    return dict(x=f(n, c, h, w), w=wm, b=b, res=f(n, co, h, w))


def _hwio(wm):
    """(Co, C) -> the reference's (1, 1, C, Co)."""
    return jnp.asarray(np.ascontiguousarray(wm.T)[None, None])


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _sum_close(got, ref):
    ref = np.asarray(ref)
    _close(got, ref, atol=SUM_TOL * float(np.abs(ref).max()), rtol=0)


# --- plans -----------------------------------------------------------------


@pytest.mark.parametrize("c,co,want", [(1, 1, (1, 1)), (13, 3, (1, 1)), (26, 13, (2, 2)),
                                       (52, 26, (4, 4)), (104, 52, (7, 7)), (37, 21, (3, 3)),
                                       (768, 100, (48, 13))])
def test_conv1x1_tc_plan(c, co, want):
    """K pads C to 16 KS, N pads Co to 8 NO (64 a block, a grid axis past it)."""
    assert tk.conv1x1_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(769, 3), (0, 3), (13, 0)])
def test_conv1x1_tc_plan_refuses(c, co):
    with pytest.raises(ValueError, match="768-channel limit"):
        tk.conv1x1_tc_plan(c, co)


def test_conv1x1_forward_refuses_wider_on_cpu():
    """The wrapper checks the plan's limit on every device (the CUDA-core
    kernel has the same one)."""
    x = torch.zeros(1, 769, 2, 2)
    with pytest.raises(ValueError, match="768-channel limit"):
        tk.conv1x1_chw(x, torch.zeros(3, 769), torch.zeros(3))


@pytest.mark.parametrize("c,co,want", [(13, 3, (1, 1)), (26, 13, (2, 2)), (52, 26, (4, 4)),
                                       (16, 8, (1, 1)), (17, 9, (2, 2)), (64, 32, (4, 4)),
                                       (48, 48, (4, 8)), (95, 1, (6, 1)), (1, 95, (1, 12)),
                                       (30, 66, (2, 12)), (70, 26, (6, 4))])
def test_conv1x1_dw_tc_plan(c, co, want):
    """M pads C to 16 MT of (1, 2, 4, 6), N pads Co to 8 NO of (1, 2, 4, 8, 12)."""
    assert tk.conv1x1_dw_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(65, 64), (90, 7), (7, 90), (0, 3)])
def test_conv1x1_dw_tc_plan_refuses(c, co):
    with pytest.raises(ValueError, match=r"C\*Co <= 4096, C\+Co <= 96"):
        tk.conv1x1_dw_tc_plan(c, co)


def test_conv1x1_dw_tc_plan_covers_every_shape_of_the_cuda_core_kernel():
    """Every (C, Co) the CUDA-core dW takes (C * Co <= 4096, C + Co <= 96)
    maps to a pair the C dispatch instantiates: NO <= 8 at MT = 4, NO <= 4 at
    MT = 6."""
    pairs = {tk.conv1x1_dw_tc_plan(c, co) for c in range(1, 96) for co in range(1, 97 - c)
             if c * co <= 4096}
    assert all((mt, no) != (4, 12) and not (mt == 6 and no > 4) for mt, no in pairs)
    assert {mt for mt, _ in pairs} == set(tk.CONV1X1_DW_TC_MT)
    assert {no for _, no in pairs} == set(tk.CONV1X1_DW_TC_NO)


# --- the C entry points ----------------------------------------------------


def test_conv1x1_tc_source_constants_match_wrapper():
    """The wrapper's partials have a row for every block the forward may
    launch along the pixels (kMaxBlocks), its channel limit is the C file's
    kMaxC, and chip_smoke.py's planted "last pixel tile dropped" drops the
    dW kernel's tile (kDwTP); the file has no atomics (fixed-order sums)."""
    import chip_smoke

    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kMaxBlocks") == tk.CONV1X1_TC_MAX_BLOCKS
    assert const("kMaxC") == tk.CONV1X1_TC_MAX_C
    assert const("kDwTP") == chip_smoke.DW1X1_TILE
    assert "atomicAdd" not in text and "atomicCAS" not in text


@pytest.mark.parametrize("entry", ["itg_conv1x1_chw_tc", "itg_conv1x1_chw_dw_tc"])
def test_conv1x1_tc_entry_point_signature(entry):
    """The ctypes binding takes the C entry point's parameters in order:
    pointers, then ints, then the stream."""
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', SOURCE.read_text()).group(1)
    kinds = [ctypes.c_void_p if "*" in q else ctypes.c_int for q in params.split(",")]
    assert kinds == _build.SIGNATURES[entry]


class _FakeLib:
    """Stands in for the kernel library: records which C entry point each
    launch calls and checks its argument count against its ctypes binding."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name]), name
            self.calls.append(name)
            return 0
        return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_routes_by_dtype(monkeypatch, dtype):
    """As on the card: bf16 takes the tensor-core entry points
    (``itg_conv1x1_chw_tc``, also for the dx form, and
    ``itg_conv1x1_chw_dw_tc``), float32 the CUDA-core ones; ROUTE_LAUNCHES
    counts each. The library is a stand-in, so only the dispatch runs."""
    fake = _FakeLib()
    monkeypatch.setattr(tk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(tk, "_lib", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda t: 0)
    monkeypatch.setattr(tk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tk, "ROUTE_LAUNCHES", dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    d = _case(5, 2, 13, 6, 4, 8)
    x = _t(d["x"]).to(dtype).requires_grad_()
    w = _t(d["w"]).requires_grad_()
    res = _t(d["res"]).to(dtype)
    y, s1, _ = tk.conv1x1_chw_add(x, w, _t(d["b"]), res, want_stats=True)
    torch.autograd.grad((y.float().sum() + s1.sum()), (x, w), allow_unused=True)
    tc = dtype == torch.bfloat16
    fwd, dw = ("itg_conv1x1_chw_tc", "itg_conv1x1_chw_dw_tc") if tc else (
        "itg_conv1x1_chw", "itg_conv1x1_chw_dw")
    assert fake.calls == [fwd, "itg_bn_corr", fwd, dw]
    routed = {k: v for k, v in tk.ROUTE_LAUNCHES.items() if "conv1x1" in k}
    assert routed == {**dict.fromkeys(routed, 0), fwd: 2, dw: 1}


# --- the forward's plain versions ------------------------------------------


@pytest.mark.parametrize("c,co", [(3, 3), (13, 13), (26, 3), (104, 52), (37, 21), (20, 70)])
def test_pack_conv1x1_weights_layout(c, co):
    """The B operand is W rounded to bf16, output channels as rows, zero in
    the padding of Co (to 8) and C (to 16); (Co, C, 1, 1) packs the same."""
    w = _t(np.random.default_rng(c * 100 + co).standard_normal((co, c)).astype(np.float32))
    wp = tk.pack_conv1x1_weights(w)
    ks, no = tk.conv1x1_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert tuple(wp.shape) == (8 * no, 16 * ks)
    assert not wp[co:].any() and not wp[:, c:].any()
    assert torch.equal(wp[:co, :c], w.to(torch.bfloat16))
    assert torch.equal(tk.pack_conv1x1_weights(w.reshape(co, c, 1, 1)), wp)


@pytest.mark.parametrize("variant", ["plain", "res", "res_stats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_tc_plain_equals_plain(variant, dtype):
    """On bf16-exact W and b the rounded plain version is today's, y and the
    sums bit for bit."""
    d = _case(7, 2, 13, 6, 5, 9, grid=True)
    x, w, b = _t(d["x"]).to(dtype), _t(d["w"]), _t(d["b"])
    res = _t(d["res"]).to(dtype) if variant != "plain" else None
    stats = variant == "res_stats"
    got = tk.conv1x1_chw_tc_plain(x, w, b, res, stats)
    ref = tk.conv1x1_chw_plain(x, w, b, res, stats)
    for a, r in zip(got if stats else (got,), ref if stats else (ref,)):
        assert torch.equal(a, r)


def test_conv1x1_tc_plain_rounds_weights_and_bias():
    """Off the bf16 grid the rounded plain version differs from today's, by
    about the rounding of W and b (2^-9 relative each) carried through the
    sum; it is today's on W and b rounded first."""
    d = _case(3, 1, 26, 13, 8, 10)
    x, w, b = _t(d["x"]), _t(d["w"]), _t(d["b"])
    got = tk.conv1x1_chw_tc_plain(x, w, b)
    ref = tk.conv1x1_chw_plain(x, w, b)
    err = float((got - ref).abs().max())
    assert 0 < err <= 2.0**-7 * float(ref.abs().max())
    assert torch.equal(got, tk.conv1x1_chw_plain(x, w.to(torch.bfloat16), b.to(torch.bfloat16)))


@pytest.mark.parametrize("variant", ["conv1x1_chw", "conv1x1_chw_add", "conv1x1_chw_add_stats"])
def test_conv1x1_tc_plain_matches_jax(variant):
    """K3: y (and Σy, Σy²) of the reference's conv1x1_chw, conv1x1_chw_add
    and conv1x1_chw_add_stats (interpret mode, given W and b rounded to
    bf16) against the rounded plain version given the unrounded ones."""
    d = _case(11, 2, 13, 5, 6, 12)
    jx, jw, jb = jnp.asarray(d["x"]), _hwio(_bf16_grid(d["w"])), jnp.asarray(_bf16_grid(d["b"]))
    x, w, b, res = _t(d["x"]), _t(d["w"]), _t(d["b"]), _t(d["res"])
    if variant == "conv1x1_chw":
        _close(tk.conv1x1_chw_tc_plain(x, w, b), pc.conv1x1_chw(jx, jw, jb))
        return
    ref = getattr(pc, variant)(jx, jw, jb, jnp.asarray(d["res"]))
    if variant == "conv1x1_chw_add":
        _close(tk.conv1x1_chw_tc_plain(x, w, b, res), ref)
        return
    y, s1, s2 = tk.conv1x1_chw_tc_plain(x, w, b, res, want_stats=True)
    _close(y, ref[0])
    _sum_close(s1, ref[1])
    _sum_close(s2, ref[2])


def test_conv1x1_tc_plain_dx_form_matches_jax_vjp():
    """The dx form (Wᵀ, a zero bias) against dx of the reference's VJP of
    conv1x1_chw (given W rounded to bf16, which its dx reuses transposed)."""
    d = _case(13, 2, 26, 13, 6, 10)
    g = np.random.default_rng(14).standard_normal((2, 13, 6, 10)).astype(np.float32)
    jw = _hwio(_bf16_grid(d["w"]))
    _, vjp = jax.vjp(lambda x_: pc.conv1x1_chw(x_, jw, jnp.asarray(d["b"])), jnp.asarray(d["x"]))
    (jdx,) = vjp(jnp.asarray(g))
    wt = _t(d["w"]).t().contiguous()
    _close(tk.conv1x1_chw_tc_plain(_t(g), wt, torch.zeros(26)), jdx)


# --- K3-dW's plain version -------------------------------------------------


@pytest.mark.parametrize("c,co", [(52, 26), (26, 13), (13, 3), (37, 21)])
def test_conv1x1_dw_plain_bf16_is_exact_product_sum(c, co):
    """conv1x1_chw_dw_plain on bf16 tensors against a float64 einsum of the
    same bf16 operands: the route needs no rounded twin."""
    rng = np.random.default_rng(c * 100 + co)
    x = torch.from_numpy(rng.standard_normal((2, c, 7, 9)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, co, 7, 9)).astype(np.float32)).bfloat16()
    dw, db = tk.conv1x1_chw_dw_plain(x, g)
    assert dw.dtype == db.dtype == torch.float32
    ref = torch.einsum("nohw,nchw->oc", g.double(), x.double())
    for got, r in ((dw, ref), (db, g.double().sum(dim=(0, 2, 3)))):
        assert float((got.double() - r).abs().max()) <= EXACT_TOL * float(r.abs().max())


@pytest.mark.parametrize("c,co", [(52, 26), (13, 3)])
def test_conv1x1_dw_plain_matches_jax(c, co):
    """K3-dW: dW and db of the reference's _conv1x1_chw_dw (interpret mode,
    float32) against the plain version on bf16 tensors of the same values
    (small integers times 2^-4: exact in bf16)."""
    rng = np.random.default_rng(c + co)
    x = (rng.integers(-16, 17, (2, c, 6, 10)) / 16).astype(np.float32)
    g = (rng.integers(-16, 17, (2, co, 6, 10)) / 16).astype(np.float32)
    jdw, jdb = pc._conv1x1_chw_dw(jnp.asarray(x), jnp.asarray(g), co=co)
    dw, db = tk.conv1x1_chw_dw_plain(_t(x).bfloat16(), _t(g).bfloat16())
    _sum_close(dw, jdw)
    _sum_close(db, np.asarray(jdb)[:, 0])
