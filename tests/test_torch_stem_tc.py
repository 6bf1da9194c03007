"""The plain side of K13's bf16 tensor-core routes, on the CPU.

The forward (``stem_fwd`` on ``itg_stem_fwd_tc``): the route's plan, the
weight packing the kernel reads, and the plain version with the route's
roundings (``stem_fwd_tc_plain``) against the JAX reference's
``conv4x4s2_stem_chw`` in bfloat16 (its Pallas kernel in interpret mode,
which rounds the weights and the bias to the activation type before the
kernel, pallas_conv.py:3041 and :3045). Tolerance against JAX: both
multiply bf16 values exactly into float32 and round y once to bf16; only
the order of the float32 sums differs, so an output may sit one bf16 ulp
(2^-8 relative) apart either way: 2^-7 of max|ref|, two ulps.

The weight gradient (``stem_dw`` on ``itg_stem_dw_tc``): the route's plan
and its refusal outside its limits, the claim that it needs no rounded
plain version (``stem_dw_plain`` on bf16 tensors against a float64 im2col
product of the same bf16 operands, 1e-6 of max|ref|), and the plain version
against the reference's VJP of ``conv4x4s2_stem_chw`` in float32 on a bf16
grid (x and g small integers times 2^-4, so every product is exact in
float32): 1e-4 of the largest reference entry (SUM_TOL), at Co 64 and at a
Co that is no multiple of 8.

The input gradient (``stem_dx`` on ``itg_stem_dx_tc``): the route's plan
and its refusal outside its limits, the B operands its pack launch writes
(``pack_stem_dx_weights``) summed over the 9 shifts of g into the four
sub-pixel phases, the plain version with the route's rounding
(``stem_dx_tc_plain``) against the reference's VJP of
``conv4x4s2_stem_chw`` in bfloat16, and ``stem_dx_plain`` in bf16 on a grid
where every product and sum is exact. Tolerance against JAX: the reference
rounds each tap's sum over Co to bf16 before it adds the (at most 2 x 2)
taps of a pixel (pallas_conv.py:2905), the port rounds dx once; each
rounding is at most half a bf16 ulp (2^-8 of the value), so the two sit
a few such steps apart: 2^-7 of max|ref| (BF16_TOL), read at 4.7e-3 and
4.8e-3 at these shapes.

Inputs are numpy arrays drawn from a seed."""

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

BF16_TOL = 2.0**-7
EXACT_TOL = 1e-6
SUM_TOL = 1e-4


def _case(seed, n, c, h, w, co):
    """x (n, c, h, w), HWIO weights (unit-variance outputs) and bias,
    float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    k = (rng.standard_normal((4, 4, c, co)) * (16 * c) ** -0.5).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, k, b


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 8), (1, 3, 12, 20, 16), (2, 3, 16, 24, 64),
                                   (2, 3, 12, 16, 12), (1, 3, 8, 12, 136)])
def test_stem_tc_plain_matches_jax_bf16(shape):
    """``stem_fwd_tc_plain`` against the reference's stem in bf16, given the
    same bf16 image and the unrounded float32 weights and bias (each side
    rounds them to bf16 itself)."""
    xa, ka, ba = _case(7, *shape)
    xj = jnp.asarray(xa).astype(jnp.bfloat16)
    ref = np.asarray(pc.conv4x4s2_stem_chw(xj, jnp.asarray(ka), jnp.asarray(ba)).astype(jnp.float32))
    x = torch.from_numpy(xa).to(torch.bfloat16)
    got = tk.stem_fwd_tc_plain(x, _oihw(ka), torch.from_numpy(ba))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= BF16_TOL * float(np.abs(ref).max()), err


def test_stem_tc_plain_rounds_weights_and_bias():
    """The route's plain version differs from the plain version exactly by
    rounding w and b to bf16: the same on bf16-representable ones, apart
    on others."""
    xa, ka, ba = _case(8, 2, 3, 12, 16, 8)
    x = torch.from_numpy(xa).to(torch.bfloat16)
    w, b = _oihw(ka), torch.from_numpy(ba)
    wr, br = w.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    assert torch.equal(tk.stem_fwd_tc_plain(x, w, b), tk.stem_fwd_plain(x, wr, br))
    exact = tk.stem_fwd_plain(x.float(), wr, br)
    rounded = tk.stem_fwd_tc_plain(x.float(), w, b)
    unrounded = tk.stem_fwd_plain(x.float(), w, b)
    assert torch.allclose(rounded, exact, rtol=0, atol=1e-5)
    assert not torch.allclose(rounded, unrounded, rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,co", [(3, 64), (1, 8), (4, 128), (3, 24), (3, 12), (2, 100)])
def test_pack_stem_weights_reproduces_conv(c, co):
    """The B operand in the kernel's order (row o, column 16 c + 4 ky + kx,
    bf16; Co padded to 8 NO with zero rows) times an explicit im2col of the
    zero-padded stride-2 windows in the same column order is F.conv2d with
    the bf16-rounded weights, in float32."""
    xa, ka, _ = _case(9, 2, c, 10, 14, co)
    x, w = torch.from_numpy(xa), _oihw(ka)
    wp = tk.pack_stem_weights(w)
    cop = 8 * tk.stem_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and tuple(wp.shape) == (cop, 16 * c)
    assert not wp[co:].any()
    cols = F.unfold(x, kernel_size=4, padding=1, stride=2)  # (n, c * 16, h2 * w2)
    y = torch.einsum("ok,nkp->nop", wp[:co].float(), cols).reshape(2, co, 5, 7)
    ref = F.conv2d(x, w.to(torch.bfloat16).float(), stride=2, padding=1)
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(wp[:co, 16 * (c - 1) + 4 * 2 + 1], w[:, c - 1, 2, 1].to(torch.bfloat16))


@pytest.mark.parametrize("c,co", [(3, 0), (5, 64), (0, 64), (3, 513)])
def test_stem_tc_plan_raises_outside_range(c, co):
    with pytest.raises(ValueError, match="tensor-core stem forward"):
        tk.stem_tc_plan(c, co)


@pytest.mark.parametrize("c,co,no", [(3, 64, 8), (1, 8, 1), (4, 128, 16), (3, 24, 3), (3, 12, 2),
                                     (3, 136, 17), (3, 100, 13), (4, 512, 64), (3, 1, 1)])
def test_stem_tc_plan_groups(c, co, no):
    """Any Co plans: padded up to 8 NO output channels (zero weight rows)."""
    assert tk.stem_tc_plan(c, co) == no


def test_stem_tc_max_co_matches_kernel():
    """STEM_TC_MAX_CO is the C file's kMaxCo, the limit its entry point
    holds."""
    src = (Path(tk.__file__).parents[1] / "csrc" / "stem_fwd_tc.cu").read_text()
    found = re.search(r"constexpr int kMaxCo = (\d+);", src)
    assert found and int(found.group(1)) == tk.STEM_TC_MAX_CO


@pytest.mark.parametrize("dtype, d_ch, chw", [(torch.bfloat16, 512, True),
                                               (torch.bfloat16, 640, False),
                                               (torch.float32, 640, True)])
def test_discriminator_stem_gate_takes_the_route_limit(dtype, d_ch, chw):
    """The discriminator sends a channels-major fake to K13 only where the
    stem's route for its compute type takes conv0's width: bf16's tensor
    cores up to STEM_TC_MAX_CO (so ``train --D_ch 640 --compute_dtype
    bfloat16`` runs conv0 NHWC through one transpose, as the reference's
    ``_stem_ok_chw`` falls back), float32's CUDA cores any. Where the gate
    says NHWC, D on the channels-major fake equals D on its NHWC
    transpose."""
    from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator

    D = PatchDiscriminator(base_ch=d_ch, n_layers_D=2, dtype=dtype)
    x = torch.from_numpy(_case(9, 2, 3, 16, 16, 8)[0])
    assert D.stem_takes_chw(x) == chw
    assert tk.stem_chw_takes(dtype, d_ch) == chw
    if not chw:
        with torch.no_grad():
            assert torch.equal(D(x, chw_in=True), D(x.permute(0, 2, 3, 1)))


def test_stem_fwd_on_cpu_takes_plain_version():
    """A CPU tensor runs the plain version, in either dtype, and counts no
    launch on either route."""
    xa, ka, ba = _case(10, 1, 3, 8, 12, 16)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    w, b = _oihw(ka), torch.from_numpy(ba)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(xa).to(dtype)
        assert torch.equal(tk.stem_fwd(x, w, b), tk.stem_fwd_plain(x, w, b))
    assert tk.LAUNCHES["stem_fwd"] == 0
    assert tk.ROUTE_LAUNCHES["itg_stem_fwd_tc"] == tk.ROUTE_LAUNCHES["itg_stem_fwd"] == 0


def _dw_close(got, ref, tol, name):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    limit = tol * float(np.abs(ref).max())
    assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("c,co,chunks", [(3, 64, 1), (1, 8, 1), (4, 128, 2), (3, 12, 1),
                                         (3, 100, 2), (4, 512, 8), (3, 65, 2), (3, 1, 1)])
def test_stem_dw_tc_plan(c, co, chunks):
    """Any Co up to the forward's limit plans: 64-channel chunks across the
    grid, the last one zero-padded."""
    assert tk.stem_dw_tc_plan(c, co) == chunks


@pytest.mark.parametrize("c,co", [(3, 0), (5, 64), (0, 64), (3, 513)])
def test_stem_dw_tc_plan_raises_outside_range(c, co):
    with pytest.raises(ValueError, match="tensor-core stem dW takes 1 <= C <= 4 and 1 <= Co <= 512"):
        tk.stem_dw_tc_plan(c, co)


def test_stem_dw_tc_limits_match_kernel():
    """The plan's limit and chunk are the C file's kMaxCo and kCoBlock."""
    src = (Path(tk.__file__).parents[1] / "csrc" / "stem_dw_tc.cu").read_text()
    max_co = re.search(r"constexpr int kMaxCo = (\d+);", src)
    block = re.search(r"constexpr int kCoBlock = (\d+);", src)
    assert max_co and int(max_co.group(1)) == tk.STEM_TC_MAX_CO
    assert block and int(block.group(1)) == tk.STEM_DW_TC_CO_BLOCK


@pytest.mark.parametrize("shape", [(2, 3, 12, 20, 64), (1, 3, 10, 14, 12), (2, 1, 8, 10, 100),
                                   (1, 4, 6, 18, 8)])
def test_stem_dw_plain_bf16_is_exact_product_sum(shape):
    """stem_dw_plain on bf16 tensors against a float64 im2col product of the
    same bf16 operands: the route needs no rounding twin."""
    n, c, h, w, co = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((n, h // 2, w // 2, co)).astype(np.float32)).bfloat16()
    dw, db = tk.stem_dw_plain(x, g)
    cols = F.unfold(x.double(), kernel_size=4, padding=1, stride=2)  # (n, c * 16, h2 * w2)
    ref = torch.einsum("nkl,nlo->ok", cols, g.double().reshape(n, -1, co)).reshape(co, c, 4, 4)
    assert dw.dtype == db.dtype == torch.float32
    _dw_close(dw, ref, EXACT_TOL, "dW")
    _dw_close(db, g.double().sum(dim=(0, 1, 2)), EXACT_TOL, "db")


@pytest.mark.parametrize("shape", [(2, 3, 16, 24, 64), (1, 3, 12, 16, 12)])
def test_stem_dw_plain_bf16_matches_jax(shape):
    """K13 dW: dW and db of the reference's conv4x4s2_stem_chw VJP (float32,
    interpret mode) against the plain version on bf16 tensors of the same
    grid values."""
    n, c, h, w, co = shape
    rng = np.random.default_rng(sum(shape) + 1)
    x = (rng.integers(-16, 17, (n, c, h, w)) / 16).astype(np.float32)
    g = (rng.integers(-16, 17, (n, h // 2, w // 2, co)) / 16).astype(np.float32)
    k = np.zeros((4, 4, c, co), np.float32)
    b = np.zeros((co,), np.float32)
    _, vjp = jax.vjp(lambda k_, b_: pc.conv4x4s2_stem_chw(jnp.asarray(x), k_, b_),
                     jnp.asarray(k), jnp.asarray(b))
    jdk, jdb = vjp(jnp.asarray(g))
    dw, db = tk.stem_dw_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    _dw_close(dw, np.transpose(np.asarray(jdk), (3, 2, 0, 1)), SUM_TOL, "dW")
    _dw_close(db, jdb, SUM_TOL, "db")


def test_stem_dw_on_cpu_takes_plain_version():
    """A CPU tensor runs the plain version, in either dtype, and counts no
    launch on either route."""
    rng = np.random.default_rng(11)
    xa = rng.standard_normal((1, 3, 8, 12)).astype(np.float32)
    ga = rng.standard_normal((1, 4, 6, 12)).astype(np.float32)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        x, g = torch.from_numpy(xa).to(dtype), torch.from_numpy(ga).to(dtype)
        got, ref = tk.stem_dw(x, g), tk.stem_dw_plain(x, g)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, ref))
    assert tk.LAUNCHES["stem_dw"] == 0
    assert tk.ROUTE_LAUNCHES["itg_stem_dw_tc"] == tk.ROUTE_LAUNCHES["itg_stem_dw"] == 0


def _dx_case(seed, n, c, h2, w2, co):
    """NHWC g (n, h2, w2, co) and HWIO weights (unit-variance taps), float32
    numpy."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, h2, w2, co)).astype(np.float32)
    k = (rng.standard_normal((4, 4, c, co)) * co ** -0.5).astype(np.float32)
    return g, k


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 8), (1, 3, 6, 10, 12)])
def test_stem_dx_tc_plain_matches_jax_bf16(shape):
    """K13 dx: ``stem_dx_tc_plain`` against the reference's VJP of
    conv4x4s2_stem_chw in bf16 (its Pallas kernels in interpret mode), given
    the same bf16 cotangent and the unrounded float32 weights (each side
    rounds them to bf16 itself); Co 8 and a Co that is no multiple of 8."""
    n, c, h2, w2, co = shape
    ga, ka = _dx_case(12, n, c, h2, w2, co)
    x = jnp.zeros((n, c, 2 * h2, 2 * w2), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_: pc.conv4x4s2_stem_chw(x_, jnp.asarray(ka), jnp.zeros(co)), x)
    (jdx,) = vjp(jnp.asarray(ga).astype(jnp.bfloat16))
    ref = np.asarray(jdx.astype(jnp.float32))
    got = tk.stem_dx_tc_plain(torch.from_numpy(ga).to(torch.bfloat16), _oihw(ka))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= BF16_TOL * float(np.abs(ref).max()), err


@pytest.mark.parametrize("c,co", [(3, 8), (1, 12), (4, 24)])
def test_stem_dx_plain_bf16_is_exact(c, co):
    """``stem_dx_plain`` in bf16 on a grid where every product and sum is
    exact in float32 and every dx value in bf16 (g in {-2..2}/4, w in
    {-2..2}/8): equal to a float64 F.conv_transpose2d."""
    rng = np.random.default_rng(c * co)
    g = torch.from_numpy(rng.integers(-2, 3, (2, 5, 7, co)) / 4.0)
    w = torch.from_numpy(rng.integers(-2, 3, (co, c, 4, 4)) / 8.0)
    got = tk.stem_dx_plain(g.to(torch.bfloat16), w.float())
    ref = F.conv_transpose2d(g.permute(0, 3, 1, 2), w, stride=2, padding=1)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, c, 10, 14)
    assert torch.equal(got.double(), ref)


def test_stem_dx_tc_plain_rounds_weights():
    """The route's plain version differs from the plain version exactly by
    rounding w to bf16."""
    ga, ka = _dx_case(13, 2, 3, 4, 6, 16)
    g, w = torch.from_numpy(ga), _oihw(ka)
    wr = w.to(torch.bfloat16).float()
    assert torch.equal(tk.stem_dx_tc_plain(g.bfloat16(), w), tk.stem_dx_plain(g.bfloat16(), wr))
    assert torch.allclose(tk.stem_dx_tc_plain(g, w), tk.stem_dx_plain(g, wr), rtol=0, atol=1e-5)
    assert not torch.allclose(tk.stem_dx_tc_plain(g, w), tk.stem_dx_plain(g, w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,co,chunks", [(3, 64, 2), (1, 8, 1), (4, 128, 4), (3, 12, 1),
                                         (3, 100, 4), (4, 512, 16), (3, 33, 2), (3, 1, 1)])
def test_stem_dx_tc_plan(c, co, chunks):
    """Any Co up to the forward's limit plans: 32-channel chunks of g, the
    last one zero-padded."""
    assert tk.stem_dx_tc_plan(c, co) == chunks


@pytest.mark.parametrize("c,co", [(3, 0), (5, 64), (0, 64), (3, 513)])
def test_stem_dx_tc_plan_raises_outside_range(c, co):
    with pytest.raises(ValueError, match="tensor-core stem dx takes 1 <= C <= 4 and 1 <= Co <= 512"):
        tk.stem_dx_tc_plan(c, co)


def test_stem_dx_tc_limits_match_kernel():
    """The plan's limit and chunk are the C file's kMaxCo and kKC."""
    src = (Path(tk.__file__).parents[1] / "csrc" / "stem_dx_tc.cu").read_text()
    max_co = re.search(r"constexpr int kMaxCo = (\d+);", src)
    chunk = re.search(r"constexpr int kKC = (\d+);", src)
    assert max_co and int(max_co.group(1)) == tk.STEM_TC_MAX_CO
    assert chunk and int(chunk.group(1)) == tk.STEM_DX_TC_CO_CHUNK


@pytest.mark.parametrize("c,co", [(3, 64), (1, 8), (4, 12), (3, 100)])
def test_pack_stem_dx_weights_reproduces_conv_transpose(c, co):
    """The 12 B operands in the kernel's order (u = 6 py + 3 a + dj + 1, row
    4 px + c, bf16, Co padded to 32 with zeros), each times g shifted by (di
    = py - 1 + a, dj) on the zero-bordered grid and added into the phase (py,
    px) of dx, are F.conv_transpose2d with the bf16-rounded weights."""
    ga, ka = _dx_case(14, 2, c, 5, 7, co)
    g, w = torch.from_numpy(ga), _oihw(ka)
    wp = tk.pack_stem_dx_weights(w)
    cop = tk.STEM_DX_TC_CO_CHUNK * tk.stem_dx_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and tuple(wp.shape) == (12, 8, cop)
    assert not wp[:, :, co:].any() and not wp[:, 4 * np.arange(2)[:, None] + np.arange(c, 4)].any()
    gz = F.pad(g, (0, 0, 1, 1, 1, 1))
    dx = torch.zeros(2, c, 10, 14)
    for py in range(2):
        for a in range(2):
            di = py - 1 + a
            for dj in (-1, 0, 1):
                part = torch.einsum("nhwo,ko->nkhw", gz[:, 1 + di : 6 + di, 1 + dj : 8 + dj],
                                    wp[6 * py + 3 * a + dj + 1, :, :co].float())
                for px in range(2):
                    dx[:, :, py::2, px::2] += part[:, 4 * px : 4 * px + c]
    ref = F.conv_transpose2d(g.permute(0, 3, 1, 2), w.to(torch.bfloat16).float(), stride=2,
                             padding=1)
    assert torch.allclose(dx, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(wp[7, 4 + c - 1, :co], w[:, c - 1, 2, 2].to(torch.bfloat16))


def test_stem_dx_on_cpu_takes_plain_version():
    """A CPU tensor runs the plain version, in either dtype, and counts no
    launch on either route."""
    ga, ka = _dx_case(15, 1, 3, 4, 6, 12)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    w = _oihw(ka)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(ga).to(dtype)
        assert torch.equal(tk.stem_dx(g, w), tk.stem_dx_plain(g, w))
    assert tk.LAUNCHES["stem_dx"] == 0
    assert tk.ROUTE_LAUNCHES["itg_stem_dx_tc"] == tk.ROUTE_LAUNCHES["itg_stem_dx"] == 0
