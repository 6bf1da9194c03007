"""The plain side of the tensor-core route of K6 (``conv3x3_chw_dx``) and K9
dx (``upconv3x3_chw_dx``), on the CPU in float32: the weight packing the
kernels read, the plain versions with the route's rounding
(``*_tc_plain``) against today's plain versions, and against the JAX
reference's K6 and K9 dx in interpret mode. Inputs are numpy arrays drawn
from a seed.

The weights are small integers times 2^-4, so that w and K9 dx's combined
4x4 sums of up to three of them are exact in bf16: the route's rounding then
changes nothing. K6's rounded plain version must equal today's bit for
bit; K9 dx's sums in the phase form (the stride-2 conv of g with the
combined kernels), today's in the unfused pair's order, so it is held to
1e-5 of max|ref|. Against JAX: 1e-5 of the largest reference value for dx
and 1e-4 for the sums, as ``tests/test_torch_train_kernels.py`` holds
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

PHASE_TOL = 1e-5
DX_TOL, SUM_TOL = 1e-5, 1e-4


def _oihw(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _close(got, ref, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    limit = tol * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= limit, (name, err, limit)


def _case(seed, n, c, co, h, w, up):
    """x (n, c, h, w), g at ``up`` times x's size, HWIO weights of small
    integers times 2^-4, BN fold scale/shift; float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    k = (rng.integers(-8, 9, (3, 3, c, co)) / 16).astype(np.float32)
    return dict(x=f(n, c, h, w), k=k, b=f(co, a=0.1), sc=1 + f(c, a=0.3), sh=f(c, a=0.3),
                g=f(n, co, up * h, up * w))


def _torch_args(d):
    return [torch.from_numpy(d["x"]), torch.from_numpy(d["g"]), torch.from_numpy(_oihw(d["k"]).copy()),
            torch.from_numpy(d["sc"]), torch.from_numpy(d["sh"])]


@pytest.mark.parametrize("c,co,want", [(3, 3, (1, 1)), (13, 13, (2, 2)), (13, 3, (2, 1)),
                                       (26, 26, (4, 4)), (52, 26, (7, 4)), (64, 19, (8, 4))])
def test_dx_tc_plan(c, co, want):
    """N pads C to 8 NT, K pads Co to 8 NO per tap, with one template each."""
    assert tk.dx_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(65, 13), (13, 33)])
def test_dx_tc_plan_refuses_wider(c, co):
    with pytest.raises(ValueError):
        tk.dx_tc_plan(c, co)


@pytest.mark.parametrize("kind", ["conv", "upconv"])
@pytest.mark.parametrize("c,co", [(3, 3), (13, 13), (26, 3), (52, 26), (11, 19)])
def test_pack_dx_weights_round_trip(kind, c, co):
    """Unpacking the B operand gives the weights rounded to bf16: K6's
    flipped 3x3 taps, K9 dx's combined 4x4 form (rounded after combining),
    zero in the padding of C and Co."""
    w = torch.from_numpy(np.random.default_rng(c * 100 + co).standard_normal((co, c, 3, 3)).astype(np.float32))
    w4 = w if kind == "conv" else tk._upconv_dx_weights(w)
    taps = 3 if kind == "conv" else 4
    wp = tk.pack_dx_weights(w, up=kind == "upconv")
    nt, no = tk.dx_tc_plan(c, co)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert tuple(wp.shape) == (8 * nt, taps, taps, 8 * no)
    assert not wp[c:].any() and not wp[..., co:].any()
    back = wp[:c, :, :, :co].permute(3, 0, 1, 2)
    if kind == "conv":
        back = back.flip((2, 3))
    assert torch.equal(back, w4.to(torch.bfloat16))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c", [3, 13, 26])
@pytest.mark.parametrize("co", [3, 13])
def test_conv3x3_dx_tc_plain_equals_plain(outer, c, co):
    d = _case(c + co, 2, c, co, 7, 9, 1)
    x, g, w, sc, sh = _torch_args(d)
    got = tk.conv3x3_chw_dx_tc_plain(x, g, w, sc, sh, True, outer)
    ref = tk.conv3x3_chw_dx_plain(x, g, w, sc, sh, True, outer)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c", [3, 13, 26])
@pytest.mark.parametrize("co", [3, 13])
def test_upconv3x3_dx_tc_plain_matches_plain(outer, c, co):
    d = _case(c + co, 2, c, co, 5, 7, 2)
    x, g, w, sc, sh = _torch_args(d)
    got = tk.upconv3x3_chw_dx_tc_plain(x, g, w, sc, sh, True, outer)
    ref = tk.upconv3x3_chw_dx_plain(x, g, w, sc, sh, True, outer)
    for a, r, name in zip(got, ref, ("dx", "dscale", "dshift")):
        _close(a, r.numpy(), PHASE_TOL, name)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_conv3x3_dx_tc_plain_matches_jax(outer):
    """K6: dx, d(scale), d(shift) of the reference's conv3x3_chw VJP."""
    d = _case(1, 2, 5, 4, 8, 12, 1)

    def f(x, k, b, sc, sh):
        return pc.conv3x3_chw(x, k, b, sc, sh, True, outer)

    _, vjp = jax.vjp(f, *(jnp.asarray(d[n]) for n in ("x", "k", "b", "sc", "sh")))
    jdx, _, _, jdsc, jdsh = vjp(jnp.asarray(d["g"]))
    x, g, w, sc, sh = _torch_args(d)
    dx, dsc, dsh = tk.conv3x3_chw_dx_tc_plain(x, g, w, sc, sh, True, outer)
    _close(dx, jdx, DX_TOL, "dx")
    _close(dsc, jdsc, SUM_TOL, "dscale")
    _close(dsh, jdsh, SUM_TOL, "dshift")


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_upconv3x3_dx_tc_plain_matches_jax(outer):
    """K9 dx: dx, d(scale), d(shift) of the reference's upconv3x3_chw_p VJP,
    on its 128-lane carry whose pad columns repeat the edge (as
    ``tests/test_torch_upconv.py`` builds it); the valid columns compared."""
    w_true = 12
    d = _case(2, 2, 5, 4, 6, w_true, 2)
    wp = pc._round_up_128(w_true)
    x_pad = np.concatenate([d["x"], np.repeat(d["x"][..., -1:], wp - w_true, axis=-1)], axis=-1)

    def f(x, k, b, sc, sh):
        return pc.upconv3x3_chw_p(x, k, b, sc, sh, True, outer, w_true, False)

    jargs = [jnp.asarray(x_pad)] + [jnp.asarray(d[n]) for n in ("k", "b", "sc", "sh")]
    y, vjp = jax.vjp(f, *jargs)
    g_pad = np.zeros(y.shape, np.float32)
    g_pad[..., : 2 * w_true] = d["g"]
    jdx, _, _, jdsc, jdsh = vjp(jnp.asarray(g_pad))
    x, g, w, sc, sh = _torch_args(d)
    dx, dsc, dsh = tk.upconv3x3_chw_dx_tc_plain(x, g, w, sc, sh, True, outer)
    _close(dx, np.asarray(jdx)[..., :w_true], DX_TOL, "dx")
    _close(dsc, jdsc, SUM_TOL, "dscale")
    _close(dsh, jdsh, SUM_TOL, "dshift")
