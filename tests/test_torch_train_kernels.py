"""The port's training-kernel wrappers against the JAX reference's custom-VJP
functions, forward and backward, on the CPU in float32: the wrappers run
their plain PyTorch versions (CPU tensors), the Pallas kernels run in
interpret mode. Inputs and cotangents are numpy arrays drawn from a seed.

Tolerances: outputs and BN sums to 1e-5 of the largest reference value,
gradients to 1e-4 of the largest reference value of each gradient (float32
sums taken in another order; the reference's stats cotangent fold groups
its additions differently from the port's K8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import conv as jconv
from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import conv as tconv
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _oihw(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _close(got, ref, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    limit = tol * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= limit, (name, err, limit)


def _conv_case(seed, n=2, c=5, co=4, h=8, w=12):
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)
    return dict(x=f(n, c, h, w), k=f(3, 3, c, co, a=0.3), b=f(co), sc=1 + f(c, a=0.3),
                sh=f(c, a=0.3), g=f(n, co, h, w), gs1=f(co), gs2=f(co, a=0.1))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("want_stats", [True, False])
def test_conv3x3_stats_fwd_and_vjp_match_jax(outer, want_stats):
    """K5 (stats epilogue), K8, K6, K7 through conv3x3_chw(want_stats) against
    the reference's conv3x3_chw_stats / conv3x3_chw."""
    d = _conv_case(1)
    fn = pc.conv3x3_chw_stats if want_stats else pc.conv3x3_chw

    def f(x, k, b, sc, sh):
        return fn(x, k, b, sc, sh, True, outer)

    jargs = [jnp.asarray(d[n]) for n in ("x", "k", "b", "sc", "sh")]
    ref, vjp = jax.vjp(f, *jargs)
    cts = (jnp.asarray(d["g"]), jnp.asarray(d["gs1"]), jnp.asarray(d["gs2"])) if want_stats else jnp.asarray(d["g"])
    ref_grads = vjp(cts)

    x, w, b, sc, sh = _t(d["x"], True), _t(_oihw(d["k"]), True), _t(d["b"], True), _t(d["sc"], True), _t(d["sh"], True)
    out = tk.conv3x3_chw(x, w, b, sc, sh, True, outer, want_stats=want_stats)
    outs = out if want_stats else (out,)
    refs = ref if want_stats else (ref,)
    for got, r, name in zip(outs, refs, ("y", "s1", "s2")):
        _close(got, r, OUT_TOL, name)
    t_cts = [_t(d["g"]), _t(d["gs1"]), _t(d["gs2"])][: len(outs)]
    grads = torch.autograd.grad(outs, (x, w, b, sc, sh), t_cts)
    names = ("dx", "dw", "db", "dscale", "dshift")
    for got, r, name in zip(grads, ref_grads, names):
        if name == "dw":
            r = _oihw(r)
        _close(got, r, GRAD_TOL, name)


@pytest.mark.parametrize("want_stats", [True, False])
def test_conv1x1_add_stats_fwd_and_vjp_match_jax(want_stats):
    """K3 with the stats epilogue, its dx (K3 with Wᵀ) and dW (K3-dW), K8."""
    rng = np.random.default_rng(2)
    n, c, co, h, w = 2, 6, 4, 8, 12
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xa, ka, ba, ra, ga, gs1, gs2 = f(n, c, h, w), f(1, 1, c, co), f(co), f(n, co, h, w), f(n, co, h, w), f(co), f(co)
    fn = pc.conv1x1_chw_add_stats if want_stats else pc.conv1x1_chw_add
    ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (xa, ka, ba, ra)))
    cts = tuple(jnp.asarray(a) for a in (ga, gs1, gs2)) if want_stats else jnp.asarray(ga)
    ref_grads = vjp(cts)
    x, wt, b, res = _t(xa, True), _t(_oihw(ka), True), _t(ba, True), _t(ra, True)
    out = tk.conv1x1_chw_add(x, wt, b, res, want_stats=want_stats)
    outs = out if want_stats else (out,)
    refs = ref if want_stats else (ref,)
    for got, r, name in zip(outs, refs, ("y", "s1", "s2")):
        _close(got, r, OUT_TOL, name)
    grads = torch.autograd.grad(outs, (x, wt, b, res), [_t(ga), _t(gs1), _t(gs2)][: len(outs)])
    for got, r, name in zip(grads, ref_grads, ("dx", "dw", "db", "dres")):
        _close(got, _oihw(r) if name == "dw" else r, GRAD_TOL, name)


def test_conv1x1_vjp_without_residual_matches_jax():
    rng = np.random.default_rng(3)
    xa, ka, ba, ga = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 8, 10), (1, 1, 5, 3), (3,), (2, 3, 8, 10)))
    ref, vjp = jax.vjp(pc.conv1x1_chw, jnp.asarray(xa), jnp.asarray(ka), jnp.asarray(ba))
    x, wt, b = _t(xa, True), _t(_oihw(ka), True), _t(ba, True)
    y = tk.conv1x1_chw(x, wt, b)
    _close(y, ref, OUT_TOL, "y")
    for got, r, name in zip(torch.autograd.grad(y, (x, wt, b), _t(ga)), vjp(jnp.asarray(ga)), ("dx", "dw", "db")):
        _close(got, _oihw(r) if name == "dw" else r, GRAD_TOL, name)


@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (1, 4, 6, 10)])
def test_upsample2_and_adjoint_match_jax(shape):
    rng = np.random.default_rng(4)
    xa = rng.standard_normal(shape).astype(np.float32)
    ga = rng.standard_normal(shape[:2] + (2 * shape[2], 2 * shape[3])).astype(np.float32)
    ref, vjp = jax.vjp(pc.upsample2_chw, jnp.asarray(xa))
    x = _t(xa, True)
    y = tk.upsample2_chw(x)
    _close(y, ref, 0.0, "y")
    (dx,) = torch.autograd.grad(y, x, _t(ga))
    _close(dx, vjp(jnp.asarray(ga))[0], 1e-6, "dx")


@pytest.mark.parametrize("n_cols", [12, 128])
def test_bn_corr_matches_jax(n_cols):
    rng = np.random.default_rng(5)
    g, y = (rng.standard_normal((2, 4, 8, n_cols)).astype(np.float32) for _ in range(2))
    alpha, beta2 = rng.standard_normal(4).astype(np.float32), rng.standard_normal(4).astype(np.float32)
    ref = pc._bn_corr(*(jnp.asarray(a) for a in (g, y, alpha, beta2)), w_true=n_cols)
    _close(tk.bn_corr(_t(g), _t(y), _t(alpha), _t(beta2)), ref, OUT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_bn_corr_plain_rounds_once(dtype, hw):
    """K8's arithmetic, which its kernel repeats bit for bit: beta2[c]·y,
    then + alpha[c], then g + that, each a float32 operation rounded to
    nearest, and one rounding to the activation type at the store; at an
    even and an odd HW (the kernel's scalar head and tail)."""
    rng = np.random.default_rng(sum(hw))
    g, y = (torch.from_numpy(rng.standard_normal((2, 3, *hw)).astype(np.float32)).to(dtype)
            for _ in range(2))
    alpha, beta2 = (rng.standard_normal(3).astype(np.float32) for _ in range(2))
    gf, yf = g.float().numpy(), y.float().numpy()
    a4, b4 = alpha.reshape(1, 3, 1, 1), beta2.reshape(1, 3, 1, 1)
    want = gf + (a4 + b4 * yf)  # float32 numpy, rounded per operation
    got = tk.bn_corr(g, y, torch.from_numpy(alpha), torch.from_numpy(beta2))
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 3, 12, 20)])
def test_stem_chw_fwd_and_vjp_match_jax(shape):
    """K13: forward, dW/db and dx of conv4x4s2_stem_chw."""
    rng = np.random.default_rng(6)
    n, c, h, w = shape
    co = 8
    xa = rng.standard_normal(shape).astype(np.float32)
    ka = (0.2 * rng.standard_normal((4, 4, c, co))).astype(np.float32)
    ba = rng.standard_normal(co).astype(np.float32)
    ga = rng.standard_normal((n, h // 2, w // 2, co)).astype(np.float32)
    ref, vjp = jax.vjp(pc.conv4x4s2_stem_chw, *(jnp.asarray(a) for a in (xa, ka, ba)))
    x, wt, b = _t(xa, True), _t(_oihw(ka), True), _t(ba, True)
    y = tk.conv4x4s2_stem_chw(x, wt, b)
    _close(y, ref, OUT_TOL, "y")
    for got, r, name in zip(torch.autograd.grad(y, (x, wt, b), _t(ga)), vjp(jnp.asarray(ga)), ("dx", "dw", "db")):
        _close(got, _oihw(r) if name == "dw" else r, GRAD_TOL, name)


def test_stem_skips_unneeded_gradients():
    """The D update needs no stem dx, the G update no stem dW."""
    x = torch.randn(1, 3, 8, 8)
    w = torch.randn(4, 3, 4, 4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y = tk.conv4x4s2_stem_chw(x, w, b)
    dw, db = torch.autograd.grad(y.sum(), (w, b))
    assert dw.shape == w.shape and db.shape == b.shape
    x.requires_grad_(True)
    (dx,) = torch.autograd.grad(tk.conv4x4s2_stem_chw(x, w.detach(), b.detach()).sum(), x)
    assert dx.shape == x.shape


def test_spectral_normalize_u_matches_jax_after_three_calls():
    rng = np.random.default_rng(7)
    k = rng.standard_normal((4, 4, 3, 8)).astype(np.float32)
    u0 = rng.standard_normal(8).astype(np.float32)
    v0 = rng.standard_normal(48).astype(np.float32)
    ju, jv = jnp.asarray(u0 / np.linalg.norm(u0)), jnp.asarray(v0 / np.linalg.norm(v0))
    tu, tv = _t(np.asarray(ju)), _t(np.asarray(jv))
    w = _t(_oihw(k))
    for _ in range(3):
        jk, ju, jv = jconv.spectral_normalize(jnp.asarray(k), ju, jv, True)
        tw, tu, tv = tconv.spectral_normalize(w, tu, tv, True)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.detach().numpy(), _oihw(jk), rtol=1e-5, atol=1e-7)
