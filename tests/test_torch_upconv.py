"""The port's fused up-conv (K9 ``upconv3x3_chw``) and its residual join
(K10 ``upsample2_chw_add``) against the JAX reference's custom-VJP functions
``upconv3x3_chw_p`` / ``upsample2_chw_add_p``, forward and backward, on the
CPU in float32 at the shapes of ``tests/test_upconv.py``: the wrappers run
their plain PyTorch versions (CPU tensors), the Pallas kernels run in
interpret mode on a 128-lane padded carry whose pad columns hold an edge
fill (as that file's ``_mk`` builds it); only the valid columns are
compared. Also the phase algebra the CUDA kernels compute with (the packed
weights of ``ops/kernels.py``), and the port's fused train-mode generator
against its unfused one.

Tolerances (as ``tests/test_torch_train_kernels.py``): outputs and BN sums
to 1e-5 of the largest reference value, gradients to 1e-4 of the largest
reference value of each gradient. The reference's fused kernels regroup
the 3x3 taps into combined 2x2 kernels, the port's plain versions are the
unfused pair: float32 sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


OUT_TOL, GRAD_TOL = 1e-5, 1e-4
W_TRUE = 24  # half-res valid width; the reference's carry is 128 lanes wide


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


def _lane_pad(a, w_true):
    """(…, w_true) -> (…, round_up_128(w_true)) with the edge value repeated."""
    wp = pc._round_up_128(w_true)
    return np.concatenate([a, np.repeat(a[..., -1:], wp - w_true, axis=-1)], axis=-1)


def _upconv_case(seed, n, c, co, h):
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)
    return dict(x=f(n, c, h, W_TRUE), k=f(3, 3, c, co, a=0.3), b=f(co, a=0.1),
                sc=1 + f(c, a=0.5), sh=f(c, a=0.2), g=f(n, co, 2 * h, 2 * W_TRUE),
                gs1=f(co), gs2=f(co, a=0.1))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("want_stats", [True, False])
def test_upconv_fwd_and_vjp_match_jax(outer, want_stats):
    """K9 forward (and its stats), and dx, dW, db, d(scale), d(shift) under a
    cotangent of y (and of the stats)."""
    d = _upconv_case(1, 2, 5, 4, 8)
    wt = 2 * W_TRUE

    def f(x, k, b, sc, sh):
        return pc.upconv3x3_chw_p(x, k, b, sc, sh, True, outer, W_TRUE, want_stats)

    jargs = [jnp.asarray(_lane_pad(d["x"], W_TRUE))] + [jnp.asarray(d[n]) for n in ("k", "b", "sc", "sh")]
    ref, vjp = jax.vjp(f, *jargs)
    refs = ref if want_stats else (ref,)
    g_pad = np.zeros(refs[0].shape, np.float32)
    g_pad[..., :wt] = d["g"]
    cts = (jnp.asarray(g_pad), jnp.asarray(d["gs1"]), jnp.asarray(d["gs2"])) if want_stats else jnp.asarray(g_pad)
    ref_grads = vjp(cts)

    x, w, b, sc, sh = (_t(d["x"], True), _t(_oihw(d["k"]), True), _t(d["b"], True),
                       _t(d["sc"], True), _t(d["sh"], True))
    out = tk.upconv3x3_chw(x, w, b, sc, sh, True, outer, want_stats=want_stats)
    outs = out if want_stats else (out,)
    _close(outs[0], np.asarray(refs[0])[..., :wt], OUT_TOL, "y")
    for got, r, name in zip(outs[1:], refs[1:], ("s1", "s2")):
        _close(got, r, OUT_TOL, name)
    t_cts = [_t(d["g"]), _t(d["gs1"]), _t(d["gs2"])][: len(outs)]
    grads = torch.autograd.grad(outs, (x, w, b, sc, sh), t_cts)
    for got, r, name in zip(grads, ref_grads, ("dx", "dw", "db", "dscale", "dshift")):
        r = np.asarray(r)
        if name == "dx":
            r = r[..., :W_TRUE]
        elif name == "dw":
            r = _oihw(r)
        _close(got, r, GRAD_TOL, name)


@pytest.mark.parametrize("fill", ["edge", "zeros"])
@pytest.mark.parametrize("want_stats", [True, False])
def test_upsample2_add_fwd_and_vjp_match_jax(fill, want_stats):
    """K10: y = up2(x) + res (and its stats), dx and dres."""
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xa, ra = f(2, 3, 8, W_TRUE), f(2, 3, 16, 2 * W_TRUE)
    ga, gs1, gs2 = f(2, 3, 16, 2 * W_TRUE), f(3), f(3)
    wt = 2 * W_TRUE

    def fn(x, res):
        return pc.upsample2_chw_add_p(x, res, W_TRUE, fill, want_stats)

    ref, vjp = jax.vjp(fn, jnp.asarray(_lane_pad(xa, W_TRUE)), jnp.asarray(_lane_pad(ra, wt)))
    refs = ref if want_stats else (ref,)
    g_pad = np.zeros(refs[0].shape, np.float32)
    g_pad[..., :wt] = ga
    cts = (jnp.asarray(g_pad), jnp.asarray(gs1), jnp.asarray(gs2)) if want_stats else jnp.asarray(g_pad)
    rdx, rdres = vjp(cts)

    x, res = _t(xa, True), _t(ra, True)
    out = tk.upsample2_chw_add(x, res, want_stats=want_stats)
    outs = out if want_stats else (out,)
    _close(outs[0], np.asarray(refs[0])[..., :wt], OUT_TOL, "y")
    for got, r, name in zip(outs[1:], refs[1:], ("s1", "s2")):
        _close(got, r, OUT_TOL, name)
    dx, dres = torch.autograd.grad(outs, (x, res), [_t(ga), _t(gs1), _t(gs2)][: len(outs)])
    _close(dx, np.asarray(rdx)[..., :W_TRUE], GRAD_TOL, "dx")
    _close(dres, np.asarray(rdres)[..., :wt], GRAD_TOL, "dres")


# K10's x shapes on the main paths: the Experiment-1 step's (N = 8, blocks
# 5 and 6) and the --fuse_up all sub-image's (N = 1, blocks 4-6)
UP2ADD_PATH_SHAPES = [(8, 26, 96, 96), (8, 13, 192, 192), (1, 52, 48, 48), (1, 26, 96, 96),
                      (1, 13, 192, 192)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("shape", UP2ADD_PATH_SHAPES + [(2, 5, 7, 47), (2, 3, 5, 1),
                                                        (1, 70001, 1, 3)])
def test_upsample2_add_plan(shape, elem_bytes):
    """K10's plan, walked as csrc/upsample2_chw.cu walks it: every plane,
    x row and row vector is taken exactly once; the partials are one row
    per (image, row chunk); on the main paths the launch has at least
    UP2ADD_BLOCKS_PER_SM (eight) blocks per SM of an H100, and everywhere
    as many as the rows allow."""
    n, c, h, w = shape
    sms = 132
    plan = tk.upsample2_add_plan(n, c, h, w, elem_bytes, sms)
    chunks, gy = plan.grid
    assert plan.bx % 2 == 0 and plan.bx * plan.by <= tk.UP2ADD_THREADS and plan.rows in (1, 2)
    assert plan.part_rows == n * chunks
    planes = np.zeros(n * c, int)
    for py in range(gy):
        planes[py :: gy] += 1
    rows = np.zeros(h, int)
    for cx in range(chunks):
        r1 = min((cx + 1) * plan.chunk, h)
        for ty in range(plan.by):
            for i0 in range(cx * plan.chunk + ty, r1, plan.rows * plan.by):
                for i in range(i0, min(i0 + plan.rows * plan.by, r1), plan.by):
                    rows[i] += 1
    nvec = -(-w // (16 // elem_bytes))
    vecs = np.zeros(nvec + nvec % 2, int)
    for tx in range(plan.bx):
        vecs[tx :: plan.bx] += 1
    assert (planes == 1).all() and (rows == 1).all() and (vecs == 1).all()
    blocks = chunks * gy
    assert blocks >= min(tk.UP2ADD_BLOCKS_PER_SM * sms, n * c * h)
    if shape in UP2ADD_PATH_SHAPES:
        assert blocks >= tk.UP2ADD_BLOCKS_PER_SM * sms


def test_upsample2_add_plan_refuses_outside_kernel():
    for shape in ((0, 3, 4, 4), (1, 1, 1 << 15, 1 << 14)):
        with pytest.raises(ValueError, match="upsample2_chw_add takes"):
            tk.upsample2_add_plan(*shape)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", [(2, 5, 4, 5, 7), (1, 3, 2, 1, 3)])  # n, c, co, h, w
def test_upconv_phase_weights_reproduce_the_pair(outer, shape):
    """The arithmetic of the CUDA kernels, written with plain PyTorch ops on
    the weights the wrappers pack: the forward as four phase convs of the
    half-res padded slab with the combined 2x2 kernels; dx as the stride-2
    gather of g with the 4x4 transposed kernels, the padded border folded
    back (replicate) on the half-res slab; dW summed per phase tap and
    unpacked. Each equals the plain (unfused) pair to float32 rounding."""
    n, c, co, h, w = shape
    rng = np.random.default_rng(5)
    f = lambda *s, a=1.0: torch.from_numpy((a * rng.standard_normal(s)).astype(np.float32))
    x, wt, b = f(n, c, h, w), f(co, c, 3, 3, a=0.3), f(co)
    sc, sh, g = 1 + f(c, a=0.3), f(c, a=0.3), f(n, co, 2 * h, 2 * w)
    chan = lambda v: v.reshape(1, -1, 1, 1)
    ap = F.pad(tk.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode=outer)

    wc = tk._upconv_phase_weights(wt).reshape(co, c, 2, 2, 2, 2)
    y = torch.empty(n, co, 2 * h, 2 * w)
    for di in range(2):
        for dj in range(2):
            # phase (di, dj) reads slab rows i - 1 + di + r: padded rows i + di + r
            y[:, :, di::2, dj::2] = F.conv2d(ap[:, :, di:di + h + 1, dj:dj + w + 1],
                                             wc[:, :, di, dj], b)
    _close(y, tk.upconv3x3_chw_plain(x, wt, b, sc, sh, True, outer), OUT_TOL, "y")

    # dA at the padded slab cells -1..H: g rows 2p - 1 .. 2p + 2
    d_pad = F.conv2d(F.pad(g, (3, 3, 3, 3)), tk._upconv_dx_weights(wt).transpose(0, 1), stride=2)
    da = tk._fold_border(d_pad) if outer == "replicate" else d_pad[..., 1:-1, 1:-1]
    da = da * ((x * chan(sc) + chan(sh)) > 0)
    dx_ref, dsc_ref, dsh_ref = tk.upconv3x3_chw_dx_plain(x, g, wt, sc, sh, True, outer)
    _close(da * chan(sc), dx_ref, GRAD_TOL, "dx")
    _close((da * x).sum(dim=(0, 2, 3)), dsc_ref, GRAD_TOL, "dscale")
    _close(da.sum(dim=(0, 2, 3)), dsh_ref, GRAD_TOL, "dshift")

    dwc = torch.empty(co, c, 2, 2, 2, 2)
    for di in range(2):
        for dj in range(2):
            for r in range(2):
                for s in range(2):
                    a = ap[:, :, di + r : di + r + h, dj + s : dj + s + w]
                    dwc[:, :, di, dj, r, s] = torch.einsum("nohw,nchw->oc", g[:, :, di::2, dj::2], a)
    dw_ref, _ = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    _close(tk._upconv_unpack_dw(dwc.reshape(co, c, 16)), dw_ref, GRAD_TOL, "dw")


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_generator_fuse_up_matches_unfused(outer):
    """The port's train-mode generator under fuse_up='auto' (blocks 4-6
    fused) against 'off', from the same parameters and latents: the image
    and running statistics to 1e-4, and each parameter gradient within the
    criterion of the reference's test_generator_fuse_up_matches_unfused
    (tests/test_upconv.py): a norm-relative deviation of at most
    max(2e-3, 1.5x) the deviation between the channels-major and the NHWC
    tail on the same loss."""
    kw = dict(z_dim=8, G_ch=8, base_res=4, n_layers_G=6, attention=True, img_ch=3,
              outer_padding=outer)
    torch.manual_seed(0)
    state = ResidualPatchGenerator(**kw).state_dict()  # the attention gate at its initial 0
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 14, 14, 8)).astype(np.float32))

    def run(**over):
        gen = ResidualPatchGenerator(**{**kw, **over})
        gen.load_state_dict(state, strict=True)
        gen.train()
        y, _ = gen(z)
        grads = torch.autograd.grad((y * torch.sin(y)).sum(), list(gen.parameters()))
        names = [k for k, _ in gen.named_parameters()]
        return y.detach(), dict(zip(names, grads)), gen.state_dict()

    y0, g0, s0 = run(fuse_up="off")
    y1, g1, s1 = run(fuse_up="auto")
    _, g2, _ = run(fuse_up="off", chw_tail="off")
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)
    for k in s0:
        if k.endswith(("mean", "var")):
            torch.testing.assert_close(s1[k], s0[k], rtol=1e-4, atol=1e-5, msg=k)
    for k, a in g0.items():
        norm = float(a.norm()) + 1e-12
        fuse_err = float((a - g1[k]).norm()) / norm
        floor = float((a - g2[k]).norm()) / norm
        assert fuse_err <= max(2e-3, 1.5 * floor), (k, fuse_err, floor)
