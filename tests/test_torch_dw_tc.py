"""The plain side of K7's tensor-core route (``conv3x3_chw_dw`` in bf16), on
the CPU: the route's plan and its refusal above the limit, the claim that
the route needs no rounded plain version, and the plain version against the
JAX reference's K7 in interpret mode. Inputs are numpy arrays drawn from a
seed.

The route multiplies bf16 g by the bf16 post-norm input A; both are bf16
values, so every product is exact in float32, and
``conv3x3_chw_dw_plain`` on bf16 tensors is the function the kernel
computes, up to the order of its float32 sums: held here to a float64
einsum of the same bf16 operands at 1e-6 of max|ref|. Against JAX the
inputs lie on a bf16 grid (x and g small integers times 2^-4, scale powers
of two, shift multiples of 2^-4), so the bf16 operands are exact and the
float32 reference computes the same products: 1e-4 of the largest
reference entry, as ``chip_smoke.py`` holds the kernel (SUM_TOL)."""

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
# the (C, Co) pairs the training gate lets into the channels-major tail:
# auto (26, 26), (13, 13), (13, 3); off adds (52, 26), (26, 13); SSM (26, 3)
TAIL_PAIRS = [(26, 26), (13, 13), (13, 3), (52, 26), (26, 13), (26, 3)]


def _close(got, ref, tol, name=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    limit = tol * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= limit, (name, err, limit)


def _grid_case(seed, n, c, co, h, w):
    """x, g (small integers x 2^-4), scale (powers of two), shift (multiples
    of 2^-4): every post-norm value and every g is exact in bf16."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c, h, w)) / 16).astype(np.float32)
    g = (rng.integers(-16, 17, (n, co, h, w)) / 16).astype(np.float32)
    sc = (2.0 ** rng.integers(-1, 2, c)).astype(np.float32)
    sh = (rng.integers(-8, 9, c) / 16).astype(np.float32)
    return x, g, sc, sh


@pytest.mark.parametrize("c,co,want", [(3, 3, (1, 1)), (13, 3, (1, 1)), (16, 8, (1, 1)),
                                       (13, 13, (1, 2)), (26, 26, (2, 4)), (26, 3, (2, 1)),
                                       (52, 26, (4, 4)), (64, 32, (4, 4)), (17, 9, (2, 2))])
def test_dw_tc_plan(c, co, want):
    """M pads C to 16 MT, N pads Co to 8 NO, with one template each."""
    assert tk.dw_tc_plan(c, co) == want


@pytest.mark.parametrize("c,co", [(65, 13), (13, 33), (104, 52)])
def test_dw_tc_plan_refuses_wider(c, co):
    with pytest.raises(ValueError, match="C <= 64 and Co <= 32"):
        tk.dw_tc_plan(c, co)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", TAIL_PAIRS)
def test_dw_plain_bf16_is_exact_product_sum(outer, c, co):
    """conv3x3_chw_dw_plain on bf16 tensors against a float64 einsum of the
    same bf16 operands (A = prenorm rounded to bf16, g): the route needs no
    rounding twin."""
    rng = np.random.default_rng(c * 100 + co)
    x = torch.from_numpy(rng.standard_normal((2, c, 7, 9)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, co, 7, 9)).astype(np.float32)).bfloat16()
    sc = torch.from_numpy((1 + 0.3 * rng.standard_normal(c)).astype(np.float32))
    sh = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    dw, db = tk.conv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    mode = "replicate" if outer == "replicate" else "constant"
    a = F.pad(tk.prenorm(x, sc, sh, True).double(), (1, 1, 1, 1), mode=mode)
    gd = g.double()
    ref = torch.stack([torch.einsum("nohw,nchw->oc", gd, a[:, :, ky:ky + 7, kx:kx + 9])
                       for ky in range(3) for kx in range(3)], dim=-1).reshape(co, c, 3, 3)
    assert dw.dtype == db.dtype == torch.float32
    _close(dw, ref, EXACT_TOL, "dW")
    _close(db, gd.sum(dim=(0, 2, 3)), EXACT_TOL, "db")


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("c,co", TAIL_PAIRS)
def test_dw_plain_bf16_matches_jax(outer, c, co):
    """K7: dW and db of the reference's conv3x3_chw VJP (float32, interpret
    mode) against the plain version on bf16 tensors of the same grid
    values."""
    x, g, sc, sh = _grid_case(c + co, 2, c, co, 6, 10)
    k = np.zeros((3, 3, c, co), np.float32)
    b = np.zeros((co,), np.float32)

    def f(k_, b_):
        return pc.conv3x3_chw(jnp.asarray(x), k_, b_, jnp.asarray(sc), jnp.asarray(sh), True, outer)

    _, vjp = jax.vjp(f, jnp.asarray(k), jnp.asarray(b))
    jdk, jdb = vjp(jnp.asarray(g))
    dw, db = tk.conv3x3_chw_dw_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(),
                                     torch.from_numpy(sc), torch.from_numpy(sh), True, outer)
    _close(dw, np.transpose(np.asarray(jdk), (3, 2, 0, 1)), SUM_TOL, "dW")
    _close(db, jdb, SUM_TOL, "db")
