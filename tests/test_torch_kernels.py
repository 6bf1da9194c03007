"""The PyTorch port's kernel wrappers and padding ops against the JAX
reference, on the CPU in float32 (the wrappers take their plain PyTorch
versions for CPU tensors; the Pallas kernels run in interpret mode).
Inputs are numpy arrays drawn from a seed and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infinite_texture_gans_tpu.ops import padding as jpad
from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import padding as tpad
from infinite_texture_gans_torch.models.layers import ConvLP
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


# the tolerance of tests/test_halo.py: f32 sums taken in another order
ATOL, RTOL = 2e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return _t(np.transpose(w_hwio, (3, 2, 0, 1)))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _conv_inputs(seed, n=2, c=5, co=4, h=8, w=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    k = (0.3 * rng.standard_normal((3, 3, c, co))).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    shift = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, k, b, scale, shift


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_chw_matches_jax(outer, relu):
    x, k, b, sc, sh = _conv_inputs(0)
    args = [jnp.asarray(a) for a in (x, k, b, sc, sh)]
    ref = pc.conv3x3_chw(*args, relu, outer)
    oracle = pc.conv3x3_chw_reference(*args, relu=relu, outer_padding=outer)
    got = tk.conv3x3_chw(_t(x), _oihw(k), _t(b), _t(sc), _t(sh), relu, outer)
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got, ref)
    _close(got, oracle)


def _jax_site(site):
    return jpad.SiteState(*(jnp.asarray(a) for a in site))


def _halo_case(seed, gh=3, gw=3, patch=4, c=3, tot_w=7):
    """Merged NCHW activation of one sub-image plus a random halo cache."""
    rng = np.random.default_rng(seed)
    hm, wm = gh * patch, gw * patch
    x = rng.standard_normal((1, c, hm, wm)).astype(np.float32)
    wtot = tot_w * patch
    site = tuple(
        rng.standard_normal(s).astype(np.float32)
        for s in ((1, hm, 1, c), (1, 1, wtot + 2, c), (1, 1, wtot + 2, c))
    )
    return x, site


HALO_POSITIONS = [
    (True, True, 0),
    (True, False, 1),
    (False, True, 0),
    (False, False, 1),
    (False, False, 2),
]


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", HALO_POSITIONS)
def test_chw_halo_step_matches_jax(outer, first_row, first_col, col):
    gh = gw = 3
    x, site = _halo_case(1)
    c = x.shape[1]
    _, k, b, sc, sh = _conv_inputs(2, c=c, co=2)
    jpos = jpad.GridPos(
        col=jnp.int32(col), first_row=jnp.bool_(first_row), first_col=jnp.bool_(first_col)
    )
    y_ref, s_ref = pc.chw_halo_step(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.asarray(sc), jnp.asarray(sh),
        True, outer, _jax_site(site), jpos, gh, gw,
    )
    tsite = tpad.SiteState(*(_t(a) for a in site))
    y, s_new = tk.chw_halo_step(
        _t(x), _oihw(k), _t(b), _t(sc), _t(sh), True, outer, tsite,
        tpad.GridPos(col, first_row, first_col), gh, gw,
    )
    _close(y, y_ref)
    for got, ref in zip(s_new, s_ref):
        _close(got, ref)


@pytest.mark.parametrize("with_res", [False, True])
def test_conv1x1_chw_matches_jax(with_res):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 12)).astype(np.float32)
    k = rng.standard_normal((1, 1, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    res = rng.standard_normal((2, 4, 5, 12)).astype(np.float32)
    w = _oihw(k)
    if with_res:
        ref = pc.conv1x1_chw_add(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.asarray(res))
        got = tk.conv1x1_chw_add(_t(x), w, _t(b), _t(res))
    else:
        ref = pc.conv1x1_chw(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
        got = tk.conv1x1_chw(_t(x), w, _t(b))
    _close(got, ref)


def test_upsample2_chw_matches_jax_exactly():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(pc.upsample2_chw(jnp.asarray(x)))
    np.testing.assert_array_equal(tk.upsample2_chw(_t(x)).numpy(), ref)


def test_wrappers_reject_bad_inputs():
    x, k, b, sc, sh = _conv_inputs(5)
    w = _oihw(k)
    with pytest.raises(TypeError):
        tk.conv3x3_chw(_t(x).double(), w, _t(b), _t(sc), _t(sh))
    with pytest.raises(ValueError):
        tk.conv3x3_chw(_t(x).transpose(2, 3), w, _t(b), _t(sc), _t(sh))
    with pytest.raises(ValueError):
        tk.conv3x3_chw(_t(x), w, _t(b), _t(sc), _t(sh), outer_padding="reflect")
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent plain path
        tk.upsample2_chw(torch.empty((1, 2, 3, 4), device="meta"))


# ---------------------------------------------------------------------------
# ops/padding.py


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", HALO_POSITIONS)
def test_halo_pad_step_matches_jax(outer, first_row, first_col, col):
    gh = gw = 3
    x, site = _halo_case(6, c=4)
    x = np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))  # NHWC
    jpos = jpad.GridPos(
        col=jnp.int32(col), first_row=jnp.bool_(first_row), first_col=jnp.bool_(first_col)
    )
    p_ref, s_ref = jpad.halo_pad_step(jnp.asarray(x), _jax_site(site), jpos, gh, gw, outer)
    p, s_new = tpad.halo_pad_step(
        _t(x), tpad.SiteState(*(_t(a) for a in site)),
        tpad.GridPos(col, first_row, first_col), gh, gw, outer,
    )
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    for got, ref in zip(s_new, s_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_finalize_and_rotate_rows_match_jax(outer):
    _, site = _halo_case(7)
    ref = jpad.rotate_rows(jpad.finalize_row(_jax_site(site), outer))
    got = tpad.rotate_rows(tpad.finalize_row(tpad.SiteState(*(_t(a) for a in site)), outer))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_init_halo_state_matches_jax():
    specs = [jpad.SiteSpec("a", 4, 3), jpad.SiteSpec("b", 8, 2)]
    ref = jpad.init_halo_state(specs, 2, 3, 3, 5)
    got = tpad.init_halo_state([tpad.SiteSpec(*s) for s in specs], 2, 3, 3, 5, device="cpu")
    assert ref.keys() == got.keys()
    for name in ref:
        for g, r in zip(got[name], ref[name]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_local_pad_matches_jax(outer):
    x = np.random.default_rng(8).standard_normal((2, 6, 9, 3)).astype(np.float32)
    ref = jpad.local_pad(jnp.asarray(x), 1, outer)
    np.testing.assert_array_equal(tpad.local_pad(_t(x), 1, outer).numpy(), np.asarray(ref))


def test_local_padding_identity():
    """A conv over patches, each padded with its neighbours' border pixels
    (the canvas edge replicated at the border), equals one pad-1 replicate
    conv over the merged grid (SURVEY.md §4.3)."""
    gh, gw, h, w, c, co = 3, 4, 5, 6, 3, 2
    rng = np.random.default_rng(9)
    canvas = rng.standard_normal((1, gh * h, gw * w, c)).astype(np.float32)
    layer = ConvLP(c, co)
    with torch.no_grad():
        layer.conv.weight.copy_(torch.from_numpy(rng.standard_normal((co, c, 3, 3)).astype(np.float32)))
        layer.conv.bias.copy_(torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
        merged, _ = layer(_t(canvas), grid=(gh, gw))
        rows = np.clip(np.arange(-1, gh * h + 1), 0, gh * h - 1)
        cols = np.clip(np.arange(-1, gw * w + 1), 0, gw * w - 1)
        for r in range(gh):
            for q in range(gw):
                tile = canvas[:, rows[r * h : r * h + h + 2]][:, :, cols[q * w : q * w + w + 2]]
                y = F.conv2d(_t(tile).permute(0, 3, 1, 2), layer.conv.weight, layer.conv.bias)
                _close(y.permute(0, 2, 3, 1), merged[:, r * h : (r + 1) * h, q * w : (q + 1) * w])
