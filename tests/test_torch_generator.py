"""The PyTorch port's generator and raster engine against the JAX reference
and against its own one-pass oracle, on the CPU in float32.

Weights come from a JAX init and cross through ``weights.from_jax_variables``;
latents are numpy arrays handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.models.generator import (
    ResidualPatchGenerator as JaxGenerator,
)
from infinite_texture_gans_tpu.sampling import latents as jax_latents
from infinite_texture_gans_tpu.sampling.infinite import (
    generate_canvas as jax_generate_canvas,
)
from infinite_texture_gans_torch.config import dict_to_args, generator_kwargs
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import (
    canvas_geometry,
    generate_canvas,
    generate_one_pass,
)
from infinite_texture_gans_torch.weights import from_jax_variables

# the tolerance of tests/test_halo.py: f32 sums taken in another order
ATOL, RTOL = 2e-4, 1e-4

SMALL = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=4, attention=True, img_ch=3)


def _jax_variables(cfg, gamma=None):
    gen = JaxGenerator(type_norm="BN", padding_mode="local", **cfg)
    z = jnp.zeros((1, 3 * cfg["base_res"] + 2, 3 * cfg["base_res"] + 2, cfg["z_dim"]))
    v = jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(z)
    tree = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    # running stats away from their (0, 1) init, so the BN folds matter
    rng = np.random.default_rng(11)
    for bn in jax.tree_util.tree_leaves(tree["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    if gamma is not None:
        tree["params"]["attention"]["attn"]["gamma"] = np.float32(gamma)
    return tree


def _port(cfg, tree, **kw):
    gen = ResidualPatchGenerator(**cfg, **kw)
    gen.load_state_dict(from_jax_variables(tree), strict=True)
    return gen.eval()


def _z(seed, n, gh, gw, cfg):
    rng = np.random.default_rng(seed)
    b = cfg["base_res"]
    return rng.standard_normal((n, gh * b + 2, gw * b + 2, cfg["z_dim"])).astype(np.float32)


def test_latent_windows_match_jax():
    z = np.random.default_rng(5).standard_normal((1, 7 * 4 + 2, 9 * 4 + 2, 3)).astype(np.float32)
    for r, c in ((0, 0), (1, 2), (2, 3)):
        np.testing.assert_array_equal(
            latents.slice_sub_z(torch.from_numpy(z), r, c, 4, 3, 3).numpy(),
            np.asarray(jax_latents.slice_sub_z(jnp.asarray(z), r, c, 4, 3, 3)),
        )
        strip, _ = jax_latents.row_strips(jnp.asarray(z), None, r, 4, 3)
        got, no_maps = latents.row_strips(torch.from_numpy(z), None, r, 4, 3)
        assert no_maps is None
        np.testing.assert_array_equal(got.numpy(), np.asarray(strip))
    g = torch.Generator().manual_seed(0)
    assert latents.build_z_full(g, 2, 16, 4, 3, 5, device="cpu").shape == (2, 14, 22, 16)


@pytest.fixture(scope="module")
def small_tree():
    return _jax_variables(SMALL, gamma=0.5)


@pytest.fixture(scope="module")
def small_tree_gamma0():
    return _jax_variables(SMALL)


@pytest.mark.parametrize("port_tail", ["auto", "off"])
@pytest.mark.parametrize("jax_tail", ["off", "on"])
def test_one_pass_matches_jax(small_tree, jax_tail, port_tail):
    z = _z(1, 2, 3, 3, SMALL)
    jgen = JaxGenerator(type_norm="BN", padding_mode="local", chw_tail=jax_tail, **SMALL)
    ref, _ = jgen.apply(small_tree, jnp.asarray(z), train=False)
    gen = _port(SMALL, small_tree, chw_tail=port_tail)
    kernels.reset_launches()
    with torch.no_grad():
        out, halo = gen(torch.from_numpy(z))
    assert halo is None and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors take the plain path


def test_rejects_unported_options():
    with pytest.raises(NotImplementedError):  # zeros padding mode (SSM is ported)
        ResidualPatchGenerator(**SMALL, padding_mode="zeros")
    with pytest.raises(NotImplementedError):
        generator_kwargs(dict_to_args({"fuse_up": "all"}))
    assert generator_kwargs(dict_to_args({"fuse_up": "off"}))["fuse_up"] == "off"
    with pytest.raises(ValueError):  # 'auto' already runs the tail on any device
        ResidualPatchGenerator(**SMALL, chw_tail="on")
    with pytest.raises(ValueError):  # the halo engine is eval-only
        ResidualPatchGenerator(**SMALL)(torch.zeros(1, 14, 14, 16), halo={})
    with pytest.raises(ValueError):  # the fused eval up-conv (K14)
        ResidualPatchGenerator(**SMALL, fuse_up="all")


def _canvas_vs_one_pass(gen, out_h, out_w, seed=7):
    P, gh, gw = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w
    _, _, tot_h, tot_w = canvas_geometry(out_h, out_w, P, gh, gw)
    z = torch.from_numpy(_z(seed, 1, tot_h, tot_w, dict(base_res=gen.base_res, z_dim=gen.z_dim)))
    canvas = generate_canvas(gen, None, out_h, out_w, z_full=z)
    oracle = generate_one_pass(gen, z, tot_h, tot_w)[:, :out_h, :out_w].numpy()
    assert canvas.shape == (1, out_h, out_w, 3) and canvas.dtype == np.float32
    np.testing.assert_allclose(canvas, oracle, atol=ATOL, rtol=RTOL)
    return canvas, z


# the sizes of tests/test_halo.py (patch 32): 1x1, 1xN, Nx1 and NxM steps,
# zeros outer padding, and a size that is not a multiple of the patch
HALO_CASES = [
    ("replicate", 96, 96),
    ("replicate", 96, 96 + 4 * 64),
    ("replicate", 96 + 4 * 64, 96),
    ("replicate", 96 + 2 * 64, 96 + 2 * 64),
    ("constant", 96 + 64, 96 + 64),
    ("replicate", 100, 150),
]


@pytest.mark.parametrize("outer,out_h,out_w", HALO_CASES)
def test_raster_canvas_equals_one_pass(small_tree_gamma0, outer, out_h, out_w):
    gen = _port(SMALL, small_tree_gamma0, outer_padding=outer)
    _canvas_vs_one_pass(gen, out_h, out_w)


def test_raster_canvas_matches_jax(small_tree):
    """Same weights (attention gate on), same z_full: the port's canvas
    equals JAX generate_canvas; the u8 wire and row groups agree too."""
    out_h, out_w = 96 + 64, 96 + 2 * 64
    gen = _port(SMALL, small_tree)
    _, _, tot_h, tot_w = canvas_geometry(out_h, out_w, gen.patch_resolution, 3, 3)
    z = _z(3, 1, tot_h, tot_w, SMALL)
    jgen = JaxGenerator(type_norm="BN", padding_mode="local", **SMALL)
    ref = jax_generate_canvas(jgen, small_tree, jax.random.key(0), out_h, out_w, z_full=jnp.asarray(z))
    zt = torch.from_numpy(z)
    got = generate_canvas(gen, None, out_h, out_w, z_full=zt)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    u8 = generate_canvas(gen, None, out_h, out_w, z_full=zt, wire="u8", row_group=1)
    host = np.clip((got * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(u8, host)
    np.testing.assert_array_equal(generate_canvas(gen, None, out_h, out_w, z_full=zt, row_group=1), got)


def test_six_layer_attention_matches_jax_and_one_pass():
    """The flagship depth (n_layers_G 6, attention) at a tiny width: one
    pass against JAX with the attention gate on, and the raster canvas
    against the one pass with the gate at its init value 0 (with gamma != 0
    the raster engine deviates from the one pass by design, PARITY.md)."""
    cfg = dict(z_dim=8, G_ch=8, base_res=4, n_layers_G=6, attention=True, img_ch=3)
    tree = _jax_variables(cfg, gamma=0.5)
    z = _z(4, 1, 3, 3, cfg)
    ref, _ = JaxGenerator(type_norm="BN", padding_mode="local", **cfg).apply(
        tree, jnp.asarray(z), train=False
    )
    with torch.no_grad():
        out, _ = _port(cfg, tree)(torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    tree["params"]["attention"]["attn"]["gamma"] = np.float32(0.0)
    gen = _port(cfg, tree)
    _canvas_vs_one_pass(gen, 5 * gen.patch_resolution, 5 * gen.patch_resolution)
