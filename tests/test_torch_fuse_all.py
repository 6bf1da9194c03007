"""The port's ``--fuse_up all`` generation path (the fused eval tail: K9 on
the one pass, K14 ``chw_upconv_halo_step`` in the raster engine) and the
streamed PNG engine, on the CPU in float32: against the JAX reference (its
Pallas kernels in interpret mode) and against the port's own one pass.

The generator is the reference test's own (``tests/test_upconv.py``:
G_ch 8, n_layers_G 5, no attention, z_dim 16; blocks 4 and 5 fuse). Weights
come from a JAX init and cross through ``weights.from_jax_variables``;
latents are numpy arrays handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxGenerator
from infinite_texture_gans_tpu.models.generator import generator_site_specs as jax_site_specs
from infinite_texture_gans_tpu.ops import padding as jpad
from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_tpu.sampling.infinite import generate_canvas as jax_generate_canvas
from infinite_texture_gans_tpu.sampling.infinite import generate_one_pass as jax_generate_one_pass
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import padding as tpad
from infinite_texture_gans_torch.sampling.infinite import (
    canvas_geometry,
    generate_canvas,
    generate_one_pass,
)
from infinite_texture_gans_torch.sampling.stream import (
    StreamingPNGWriter,
    generate_canvas_streamed,
    read_png,
)
from infinite_texture_gans_torch.train import checkpoint
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

# port against JAX: the tolerance of tests/test_halo.py (f32 sums taken in
# another order), the port-vs-JAX tolerance of the other port tests
ATOL, RTOL = 2e-4, 1e-4
# K14's plain step against JAX's: one conv of a few channels, f32
STEP_ATOL = 2e-5
# 'all' against the unfused engine: tests/test_upconv.py's own tolerance
# (the fused kernels regroup float additions)
FUSE_ATOL, FUSE_RTOL = 5e-4, 1e-3

TINY = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=5, attention=False, img_ch=3)


def _jax_gen(cfg=TINY, **kw):
    return JaxGenerator(type_norm="BN", padding_mode="local", chw_tail="on", **{**cfg, **kw})


@pytest.fixture(scope="module")
def tree():
    """The tiny generator's variables from a JAX init, running statistics
    moved away from (0, 1) so that the BN folds matter."""
    gen = _jax_gen(fuse_up="all")
    z = jnp.zeros((1, 3 * 4 + 2, 3 * 4 + 2, 16))
    v = jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(z)
    out = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    rng = np.random.default_rng(11)
    for bn in jax.tree_util.tree_leaves(out["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    return out


def _port(tree, cfg=TINY, **kw):
    gen = ResidualPatchGenerator(**cfg, **kw)
    gen.load_state_dict(from_jax_variables(tree), strict=True)
    return gen.eval()


def _z(seed, th, tw, cfg=TINY):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, th * cfg["base_res"] + 2, tw * cfg["base_res"] + 2,
                                cfg["z_dim"])).astype(np.float32)


# --- the fused blocks and their half-resolution conv1 sites ---------------

SPEC_CASES = [
    ("tiny", TINY, {}, {4, 5}),
    ("flagship", dict(z_dim=128, G_ch=52, base_res=4, n_layers_G=6, attention=True, img_ch=3), {},
     {4, 5, 6}),
    ("ssm", dict(TINY, map_dim=1), {"type_norm": "SSM"}, set()),
]


@pytest.mark.parametrize("name,cfg,kw,fused", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_eval_fuse_blocks_and_site_specs_match_jax(name, cfg, kw, fused):
    jgen = JaxGenerator(padding_mode="local", chw_tail="on", fuse_up="all", **{"type_norm": "BN", **cfg, **kw})
    with torch.device("meta"):  # the structure alone: no weights drawn
        gen = ResidualPatchGenerator(**cfg, fuse_up="all", **kw)
        unfused = ResidualPatchGenerator(**cfg, fuse_up="auto", **kw)
    assert gen.eval_fuse_blocks() == jgen.eval_fuse_blocks() == frozenset(fused)
    want = [tuple(s) for s in jax_site_specs(cfg["G_ch"], cfg["base_res"], cfg["n_layers_G"],
                                             fused_blocks=jgen.eval_fuse_blocks())]
    assert [tuple(s) for s in gen.site_specs()] == want
    specs = {s.name: s.patch_res for s in gen.site_specs()}
    for i in fused:  # conv1 caches its halo at half the block's resolution
        assert specs[f"block{i}.conv1"] * 2 == specs[f"block{i}.conv2"]
    assert unfused.eval_fuse_blocks() == frozenset()


# --- K14's step: its plain path against JAX chw_upconv_halo_step ----------

HALO_POSITIONS = [(True, True, 0), (True, False, 1), (False, True, 0), (False, False, 1)]


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", HALO_POSITIONS)
def test_chw_upconv_halo_step_matches_jax(outer, first_row, first_col, col):
    """A half-res sub-image (3 x 3 patches of 2 x 4) with a random half-res
    halo cache: y, the new ``v`` and ``row_write`` as JAX's."""
    gh = gw = 3
    rng = np.random.default_rng(1)
    c, co, hm, wm, tot_w = 3, 2, 6, 12, 7
    x = rng.standard_normal((1, c, hm, wm)).astype(np.float32)
    site = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, hm, 1, c), (1, 1, tot_w * 4 + 2, c), (1, 1, tot_w * 4 + 2, c))]
    k = (0.3 * rng.standard_normal((3, 3, c, co))).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    sc = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    sh = (0.3 * rng.standard_normal(c)).astype(np.float32)
    jpos = jpad.GridPos(col=jnp.int32(col), first_row=jnp.bool_(first_row),
                        first_col=jnp.bool_(first_col))
    y_ref, s_ref = pc.chw_upconv_halo_step(
        *(jnp.asarray(a) for a in (x, k, b, sc, sh)), True, outer,
        jpad.SiteState(*(jnp.asarray(a) for a in site)), jpos, gh, gw)
    t = torch.from_numpy
    tk.reset_launches()
    y, s_new = tk.chw_upconv_halo_step(
        t(x), t(np.ascontiguousarray(k.transpose(3, 2, 0, 1))), t(b), t(sc), t(sh), True, outer,
        tpad.SiteState(*(t(a.copy()) for a in site)), tpad.GridPos(col, first_row, first_col), gh, gw)
    assert y.shape == (1, co, 2 * hm, 2 * wm) and sum(tk.LAUNCHES.values()) == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=STEP_ATOL, rtol=0)
    for got, ref in zip(s_new, s_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=STEP_ATOL, rtol=0)


def test_upconv_halo_rejects_bad_borders():
    x = torch.zeros(1, 3, 4, 5)
    w, b, sc, sh = torch.zeros(2, 3, 3, 3), torch.zeros(2), torch.ones(3), torch.zeros(3)
    with pytest.raises(ValueError):  # top is (N, C, W + 2)
        tk.upconv3x3_chw_halo(x, w, b, sc, sh, True, "replicate", torch.zeros(1, 3, 5), None)
    with pytest.raises(ValueError):  # left is (N, C, H)
        tk.upconv3x3_chw_halo(x, w, b, sc, sh, True, "replicate", None, torch.zeros(1, 3, 5))
    with pytest.raises(TypeError):
        tk.upconv3x3_chw_halo(x, w, b, sc, sh, True, "replicate", None,
                              torch.zeros(1, 3, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tk.upconv3x3_chw_halo(x, w, b, sc, sh, True, "reflect", None, None)
    y = tk.upconv3x3_chw_halo(x, w, b, sc, sh, True, "constant", None, None)
    assert y.shape == (1, 2, 8, 10)


# --- the fused generator against JAX and against itself --------------------


def test_fused_one_pass_and_canvas_match_jax(tree):
    """5 x 7 patches under 'all': the port's one pass against JAX
    generate_one_pass, the port's raster canvas against JAX generate_canvas
    (its K14 sites in interpret mode)."""
    jgen = _jax_gen(fuse_up="all")
    gen = _port(tree, fuse_up="all")
    P = gen.patch_resolution
    z = _z(2, 5, 7)
    ref_one = np.asarray(jax_generate_one_pass(jgen, tree, jnp.asarray(z), None, 5, 7))
    tk.reset_launches()
    one = generate_one_pass(gen, torch.from_numpy(z), 5, 7).numpy()
    np.testing.assert_allclose(one, ref_one, atol=ATOL, rtol=RTOL)
    ref = jax_generate_canvas(jgen, tree, jax.random.key(0), 5 * P, 7 * P, z_full=jnp.asarray(z))
    got = generate_canvas(gen, None, 5 * P, 7 * P, z_full=torch.from_numpy(z))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors take the plain versions


# the sizes of tests/test_halo.py (patch 64 here): 1x1, 1xN, Nx1, NxM steps,
# zeros outer padding, and a size that is not a multiple of the patch
RASTER_CASES = [
    ("replicate", 3 * 64, 3 * 64),
    ("replicate", 3 * 64, 3 * 64 + 4 * 64),
    ("replicate", 3 * 64 + 4 * 64, 3 * 64),
    ("replicate", 5 * 64, 5 * 64),
    ("constant", 5 * 64, 7 * 64),
    ("replicate", 200, 300),
]


@pytest.mark.parametrize("outer,out_h,out_w", RASTER_CASES)
def test_fused_raster_equals_fused_one_pass(tree, outer, out_h, out_w):
    gen = _port(tree, fuse_up="all", outer_padding=outer)
    P = gen.patch_resolution
    _, _, th, tw = canvas_geometry(out_h, out_w, P, 3, 3)
    z = torch.from_numpy(_z(7, th, tw))
    canvas = generate_canvas(gen, None, out_h, out_w, z_full=z)
    oracle = generate_one_pass(gen, z, th, tw)[:, :out_h, :out_w].numpy()
    assert canvas.shape == (1, out_h, out_w, 3)
    np.testing.assert_allclose(canvas, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
def test_fuse_all_matches_unfused_engine(tree, outer):
    """'all' against 'auto' (eval unfused) on the same latents, the
    reference's tolerance for the fused kernels' regrouped additions."""
    fused = _port(tree, fuse_up="all", outer_padding=outer)
    unfused = _port(tree, fuse_up="auto", outer_padding=outer)
    P = fused.patch_resolution
    z = torch.from_numpy(_z(3, 5, 5))
    a = generate_canvas(unfused, None, 5 * P, 5 * P, z_full=z)
    b = generate_canvas(fused, None, 5 * P, 5 * P, z_full=z)
    np.testing.assert_allclose(b, a, atol=FUSE_ATOL, rtol=FUSE_RTOL)


# --- the streamed PNG engine ----------------------------------------------


def _ssm_gen():
    gen = ResidualPatchGenerator(**dict(TINY, n_layers_G=4), type_norm="SSM", map_dim=2)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return gen.eval()


@pytest.mark.parametrize("which", ["all", "auto", "ssm"])
def test_streamed_png_equals_in_memory_canvas(tree, tmp_path, which):
    """Three bands (one canvas row each) and a ragged crop: the decoded PNG
    is generate_canvas(wire='u8') from the same seed, byte for byte."""
    gen = _ssm_gen() if which == "ssm" else _port(tree, fuse_up=which)
    P = gen.patch_resolution
    out_h, out_w = 6 * P - 13, 4 * P - 7
    want = generate_canvas(gen, torch.Generator().manual_seed(5), out_h, out_w, wire="u8")[0]
    path = generate_canvas_streamed(gen, torch.Generator().manual_seed(5), out_h, out_w,
                                    str(tmp_path / "c.png"), row_group=1)
    img = read_png(path)
    assert img.shape == (out_h, out_w, 3)
    np.testing.assert_array_equal(img, want)


def test_streamed_engine_removes_the_partial_png_on_error(tree, tmp_path, monkeypatch):
    """A failure after the first band was handed to the encoder thread
    propagates, and no truncated PNG is left behind."""
    gen = _port(tree, fuse_up="all")
    real, calls = gen.forward, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:  # two sub-images a canvas row
            raise RuntimeError("planted")
        return real(*args, **kwargs)

    monkeypatch.setattr(gen, "forward", failing)
    path = tmp_path / "c.png"
    P = gen.patch_resolution
    with pytest.raises(RuntimeError, match="planted"):
        generate_canvas_streamed(gen, torch.Generator().manual_seed(5), 6 * P - 13, 4 * P - 7,
                                 str(path), row_group=1)
    assert len(calls) == 4 and not path.exists()


def test_streaming_writer_refuses_early_close_and_aborts(tmp_path):
    path = tmp_path / "p.png"
    w = StreamingPNGWriter(str(path), 3, 4, 1)
    w.write_rows(np.full((2, 6, 1), 7, np.uint8))  # columns past the width are dropped
    with pytest.raises(ValueError, match="closed early"):
        w.close()
    w.abort()
    assert not path.exists()
    w = StreamingPNGWriter(str(path), 3, 4, 1)
    w.write_rows(np.arange(20, dtype=np.uint8).reshape(5, 4, 1))  # rows past the height too
    w.close()
    np.testing.assert_array_equal(read_png(path), np.arange(12, dtype=np.uint8).reshape(3, 4, 1))
    blob = bytearray(path.read_bytes())
    blob[-20] ^= 1  # inside the last IDAT chunk: its CRC no longer holds
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(path))
    with pytest.raises(ValueError):
        StreamingPNGWriter(str(tmp_path / "q.png"), 2, 2, 4)


def test_sample_cli_fuse_all_stream(tree, tmp_path):
    """``sample --fuse_up all --stream`` writes the in-memory 'all' canvas
    of the same seed."""
    ckpt = str(tmp_path / "tiny.ckpt")
    args = {"G_ch": 8, "z_dim": 16, "n_layers_G": 5, "attention": False,
            "padding_mode": "local", "compute_dtype": "float32"}
    jax_ckpt.save_checkpoint(ckpt, {"meta": {"args": args}, "netG_variables": tree})
    sample.main(["--model_path", ckpt, "--device", "cpu", "--output_name", "s.png", "--seed", "4",
                 "--output_resolution_height", "200", "--output_resolution_width", "150",
                 "--fuse_up", "all", "--stream", "--row_group", "1"])
    gen, targs = checkpoint.load_generator_from_checkpoint(ckpt, device="cpu", fuse_up="all")
    assert targs.fuse_up == gen.fuse_up == "all" and gen.eval_fuse_blocks() == {4, 5}
    want = generate_canvas(gen, torch.Generator().manual_seed(4), 200, 150, wire="u8")[0]
    np.testing.assert_array_equal(read_png(tmp_path / "s.png"), want)
