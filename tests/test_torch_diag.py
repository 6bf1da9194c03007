"""The port's remaining eval variants on the CPU in float32: the
batched-diagonal engine (``sampling/diag.py``) against the port's raster
and against JAX's diagonal engine, its per-lane halo helpers against the
one-position ones, the schedule constants, ``truncated_normal_z`` and
``sample_from_gen_patch_by_patch_train``, and ``sample --diag_lanes``.

The generator is the reference test's (``tests/test_diag.py``: z_dim 8,
G_ch 8, n_layers_G 4, patch 32, no attention), its weights from a JAX init
with the BN statistics moved off (0, 1); latents are numpy arrays handed to
both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxGenerator
from infinite_texture_gans_tpu.ops import padding as jpad
from infinite_texture_gans_tpu.parallel.wavefront import schedule_constants as jax_schedule
from infinite_texture_gans_tpu.sampling.diag import generate_canvas_diag as jax_canvas_diag
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import padding as tpad
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag, schedule_constants
from infinite_texture_gans_torch.sampling.infinite import (
    generate_canvas,
    generate_one_pass,
    sample_from_gen_patch_by_patch_train,
)
from infinite_texture_gans_torch.sampling.stream import read_png
from infinite_texture_gans_torch.train import checkpoint
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

# port against JAX: the other port tests' tolerance (f32 sums in another order)
ATOL, RTOL = 2e-4, 1e-4
# the diagonal engine against the raster where PyTorch's CPU convolutions
# sum in an order that depends on the batch (oneDNN at small images; its
# fallback at 128 input channels, the SSM embed's): float32 rounding carried
# through the model, read up to 3e-6
CPU_CONV_ATOL = 1e-5

TINY = dict(z_dim=8, G_ch=8, base_res=4, n_layers_G=4, attention=False, img_ch=3)
VARIANTS = {"BN": {}, "all": {"fuse_up": "all"}, "SSM": {"type_norm": "SSM", "map_dim": 1}}


def _jax_gen(**kw):
    cfg = {"type_norm": "BN", **TINY, **kw}
    return JaxGenerator(padding_mode="local", outer_padding="replicate", chw_tail="on", **cfg)


def _tree(variant):
    """A JAX init of the variant's generator, statistics moved off (0, 1)."""
    gen = _jax_gen(**VARIANTS[variant])
    z = jnp.zeros((1, 14, 14, 8))
    maps = None
    if variant == "SSM":
        maps = [jnp.zeros((1, r * 3 + 4, r * 3 + 4, 1)) for r in (4, 8, 16, 32)]
    v = jax.jit(lambda z, m: gen.init(jax.random.key(0), z, m, train=True))(z, maps)
    out = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    rng = np.random.default_rng(11)
    for bn in jax.tree_util.tree_leaves(out["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    return gen, out


@pytest.fixture(scope="module")
def trees():
    return {v: _tree(v) for v in VARIANTS}


def _port(tree, variant, **kw):
    gen = ResidualPatchGenerator(**{**TINY, **VARIANTS[variant], **kw}, padding_mode="local")
    gen.load_state_dict(from_jax_variables(tree), strict=True)
    return gen.eval()


def _latents(seed, th, tw, ssm):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((1, th * 4 + 2, tw * 4 + 2, 8)).astype(np.float32)
    maps = None
    if ssm:
        maps = [rng.standard_normal((1, th * r + 4, tw * r + 4, 1)).astype(np.float32)
                for r in (4, 8, 16, 32)]
    return z, maps


def _t(maps):
    return None if maps is None else [torch.from_numpy(m) for m in maps]


@pytest.mark.parametrize("steps", [(5, 4), (3, 5), (8, 3)])
@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
def test_schedule_constants_match_jax(steps, lanes):
    assert schedule_constants(steps[1], steps[0], lanes) == jax_schedule(steps[1], steps[0], lanes)


# a 5 x 4-step canvas (11 x 9 patches of 32): lanes 2 runs rows in three
# cycles with a ragged tail, lanes 3 and 4 ragged cyclic assignments
DIAG_CASES = [("BN", 1), ("BN", 2), ("BN", 3), ("BN", 4), ("all", 2), ("all", 3)]


@pytest.mark.parametrize("variant,lanes", DIAG_CASES)
def test_diag_matches_raster_bit_for_bit(trees, variant, lanes):
    """The port's diagonal engine equals its raster bit for bit, lanes 1-4
    (BN) and ``--fuse_up all``. oneDNN is off in this test: it picks its
    convolution algorithm by batch size at these small images, which
    changes the sums' order between batch L and batch 1; without it these
    convolutions (at most 64 input channels) sum alike at any batch."""
    gen = _port(trees[variant][1], variant)
    z, _ = _latents(7, 11, 9, False)
    with torch.backends.mkldnn.flags(enabled=False):
        ref = generate_canvas(gen, None, 11 * 32, 9 * 32, z_full=torch.from_numpy(z))
        out = generate_canvas_diag(gen, None, 11 * 32, 9 * 32, lanes=lanes,
                                   z_full=torch.from_numpy(z))
    assert out.shape == ref.shape == (1, 352, 288, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("variant", ["attention", "SSM"])
def test_diag_matches_raster_within_cpu_rounding(trees, variant):
    """Where the CPU's convolutions sum by batch (oneDNN on, the attention
    block; SSM, whose 128-channel embed conv sums by batch without oneDNN
    too): a ragged 5 x 4-step canvas within CPU_CONV_ATOL of the raster's,
    lanes 1 bit for bit, the u8 wire within one level (a rounding that
    lands on a level boundary), and lanes 3 bit for bit against canvas 0 of
    the raster run at batch 3 (each call then at the diagonal's batch)."""
    if variant == "SSM":
        gen = _port(trees["SSM"][1], "SSM")
    else:
        gen = ResidualPatchGenerator(**{**TINY, "attention": True}, padding_mode="local")
        gen.load_state_dict(from_jax_variables(_tree_with_attention()), strict=True)
        gen.eval()
    z, maps = _latents(8, 11, 9, variant == "SSM")
    kw = dict(z_full=torch.from_numpy(z), maps_full=_t(maps))
    ref = generate_canvas(gen, None, 11 * 32, 9 * 32, **kw)
    np.testing.assert_array_equal(generate_canvas_diag(gen, None, 11 * 32, 9 * 32, lanes=1, **kw),
                                  ref)
    out = generate_canvas_diag(gen, None, 11 * 32, 9 * 32, lanes=3, **kw)
    np.testing.assert_allclose(out, ref, atol=CPU_CONV_ATOL, rtol=0)
    more = [_latents(9 + k, 11, 9, variant == "SSM") for k in range(2)]
    batch_maps = None if maps is None else [
        torch.from_numpy(np.concatenate(m)) for m in zip(maps, *(m for _, m in more))]
    batched = generate_canvas(gen, None, 11 * 32, 9 * 32, maps_full=batch_maps,
                              z_full=torch.from_numpy(np.concatenate([z] + [z_ for z_, _ in more])))
    np.testing.assert_array_equal(out, batched[:1])
    u8 = generate_canvas_diag(gen, None, 11 * 32, 9 * 32, lanes=2, wire="u8", **kw)
    ref8 = generate_canvas(gen, None, 11 * 32, 9 * 32, wire="u8", **kw)
    assert u8.dtype == np.uint8 and np.abs(u8.astype(int) - ref8.astype(int)).max() <= 1


def _tree_with_attention():
    gen = _jax_gen(attention=True)
    v = jax.jit(lambda z: gen.init(jax.random.key(1), z, train=True))(jnp.zeros((1, 14, 14, 8)))
    tree = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": v["batch_stats"]})
    tree["params"]["attention"]["attn"]["gamma"] = np.float32(0.4)  # the gate open
    return tree


# (variant, wire, lanes) against JAX's generate_canvas_diag: 3 x 3 steps
JAX_CASES = [("BN", "f32", 2), ("all", "f32", 3), ("SSM", "u8", 2)]


@pytest.mark.parametrize("variant,wire,lanes", JAX_CASES)
def test_diag_matches_jax(trees, variant, wire, lanes):
    """The port's diagonal engine against JAX's on the same latents (its
    Pallas tail in interpret mode): float32 within ATOL / RTOL; the u8 wire
    within one level of JAX's and of the port's own raster (a rounding on
    either side of a level boundary)."""
    jgen, tree = trees[variant]
    gen = _port(tree, variant)
    z, maps = _latents(3, 7, 7, variant == "SSM")
    want = np.asarray(jax_canvas_diag(
        jgen, tree, jax.random.key(0), 7 * 32, 7 * 32, lanes=lanes, z_full=jnp.asarray(z),
        maps_full=None if maps is None else [jnp.asarray(m) for m in maps], wire=wire))
    with torch.backends.mkldnn.flags(enabled=False):
        got = generate_canvas_diag(gen, None, 7 * 32, 7 * 32, lanes=lanes,
                                   z_full=torch.from_numpy(z), maps_full=_t(maps), wire=wire)
        raster = generate_canvas(gen, None, 7 * 32, 7 * 32, z_full=torch.from_numpy(z),
                                 maps_full=_t(maps), wire=wire)
    assert got.shape == want.shape and got.dtype == want.dtype
    if wire == "u8":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(got.astype(int) - raster.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got, raster)


def test_diag_rejects_narrow_grid():
    gen = ResidualPatchGenerator(**TINY, padding_mode="local", num_patches_w=2)
    with pytest.raises(ValueError, match="num_patches_w >= 3"):
        generate_canvas_diag(gen, torch.Generator().manual_seed(0), 64, 64)


# --- the per-lane halo helpers at one lane equal the one-position ones ----

POSITIONS = [(True, True, 0), (True, False, 1), (False, True, 0), (False, False, 2)]


def _site(rng, n, hm, c, tot_w, w):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((n, hm, 1, c), (n, 1, tot_w * w + 2, c), (n, 1, tot_w * w + 2, c))]


def _lanes(pos, active=True, n=1):
    col, first_row, first_col = pos[2], pos[0], pos[1]
    full = lambda v, dt: torch.full((n,), v, dtype=dt)  # noqa: E731
    return tpad.LanePos(full(col, torch.int64), full(first_row, torch.bool),
                        full(first_col, torch.bool), full(active, torch.bool))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("helper", ["halo_pad_step", "chw_halo_step", "chw_upconv_halo_step"])
def test_lane_halo_helpers_match_one_position(helper, pos, outer):
    """Each helper with a one-lane LanePos gives the one-position call's
    output, ``v`` and ``row_write`` bit for bit; an inactive lane leaves
    ``v`` and ``row_write`` as they were (its output is dropped)."""
    gh = gw = 3
    rng = np.random.default_rng(2)
    c, co, hm, wm, tot_w = 3, 2, 6, 12, 7
    x = torch.from_numpy(rng.standard_normal((1, c, hm, wm)).astype(np.float32))
    site = _site(rng, 1, hm, c, tot_w, 4)
    w = torch.from_numpy((0.3 * rng.standard_normal((co, c, 3, 3))).astype(np.float32))
    b, sc, sh = (torch.from_numpy(rng.standard_normal(k).astype(np.float32)) for k in (co, c, c))

    def call(p, st):
        st = tpad.SiteState(*(t.clone() for t in st))
        if helper == "halo_pad_step":
            y, s = tpad.halo_pad_step(x.permute(0, 2, 3, 1), st, p, gh, gw, outer)
        else:
            y, s = getattr(tk, helper)(x, w, b, sc, sh, True, outer, st, p, gh, gw)
        return y, s.v, s.row_write

    want = call(tpad.GridPos(pos[2], pos[0], pos[1]), site)
    for got, ref in zip(call(_lanes(pos), site), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    _, v, row_write = call(_lanes(pos, active=False), site)
    torch.testing.assert_close(v, site[0], rtol=0, atol=0)
    torch.testing.assert_close(row_write, site[2], rtol=0, atol=0)


def test_lane_halo_helpers_per_lane():
    """Three lanes at three positions in one call: each lane's output and
    cache equal its own one-position call on its own cache (oneDNN off: it
    sums by batch size)."""
    gh = gw = 3
    rng = np.random.default_rng(4)
    c, co, hm, wm, tot_w = 3, 2, 6, 12, 7
    x = torch.from_numpy(rng.standard_normal((3, c, hm, wm)).astype(np.float32))
    site = _site(rng, 3, hm, c, tot_w, 4)
    w = torch.from_numpy((0.3 * rng.standard_normal((co, c, 3, 3))).astype(np.float32))
    b, sc, sh = (torch.from_numpy(rng.standard_normal(k).astype(np.float32)) for k in (co, c, c))
    pos = [POSITIONS[3], POSITIONS[0], POSITIONS[2]]
    lane = tpad.LanePos(torch.tensor([p[2] for p in pos]), torch.tensor([p[0] for p in pos]),
                        torch.tensor([p[1] for p in pos]), torch.tensor([True, True, False]))
    with torch.backends.mkldnn.flags(enabled=False):  # sums alike at batch 3 and 1
        y, s = tk.chw_halo_step(x, w, b, sc, sh, True, "replicate",
                                tpad.SiteState(*(t.clone() for t in site)), lane, gh, gw)
    for i, p in enumerate(pos):
        one = tpad.SiteState(*(t[i : i + 1].clone() for t in site))
        with torch.backends.mkldnn.flags(enabled=False):
            y1, s1 = tk.chw_halo_step(x[i : i + 1], w, b, sc, sh, True, "replicate", one,
                                      tpad.GridPos(p[2], p[0], p[1]), gh, gw)
        torch.testing.assert_close(y[i : i + 1], y1, rtol=0, atol=0)
        if i < 2:
            torch.testing.assert_close(s.v[i : i + 1], s1.v, rtol=0, atol=0)
            torch.testing.assert_close(s.row_write[i : i + 1], s1.row_write, rtol=0, atol=0)
        else:  # inactive: untouched
            torch.testing.assert_close(s.v[i], site[0][i], rtol=0, atol=0)
            torch.testing.assert_close(s.row_write[i], site[2][i], rtol=0, atol=0)


def test_lane_halo_step_matches_jax():
    """The per-lane NHWC step against JAX's one-position ``halo_pad_step``
    at each lane's position (JAX's engine vmaps it)."""
    gh = gw = 3
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    site = [a.numpy() for a in _site(rng, 2, 12, 3, 7, 4)]
    pos = [POSITIONS[1], POSITIONS[3]]
    lane = tpad.LanePos(torch.tensor([p[2] for p in pos]), torch.tensor([p[0] for p in pos]),
                        torch.tensor([p[1] for p in pos]), torch.tensor([True, True]))
    y, s = tpad.halo_pad_step(torch.from_numpy(x), tpad.SiteState(
        *(torch.from_numpy(a.copy()) for a in site)), lane, gh, gw)
    for i, p in enumerate(pos):
        jy, js = jpad.halo_pad_step(
            jnp.asarray(x[i : i + 1]), jpad.SiteState(*(jnp.asarray(a[i : i + 1]) for a in site)),
            jpad.GridPos(col=jnp.int32(p[2]), first_row=jnp.bool_(p[0]),
                         first_col=jnp.bool_(p[1])), gh, gw)
        np.testing.assert_array_equal(y[i : i + 1].numpy(), np.asarray(jy))
        np.testing.assert_array_equal(s.v[i : i + 1].numpy(), np.asarray(js.v))
        np.testing.assert_array_equal(s.row_write[i : i + 1].numpy(), np.asarray(js.row_write))


# --- truncated_normal_z and the train-time fake sampler -------------------

@pytest.mark.parametrize("bound", [0.5, 1.0, 2.0])
def test_truncated_normal_z_distribution(bound):
    """Bounds exact; mean, variance and the CDF against
    ``scipy.stats.truncnorm`` (262144 draws: the mean within 5 standard
    errors, the variance within 3%, a Kolmogorov-Smirnov statistic below
    0.005)."""
    z = latents.truncated_normal_z(torch.Generator().manual_seed(3), bound, 64, 4096, device="cpu")
    assert z.shape == (4096, 64) and z.dtype == torch.float32
    x = z.double().numpy().ravel()
    assert x.min() >= -bound and x.max() <= bound
    dist = scipy.stats.truncnorm(-bound, bound)
    assert abs(x.mean() - dist.mean()) < 5 * dist.std() / np.sqrt(x.size)
    assert abs(x.var() / dist.var() - 1) < 0.03
    assert scipy.stats.kstest(x, dist.cdf).statistic < 0.005


@pytest.mark.parametrize("variant", ["BN", "SSM"])
def test_train_time_sample_matches_one_pass_and_jax(trees, variant):
    """One eval forward of the 3 x 3 training grid: the port's output equals
    its one pass on the same draws (drawn again from the same seed) bit for
    bit, and the forward of JAX's ``sample_from_gen_patch_by_patch_train``
    (``gen.apply`` with ``train=False``) on those draws within ATOL / RTOL
    (JAX's function draws with ``jax.random``, so its draws are passed in
    here)."""
    jgen, tree = trees[variant]
    gen = _port(tree, variant)
    out = sample_from_gen_patch_by_patch_train(gen, torch.Generator().manual_seed(9), 2)
    g = torch.Generator().manual_seed(9)
    z = latents.build_train_z(g, 2, 8, 4, 3, 3, device="cpu")
    maps = (latents.build_train_maps(g, 2, 1, 4, 4, 3, 3, device="cpu")
            if variant == "SSM" else None)
    assert out.shape == (2, 96, 96, 3)
    torch.testing.assert_close(out, generate_one_pass(gen, z, 3, 3, maps_full=maps),
                               rtol=0, atol=0)
    want, _ = jgen.apply(tree, jnp.asarray(z.numpy()),
                         None if maps is None else [jnp.asarray(m.numpy()) for m in maps],
                         train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_sample_cli_diag_lanes(trees, tmp_path):
    """``sample --diag_lanes 2 --batch 2`` on the CPU writes the diagonal
    engine's u8 canvases (the raster's, within a level: oneDNN)."""
    tree = trees["BN"][1]
    path = str(tmp_path / "tiny.ckpt")
    args = {**TINY, "padding_mode": "local", "type_norm_G": "BN", "num_patches_height": 3,
            "num_patches_width": 3}
    checkpoint.save_checkpoint(path, {"meta": {"args": args}, "netG_variables": tree})
    sample.main(["--model_path", path, "--device", "cpu", "--output_resolution_height", "200",
                 "--output_resolution_width", "170", "--seed", "4", "--diag_lanes", "2",
                 "--batch", "2", "--output_name", "d.png"])
    gen, _ = checkpoint.load_generator_from_checkpoint(path, device="cpu")
    want = generate_canvas_diag(gen, torch.Generator().manual_seed(4), 200, 170, 2, lanes=2,
                                wire="u8")
    np.testing.assert_array_equal(read_png(str(tmp_path / "d.png")), want[0])
    np.testing.assert_array_equal(read_png(str(tmp_path / "d_1.png")), want[1])
    raster = generate_canvas(gen, torch.Generator().manual_seed(4), 200, 170, 2, wire="u8")
    assert np.abs(want.astype(int) - raster.astype(int)).max() <= 1
