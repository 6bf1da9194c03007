"""The port's SSM path against the JAX reference on the CPU in float32.

- K15: ``ops.ssm.ssm_embed`` (on CPU tensors its plain version) and its
  VJP against JAX ``ssm_embed_chw_p`` in interpret mode, at the cases and
  tolerances of ``tests/test_pallas_ssm.py`` (forward atol 2e-4 on the valid
  columns; gradients to 2e-5 of each leaf's largest value, under both of the
  reference's ``bwd_impl``);
- the SSM generator (G_ch 8, n_layers_G 5, map_dim 2, attention: the
  configuration of ``tests/test_chw_tail.py::test_ssm_chw_matches_nhwc``):
  the JAX tree loads strictly, the embed init has the reference's zero
  pattern, and the eval and train forwards (with the batch statistics) match
  JAX at ``chw_tail`` 'off' and 'on' (atol 5e-5, rtol 1e-4; statistics 1e-5);
- the SSM raster canvas against the port's one pass (the grids of
  ``tests/test_halo.py``) and against JAX ``generate_canvas``;
- one tiny SSM training step against JAX ``make_train_step`` with the same
  latents and maps, at the tolerances of ``tests/test_torch_train_step.py``:
  against JAX's float32 step (its channels-major tail in interpret mode)
  and, for G, against JAX's step in float64 (x64, NHWC), since JAX's own
  float32 step sits up to 5e-3 of a leaf's largest value from it there;
  the SSM checkpoint in both directions, and the train and sample CLIs.

Inputs are numpy arrays made from a seed and handed to both sides; JAX
outputs are shared through module-scoped fixtures."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.config import discriminator_kwargs as jax_d_kwargs
from infinite_texture_gans_tpu.config import generator_kwargs as jax_g_kwargs
from infinite_texture_gans_tpu.config import prepare_parser as jax_parser
from infinite_texture_gans_tpu.models.discriminator import PatchDiscriminator as JaxD
from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxG
from infinite_texture_gans_tpu.ops.pallas_ssm import ssm_embed_chw_p
from infinite_texture_gans_tpu.sampling import latents as jax_latents
from infinite_texture_gans_tpu.sampling.infinite import generate_canvas as jax_generate_canvas
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels, ssm
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import (
    canvas_geometry,
    generate_canvas,
    generate_one_pass,
)
from infinite_texture_gans_torch.train import checkpoint as port_ckpt
from infinite_texture_gans_torch.train import train_loop
from infinite_texture_gans_torch.train.train_step import (
    create_train_state,
    train_step,
)
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oihw(k):
    return _t(np.transpose(k, (3, 2, 0, 1)))


# --- K15 ------------------------------------------------------------------


def _k15_inputs(seed, n, md, H, W, hid, co):
    rng = np.random.default_rng(seed)
    maps = rng.standard_normal((n, md, H + 4, W + 4), dtype=np.float32)
    k1 = rng.standard_normal((3, 3, md, hid), dtype=np.float32) * np.float32(0.2)
    b1 = rng.standard_normal((hid,), dtype=np.float32) * np.float32(0.1)
    k2 = rng.standard_normal((3, 3, hid, co), dtype=np.float32) * np.float32(0.2)
    b2 = rng.standard_normal((co,), dtype=np.float32) * np.float32(0.1)
    return maps, k1, b1, k2, b2


@pytest.mark.parametrize("n,md,H,W,hid,co", [
    (2, 1, 24, 44, 16, 10),
    (1, 3, 16, 128, 8, 6),
    (2, 1, 32, 60, 128, 104),
])
def test_k15_forward_matches_jax(n, md, H, W, hid, co):
    maps, k1, b1, k2, b2 = _k15_inputs(0, n, md, H, W, hid, co)
    out_w = max(W + (-W) % 128, 128)
    ref = np.asarray(ssm_embed_chw_p(*map(jnp.asarray, (maps, k1, b1, k2, b2)), W, out_w))
    kernels.reset_launches()
    got = ssm.ssm_embed(_t(maps), _oihw(k1), _t(b1), _oihw(k2), _t(b2))
    assert sum(kernels.LAUNCHES.values()) == 0  # a CPU tensor takes the plain path
    assert got.shape == (n, co, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[..., :W], rtol=0, atol=2e-4)
    torch.testing.assert_close(got, ssm.ssm_embed_plain(_t(maps), _oihw(k1), _t(b1), _oihw(k2), _t(b2)))


K15_VJP = (2, 1, 24, 44, 16, 10)  # n, md, H, W, hid, co


@pytest.fixture(scope="module")
def k15_port_grads():
    n, md, H, W, hid, co = K15_VJP
    maps, k1, b1, k2, b2 = _k15_inputs(1, n, md, H, W, hid, co)
    g = np.random.default_rng(2).standard_normal((n, co, H, W), dtype=np.float32)
    m = _t(maps).requires_grad_()
    params = [t.requires_grad_() for t in (_oihw(k1), _t(b1), _oihw(k2), _t(b2))]
    (ssm.ssm_embed(m, *params) * _t(g)).sum().backward()
    direct = ssm.ssm_embed_bwd(_t(maps), *[p.detach() for p in params[:3]], _t(g))
    return (maps, k1, b1, k2, b2, g), m.grad, [p.grad for p in params], direct


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
def test_k15_vjp_matches_jax(k15_port_grads, bwd_impl):
    (maps, k1, b1, k2, b2, g), dmaps, (dw1, db1, dw2, db2), direct = k15_port_grads
    W = maps.shape[3] - 4

    def loss(k1, b1, k2, b2):
        y = ssm_embed_chw_p(jnp.asarray(maps), k1, b1, k2, b2, W, 128, bwd_impl)
        return jnp.sum(y[..., :W] * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (k1, b1, k2, b2)))
    got = (dw1.numpy().transpose(2, 3, 1, 0), db1.numpy(), dw2.numpy().transpose(2, 3, 1, 0), db2.numpy())
    for name, a, b in zip(("dk1", "db1", "dk2", "db2"), got, ref):
        b = np.asarray(b)
        rel = float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)
        assert rel < 2e-5, (name, rel)
    assert dmaps is None  # the maps' cotangent is zero by contract
    # the backward wrapper called directly returns (dW2, db2, dW1, db1)
    for a, b in zip(direct, (dw2, db2, dw1, db1)):
        torch.testing.assert_close(a, b)


# --- the SSM generator ------------------------------------------------------

CFG = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=5, attention=True, img_ch=3, map_dim=2)


def _train_maps(seed, n, cfg, gh=3, gw=3):
    rng = np.random.default_rng(seed)
    b = cfg["base_res"]
    return [rng.standard_normal((n, gh * b * 2**i + 4, gw * b * 2**i + 4, cfg["map_dim"]), dtype=np.float32)
            for i in range(cfg["n_layers_G"])]


def _z(seed, n, gh, gw, cfg):
    b = cfg["base_res"]
    return np.random.default_rng(seed).standard_normal((n, gh * b + 2, gw * b + 2, cfg["z_dim"]),
                                                       dtype=np.float32)


def _jax_tree(cfg, gamma=None):
    gen = JaxG(type_norm="SSM", padding_mode="local", chw_tail="off", **cfg)
    z = jnp.asarray(_z(0, 1, 3, 3, cfg))
    maps = [jnp.asarray(m) for m in _train_maps(0, 1, cfg)]
    v = jax.jit(lambda z, m: gen.init(jax.random.key(0), z, m, train=True))(z, maps)
    tree = _np({"params": v["params"], "batch_stats": v["batch_stats"]})
    rng = np.random.default_rng(11)
    for bn in jax.tree_util.tree_leaves(tree["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    if gamma is not None:
        tree["params"]["attention"]["attn"]["gamma"] = np.float32(gamma)
    return tree


def _port(cfg, tree, **kw):
    gen = ResidualPatchGenerator(type_norm="SSM", **cfg, **kw)
    gen.load_state_dict(from_jax_variables(tree), strict=True)
    return gen


# --- K15's bf16 tensor-core route: what the wrapper hands the kernels ------


@pytest.mark.parametrize("co,hid", [(104, 128), (52, 128), (208, 128), (19, 16), (3, 40)])
def test_k15_tc_weight_packings(co, hid):
    """The packed w2 layouts that csrc/ssm_embed_tc.cu reads, entry by entry
    against w2, with zeros past Co and hid."""
    w2 = torch.from_numpy(np.random.default_rng(3).standard_normal((co, hid, 3, 3), dtype=np.float32))
    w2b = w2.to(torch.bfloat16)
    nt, ncb = ssm.tc_plan(co)
    nb = 8 * nt
    fwd = ssm.pack_w2_fwd(w2)
    assert fwd.dtype == torch.bfloat16 and fwd.shape == (ncb, -(-hid // 32), 9, 2, nt, 2, 8, 8)
    o, c, tap = np.meshgrid(np.arange(co), np.arange(hid), np.arange(9), indexing="ij")
    got = fwd[o // nb, c // 32, tap, (c % 32) // 16, (o % nb) // 8, (c % 16) // 8, o % 8, c % 8]
    assert torch.equal(got, w2b.reshape(co, hid, 9)[o, c, tap])
    assert int(fwd.count_nonzero()) == int(w2b.count_nonzero())  # zeros elsewhere
    dact = ssm.pack_w2_dact(w2)
    assert dact.shape == (-(-hid // 128), -(-co // 16), 9, 16, 2, 8, 8)
    sy, sx = tap // 3, tap % 3
    got = dact[c // 128, o // 16, tap, (c % 128) // 8, (o % 16) // 8, c % 8, o % 8]
    assert torch.equal(got, w2b[o, c, 2 - sy, 2 - sx])
    assert int(dact.count_nonzero()) == int(w2b.count_nonzero())


def test_k15_tc_plan_and_shares():
    """Output blocks pad Co least (the models' 52, 104 and 208 not at all);
    the backward's shares depend on the shapes alone and never exceed the
    tiles."""
    assert [ssm.tc_plan(co) for co in (52, 104, 208, 3, 60)] == [(7, 1), (13, 1), (13, 2), (7, 1), (13, 1)]
    for co in range(1, 260):
        nt, ncb = ssm.tc_plan(co)
        assert nt in ssm.TC_NT and (ncb - 1) * 8 * nt < co <= ncb * 8 * nt
    assert ssm.tc_shares(8, 192, 192, 128, 104) == (264, 33)
    assert ssm.tc_shares(1, 1, 3, 16, 3) == (1, 1)


@pytest.mark.parametrize("shape", [(2, 1, 16, 20, 32, 24), (1, 3, 8, 13, 16, 5)])
def test_k15_tc_plain_matches_jax_bf16_kernel(shape):
    """The bf16 route's plain backward, which the card checks hold its
    kernel to, against JAX's Pallas backward (``bwd_impl='pallas'``) in
    bf16: the same roundings of the hidden activation, w2 and d_pre. The
    inputs are small dyadic numbers, so that stage 1 (which JAX rounds to
    bf16 before the bias) and d_act are exact and both sides round the same
    values. dW2, db2 and dW1 agree to float32's summation order, and the
    plain version without the roundings does not; db1 sums the rounded
    d_pre, JAX's kernel the unrounded one, so they differ by at most the
    rounding, 2^-8 of sum |d_pre|."""
    n, md, H, W, hid, co = shape
    rng = np.random.default_rng(6)
    dyadic = lambda shp, k, d: (rng.integers(-k, k + 1, shp) / d).astype(np.float32)  # noqa: E731
    maps, g = dyadic((n, md, H + 4, W + 4), 2, 2), dyadic((n, co, H, W), 4, 4)
    k1, b1 = dyadic((3, 3, md, hid), 2, 4), dyadic((hid,), 2, 8)
    k2, b2 = dyadic((3, 3, hid, co), 8, 8), dyadic((co,), 2, 8)
    bf = jnp.bfloat16
    y, vjp = jax.vjp(lambda *w: ssm_embed_chw_p(jnp.asarray(maps, bf), *w, W, 128, "pallas"),
                     *map(jnp.asarray, (k1, b1, k2, b2)))
    g_pad = np.zeros(y.shape, np.float32)
    g_pad[..., :W] = g
    dk1, db1, dk2, db2 = (np.asarray(t, np.float64) for t in vjp(jnp.asarray(g_pad, bf)))
    ref = {"dW2": dk2.transpose(3, 2, 0, 1), "db2": db2, "dW1": dk1.transpose(3, 2, 0, 1)}
    args = (_t(maps).to(torch.bfloat16), _oihw(k1), _t(b1), _oihw(k2), _t(g).to(torch.bfloat16))
    got = dict(zip(("dW2", "db2", "dW1", "db1"), ssm.ssm_embed_bwd_tc_plain(*args)))
    unrounded = ssm.ssm_embed_bwd_plain(*args)[2].double().numpy()
    for name, want in ref.items():
        err = float(np.abs(got[name].double().numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
    assert float(np.abs(unrounded - ref["dW1"]).max()) > 1e-4 * float(np.abs(ref["dW1"]).max())
    m, w2 = torch.from_numpy(maps).double(), _oihw(k2).double()
    pre = torch.nn.functional.conv2d(m, _oihw(k1).double(), _t(b1).double())
    d_pre = torch.nn.grad.conv2d_input(pre.shape, w2, _t(g).double()) * (pre > 0)
    limit = 2.0**-8 * d_pre.abs().sum(dim=(0, 2, 3)).numpy()
    assert bool((np.abs(got["db1"].double().numpy() - db1) <= limit * (1 + 1e-6)).all())


@pytest.fixture(scope="module")
def ssm_tree():
    return _jax_tree(CFG, gamma=0.5)


@pytest.fixture(scope="module")
def gen_inputs():
    return _z(1, 2, 3, 3, CFG), _train_maps(2, 2, CFG)


@pytest.fixture(scope="module")
def jax_forwards(ssm_tree, gen_inputs):
    """JAX's eval output, train output and updated batch statistics, by
    ``chw_tail``, each computed once."""
    z, maps = gen_inputs
    zj, mj = jnp.asarray(z), [jnp.asarray(m) for m in maps]
    cache = {}

    def get(tail):
        if tail not in cache:
            gen = JaxG(type_norm="SSM", padding_mode="local", chw_tail=tail, **CFG)
            y_eval, _ = jax.jit(lambda v, z, m: gen.apply(v, z, m, train=False))(ssm_tree, zj, mj)

            def fwd(v, z, m):
                (y, _), upd = gen.apply(v, z, m, train=True, mutable=["batch_stats"])
                return y, upd["batch_stats"]

            y_train, stats = jax.jit(fwd)(ssm_tree, zj, mj)
            cache[tail] = np.asarray(y_eval), np.asarray(y_train), _np(stats)
        return cache[tail]

    return get


def test_ssm_tree_loads_strictly_with_the_init_zero_pattern(ssm_tree):
    """The port's fresh SSM generator has the JAX tree's leaves and shapes
    (no final ``bn``); each embed weight is zero on input channels >= C as
    JAX's init is (values differ: PyTorch's draws)."""
    torch.manual_seed(0)
    fresh = ResidualPatchGenerator(type_norm="SSM", **CFG).state_dict()
    jax_init = _np(jax.jit(lambda z, m: JaxG(type_norm="SSM", padding_mode="local", **CFG).init(
        jax.random.key(3), z, m, train=True))(jnp.asarray(_z(0, 1, 3, 3, CFG)),
                                              [jnp.asarray(m) for m in _train_maps(0, 1, CFG)]))
    want = from_jax_variables({"params": jax_init["params"], "batch_stats": jax_init["batch_stats"]})
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert not any(k.startswith("bn.") for k in fresh)
    embeds = [k for k in fresh if k.endswith(".embed.weight")]
    assert len(embeds) == 14  # bn1, bn2 in five blocks, bn3 in the four that change width
    for k in embeds:
        c = fresh[k].shape[0] // 2
        assert torch.equal(fresh[k] == 0, want[k] == 0), k
        assert bool((fresh[k][:, min(c, 128):] == 0).all()) and bool((fresh[k][:, :c] != 0).any()), k
    _port(CFG, ssm_tree)  # strict


@pytest.mark.parametrize("jax_tail,port_tail", [("off", "off"), ("off", "auto"), ("on", "auto")])
def test_ssm_generator_eval_and_train_match_jax(ssm_tree, gen_inputs, jax_forwards, jax_tail,
                                                port_tail):
    """JAX's NHWC path ('off') and its channels-major Pallas tail ('on', in
    interpret mode) against the port's NHWC path and its own tail."""
    y_eval, y_train, stats = jax_forwards(jax_tail)
    z, maps = gen_inputs
    gen = _port(CFG, ssm_tree, chw_tail=port_tail).eval()
    kernels.reset_launches()
    with torch.no_grad():
        out, _ = gen(_t(z), [_t(m) for m in maps])
    np.testing.assert_allclose(out.numpy(), y_eval, atol=5e-5, rtol=1e-4)
    gen.train()
    out, _ = gen(_t(z), [_t(m) for m in maps])
    np.testing.assert_allclose(out.detach().numpy(), y_train, atol=5e-5, rtol=1e-4)
    want = from_jax_variables({"batch_stats": stats})
    got = gen.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    assert sum(kernels.LAUNCHES.values()) == 0


# --- the raster canvas ------------------------------------------------------

CANVAS_CFG = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=4, attention=True, img_ch=3, map_dim=2)


def _full_inputs(seed, cfg, out_h, out_w):
    P = 2 ** (cfg["n_layers_G"] - 1) * cfg["base_res"]
    _, _, th, tw = canvas_geometry(out_h, out_w, P, 3, 3)
    maps = _train_maps(seed + 1, 1, cfg, th, tw)
    return _z(seed, 1, th, tw, cfg), maps, th, tw


@pytest.fixture(scope="module")
def canvas_tree():
    return _jax_tree(CANVAS_CFG)  # attention gate at its init value 0


@pytest.mark.parametrize("out_h,out_w", [(96, 96), (96, 96 + 4 * 64), (96 + 4 * 64, 96),
                                         (96 + 2 * 64, 96 + 2 * 64)])
def test_ssm_raster_canvas_equals_one_pass(canvas_tree, out_h, out_w):
    """1x1, 1xN, Nx1 and NxM sub-image grids (tests/test_halo.py)."""
    gen = _port(CANVAS_CFG, canvas_tree).eval()
    z, maps, th, tw = _full_inputs(7, CANVAS_CFG, out_h, out_w)
    canvas = generate_canvas(gen, None, out_h, out_w, z_full=_t(z), maps_full=[_t(m) for m in maps])
    oracle = generate_one_pass(gen, _t(z), th, tw, maps_full=[_t(m) for m in maps])
    assert canvas.shape == (1, out_h, out_w, 3)
    np.testing.assert_allclose(canvas, oracle[:, :out_h, :out_w].numpy(), atol=2e-4, rtol=1e-4)


def test_ssm_raster_canvas_matches_jax():
    tree = _jax_tree(CANVAS_CFG, gamma=0.5)
    out_h, out_w = 96 + 64, 96 + 2 * 64
    z, maps, _, _ = _full_inputs(3, CANVAS_CFG, out_h, out_w)
    jgen = JaxG(type_norm="SSM", padding_mode="local", **CANVAS_CFG)
    ref = jax_generate_canvas(jgen, tree, jax.random.key(0), out_h, out_w, z_full=jnp.asarray(z),
                              maps_full=[jnp.asarray(m) for m in maps])
    gen = _port(CANVAS_CFG, tree).eval()
    got = generate_canvas(gen, None, out_h, out_w, z_full=_t(z), maps_full=[_t(m) for m in maps])
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    # without maps_full the engine draws its own: same seed, same canvas
    draw = [generate_canvas(gen, torch.Generator().manual_seed(5), 96, 96) for _ in range(2)]
    np.testing.assert_array_equal(draw[0], draw[1])


def test_ssm_latent_windows_match_jax():
    maps = _train_maps(5, 1, dict(base_res=4, n_layers_G=3, map_dim=2), 7, 9)
    z = _z(6, 1, 7, 9, dict(base_res=4, z_dim=3))
    for r, c in ((0, 0), (1, 2), (2, 3)):
        for a, b in zip(latents.slice_sub_maps([_t(m) for m in maps], r, c, 4, 3, 3),
                        jax_latents.slice_sub_maps([jnp.asarray(m) for m in maps], r, c, 4, 3, 3)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        zs, ms = latents.row_strips(_t(z), [_t(m) for m in maps], r, 4, 3)
        zj, mj = jax_latents.row_strips(jnp.asarray(z), [jnp.asarray(m) for m in maps], r, 4, 3)
        np.testing.assert_array_equal(zs.numpy(), np.asarray(zj))
        for a, b in zip(ms, mj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = torch.Generator().manual_seed(0)
    full = latents.build_maps_full(g, 2, 2, 3, 4, 3, 5, device="cpu")
    assert [tuple(m.shape) for m in full] == [(2, 16, 24, 2), (2, 28, 44, 2), (2, 52, 84, 2)]
    assert [tuple(m.shape) for m in latents.build_train_maps(g, 2, 1, 3, 4, 3, 3, device="cpu")] \
        == [(2, 16, 16, 1), (2, 28, 28, 1), (2, 52, 52, 1)]


# --- one training step, checkpoints, CLIs ----------------------------------

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "4", "--num_images", "2",
        "--random_crop", "48", "--sampling", "8", "--ema", "--spec_norm_D", "--smooth",
        "--type_norm_G", "SSM", "--map_dim", "2"]
LR = 2e-4
NOISE = 1e-6  # a gradient below this share of the model's largest is rounding noise


def _port_state(targs, init):
    """The port's train state on the CPU from JAX's initial variables."""
    st = create_train_state(targs, 2, "cpu", seed=0)
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]}), strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]}, spectral=True),
                         strict=True)
    return st


def _train_z_f32(key, num_images, z_dim, base_res, gh, gw):
    """JAX ``build_train_z`` drawing float32 normals, as it does without x64."""
    pad = jax_latents.Z_PAD
    return jax.random.normal(key, (num_images, gh * base_res + pad, gw * base_res + pad, z_dim), jnp.float32)


def _train_maps_f32(key, num_images, map_dim, n_layers_G, base_res, gh, gw):
    """JAX ``build_train_maps`` drawing float32 normals, as it does without x64."""
    pad, keys = jax_latents.MAP_PAD, jax.random.split(key, n_layers_G)
    return [jax.random.normal(keys[i], (num_images, gh * 2**i * base_res + pad,
                                        gw * 2**i * base_res + pad, map_dim), jnp.float32)
            for i in range(n_layers_G)]


def _jax_step64(jargs, state, tx_G, tx_D, real, key):
    """JAX ``make_train_step`` in float64 (x64, every block NHWC) from the
    float32 step's state, crops and key. Under x64 JAX would draw its
    latents in float64, so the step draws them in float32 as the float32
    step does."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_latents, "build_train_z", _train_z_f32)
        mp.setattr(jax_latents, "build_train_maps", _train_maps_f32)
        G = JaxG(**{**jax_g_kwargs(jargs), "dtype": jnp.float64, "chw_tail": "off"})
        D = JaxD(**{**jax_d_kwargs(jargs), "dtype": jnp.float64})

        def wide(a):  # new arrays throughout: the step donates its state
            return a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else jnp.array(a)

        step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                               num_images=2, use_ema=True)
        new, metrics = step(jax.tree_util.tree_map(wide, state), jnp.asarray(real, jnp.float64), key)
        zk, mk = jax.random.split(jax.random.split(key, 1)[0])
        drawn = [np.array(_train_z_f32(zk, 2, 16, 4, 3, 3))]
        drawn += [np.array(m) for m in _train_maps_f32(mk, 2, 2, 4, 4, 3, 3)]
        return _np(new), {k: float(v) for k, v in metrics.items()}, drawn


@pytest.fixture(scope="module")
def step_case():
    """One SSM step of JAX ``make_train_step`` (channels-major tail in
    interpret mode, so the fake reaches D through the stem and every tail
    SSM site through K15), of JAX's step in float64, and of the port, from
    the same state, crops, latents and maps."""
    jargs = jax_parser().parse_args(TINY)
    jargs.chw_tail = "on"
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    assert G.emits_chw() and G.type_norm == "SSM"
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    init = _np({"params_G": state.params_G, "aux_G": state.aux_G, "params_D": state.params_D,
                "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    real = np.clip(np.random.default_rng(0).standard_normal((4, 48, 48, 3)), -1, 1).astype(np.float32)
    key = jax.random.key(1)
    new64, metrics64, drawn = _jax_step64(jargs, state, tx_G, tx_D, real, key)
    new, metrics = step(state, jnp.asarray(real), key)
    # the step's own latents: keys = split(key, disc_iters); zk, mk = split(keys[0])
    zk, mk = jax.random.split(jax.random.split(key, 1)[0])
    z = np.array(jax_latents.build_train_z(zk, 2, 16, 4, 3, 3))
    maps = [np.array(m) for m in jax_latents.build_train_maps(mk, 2, 2, 4, 4, 3, 3)]
    for a, b in zip(drawn, [z, *maps]):
        np.testing.assert_array_equal(a, b)  # the float64 step's latents are the float32 step's

    targs = prepare_parser().parse_args(TINY + ["--device", "cpu"])
    st = _port_state(targs, init)
    st.ema = from_jax_variables(init["ema"])
    m = train_step(st, _t(real), _t(z), [_t(a) for a in maps], smooth=True, use_ema=True)
    return dict(jargs=jargs, targs=targs, new=new, metrics=metrics, st=st, m=m, G=G, D=D,
                metrics64=metrics64,
                g64={k: v.float() for k, v in from_jax_variables({"params": new64.opt_G[0].mu}).items()},
                after64={k: v.float() for k, v in from_jax_variables(
                    {"params": new64.params_G, **new64.aux_G}).items()})


def _jax_grads(case, model):
    opt = case["new"].opt_G if model == "G" else case["new"].opt_D
    return from_jax_variables({"params": _np(opt[0].mu)})  # beta1 = 0: Adam's mu is the gradient


def _noise(grads):
    top = max(float(v.abs().max()) for v in grads.values())
    return top, {k for k, v in grads.items() if float(v.abs().max()) < NOISE * top}


def test_ssm_step_losses_match(step_case):
    for k, v in step_case["metrics"].items():
        np.testing.assert_allclose(float(step_case["m"][k]), float(v), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(step_case["m"][k]), step_case["metrics64"][k], rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["G", "D"])
def test_ssm_step_gradients_and_state_match(step_case, model):
    """Gradients to 1e-4 of each leaf's largest reference value (a
    rounding-noise leaf to 1e-4 of the model's largest gradient); new
    parameters to rtol 5e-3, atol 5e-5 (a noise leaf to 2·lr); BN
    statistics and SN vectors to rtol 1e-5 of JAX's. The reference for D's
    gradients and parameters is JAX's float32 step; for G's gradients and
    parameters, JAX's float64 step. JAX's own float32 step sits up to 5e-3
    of a leaf's largest value from that on the leaves upstream of block 2's
    first SSM norm (the port's float32 step 2e-6), so G is held to JAX's
    float32 gradients per leaf at 2e-3 norm-relative."""
    new, st = step_case["new"], step_case["st"]
    module = st.G if model == "G" else st.D
    got = {n: p.grad for n, p in module.named_parameters()}
    jax_g = _jax_grads(step_case, model)
    want = step_case["g64"] if model == "G" else jax_g
    assert set(got) == set(want) == set(jax_g)
    top, noise = _noise(want)
    for name, ref in want.items():
        scale = top if name in noise else float(ref.abs().max())
        err = float((got[name] - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
        if model == "G" and name not in noise:
            assert float((got[name] - jax_g[name]).norm()) <= 2e-3 * float(jax_g[name].norm()), name
    if model == "G":
        after = from_jax_variables({"params": _np(new.params_G), **_np(new.aux_G)})
    else:
        after = from_jax_variables({"params": _np(new.params_D), **_np(new.aux_D)}, spectral=True)
    state = module.state_dict()
    assert set(state) == set(after)
    for name, ref in after.items():
        g = state[name].numpy()
        if name.rsplit(".", 1)[-1] in ("mean", "var", "u", "v"):
            np.testing.assert_allclose(g, ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
            continue
        if model == "G":
            ref = step_case["after64"][name]
        if name in noise:
            assert np.abs(g - ref.numpy()).max() <= 2 * LR, name
        else:
            np.testing.assert_allclose(g, ref.numpy(), rtol=5e-3, atol=5e-5, err_msg=name)


def _jax_payload(state, jargs):
    return {
        "meta": {"epoch": 1, "args": dict(vars(jargs)), "seed": 0, "Gloss": [0.5], "Dloss": [1.0]},
        "netG_variables": {"params": state.params_G, **state.aux_G},
        "netD_variables": {"params": state.params_D, **state.aux_D},
        "opt_G": state.opt_G, "opt_D": state.opt_D, "ema": state.ema,
    }


def test_ssm_checkpoint_round_trip(step_case, tmp_path):
    """The port's SSM .ckpt has the reference's tree and loads in JAX
    ``load_checkpoint``; the reference's loads in the port's sampling
    loader (strictly, EMA too)."""
    st, new = step_case["st"], step_case["new"]
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, train_loop.checkpoint_payload(st, step_case["targs"], 1, 0, [0.5], [1.0]))
    got = jax_ckpt.load_checkpoint(path)
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jpath, _jax_payload(new, step_case["jargs"]))
    ref = jax_ckpt.load_checkpoint(jpath)
    body = lambda t: {k: v for k, v in t.items() if k != "meta"}
    shape = lambda t: jax.tree_util.tree_map(lambda a: (np.shape(a), np.asarray(a).dtype.name), body(t))
    assert shape(got) == shape(ref)
    assert got["meta"]["args"]["type_norm_G"] == "SSM" and got["meta"]["args"]["map_dim"] == 2
    for k, v in from_jax_variables(got["netG_variables"]).items():
        torch.testing.assert_close(v, st.G.state_dict()[k], rtol=0, atol=0)
    gen, args = port_ckpt.load_generator_from_checkpoint(jpath, device="cpu")
    assert gen.type_norm == "SSM" and gen.map_dim == 2 and gen.bn is None
    np.testing.assert_array_equal(
        gen.block4.bn1.embed.weight.detach().numpy(),
        np.transpose(np.asarray(new.params_G["block4"]["bn1"]["embed"]["kernel"]), (3, 2, 0, 1)))
    ema_gen, _ = port_ckpt.load_generator_from_checkpoint(jpath, ema=True, device="cpu")
    np.testing.assert_array_equal(ema_gen.block4.bn2.bn.mean.numpy(),
                                  np.asarray(new.ema["batch_stats"]["block4"]["bn2"]["bn"]["mean"]))


def test_ssm_train_cli_writes_checkpoint_that_samples(tmp_path):
    """Two SSM steps of the train CLI at tiny width on the CPU; the sample
    CLI draws the maps and renders from the EMA checkpoint."""
    from PIL import Image

    from infinite_texture_gans_torch import sample

    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(tmp_path / "tex.png")
    out = tmp_path / "run"
    train_loop.main(TINY + ["--data_path", str(tmp_path / "tex.png"), "--data_ext", "png",
                            "--device", "cpu", "--seed", "3", "--epochs", "1", "--saving_rate", "1",
                            "--fname", str(out)])
    # the loss plot where matplotlib is installed, as the reference writes it
    plot = ["1_losses.png"] if importlib.util.find_spec("matplotlib") else []
    assert sorted(os.listdir(out)) == ["1_1.ckpt", "1__ema.ckpt"] + plot
    sample.main(["--model_path", str(out / "1__ema.ckpt"), "--output_resolution_height", "80",
                 "--output_resolution_width", "72", "--output_name", "c.png", "--device", "cpu"])
    img = np.asarray(Image.open(out / "c.png"))
    assert img.shape == (80, 72, 3) and img.std() > 0
