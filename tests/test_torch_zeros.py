"""The zeros-padding generator (the reference parsers' default
``--padding_mode``), its training step, the tiled engine and both CLIs,
against the JAX reference on the CPU in float32 at the reference tests'
tiny widths. The path runs NHWC throughout, as the reference's channels-
major gate needs local padding: it launches none of the port's kernels.
Weights cross through ``weights.from_jax_variables``; latents and crops are
numpy arrays drawn from a seed."""

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
from infinite_texture_gans_tpu.sampling.tiled import tile_process as jax_tile_process
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.config import check_train_args, prepare_parser
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels, ssm
from infinite_texture_gans_torch.sampling.tiled import sample_from_gen, tile_process
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.train_step import create_train_state, train_step
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_step_check import assert_step_matches, np_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

# the tolerance of the reference's test_generator_zeros_mode_parity: f32
# sums in another order
ATOL, RTOL = 2e-5, 1e-4
TINY_G = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=4, attention=True, img_ch=3)
# tests/test_train.py tiny_args with the parsers' default padding (no --padding_mode)
TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--attention", "--batch_size", "4", "--num_images", "2", "--random_crop", "48",
        "--ema", "--spec_norm_D", "--smooth"]
LR = 2e-4


def _launches():
    return (sum(kernels.LAUNCHES.values()) + sum(kernels.ROUTE_LAUNCHES.values())
            + sum(ssm.ROUTE_LAUNCHES.values()))


def _maps(rng, n, h, w, layers, md=2):
    return [rng.standard_normal((n, h * 2**i, w * 2**i, md)).astype(np.float32)
            for i in range(layers)]


@pytest.fixture(scope="module", params=["BN", "SSM"])
def g_case(request):
    """A JAX zeros-mode generator's variables (running statistics away from
    their init, the attention gate on) and the port generator carrying
    them."""
    norm = request.param
    kw = dict(type_norm=norm, map_dim=2, padding_mode="zeros", **TINY_G)
    gen = JaxG(**kw)
    rng = np.random.default_rng(3)
    maps0 = [jnp.asarray(m) for m in _maps(rng, 1, 4, 4, 4)] if norm == "SSM" else None
    v = jax.jit(lambda z, m: gen.init(jax.random.key(0), z, m, train=True))(
        jnp.zeros((1, 4, 4, 16)), maps0)
    v = jax.tree_util.tree_map(np.array, {"params": v["params"], "batch_stats": v["batch_stats"]})
    for bn in jax.tree_util.tree_leaves(v["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    v["params"]["attention"]["attn"]["gamma"] = np.float32(0.3)
    port = ResidualPatchGenerator(**kw)
    port.load_state_dict(from_jax_variables(v), strict=True)
    assert not port.emits_chw() and not any(port.chw_gate(i, 8) for i in range(4, 7))
    return norm, gen, v, port, rng


def test_generator_eval_matches_jax(g_case):
    """Eval on a latent larger than base_res (as the sample CLI draws it):
    the claim of the reference's ``test_generator_zeros_mode_parity``, for
    BN and SSM; no kernel launches."""
    norm, gen, v, port, rng = g_case
    z = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    maps = _maps(rng, 2, 8, 6, 4) if norm == "SSM" else None
    ref, _ = jax.jit(lambda v, z, m: gen.apply(v, z, m, train=False))(
        v, jnp.asarray(z), None if maps is None else [jnp.asarray(m) for m in maps])
    kernels.reset_launches()
    with torch.no_grad():
        out, halo = port.eval()(torch.from_numpy(z),
                                None if maps is None else [torch.from_numpy(m) for m in maps])
    assert halo is None and out.shape == ref.shape == (2, 64, 48, 3) and _launches() == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="local"):  # no halo engine in zeros mode
        port(torch.from_numpy(z), None if maps is None else [torch.from_numpy(m) for m in maps],
             halo={})


def test_generator_train_forward_matches_jax(g_case):
    """Train mode (batch statistics): the image and the updated running
    statistics, for BN and SSM. The inputs are the test's own draw, so they
    do not depend on which tests of the module ran before it."""
    norm, gen, v, port, _ = g_case
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    maps = _maps(rng, 2, 4, 4, 4) if norm == "SSM" else None
    (img, _), new = gen.apply(v, jnp.asarray(z),
                              None if maps is None else [jnp.asarray(m) for m in maps],
                              train=True, mutable=["batch_stats"])
    port.load_state_dict(from_jax_variables(v), strict=True)
    kernels.reset_launches()
    out, _ = port.train()(torch.from_numpy(z),
                          None if maps is None else [torch.from_numpy(m) for m in maps])
    assert out.shape == img.shape == (2, 32, 32, 3) and _launches() == 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(img), atol=1e-4, rtol=0)
    state = port.state_dict()
    for k, ref in from_jax_variables({"batch_stats": np_tree(new)["batch_stats"]}).items():
        np.testing.assert_allclose(state[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    port.load_state_dict(from_jax_variables(v), strict=True)


@pytest.mark.parametrize("norm", ["BN", "SSM"])
def test_zeros_step_matches_jax(norm):
    """One fused zeros-mode step against the reference's ``make_train_step``
    (the fake reaches D as NHWC on both sides), held as
    ``tests/test_torch_train_step.py`` holds the local-padding step."""
    flags = TINY + ["--type_norm_G", norm, "--map_dim", "2"]
    jargs = jax_parser().parse_args(flags)
    assert jargs.padding_mode == "zeros"
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    init = np_tree({"params_G": state.params_G, "aux_G": state.aux_G, "params_D": state.params_D,
                    "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    real = np.clip(np.random.default_rng(0).standard_normal((4, 48, 48, 3)), -1, 1).astype(np.float32)
    key = jax.random.key(1)
    new, metrics = step(state, jnp.asarray(real), key)
    # the step's own draws (train_step.py:256-275): zk, mk = split(split(key, 1)[0])
    zk, mk = jax.random.split(jax.random.split(key, 1)[0])
    z = np.array(jax.random.normal(zk, (2, 4, 4, 16)))
    maps = None
    if norm == "SSM":
        keys = jax.random.split(mk, 4)
        maps = [torch.from_numpy(np.array(jax.random.normal(keys[i], (2, 4 * 2**i, 4 * 2**i, 2))))
                for i in range(4)]

    targs = prepare_parser().parse_args(flags + ["--device", "cpu"])
    check_train_args(targs)
    st = create_train_state(targs, 2, "cpu", seed=0)
    assert st.G.padding_mode == "zeros" and not st.G.emits_chw()
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]}),
                         strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]},
                                            spectral=True), strict=True)
    st.ema = from_jax_variables(init["ema"])
    before = {k: v.clone() for k, v in st.G.state_dict().items()}
    kernels.reset_launches()
    m = train_step(st, torch.from_numpy(real), torch.from_numpy(z), maps, smooth=True,
                   use_ema=True)
    assert _launches() == 0
    assert_step_matches(new, metrics, st, m, before, noise_move=2 * LR)


@pytest.fixture(scope="module")
def tiled_case():
    """The reference tiled test's generator (tests/test_tiled.py: z_dim 8,
    G_ch 8, base 8, 4 layers, BN, zeros) with its JAX init, on both sides."""
    kw = dict(z_dim=8, G_ch=8, base_res=8, n_layers_G=4, attention=False, img_ch=3,
              type_norm="BN", padding_mode="zeros")
    gen = JaxG(**kw)
    v = jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(jnp.zeros((1, 8, 8, 8)))
    v = np_tree({"params": v["params"], "batch_stats": v["batch_stats"]})
    port = ResidualPatchGenerator(**kw)
    port.load_state_dict(from_jax_variables(v), strict=True)
    return gen, v, port.eval()


def test_sample_from_gen_zeros_mode(tiled_case):
    """Shape, finite values, |x| <= 1 (tests/test_tiled.py:23); with
    ``tiles``, the tiled image of the same draws."""
    _, _, port = tiled_case
    out = sample_from_gen(port, torch.Generator().manual_seed(1), num_images=2, base_res=8)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0
    tiled = sample_from_gen(port, torch.Generator().manual_seed(1), num_images=2, base_res=8,
                            tiles=True)
    torch.testing.assert_close(tiled, out, rtol=0, atol=0)  # one tile: the latent is 8 wide
    with pytest.raises(ValueError, match="zeros"):
        sample_from_gen(ResidualPatchGenerator(**TINY_G))


def test_tile_process_matches_jax_and_single_pass(tiled_case):
    """The port's ``tile_process`` equals the reference's on the same latent,
    and the first tile's interior equals the one pass (tests/test_tiled.py:32,
    its tolerance)."""
    gen, v, port = tiled_case
    z = np.random.default_rng(2).standard_normal((1, 64, 64, 8)).astype(np.float32)
    ref = np.asarray(jax_tile_process(gen, v, jnp.asarray(z), scale=8, tile_size=32, tile_pad=16))
    kernels.reset_launches()
    tiled = tile_process(port, torch.from_numpy(z), scale=8, tile_size=32, tile_pad=16)
    assert tiled.shape == ref.shape == (1, 512, 512, 3) and _launches() == 0
    np.testing.assert_allclose(tiled.numpy(), ref, atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        full, _ = port(torch.from_numpy(z))
    np.testing.assert_allclose(full[:, :128, :128].numpy(), tiled[:, :128, :128].numpy(),
                               atol=1e-4, rtol=1e-4)


def test_ssm_tiles_take_their_maps():
    """An SSM zeros generator's tiles crop the maps with the latent at each
    layer's scale: the first tile's interior equals the one pass."""
    port = ResidualPatchGenerator(z_dim=8, G_ch=8, base_res=8, n_layers_G=4, attention=False,
                                  type_norm="SSM", map_dim=1, padding_mode="zeros").eval()
    g = torch.Generator().manual_seed(4)
    z = torch.randn(1, 48, 40, 8, generator=g)
    maps = [torch.randn(1, 48 * 2**i, 40 * 2**i, 1, generator=g) for i in range(4)]
    tiled = tile_process(port, z, maps, scale=8, tile_size=32, tile_pad=16)
    with torch.no_grad():
        full, _ = port(z, maps)
    assert tiled.shape == full.shape == (1, 384, 320, 3)
    torch.testing.assert_close(tiled[:, :128, :128], full[:, :128, :128], atol=1e-4, rtol=1e-4)
    # maps cropped at the wrong scale (every layer at the latent's) break it
    wrong = [m[:, : 48, : 40] for m in maps]
    with pytest.raises(RuntimeError):
        tile_process(port, z, wrong, scale=8, tile_size=32, tile_pad=16)


def test_cli_trains_and_samples_the_default_padding(tmp_path, capsys):
    """The train CLI with no ``--padding_mode`` (the reference's default,
    zeros) trains one epoch and writes its checkpoints; the sample CLI
    renders the EMA checkpoint as one pass (height / 2^(n_layers_G-1)
    latent squared, as the reference draws it) and with ``--tiles``;
    ``--stream`` warns and renders in memory."""
    from PIL import Image

    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(tmp_path / "tex.png")
    out = tmp_path / "run"
    train_loop.main(TINY + ["--data_path", str(tmp_path / "tex.png"), "--data_ext", "png",
                            "--device", "cpu", "--seed", "3", "--epochs", "1", "--sampling", "8",
                            "--saving_rate", "1", "--fname", str(out)])
    ck = checkpoint.load_checkpoint(str(out / "1_1.ckpt"))
    assert ck["meta"]["args"]["padding_mode"] == "zeros" and int(ck["opt_G"]["0"]["count"]) == 2
    ema = str(out / "1__ema.ckpt")
    common = ["--model_path", ema, "--device", "cpu", "--output_resolution_width", "99",
              "--seed", "2"]
    sample.main(common + ["--output_resolution_height", "64", "--output_name", "one.png"])
    sample.main(common + ["--output_resolution_height", "320", "--output_name", "tiled.png",
                          "--tiles"])
    capsys.readouterr()
    sample.main(common + ["--output_resolution_height", "64", "--output_name", "s.png",
                          "--stream"])
    assert "--stream requires a local-padding checkpoint" in capsys.readouterr().out
    one = np.asarray(Image.open(out / "one.png"))
    tiled = np.asarray(Image.open(out / "tiled.png"))
    assert one.shape == (64, 64, 3) and tiled.shape == (320, 320, 3)
    assert one.std() > 0 and tiled.std() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(out / "s.png")), one)
    gen, _ = checkpoint.load_generator_from_checkpoint(ema, device="cpu")
    want = sample_from_gen(gen, torch.Generator().manual_seed(2), base_res=320 // 8, tiles=True)
    from infinite_texture_gans_torch.sampling.infinite import _to_uint8

    np.testing.assert_array_equal(tiled, _to_uint8(want)[0].numpy())
    assert sorted(os.listdir(out))[:2] == ["1_1.ckpt", "1__ema.ckpt"]
