"""The port's ``parallel/`` on the CPU: gloo ranks started by
``parallel.mesh.run_ranks`` (one process each, one intra-op thread, a
``file://`` rendezvous under the test's ``tmp_path``, every join bounded by
JOIN_S seconds), held to the JAX package's single-device functions, which
its mesh equals (PARITY.md; JAX's 8-device CPU mesh is not built here).

The claims of the reference's ``tests/test_parallel.py`` and
``tests/test_train.py``:

- ``make_mesh``'s parsing and errors, the batch slice, the schedule
  constants (shared with ``sampling/diag.py``), the wavefront's refusals;
- the data-parallel step on 2 ranks (``num_images`` 8, ``batch_size`` 8,
  EMA, ``--smooth``, the fused channels-major ``auto`` tail) against
  JAX's ``make_train_step`` on the global batch through
  ``tests/_torch_step_check.py``'s measures, with G's BatchNorms and with
  D's (``--norm_layer_D batch``); both ranks' parameters bit-equal; the
  statistics' all-reduce removed must fail the comparison;
- ``train(args)`` over 2 ranks (``--mesh data:2``, and ``--num_gpus 2
  --gpu_list 0 1`` with a rotating multi-image window): the checkpoint's
  losses equal the 1-rank run's to 1e-5 relative (only the sums' order
  differs);
- the wavefront canvas (BN in both of its schedule's regimes, SSM, the
  channels-major tail, ``--fuse_up all``) bit-equal to the port's raster on
  the same latents and within 5e-5 / 1e-4 of JAX's; the slab-streamed PNG
  (BN, SSM) byte-equal to the port's single-device stream; ``sample --mesh
  data:2`` byte-equal to the single-device CLI;
- the width-sharded one pass and the image-sharded canvas equal to the
  single-device ones within 1e-5.

The port's raster is taken with one intra-op thread, as the ranks run it:
PyTorch's CPU convolutions may sum in another order with more threads.
"""

import contextlib
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
from infinite_texture_gans_tpu.parallel.wavefront import schedule_constants as jax_schedule
from infinite_texture_gans_tpu.sampling.infinite import generate_canvas as jax_generate_canvas
from infinite_texture_gans_tpu.sampling.latents import build_maps_full as jax_maps_full
from infinite_texture_gans_tpu.sampling import latents as jax_latents
from infinite_texture_gans_tpu.sampling.latents import build_train_z
from infinite_texture_gans_tpu.sampling.latents import build_z_full as jax_z_full
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.parallel import (
    generate_canvas_wavefront,
    generate_canvas_wavefront_streamed,
    make_mesh,
    schedule_constants,
    shard_batch,
)
from infinite_texture_gans_torch.parallel.mesh import DataAxis, Mesh, run_ranks
from infinite_texture_gans_torch.sampling import diag
from infinite_texture_gans_torch.sampling.infinite import generate_canvas, generate_one_pass
from infinite_texture_gans_torch.sampling.stream import generate_canvas_streamed, read_png
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.train_loop import train
from infinite_texture_gans_torch.train.train_step import check_data_parallel, create_train_state
import _torch_parallel_ranks as R
from _torch_step_check import assert_step_matches, np_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

JOIN_S = 120  # every rank's join: a hung rank fails its test
LR = 2e-4
TOL = dict(rtol=1e-5, atol=0)  # the sums' order alone differs from one device
JAX_CANVAS = dict(atol=5e-5, rtol=1e-4)  # tests/test_parallel.py's wavefront tolerance
STEP_FLAGS = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D",
              "2", "--padding_mode", "local", "--attention", "--batch_size", "8",
              "--num_images", "8", "--random_crop", "48", "--sampling", "8", "--ema", "--smooth",
              "--chw_tail", "on", "--fuse_up", "auto"]


def ranks(tmp_path, fn, *args, n=2):
    """``fn(*args)`` on ``n`` gloo ranks; their results in rank order."""
    return run_ranks(fn, make_mesh(f"data:{n}", device="cpu"), args, timeout=JOIN_S, threads=1,
                     tmpdir=str(tmp_path))


def bounded(tmp_path):
    """``run_ranks`` as the CLIs call it, with the tests' join bound, one
    thread a rank and the rendezvous under ``tmp_path``."""
    return lambda fn, mesh, args=(): run_ranks(fn, mesh, args, timeout=JOIN_S, threads=1,
                                               tmpdir=str(tmp_path))


@contextlib.contextmanager
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# --- the data axis, without ranks -----------------------------------------

MESH_CASES = {
    "spec": (dict(spec="data:2", device="cpu"), Mesh(2, ("cpu", "cpu"), "gloo")),
    "num_gpus": (dict(num_devices=3, device="cpu"), Mesh(3, ("cpu",) * 3, "gloo")),
    "gpu_list": (dict(num_devices=2, device_list=[1, 0], device="cpu"),
                 Mesh(2, ("cpu", "cpu"), "gloo")),
    "one_device": (dict(spec="data:1", device="cpu"), None),
    "default": (dict(num_devices=1, device_list=[0, 1], device="cpu"), None),
    "axis": (dict(spec="model:2", device="cpu"), "unsupported mesh axis 'model'"),
    "range": (dict(num_devices=2, device_list=[0, 10**6], device="cpu"), "out of range"),
    "duplicates": (dict(num_devices=2, device_list=[1, 1], device="cpu"), "duplicates"),
    "short": (dict(num_devices=3, device_list=[0, 1], device="cpu"), "has 2 entries"),
    "cards": (dict(spec=f"data:{torch.cuda.device_count() + 2}", device="cuda"),
              f"only {torch.cuda.device_count()} available"),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_make_mesh_parses_and_refuses(case):
    """``make_mesh``: ``data:N``, ``--num_gpus`` and ``--gpu_list`` as the
    reference parses them (tests/test_parallel.py:44), None for one device,
    and its errors, message by message."""
    kw, want = MESH_CASES[case]
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            make_mesh(**kw)
    else:
        assert make_mesh(**kw) == want
    assert make_mesh("data:", device="cpu").size == os.cpu_count()


def test_shard_batch_layout():
    """Each rank's slice of a global batch, in rank order, covers it once
    (tests/test_parallel.py:162); a batch the ranks do not split is
    refused, and outside a rank the batch is the rank's own."""
    x = torch.arange(16 * 2).reshape(16, 2)
    parts = [shard_batch(x, DataAxis(None, r, 4, torch.device("cpu"))) for r in range(4)]
    assert all(p.shape == (4, 2) for p in parts)
    assert torch.equal(torch.cat(parts), x)
    assert shard_batch(x) is x
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:6], DataAxis(None, 0, 4, torch.device("cpu")))


@pytest.mark.parametrize("steps", [(4, 3, 8), (4, 10, 8), (30, 30, 8), (5, 4, 1), (6, 6, 2)])
def test_schedule_constants_match_jax(steps):
    """The v3 cyclic schedule's constants equal JAX's, and the batched-
    diagonal engine uses this module's copy (tests/test_parallel.py:383)."""
    assert schedule_constants(*steps) == jax_schedule(*steps)
    assert diag.schedule_constants is schedule_constants
    w, h, n = steps
    _, T, _ = schedule_constants(w, h, n)
    if w <= 2 * n:  # short rows: the ideal wavefront
        assert T == 2 * ((h - 1) % n) + ((h - 1) // n) * 2 * n + w
    else:  # wide rows: one ramp, then every rank busy
        assert T == ((h - 1) // n) * w + 2 * ((h - 1) % n) + w


def _tiny_variables(kw=None):
    """The reference tests' tiny generator and its initial variables
    (numpy), the BN running statistics moved off their init."""
    kw = {**R.TINY_G, "type_norm": "BN", **(kw or {})}
    gen = JaxG(**kw)
    maps0 = None
    if kw["type_norm"] == "SSM":
        maps0 = jax_maps_full(jax.random.key(1), 1, kw["map_dim"], 4, 4, 3, 3)
    v = jax.jit(lambda z, m: gen.init(jax.random.key(0), z, m, train=True))(
        jnp.zeros((1, 14, 14, 8)), maps0)
    v = np_tree({k: v[k] for k in ("params", "batch_stats")})
    rng = np.random.default_rng(4)
    for bn in jax.tree_util.tree_leaves(v["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    return gen, v


def test_wavefront_refuses_narrow_grid_and_oversized_canvas():
    """Fewer than 3 patch columns race the lag-2 row buffer; a canvas whose
    per-rank buffer would pass 6 GiB is refused before any latent is
    drawn (tests/test_parallel.py:170, :407), on either engine."""
    _, v = _tiny_variables()
    axis = DataAxis(None, 0, 2, torch.device("cpu"))
    narrow = R.tiny_gen(v)
    narrow.num_patches_w = 2
    with pytest.raises(ValueError, match="num_patches_w"):
        generate_canvas_wavefront(narrow, None, 128, 128, axis=axis)
    with pytest.raises(ValueError, match="num_patches_w"):
        generate_canvas_wavefront_streamed(narrow, None, 128, 128, "unused.png", axis=axis)
    P = narrow.patch_resolution
    with pytest.raises(ValueError, match="GiB"):
        generate_canvas_wavefront(R.tiny_gen(v), None, 4000 * P, 4000 * P, axis=axis)


@pytest.mark.parametrize("flags, match", [
    (["--batch_size", "6"], "--batch_size 6"),
    (["--loss", "wgan", "--gp_weight", "10", "--num_images", "4"], "--gp_weight"),
])
def test_data_parallel_refuses_unsplittable_flags(flags, match, tmp_path):
    """A step that cannot be split so that it equals the global one is
    refused, naming the flag, before any rank starts."""
    args = prepare_parser().parse_args(STEP_FLAGS + flags + ["--device", "cpu", "--mesh",
                                                             "data:4", "--fname",
                                                             str(tmp_path)])
    with pytest.raises(ValueError, match=match):
        check_data_parallel(args, 4)
    with pytest.raises(ValueError, match=match):
        train(args)


# --- the data-parallel step -----------------------------------------------

STEP_KW = dict(loss_type="standard", smooth=True, disc_iters=1, num_images=8, use_ema=True)


def _jax_step(flags):
    """JAX's single-device step on the global batch: (new state, metrics,
    init numpy tree, real, z, its float64 step as a callable)."""
    jargs = jax_parser().parse_args(STEP_FLAGS + flags)
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    assert G.fuse_up == "auto" and G.emits_chw()
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    init = np_tree({"params_G": state.params_G, "aux_G": state.aux_G,
                    "params_D": state.params_D, "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, D, tx_G, tx_D, **STEP_KW)
    real = np.clip(np.random.default_rng(3).standard_normal((8, 48, 48, 3)), -1, 1)
    real = real.astype(np.float32)
    key = jax.random.key(7)
    new, metrics = step(state, jnp.asarray(real), key)
    zk, _ = jax.random.split(jax.random.split(key, 1)[0])
    z = np.array(build_train_z(zk, 8, 16, 4, 3, 3))

    def step64():
        """The same step in float64 (every block NHWC) from the same
        initial state, crops and latents (drawn in float32, then widened:
        tests/test_torch_train_options.py's ``jax_step64``)."""
        state64, _, _ = jax_create(G, D, jargs, jax.random.key(0), 2)
        z32 = jax_latents.build_train_z
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_latents, "build_train_z", lambda *a: z32(*a).astype(jnp.float32))
            G64 = JaxG(**{**jax_g_kwargs(jargs), "dtype": jnp.float64, "chw_tail": "off"})
            D64 = JaxD(**{**jax_d_kwargs(jargs), "dtype": jnp.float64})

            def wide(a):
                return (a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                        else jnp.array(a))

            out, _ = make_train_step(G64, D64, tx_G, tx_D, **STEP_KW)(
                jax.tree_util.tree_map(wide, state64), jnp.asarray(real, jnp.float64), key)
            return np_tree(out)

    return new, metrics, init, real, z, step64


def _port_state(flags, rank_out):
    """A port train state holding one rank's results, for
    ``assert_step_matches``."""
    st = create_train_state(prepare_parser().parse_args(STEP_FLAGS + flags + ["--device", "cpu"]),
                            2, "cpu")
    st.G.load_state_dict(rank_out["G"], strict=True)
    st.D.load_state_dict(rank_out["D"], strict=True)
    st.ema = rank_out["ema"]
    for model, mod in (("G", st.G), ("D", st.D)):
        for n, p in mod.named_parameters():
            p.grad = rank_out["grads"][f"{model}.{n}"]
    return st


@pytest.mark.parametrize("norm", ["G", "D"])
def test_mesh_step_matches_jax_single_device(norm, tmp_path):
    """One step on 2 ranks against JAX's single-device step on the global
    batch (tests/test_parallel.py:214): the losses, every gradient leaf,
    the new parameters, BN running statistics and the EMA, within
    ``_torch_step_check``'s tolerances (a gradient leaf outside its limit
    held to JAX's float64 step: D's biases before its train-mode
    BatchNorms, whose gradient is 0 in exact arithmetic). ``G``: G's BatchNorms
    over the sharded fakes; ``D``: D's too (``--norm_layer_D batch``; the
    G pass on JAX's updated D, as ``tests/test_torch_train_options.py``
    takes it, with its rounding-decided elements held as noise). Both
    ranks' states and gradients are bit-equal. ``G`` also runs the step
    with the statistics' all-reduce removed, which must fail the
    comparison."""
    flags = ["--norm_layer_D", "batch"] if norm == "D" else []
    new, metrics, init, real, z, step64 = _jax_step(flags)
    d_after = None
    if norm == "D":
        from infinite_texture_gans_torch.weights import from_jax_variables

        d_after = {k: v.numpy() for k, v in
                   from_jax_variables({"params": np_tree(new.params_D)}).items()}
    out = ranks(tmp_path, R.mesh_step, STEP_FLAGS + flags, init, real, z, d_after)
    for key in ("G", "D", "ema", "grads"):
        for name, v in out[0][key].items():
            assert torch.equal(v, out[1][key][name]), (key, name)
    assert out[0]["m"] == out[1]["m"]
    st = _port_state(flags, out[0])
    kw = dict(element_noise=True, d_params=out[0]["d_params"]) if norm == "D" else {}
    assert_step_matches(new, metrics, st, out[0]["m"], out[0]["before"], noise_move=2 * LR,
                        exact=step64, **kw)
    if norm == "G":
        planted = ranks(tmp_path, R.mesh_step, STEP_FLAGS, init, real, z, None, True)[0]
        with pytest.raises(AssertionError):
            assert_step_matches(new, metrics, _port_state(flags, planted), planted["m"],
                                planted["before"], noise_move=2 * LR)


# --- the train CLI over ranks -------------------------------------------

def _texture(tmp_path):
    from PIL import Image

    path = str(tmp_path / "tex.png")
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(path)
    return path


def _images(tmp_path, n=4, size=56):
    from PIL import Image

    d = tmp_path / "imgs"
    os.makedirs(d)
    rng = np.random.default_rng(6)
    for i in range(n):
        Image.fromarray(rng.integers(1, 256, (size, size, 3), dtype=np.uint8)).save(
            d / f"t{i}.png")
    return str(d)


TRAIN_FLAGS = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4",
               "--n_layers_D", "2", "--padding_mode", "local", "--attention", "--batch_size",
               "4", "--num_images", "2", "--random_crop", "48", "--sampling", "8", "--ema",
               "--smooth", "--spec_norm_D", "--epochs", "2", "--saving_rate", "2", "--seed", "5",
               "--steps_per_dispatch", "2", "--device", "cpu"]
# a cap of 2 of the 4 56^2 images: the rotating window (tests/test_torch_multi_data.py)
ROTATING_MB = 56 * 56 * 3 * 2.5 / 2**20


@pytest.mark.parametrize("how", ["mesh_single_image", "num_gpus_rotating"])
def test_train_cli_over_ranks_matches_one_rank(how, tmp_path):
    """``train(args)`` over 2 ranks (tests/test_train.py:331, :1078):
    ``--mesh data:2`` on one image through the train CLI's own ranks, and
    ``--num_gpus 2 --gpu_list 0 1`` on a directory whose rotating window
    (2 of 4 images) is swapped before every chunk, in ranks started here
    with the cap set (a rank runs ``train`` as the CLI's ranks do). The
    fakes (2) do not split over the ranks: each computes them all. The
    checkpoint's losses equal the 1-rank run's to 1e-5 relative, and rank
    0 alone saved it."""
    rotating = how == "num_gpus_rotating"
    data = (["--data", "multiple_images", "--data_path", _images(tmp_path), "--data_ext", "png"]
            if rotating else ["--data_path", _texture(tmp_path), "--data_ext", "png"])

    def argv(name, extra):
        return TRAIN_FLAGS + data + extra + ["--fname", str(tmp_path / name)]

    one = argv("one", [])
    if rotating:
        from infinite_texture_gans_torch.data import datasets

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(datasets.DeviceMultiImageSampler, "MAX_DEVICE_MB", ROTATING_MB)
            _, g1, d1 = train(prepare_parser().parse_args(one))
        two = argv("two", ["--num_gpus", "2", "--gpu_list", "0", "1"])
        g2, d2 = ranks(tmp_path, R.train_cli, two, ROTATING_MB)[0]
    else:
        _, g1, d1 = train(prepare_parser().parse_args(one))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_loop, "run_ranks", bounded(tmp_path))
            state, g2, d2 = train(prepare_parser().parse_args(argv("two", ["--mesh", "data:2"])))
        assert state is None
    ckpt = checkpoint.load_checkpoint(str(tmp_path / "two" / "2_2.ckpt"))
    assert ckpt["meta"]["Gloss"] == g2 and ckpt["meta"]["Dloss"] == d2
    np.testing.assert_allclose(g2, g1, **TOL)
    np.testing.assert_allclose(d2, d1, **TOL)
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))


# --- generation -----------------------------------------------------------

CANVAS_CASES = {
    # (generator kwargs, patches (h, w), slab_rows of the streamed PNG or None)
    "bn": (dict(), (7, 9), None),  # 3 x 4 steps: short rows (steps_w <= 2N)
    "bn_multiband": (dict(), (13, 13), 2),  # 6 x 6 steps, 3 bands: wide rows
    "ssm": (dict(type_norm="SSM", map_dim=2), (11, 7), 3),  # a ragged last slab
    "chw_tail": (dict(chw_tail="on"), (5, 7), None),
    "fuse_all": (dict(chw_tail="on", fuse_up="all"), (5, 7), None),
}


def test_wavefront_canvases_match_raster_and_jax(tmp_path):
    """The wavefront on 2 ranks (tests/test_parallel.py:82, :105, :129,
    :185, :427): each case's canvas bit-equal to the port's raster on the
    same latents and within 5e-5 / 1e-4 of JAX's ``generate_canvas``; the
    slab-streamed PNGs (BN, SSM: tests/test_parallel.py:480, :512) byte-equal
    to the port's ``generate_canvas_streamed`` with ``row_group`` =
    ``slab_rows``."""
    cases, refs = {}, {}
    for i, (name, (kw, (th, tw), slab)) in enumerate(CANVAS_CASES.items()):
        jgen, v = _tiny_variables({k: x for k, x in kw.items() if k != "fuse_up"})
        if "fuse_up" in kw:
            jgen = jgen.clone(fuse_up=kw["fuse_up"])
        key = jax.random.key(10 + i)
        z = np.array(jax_z_full(key, 1, 8, 4, th, tw))
        maps = None
        if kw.get("type_norm") == "SSM":
            maps = [np.array(m) for m in jax_maps_full(jax.random.fold_in(key, 1), 1, 2, 4, 4,
                                                       th, tw)]
        size = (th * 32, tw * 32)
        cases[name] = dict(variables=v, kw=kw, z=z, maps=maps, size=size, slab_rows=slab)
        jax_out = jax_generate_canvas(jgen, v, jax.random.key(0), *size, num_images=1,
                                      z_full=jnp.asarray(z),
                                      maps_full=None if maps is None else [jnp.asarray(m)
                                                                           for m in maps])
        refs[name] = np.asarray(jax_out)
    got = ranks(tmp_path, R.canvases, cases, str(tmp_path))
    assert all(g is None for g in got[1].values())  # rank 0 holds the canvas
    with one_thread():
        for name, c in cases.items():
            gen = R.tiny_gen(c["variables"], **c["kw"])
            maps = None if c["maps"] is None else [torch.from_numpy(m) for m in c["maps"]]
            raster = generate_canvas(gen, None, *c["size"], z_full=torch.from_numpy(c["z"]),
                                     maps_full=maps)
            np.testing.assert_array_equal(got[0][name], raster, err_msg=name)
            np.testing.assert_allclose(got[0][name], refs[name], **JAX_CANVAS, err_msg=name)
            if c["slab_rows"]:
                seq = str(tmp_path / f"{name}_seq.png")
                generate_canvas_streamed(gen, None, *c["size"], seq,
                                         z_full=torch.from_numpy(c["z"]), maps_full=maps,
                                         row_group=c["slab_rows"])
                with open(seq, "rb") as a, open(tmp_path / f"{name}.png", "rb") as b:
                    assert a.read() == b.read(), name


def test_sharded_one_pass_and_images_match_single(tmp_path):
    """The width-sharded one pass (15 patch columns over 2 ranks: slabs of
    8 and 7, the conv halos exchanged by P2P) and the image-sharded canvas
    (4 images, 2 a rank) equal the single-device ones within 1e-5
    (tests/test_parallel.py:50, :64)."""
    _, v = _tiny_variables()
    z_one = np.array(jax_z_full(jax.random.key(1), 1, 8, 4, 3, 15))
    z_img = np.array(jax_z_full(jax.random.key(2), 4, 8, 4, 5, 5))
    out = ranks(tmp_path, R.sharded, v, z_one, (3, 15), z_img, (5 * 32, 5 * 32))
    assert out[1][0] is None  # rank 0 gathers the canvas
    with one_thread():
        gen = R.tiny_gen(v)
        ref_one = generate_one_pass(gen, torch.from_numpy(z_one), 3, 15).numpy()
        ref = generate_canvas(gen, None, 5 * 32, 5 * 32, num_images=4,
                              z_full=torch.from_numpy(z_img))
    np.testing.assert_allclose(out[0][0], ref_one, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([o[1] for o in out]), ref, atol=1e-5, rtol=1e-5)


def test_sample_cli_mesh_matches_single_device(tmp_path):
    """``sample --mesh data:2`` (tests/test_parallel.py:553): with
    ``--stream --slab_rows 4`` the PNG is the single-device ``--stream``
    file byte for byte (its row groups are 4 rows), and without it the
    in-memory canvas's PNG is the single-device CLI's; ``data:1`` and a
    ``--batch`` are warned about."""
    from infinite_texture_gans_torch.config import GENERATOR_DEFAULTS

    _, v = _tiny_variables()
    ckpt = str(tmp_path / "tiny__ema.ckpt")
    meta_args = {**GENERATOR_DEFAULTS, **R.TINY_G}
    checkpoint.save_checkpoint(ckpt, {"meta": {"args": meta_args}, "netG_variables": v})
    size = ["--output_resolution_height", str(9 * 32), "--output_resolution_width", str(7 * 32)]
    base = ["--model_path", ckpt, "--seed", "3", "--device", "cpu", *size]
    with one_thread():
        sample.main(base + ["--output_name", "seq.png", "--stream"])
        sample.main(base + ["--output_name", "one.png"])
        sample.main(base + ["--output_name", "data1.png", "--mesh", "data:1"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sample, "run_ranks", bounded(tmp_path))
        sample.main(base + ["--output_name", "slab.png", "--stream", "--mesh", "data:2",
                            "--slab_rows", "4"])
        sample.main(base + ["--output_name", "wf.png", "--mesh", "data:2", "--batch", "2"])
    files = {n: open(tmp_path / n, "rb").read() for n in ("seq.png", "slab.png", "one.png",
                                                           "wf.png", "data1.png")}
    assert files["slab.png"] == files["seq.png"]
    assert files["wf.png"] == files["one.png"] == files["data1.png"]
    assert read_png(str(tmp_path / "wf.png")).std() > 1
