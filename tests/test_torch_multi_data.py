"""Multi-image training data in the port, on the CPU: ``data/datasets.py``
(``MultipleImagesDataset``, the device samplers, the host prefetcher,
``prepare_data``) against the JAX package's on the same image directories
(written here with numpy and PIL), the train loop's ``--data
multiple_images`` with each sampler, and one step on a multi-image batch
against JAX's step. The claims are those of the reference's
``tests/test_train.py`` :302, :671, :714, :746, :832, :992, :1053 and
:1104; two faults of the reference are held absent (a seedless run over the
cap, and the per-step path's single window)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from infinite_texture_gans_tpu.config import discriminator_kwargs as jax_d_kwargs
from infinite_texture_gans_tpu.config import generator_kwargs as jax_g_kwargs
from infinite_texture_gans_tpu.config import prepare_parser as jax_parser
from infinite_texture_gans_tpu.data import datasets as J
from infinite_texture_gans_tpu.models.discriminator import PatchDiscriminator as JaxD
from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxG
from infinite_texture_gans_tpu.sampling.latents import build_train_z
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.data import datasets as D
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.train_step import create_train_state, train_step
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_step_check import assert_step_matches, np_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "2", "--num_images", "2",
        "--random_crop", "48", "--ema", "--spec_norm_D", "--smooth", "--device", "cpu"]
LR = 2e-4


def _bright(dirpath, sizes, mode="RGB"):
    """Images of random texture whose every value is >= 1: zero padding in a
    stack is then an exact 0 (normalised, an exact -1)."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(len(sizes))
    for i, (h, w) in enumerate(sizes):
        shape = (h, w) if mode == "L" else (h, w, 3)
        Image.fromarray(rng.integers(1, 256, shape, dtype=np.uint8)).save(
            os.path.join(dirpath, f"t{i}.png"))
    return str(dirpath)


def _const(dirpath, n, size):
    """Image i of one value 15 + 30 i: any pixel tells its source."""
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n):
        Image.fromarray(np.full((size, size, 3), 15 + 30 * i, np.uint8)).save(
            os.path.join(dirpath, f"c{i}.png"))
    return str(dirpath)


def _ids(batch):
    vals = np.round((np.asarray(batch)[:, 0, 0, 0] + 1.0) * 127.5).astype(int)
    assert ((vals - 15) % 30 == 0).all()  # only real images drawn
    return (vals - 15) // 30


# --- the dataset and its stack, against JAX's -----------------------------

STACK_CASES = {
    "crop": dict(random_crop=32),
    "resize": dict(random_crop=24, resize=(40, 44)),
    "center": dict(center_crop=36),
}


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_matches_jax(tmp_path, case):
    """``stacked_images`` (zero-padded stack, ``h_valid``, ``w_valid``),
    ``stacked_nbytes``, ``len`` and a host batch from the same numpy
    generator equal JAX's bit for bit."""
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40), (48, 48)])
    kw = STACK_CASES[case]
    port, ref = D.MultipleImagesDataset(d, "png", **kw), J.MultipleImagesDataset(d, "png", **kw)
    for got, want in zip(port.stacked_images(), ref.stacked_images()):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert port.stacked_nbytes() == ref.stacked_nbytes() == port.stacked_images()[0].nbytes
    assert len(port) == len(ref) == 3 and port.img_ch == 3
    np.testing.assert_array_equal(port.sample_batch(np.random.default_rng(4), 5),
                                  ref.sample_batch(np.random.default_rng(4), 5))
    stacked, hs, ws = port.stacked_images()
    if case == "crop":
        assert stacked.shape == (3, 64, 56, 3) and list(hs) == [40, 64, 48]
        assert stacked[0, 40:].max() == 0 and stacked[1, :, 40:].max() == 0


@pytest.mark.parametrize("case", ["mixed channels", "sizes differ", "crop too big"])
def test_stack_errors_match_jax(tmp_path, case):
    """``_stack_meta``'s three ValueErrors, message for message."""
    if case == "mixed channels":
        d = _bright(tmp_path / "a", [(40, 40)])
        _bright(tmp_path / "b", [(40, 40)], mode="L")
        os.rename(tmp_path / "b" / "t0.png", tmp_path / "a" / "u.png")
        kw = dict(random_crop=32)
    else:
        d = _bright(tmp_path / "a", [(40, 56), (64, 40)])
        kw = {} if case == "sizes differ" else dict(random_crop=48)
    errors = []
    for mod in (D, J):
        with pytest.raises(ValueError) as e:
            mod.MultipleImagesDataset(d, "png", **kw).stacked_nbytes()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_stacked_nbytes_is_header_only(tmp_path, monkeypatch):
    """``stacked_nbytes`` decodes no image (the claim of the reference's
    :746): with the decoder disabled it still gives the stack's size and
    its errors."""
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40)])
    want = D.MultipleImagesDataset(d, "png", random_crop=32).stacked_images()[0].nbytes

    def no_decode(path, ext):
        raise AssertionError("stacked_nbytes decoded pixel data")

    monkeypatch.setattr(D, "_load_image", no_decode)
    assert D.MultipleImagesDataset(d, "png", random_crop=32).stacked_nbytes() == want
    with pytest.raises(ValueError, match="smallest image"):
        D.MultipleImagesDataset(d, "png", random_crop=48).stacked_nbytes()


def test_sampling_subset_matches_jax(tmp_path):
    """``--sampling`` below the file count draws the same files as JAX
    (``np.random.default_rng(0)``); ``len`` is ``sampling``."""
    d = _const(tmp_path / "imgs", 7, 32)
    port, ref = D.MultipleImagesDataset(d, "png", sampling=4), J.MultipleImagesDataset(d, "png",
                                                                                      sampling=4)
    assert port.files == ref.files and len(port.files) == 4 and len(port) == 4
    assert D.MultipleImagesDataset(d, "png", sampling=9).files == sorted(os.listdir(d))


@pytest.mark.parametrize("max_mb,batch,crop,size_case", [
    (None, None, 32, "mixed"), (0.001, None, 32, "mixed"), (None, 1, None, "mixed"),
    (0.05, None, 24, "six"), (0.03, None, 24, "six")])
def test_maybe_build_matches_jax(tmp_path, max_mb, batch, crop, size_case):
    """``maybe_build``'s choice (stack, rotating window, host) and reason at
    the same caps and batch sizes as JAX's (the reference's :714)."""
    if size_case == "mixed":
        d = _bright(tmp_path / "imgs", [(40, 56), (64, 40)])
    else:
        d = _const(tmp_path / "imgs", 6, 56)
    kw = dict(random_crop=crop) if crop else {}
    got, why = D.DeviceMultiImageSampler.maybe_build(D.MultipleImagesDataset(d, "png", **kw), "cpu",
                                                     max_mb=max_mb, batch_size=batch, seed=3)
    want, jwhy = J.DeviceMultiImageSampler.maybe_build(J.MultipleImagesDataset(d, "png", **kw),
                                                       max_mb=max_mb, batch_size=batch, seed=3)
    assert type(got).__name__ == type(want).__name__ and why == jwhy
    if isinstance(got, D.RotatingMultiImageSampler):
        assert (got.subset_size, got.n_images) == (want.subset_size, want.n_images)


def test_maybe_build_raises_as_jax(tmp_path):
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40)])
    for kw, match in ((dict(), "differ in size"), (dict(random_crop=48), "smallest image")):
        for mod, extra in ((D, ("cpu",)), (J, ())):
            with pytest.raises(ValueError, match=match):
                mod.DeviceMultiImageSampler.maybe_build(mod.MultipleImagesDataset(d, "png", **kw),
                                                        *extra)


# --- the device samplers ----------------------------------------------------

def test_crop_draws_gather_and_bounds(tmp_path):
    """Each element's (image, top, left), drawn again from the same seed in
    the sampler's order, reproduces the batch by numpy slicing of the stack;
    every top and left stays inside its own image, so an all->=1 stack
    never gives an exact -1 (the reference's :671)."""
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40), (48, 48)])
    ds = D.MultipleImagesDataset(d, "png", random_crop=32)
    s = D.DeviceMultiImageSampler(ds, "cpu")
    assert s.random_crop == 32 and s.imgs.shape == (3, 64, 56, 3)
    batch = s.sample(torch.Generator().manual_seed(5), 256)
    assert batch.shape == (256, 32, 32, 3) and batch.dtype == torch.float32
    assert float(batch.min()) > -1.0 and float(batch.max()) <= 1.0
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 3, (256,), generator=g)
    tops = D._randbelow(s.h_valid[idx] - 31, g)
    lefts = D._randbelow(s.w_valid[idx] - 31, g)
    hs, ws = s.h_valid.numpy(), s.w_valid.numpy()
    stack = s.imgs.numpy()
    assert (tops.numpy() + 32 <= hs[idx.numpy()]).all() and (lefts.numpy() + 32 <= ws[idx.numpy()]).all()
    assert len(set(idx.tolist())) == 3 and len(set(tops.tolist())) > 10
    want = np.stack([stack[i, t : t + 32, l : l + 32] for i, t, l in
                     zip(idx.tolist(), tops.tolist(), lefts.tolist())])
    np.testing.assert_array_equal(batch.numpy(), J._normalize(want))


def test_no_crop_sampler_picks_whole_images(tmp_path):
    """A center-crop dataset (preprocessing equalises it to 64^2) picks
    whole images: ``pick_images``."""
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40), (48, 48)])
    s = D.DeviceMultiImageSampler(D.MultipleImagesDataset(d, "png", center_crop=40), "cpu")
    assert s.random_crop is None
    b = s.sample(torch.Generator().manual_seed(2), 5)
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(0, 3, (5,), generator=g)
    assert b.shape == (5, 64, 64, 3)
    torch.testing.assert_close(b, D.normalize(s.imgs[idx]), rtol=0, atol=0)


def _rotating(tmp_path, n, seed, size=56):
    d = _const(tmp_path / f"imgs{n}", n, size)
    cap = size * size * 3 / 2**20 * 4.5  # windows of 2 images
    port, why = D.DeviceMultiImageSampler.maybe_build(
        D.MultipleImagesDataset(d, "png", random_crop=24), "cpu", max_mb=cap, seed=seed)
    assert isinstance(port, D.RotatingMultiImageSampler), why
    ref = J.RotatingMultiImageSampler(J.MultipleImagesDataset(d, "png", random_crop=24), cap,
                                      device_put=lambda x: x, seed=seed)
    return port, ref


@pytest.mark.parametrize("n", [5, 6, 7])
def test_rotating_windows_match_jax(tmp_path, n):
    """Per (seed, epoch), the windows each chunk gets hold JAX's sampler's
    images and extents, chunk for chunk, over several wraps."""
    port, ref = _rotating(tmp_path, n, seed=3)
    assert port.subset_size == ref.subset_size == 2
    for epoch in (0, 1, 5):
        port.prepare_epoch(epoch)
        ref.prepare_epoch(epoch)
        for _ in range(2 * n):
            idx = port.next_window()
            imgs, hs, ws = ref.img_for_chunk()
            np.testing.assert_array_equal(port.imgs.numpy(), imgs)
            np.testing.assert_array_equal(port.h_valid.numpy(), hs)
            np.testing.assert_array_equal(port.w_valid.numpy(), ws)
            np.testing.assert_array_equal(port.imgs.numpy()[:, 0, 0, 0], 15 + 30 * idx)


@pytest.mark.parametrize("n", [5, 7, 9])
def test_rotating_residency_fairness(tmp_path, n):
    """Over an epoch of 3n chunks every image is resident within one window
    of every other (the reference's :1104); the next epoch's walk differs."""
    port, _ = _rotating(tmp_path, n, seed=1, size=40)
    walks = []
    for epoch in (0, 1):
        port.prepare_epoch(epoch)
        counts = np.zeros(n, np.int64)
        walk = []
        for _ in range(3 * n):
            walk.append(port.next_window().copy())
            np.add.at(counts, _ids(D.normalize(port.imgs)), 1)
        assert counts.sum() == 3 * n * port.subset_size
        assert counts.max() - counts.min() <= 1, counts
        walks.append(np.concatenate(walk))
    assert not np.array_equal(*walks)


def test_rotating_draws_uniform_and_replayed(tmp_path):
    """An epoch of windows draws every image about equally (the reference's
    :992: E = 32 a window of 2 of 6, a 4-sigma band), only from the resident
    window, and the same (seed, epoch) replays the same draws."""
    port, _ = _rotating(tmp_path, 6, seed=3)

    def epoch_draws(epoch):
        port.prepare_epoch(epoch)
        counts, ids = np.zeros(6, np.int64), []
        for c in range(3):
            window = port.next_window()
            got = _ids(port.sample(torch.Generator().manual_seed(c), 64))
            assert set(got) <= set(window.tolist())
            np.add.at(counts, got, 1)
            ids.append(got)
        return counts, np.concatenate(ids)

    counts, a = epoch_draws(0)
    assert counts.sum() == 192 and counts.min() >= 16 and counts.max() <= 48, counts
    np.testing.assert_array_equal(epoch_draws(0)[1], a)


def test_prefetcher(tmp_path):
    """The host prefetcher yields ``steps`` batches of ``sample_batch``
    (the reference's :302), and ``close`` stops a worker mid-iteration."""
    d = _bright(tmp_path / "imgs", [(64, 64)] * 3)
    ds = D.MultipleImagesDataset(d, "png", random_crop=32)
    batches = list(D.Prefetcher(ds, 4, 3, seed=1, device="cpu"))
    assert len(batches) == 3 and all(b.shape == (4, 32, 32, 3) for b in batches)
    rng = np.random.default_rng(1)
    for b in batches:
        np.testing.assert_array_equal(b.numpy(), ds.sample_batch(rng, 4))
    pf = D.Prefetcher(ds, 4, 50, seed=1, device="cpu")
    next(iter(pf))
    pf.close()
    assert not pf.thread.is_alive()
    ds2 = D.MultipleImagesDataset(d, "png", center_crop=48, resize=(64, 64))
    assert ds2.sample_batch(rng, 2).shape == (2, 64, 64, 3)


def test_resize_flags(tmp_path):
    """``--resize_h/--resize_w`` parse with the reference's defaults and
    resize every image (as JAX's ``prepare_data``); one without the other
    raises a ValueError before any image is read."""
    d = _bright(tmp_path / "imgs", [(40, 56), (64, 40)])
    argv = ["--data", "multiple_images", "--data_path", d, "--data_ext", "png",
            "--random_crop", "24"]
    args = prepare_parser().parse_args(argv + ["--resize_h", "30", "--resize_w", "36"])
    jargs = jax_parser().parse_args(argv + ["--resize_h", "30", "--resize_w", "36"])
    assert prepare_parser().parse_args([]).resize_h is None is jax_parser().parse_args([]).resize_w
    got, want = D.prepare_data(args), J.prepare_data(jargs)
    for a, b in zip(got.stacked_images(), want.stacked_images()):
        np.testing.assert_array_equal(a, b)
    assert got.stacked_images()[0].shape == (2, 30, 36, 3)
    for one in (["--resize_h", "30"], ["--resize_w", "36"]):
        with pytest.raises(ValueError, match="give both or neither"):
            D.prepare_data(prepare_parser().parse_args(argv + one))


# --- the train loop ---------------------------------------------------------

def _train(tmp_path, name, d, extra, capsys=None):
    args = prepare_parser().parse_args(TINY + [
        "--data", "multiple_images", "--data_path", d, "--data_ext", "png", "--saving_rate", "1",
        "--fname", str(tmp_path / name)] + extra)
    state, g, dl = train_loop.train(args)
    out = capsys.readouterr().out if capsys is not None else ""
    return args, state, g, dl, out


def test_train_loop_device_stack_and_host_fallback(tmp_path, capsys, monkeypatch):
    """``--data multiple_images`` trains through the device stack (crops
    drawn in the step, dispatched in chunks) and, with the cap forced below
    a window of two, through the host prefetcher, stepped one by one (the
    reference's :832); ``--batch_size 1`` with images of different sizes and
    no crop falls back to the host too. ``Training samples`` is
    ``--sampling``."""
    d = _bright(tmp_path / "imgs", [(64, 56), (56, 64), (60, 60)])
    common = ["--sampling", "4", "--seed", "13", "--epochs", "1"]
    args, _, g, _, out = _train(tmp_path, "dev", d, common, capsys)
    assert "sampled on device (3 images stacked in HBM)" in out
    assert "steps per dispatch: 2" in out and "Training samples:  4" in out
    assert np.isfinite(checkpoint.load_checkpoint(str(tmp_path / "dev" / "1_1.ckpt"))
                       ["meta"]["Gloss"]).all()
    monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB", 0.001)
    _, _, g, _, out = _train(tmp_path, "host", d, common, capsys)
    assert "on-device multi-image sampling disabled" in out and "host prefetcher" in out
    assert "steps per dispatch" not in out and np.isfinite(g).all()
    monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB", 1024.0)
    tiny_g = ["--random_crop", "0", "--batch_size", "1", "--sampling", "2"]
    _, _, g, _, out = _train(tmp_path, "b1", d, common + tiny_g, capsys)
    assert "batch_size=1 host batches still work" in out and np.isfinite(g).all()


def test_seedless_over_cap_run_builds(tmp_path, capsys, monkeypatch):
    """The reference passes ``args.seed`` (None without ``--seed``) to the
    rotating sampler, whose first epoch then fails; the port passes the
    seed it drew and stores it, and the run trains."""
    d = _const(tmp_path / "imgs", 6, 56)
    monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB", 56 * 56 * 3 * 4.5 / 2**20)
    with pytest.raises(TypeError):  # the reference's fault, for the record
        J.RotatingMultiImageSampler(J.MultipleImagesDataset(d, "png", random_crop=48),
                                    56 * 56 * 3 * 4.5 / 2**20, device_put=lambda x: x,
                                    seed=None).prepare_epoch(0)
    _, _, g, _, out = _train(tmp_path, "seedless", d, ["--sampling", "6", "--epochs", "1"], capsys)
    assert "rotating HBM subset of 2/6 images" in out and np.isfinite(g).all()
    drawn = int(out.split("Random Seed:")[1].split()[0])
    assert checkpoint.load_checkpoint(str(tmp_path / "seedless" / "1_1.ckpt"))["meta"]["seed"] == drawn


def test_per_step_path_rotates_windows(tmp_path, monkeypatch):
    """``--steps_per_dispatch 1`` over the cap: a new window before every
    step, the epoch's walk over all the images (the reference's per-step
    path serves a whole epoch from its first window)."""
    d = _const(tmp_path / "imgs", 6, 56)
    monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB", 56 * 56 * 3 * 4.5 / 2**20)
    windows = []
    swap = D.RotatingMultiImageSampler.next_window

    def recorded(self):
        windows.append(tuple(swap(self)))
        return windows[-1]

    monkeypatch.setattr(D.RotatingMultiImageSampler, "next_window", recorded)
    _train(tmp_path, "per_step", d, ["--sampling", "6", "--epochs", "1", "--seed", "7",
                                     "--steps_per_dispatch", "1"])
    assert len(windows) == 3  # 6 samples / batch 2: three steps, three windows
    assert sorted(i for w in windows for i in w) == list(range(6))


def test_rotating_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """Over the cap (windows of 2 of 6), a run resumed after 1 epoch equals
    the uninterrupted 2-epoch run bit for bit (the reference's :1053 and its
    resume contract): windows from (seed, epoch), draws from the reseeded
    generator."""
    d = _const(tmp_path / "imgs", 6, 56)
    monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB", 56 * 56 * 3 * 4.5 / 2**20)
    common = ["--sampling", "8", "--seed", "7", "--steps_per_dispatch", "2"]
    _, full, g_full, d_full, _ = _train(tmp_path, "full", d, common + ["--epochs", "2"])
    _train(tmp_path, "half", d, common + ["--epochs", "1"])
    _, resumed, g_res, d_res, _ = _train(tmp_path, "resumed", d, common + [
        "--epochs", "2", "--resume", str(tmp_path / "half" / "1_1.ckpt")])
    assert g_res == g_full and d_res == d_full
    for a, b in ((full.G, resumed.G), (full.D, resumed.D)):
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    for k, v in full.ema.items():
        torch.testing.assert_close(resumed.ema[k], v, rtol=0, atol=0)


def test_train_takes_the_stack_channels(tmp_path, capsys):
    """Grayscale images: G and D take the stack's one channel."""
    d = _bright(tmp_path / "imgs", [(56, 56), (60, 60)], mode="L")
    args, state, g, _, out = _train(tmp_path, "gray", d, ["--sampling", "2", "--epochs", "1",
                                                          "--seed", "2"], capsys)
    assert args.img_ch == 1 and "the images have 1 channels" in out
    assert state.G.img_ch == 1 and np.isfinite(g).all()


def test_multi_image_step_matches_jax(tmp_path):
    """One fused step (``--fuse_up auto``) on a real batch the port's
    multi-image sampler drew, against JAX's ``make_train_step`` on the same
    numpy batch, from the same state and latent, with
    ``tests/test_torch_train_step.py``'s tolerances."""
    d = _bright(tmp_path / "imgs", [(64, 56), (56, 64), (60, 60)])
    real = D.DeviceMultiImageSampler(D.MultipleImagesDataset(d, "png", random_crop=48),
                                     "cpu").sample(torch.Generator().manual_seed(3), 4)
    flags = TINY[:-2] + ["--batch_size", "4", "--data", "multiple_images"]
    jargs = jax_parser().parse_args(flags)
    G, Dn = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, Dn, jargs, jax.random.key(0), 2)
    init = np_tree({"params_G": state.params_G, "aux_G": state.aux_G,
                    "params_D": state.params_D, "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, Dn, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    key = jax.random.key(1)
    new, metrics = step(state, jnp.asarray(real.numpy()), key)
    zk, _ = jax.random.split(jax.random.split(key, 1)[0])
    z = np.array(build_train_z(zk, 2, 16, 4, 3, 3))
    st = create_train_state(prepare_parser().parse_args(flags + ["--device", "cpu"]), 2, "cpu",
                            seed=0)
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]}),
                         strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]},
                                            spectral=True), strict=True)
    st.ema = dict(from_jax_variables(init["ema"]))
    before = {k: v.clone() for k, v in st.G.state_dict().items()}
    m = train_step(st, real, torch.from_numpy(z), smooth=True, use_ema=True)
    assert_step_matches(new, metrics, st, m, before, noise_move=2 * LR)
