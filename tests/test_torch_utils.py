"""The PyTorch port's utilities against the JAX package's: the analytic FLOP
count (JAX's integers, and PyTorch's own FLOP counter on the port's CPU
forward, the counterpart of ``tests/test_flops.py``'s XLA cost check), the
card's peak table, the stall watchdog (``tests/test_watchdog.py``'s claims,
with the port's train loop) and the synthetic texture."""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from infinite_texture_gans_tpu.data import synthetic as jax_synthetic
from infinite_texture_gans_tpu.models.discriminator import PatchDiscriminator as JaxD
from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxG
from infinite_texture_gans_tpu.utils import flops as jax_flops
from infinite_texture_gans_torch.data import synthetic
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.utils import flops
from infinite_texture_gans_torch.utils.watchdog import StallWatchdog
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


def _pair(type_norm, n_layers_G, attention=True, grid=3):
    cfg = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=n_layers_G, attention=attention,
               type_norm=type_norm, map_dim=2, padding_mode="local")
    port = ResidualPatchGenerator(num_patches_h=grid, num_patches_w=grid, **cfg)
    return port, JaxG(num_patches_h=grid, num_patches_w=grid, **cfg)


@pytest.mark.parametrize("grid", [3, 6])
@pytest.mark.parametrize("n_layers_G", [4, 5, 6])
@pytest.mark.parametrize("type_norm", ["BN", "SSM"])
def test_flops_equal_jax(type_norm, n_layers_G, grid):
    """Every count equals JAX's integer: the generator forward (its own
    grid and a 6x6 one), the PatchGAN forward, the train step with 1 and 2
    D iterations and the canvas."""
    G, JG = _pair(type_norm, n_layers_G, grid=grid)
    D, JD = PatchDiscriminator(base_ch=16, n_layers_D=3), JaxD(base_ch=16, n_layers_D=3)
    for kw in ({}, {"num_images": 3}, {"gh": 6, "gw": 6}):
        assert (flops.generator_forward_flops(G, **kw)
                == jax_flops.generator_forward_flops(JG, **kw))
    assert (flops.discriminator_forward_flops(D, 48, 40, 4)
            == jax_flops.discriminator_forward_flops(JD, 48, 40, 4))
    for d_it in (1, 2):
        kw = dict(batch_size=4, crop=48, num_images=2, disc_iters=d_it)
        assert flops.train_step_flops(G, D, **kw) == jax_flops.train_step_flops(JG, JD, **kw)
    for h, w in ((1024, 1024), (384, 640)):
        assert flops.canvas_flops(G, h, w) == jax_flops.canvas_flops(JG, h, w)
    assert flops.conv2d_flops(4, 8, 3, 16, 16) == 2 * 4 * 8 * 9 * 256


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("type_norm,attention", [("BN", True), ("SSM", False)])
def test_generator_flops_near_torch_counter(type_norm, attention):
    """Within 15% of ``FlopCounterMode`` on the port's CPU forward (which
    also counts the softmax-free extras the model leaves out)."""
    G, _ = _pair(type_norm, 4, attention)
    G.eval()
    z = torch.zeros(2, 14, 14, 16)
    maps = None
    if type_norm == "SSM":
        maps = [torch.zeros(2, 12 * 2**i + 4, 12 * 2**i + 4, 2) for i in range(4)]
    counted = _counted(lambda: G(z, maps))
    assert flops.generator_forward_flops(G, num_images=2) == pytest.approx(counted, rel=0.15)


def test_discriminator_flops_near_torch_counter():
    D = PatchDiscriminator(base_ch=16, n_layers_D=3)
    counted = _counted(lambda: D(torch.zeros(4, 48, 48, 3)))
    assert flops.discriminator_forward_flops(D, 48, 48, 4) == pytest.approx(counted, rel=0.15)


def test_peak_flops_lookup(monkeypatch):
    """The H100 SXM's rates by its name; None for another card and the CPU."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_flops("cuda") == 989e12
    assert flops.peak_flops(torch.device("cuda", 0), "float32") == 67e12
    assert flops.CARD_PEAKS[flops.H100_SXM].bytes_per_s == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-40GB")
    assert flops.peak_flops("cuda") is None
    assert flops.peak_flops("cpu") is None and flops.peak_flops(torch.device("cpu")) is None


# --- the stall watchdog (tests/test_watchdog.py) -----------------------------


def _watchdog(clock, **kw):
    kw.setdefault("min_grace_s", 10.0)
    kw.setdefault("factor", 5.0)
    return StallWatchdog(clock=clock, **kw)


def test_watchdog_silent_before_first_beat():
    """The first epoch's builds and captures may take minutes: silent until
    the first beat."""
    t = [0.0]
    wd = _watchdog(lambda: t[0])
    t[0] = 10_000.0
    assert wd.check() is None


def test_watchdog_warns_once_per_episode_and_rearms_after_beat():
    t = [0.0]
    wd = _watchdog(lambda: t[0])
    wd.beat()
    t[0] = 2.0
    wd.beat()  # interval 2 s -> threshold max(10, 5 * 2) = 10
    t[0] = 11.0
    assert wd.check() is None
    t[0] = 13.0
    msg = wd.check()
    assert msg is not None and "no training progress" in msg
    t[0] = 50.0
    assert wd.check() is None  # the same episode
    wd.beat()
    t[0] = 250.0
    assert wd.check() is not None  # a new episode warns again


def test_watchdog_threshold_tracks_median_interval():
    t = [0.0]
    wd = _watchdog(lambda: t[0], min_grace_s=1.0, factor=10.0)
    for i in range(1, 6):
        t[0] = float(i)
        wd.beat()
    assert wd.threshold_s() == 10.0
    t[0] += 9.0
    assert wd.check() is None
    t[0] += 2.0
    assert wd.check() is not None


def test_watchdog_thread_warns_and_stops():
    msgs = []
    wd = StallWatchdog(min_grace_s=0.05, factor=1.0, poll_s=0.02, warn=msgs.append)
    wd.start()
    wd.beat()
    deadline = time.time() + 5.0
    while not msgs and time.time() < deadline:
        time.sleep(0.02)
    thread = wd._thread
    wd.stop()
    assert msgs and "no training progress" in msgs[0]
    assert not thread.is_alive()


TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--batch_size", "2", "--num_images", "1", "--random_crop",
        "32", "--sampling", "4", "--device", "cpu"]


@pytest.mark.parametrize("fail", [False, True])
def test_train_loop_beats_and_stops_watchdog(tmp_path, monkeypatch, fail):
    """``train`` beats once per epoch (its one read of the loss sums) and
    joins the watchdog's thread on return and on an exception."""
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.train import train_loop

    events, threads = [], []

    class Spy(StallWatchdog):
        def start(self):
            out = super().start()
            threads.append(self._thread)
            return out

        def beat(self):
            events.append("beat")
            super().beat()

        def stop(self):
            events.append("stop")
            super().stop()

    monkeypatch.setattr(train_loop, "StallWatchdog", Spy)
    tex = synthetic.write_texture(str(tmp_path / "tex.png"), 48, 48)
    args = prepare_parser().parse_args(TINY + [
        "--data_path", tex, "--data_ext", "png", "--epochs", "2", "--seed", "4",
        "--saving_rate", "2", "--fname", str(tmp_path / "cp")])

    def boom(epoch, i, metrics):
        if epoch == 1:
            raise RuntimeError("planted")

    if fail:
        with pytest.raises(RuntimeError, match="planted"):
            train_loop.train(args, step_callback=boom)
        assert events == ["beat", "stop"]
    else:
        train_loop.train(args)
        assert events == ["beat", "beat", "stop"]
    assert len(threads) == 1 and not threads[0].is_alive()


# --- the synthetic texture ---------------------------------------------------


@pytest.mark.parametrize("h,w,seed", [(440, 614, 0), (64, 96, 3)])
def test_synthetic_texture_bytes_equal_jax(tmp_path, h, w, seed):
    got = synthetic.make_texture(h, w, seed)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jax_synthetic.make_texture(h, w, seed))
    from PIL import Image

    path = synthetic.write_texture(str(tmp_path / "t.png"), h, w, seed)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), got)
