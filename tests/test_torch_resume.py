"""Resume in the port, on the CPU in float32: ``restore_train_state``, the
train loop's ``--resume`` and per-epoch draws, and ``AsyncCheckpointer``,
against the claims of the reference's tests (``tests/test_train.py``
:203, :258, :585, :1134) and against the JAX step itself: a ``.ckpt``
that JAX writes after one step is restored by the port, and both take the
second step on the same crops and latents (``_torch_step_check``'s
tolerances, those of ``tests/test_torch_train_step.py``)."""

import os
import time

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
from infinite_texture_gans_tpu.sampling.latents import build_train_z
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.checkpoint import AsyncCheckpointer, restore_train_state
from infinite_texture_gans_torch.train.train_step import create_train_state, set_lr, train_step
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_step_check import assert_step_matches, jax_grads, noise_leaves, np_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "4", "--num_images", "2",
        "--random_crop", "48", "--ema", "--spec_norm_D", "--smooth"]
LR = 2e-4


@pytest.fixture(scope="module")
def texture(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("tex") / "tex.png"
    rng = np.random.default_rng(8)
    Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(path)
    return str(path)


def _real(seed, n=4, size=48):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, size, size, 3)), -1, 1).astype(np.float32)


def _state_tensors(st):
    """Every tensor a resume restores, by name."""
    out = {f"{m}.{k}": v for m, mod in (("G", st.G), ("D", st.D))
           for k, v in mod.state_dict().items()}
    for m, mod, opt in (("G", st.G, st.opt_G), ("D", st.D, st.opt_D)):
        for n, p in mod.named_parameters():
            out.update({f"adam.{m}.{n}.{k}": v for k, v in opt.state[p].items()})
    out.update({f"ema.{k}": v for k, v in st.ema.items()})
    return out


def test_resume_roundtrip(tmp_path):
    """A state saved after one step is restored into a fresh state made from
    another seed: parameters, BN statistics, SN vectors, Adam moments and
    counts and the EMA equal exactly, written into the fresh state's own
    storages; the step count and the learning rate continue the schedule;
    one more step is finite (the claim of the reference's
    ``test_resume_roundtrip``)."""
    args = prepare_parser().parse_args(TINY + ["--device", "cpu", "--decay_lr", "exp"])
    st = create_train_state(args, 2, "cpu", seed=0)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 14, 14, 16)).astype(np.float32))
    train_step(st, torch.from_numpy(_real(0)), z, smooth=True, use_ema=True)
    path = str(tmp_path / "resume.ckpt")
    checkpoint.save_checkpoint(path, train_loop.checkpoint_payload(st, args, 1, 3, [0.5], [1.0]))

    fresh = create_train_state(args, 2, "cpu", seed=9)
    storages = {k: v.data_ptr() for k, v in _state_tensors(fresh).items()}
    assert not torch.equal(fresh.G.start.conv.weight, st.G.start.conv.weight)
    epoch = restore_train_state(fresh, checkpoint.load_checkpoint(path), steps_per_epoch=2)
    assert epoch == 1 and fresh.step == 2
    want, got = _state_tensors(st), _state_tensors(fresh)
    assert set(got) == set(want) and any(k.endswith(".u") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert got[k].data_ptr() == storages[k], k  # restored in place
    assert float(fresh.opt_G.state[fresh.G.final.conv.weight]["step"]) == 1.0
    set_lr(fresh)
    for opt in (fresh.opt_G, fresh.opt_D):
        assert float(opt.param_groups[0]["lr"]) == pytest.approx(LR * 0.99, rel=1e-6)
    m = train_step(fresh, torch.from_numpy(_real(2)), z, smooth=True, use_ema=True)
    assert all(np.isfinite(float(v)) for v in m.values())


def test_restore_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    """Another width's checkpoint raises before any tensor is written."""
    wide = prepare_parser().parse_args(TINY + ["--device", "cpu", "--G_ch", "16"])
    path = str(tmp_path / "wide.ckpt")
    checkpoint.save_checkpoint(path, train_loop.checkpoint_payload(
        create_train_state(wide, 1, "cpu", seed=0), wide, 1, 3, [], []))
    st = create_train_state(prepare_parser().parse_args(TINY + ["--device", "cpu"]), 1, "cpu", seed=4)
    before = {k: v.clone() for k, v in _state_tensors(st).items()}
    with pytest.raises(ValueError, match="in the checkpoint"):
        restore_train_state(st, checkpoint.load_checkpoint(path), 1)
    assert st.step == 0
    for k, v in _state_tensors(st).items():
        assert torch.equal(v, before[k]), k


def _train(texture, out, epochs, seed, resume=None, **kw):
    args = prepare_parser().parse_args(TINY + [
        "--device", "cpu", "--data_path", texture, "--data_ext", "png", "--batch_size", "2",
        "--random_crop", "32", "--sampling", "4", "--saving_rate", "2", "--epochs", str(epochs),
        "--fname", str(out)] + (["--seed", str(seed)] if seed is not None else [])
        + (["--resume", resume] if resume else []))
    for k, v in kw.items():
        setattr(args, k, v)
    state, g, d = train_loop.train(args)
    return args, state, g, d


def _assert_runs_equal(a, b):
    """Two train() results: equal loss histories and every tensor of the
    state, bit for bit (the CPU's float32 arithmetic is deterministic)."""
    (_, sa, ga, da), (_, sb, gb, db) = a, b
    assert (ga, da) == (gb, db) and len(ga) == 4
    ta, tb = _state_tensors(sa), _state_tensors(sb)
    for k, v in ta.items():
        assert torch.equal(tb[k], v), k


def test_resume_is_deterministic(texture, tmp_path):
    """2 epochs, then a fresh ``train`` resumed from ``2_2.ckpt`` to epoch
    4, equal the uninterrupted 4-epoch run (the claim of the reference's
    ``test_resume_is_deterministic``); the per-epoch reseed is what makes
    them equal: without it the resumed epochs draw other crops."""
    full = _train(texture, tmp_path / "full", 4, 17)
    _train(texture, tmp_path / "half", 2, 17)
    resumed = _train(texture, tmp_path / "resumed", 4, 17, str(tmp_path / "half" / "2_2.ckpt"))
    _assert_runs_equal(full, resumed)
    assert sorted(os.listdir(tmp_path / "resumed"))[:2] == ["4_4.ckpt", "4__ema.ckpt"]
    ck_full = checkpoint.load_checkpoint(str(tmp_path / "full" / "4_4.ckpt"))
    ck_res = checkpoint.load_checkpoint(str(tmp_path / "resumed" / "4_4.ckpt"))
    assert ck_res["meta"]["Gloss"] == ck_full["meta"]["Gloss"] and ck_res["meta"]["epoch"] == 4
    assert int(ck_res["opt_G"]["0"]["count"]) == 8
    np.testing.assert_array_equal(ck_res["ema"]["params"]["final"]["conv"]["kernel"],
                                  ck_full["ema"]["params"]["final"]["conv"]["kernel"])
    # the planted fault: the same resume without the per-epoch reseed
    keep = train_loop.reseed_epoch
    train_loop.reseed_epoch = lambda rng, seed, epoch: None
    try:
        broken = _train(texture, tmp_path / "broken", 4, 17, str(tmp_path / "half" / "2_2.ckpt"))
    finally:
        train_loop.reseed_epoch = keep
    assert broken[2][:2] == full[2][:2] and broken[2][2:] != full[2][2:]


def test_resume_without_seed_restores_checkpoint_seed(texture, tmp_path, capsys):
    """A seedless resume takes the seed the first leg drew, says so in the
    reference's words, and equals the uninterrupted run with that seed (the
    claim of the reference's test of the same name)."""
    _train(texture, tmp_path / "half", 2, None)
    drawn = checkpoint.load_checkpoint(str(tmp_path / "half" / "2_2.ckpt"))["meta"]["seed"]
    capsys.readouterr()
    resumed = _train(texture, tmp_path / "resumed", 4, None, str(tmp_path / "half" / "2_2.ckpt"))
    assert f"--resume: restored the run's seed {drawn} from the checkpoint" in capsys.readouterr().out
    assert resumed[0].seed == drawn
    _assert_runs_equal(_train(texture, tmp_path / "full", 4, drawn), resumed)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """JAX takes one step and writes a full ``.ckpt`` with its own
    ``save_checkpoint``; the port restores it into a state made from another
    seed, and both take the second step on the same crops and latents. The
    second step is held as ``tests/test_torch_train_step.py`` holds the
    first; its Adam bias correction (count 2) shows the stored count came
    across: where a gradient is at least a tenth of its leaf's largest,
    the port's update is within 1% of JAX's (a count lost would put it
    near 41% off)."""
    jargs = jax_parser().parse_args(TINY + ["--fuse_up", "auto", "--chw_tail", "on"])
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    state1, _ = step(state, jnp.asarray(_real(0)), jax.random.key(1))
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, {
        "meta": {"epoch": 1, "args": dict(vars(jargs)), "seed": 0, "Gloss": [0.5], "Dloss": [1.0]},
        "netG_variables": {"params": state1.params_G, **state1.aux_G},
        "netD_variables": {"params": state1.params_D, **state1.aux_D},
        "opt_G": state1.opt_G, "opt_D": state1.opt_D, "ema": state1.ema})
    # the step donates its state: keep what the checks read first
    s1 = np_tree({"params_G": state1.params_G, "aux_G": state1.aux_G, "opt_G": state1.opt_G})
    key2 = jax.random.key(2)
    state2, metrics2 = step(state1, jnp.asarray(_real(5)), key2)
    zk, _ = jax.random.split(jax.random.split(key2, 1)[0])
    z2 = np.array(build_train_z(zk, 2, 16, 4, 3, 3))
    assert int(state2.opt_G[0].count) == 2

    targs = prepare_parser().parse_args(TINY + ["--device", "cpu", "--fuse_up", "auto"])
    st = create_train_state(targs, 1, "cpu", seed=5)
    assert restore_train_state(st, checkpoint.load_checkpoint(path), steps_per_epoch=1) == 1
    for k, v in from_jax_variables({"params": s1["params_G"], **s1["aux_G"]}).items():
        assert torch.equal(st.G.state_dict()[k], v), k
    for n, p in st.G.named_parameters():
        assert float(st.opt_G.state[p]["step"]) == 1.0
    nu = from_jax_variables({"params": s1["opt_G"][0].nu})
    for n, p in st.G.named_parameters():
        assert torch.equal(st.opt_G.state[p]["exp_avg_sq"], nu[n]), n
    old = {n: p.detach().clone() for n, p in st.G.named_parameters()}
    before = {k: v.clone() for k, v in st.G.state_dict().items()}
    m = train_step(st, torch.from_numpy(_real(5)), torch.from_numpy(z2), smooth=True, use_ema=True)
    # Adam's second step moves a parameter by at most lr * sqrt(1 + beta2)
    # (beta1 = 0); two such moves apart
    assert_step_matches(state2, metrics2, st, m, before, noise_move=2 * LR * np.sqrt(1.999))
    assert all(float(st.opt_G.state[p]["step"]) == 2.0 for p in st.G.parameters())
    new = from_jax_variables({"params": np_tree(state2.params_G)})
    grads = jax_grads(state2, "G")
    _, noise = noise_leaves(grads)
    for n, p in st.G.named_parameters():
        if n in noise:
            continue
        big = grads[n].abs() >= 0.1 * grads[n].abs().max()
        want = (new[n] - old[n])[big]
        got = (p.detach() - old[n])[big]
        # 1e-3 lr: float32 rounding of a parameter of magnitude ~1
        assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3 * LR).all()), n


def test_async_checkpointer(tmp_path):
    """``AsyncCheckpointer`` (the claim of the reference's
    ``test_async_checkpointer_matches_sync``): the bytes of
    ``save_checkpoint``; ``meta`` and the tensors as they were at submit;
    saves written in submission order; a worker's error raised again once,
    at the next call, then cleared."""
    args = prepare_parser().parse_args(TINY + ["--device", "cpu"])
    st = create_train_state(args, 1, "cpu", seed=0)
    losses = [1.0, 2.0]
    payload = lambda: train_loop.checkpoint_payload(st, args, 3, 7, losses, losses)  # noqa: E731
    sync_path = tmp_path / "sync.ckpt"
    checkpoint.save_checkpoint(str(sync_path), payload())
    saver = AsyncCheckpointer()
    saver.submit(str(tmp_path / "async.ckpt"), payload())
    losses.append(99.0)  # after submit: must not reach the file
    with torch.no_grad():
        st.G.final.conv.weight.add_(1.0)
    saver.wait()
    assert (tmp_path / "async.ckpt").read_bytes() == sync_path.read_bytes()
    assert checkpoint.load_checkpoint(str(tmp_path / "async.ckpt"))["meta"]["Gloss"] == [1.0, 2.0]

    order = [str(tmp_path / f"o{i}.ckpt") for i in range(3)]
    for i, p in enumerate(order):
        saver.submit(p, {"meta": {"i": i}, "x": torch.full((3,), float(i))})
        saver.submit(str(tmp_path / "same.ckpt"), {"meta": {"i": i}, "x": torch.zeros(1)})
    saver.wait()
    assert [p for p, _ in saver.save_seconds[1:] if "same" not in p] == order
    assert checkpoint.load_checkpoint(str(tmp_path / "same.ckpt"))["meta"]["i"] == 2

    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    saver.submit(str(blocker / "x.ckpt"), payload())  # a file where a folder must be
    with pytest.raises(OSError):
        saver.wait()
    saver.submit(str(tmp_path / "retry.ckpt"), payload())
    saver.wait()  # the error was cleared once raised
    assert checkpoint.load_checkpoint(str(tmp_path / "retry.ckpt"))["meta"]["epoch"] == 3
    saver.submit(str(blocker / "y.ckpt"), payload())
    deadline = time.monotonic() + 60
    while not saver._errors and time.monotonic() < deadline:  # the worker has failed it
        time.sleep(0.01)
    with pytest.raises(OSError):  # raised again at the next submit
        saver.submit(str(tmp_path / "after.ckpt"), payload())
    saver.submit(str(tmp_path / "after.ckpt"), payload())
    saver.wait()
    assert (tmp_path / "after.ckpt").exists()
