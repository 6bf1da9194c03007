"""One whole training step of the port against the JAX reference's
``make_train_step`` on the CPU in float32, the checkpoint format in both
directions, and the train CLI.

The step: the reference tests' tiny recipe (tests/test_train.py
``tiny_args``: G_ch 8, D_ch 8, n_layers_G 4, n_layers_D 2, 48² crops,
2 fake grids) with spectral norm in D, ``--smooth``, EMA, and the JAX
generator's channels-major tail in interpret mode (``chw_tail='on',
fuse_up='off'``), so that the fake reaches D through the stem kernel.
Both sides start from the same parameters (carried by
``weights.from_jax_variables``), see the same crops and the JAX step's own
latents.

Tolerances: the losses to rtol 1e-4; the gradients to 1e-4 of each leaf's
largest reference value; the new parameters to rtol 5e-3 and atol 5e-5
(the tolerance of the reference's own ``test_chw_image_wire_matches_nhwc``);
BN statistics, SN vectors and the EMA to rtol 1e-5. Some leaves have a
gradient that is zero in exact arithmetic: biases whose output reaches only
train-mode BatchNorms, which remove a constant shift (with the attention
gate at its initial 0 that is every conv1, conv2 and shortcut bias). Their
reference gradient is float32 rounding noise, below 1e-6 of the model's
largest gradient; such a leaf is held to 1e-4 of the model's largest
gradient, and its new value to 2·lr (Adam moves a parameter by at most lr
in its first step, whatever the sign of the noise). Gradients of the
reference come from its Adam state: with beta1 = 0, Adam's first moment
after one step is the gradient itself."""

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
from infinite_texture_gans_tpu.sampling.latents import build_train_z
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.train import checkpoint as port_ckpt
from infinite_texture_gans_torch.train import train_loop
from infinite_texture_gans_torch.train.train_step import create_train_state, train_step
from infinite_texture_gans_torch.weights import from_jax_variables

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "4", "--num_images", "2",
        "--random_crop", "48", "--sampling", "8", "--ema", "--spec_norm_D", "--smooth"]
LR = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


NOISE = 1e-6  # a gradient below this share of the model's largest is rounding noise


def _grads(step_case, model):
    opt = step_case["new"].opt_G if model == "G" else step_case["new"].opt_D
    return from_jax_variables({"params": _np(opt[0].mu)})


def _noise_leaves(grads):
    top = max(float(v.abs().max()) for v in grads.values())
    return top, {k for k, v in grads.items() if float(v.abs().max()) < NOISE * top}


def run_step_case():
    """Both steps from the same state; returns what the tests compare."""
    jargs = jax_parser().parse_args(TINY)
    jargs.chw_tail, jargs.fuse_up = "on", "off"
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    assert G.emits_chw()
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    init = _np({"params_G": state.params_G, "aux_G": state.aux_G, "params_D": state.params_D,
                "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    real = np.clip(np.random.default_rng(0).standard_normal((4, 48, 48, 3)), -1, 1).astype(np.float32)
    key = jax.random.key(1)
    new, metrics = step(state, jnp.asarray(real), key)
    # the step's own latent: keys = split(key, disc_iters); zk, _ = split(keys[0])
    zk, _ = jax.random.split(jax.random.split(key, 1)[0])
    z = np.array(build_train_z(zk, 2, 16, 4, 3, 3))

    targs = prepare_parser().parse_args(TINY + ["--device", "cpu"])
    st = create_train_state(targs, 2, "cpu", seed=0)
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]}), strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]}, spectral=True),
                         strict=True)
    st.ema = {k: v for k, v in from_jax_variables(init["ema"]).items()}
    before = {k: v.clone() for k, v in st.G.state_dict().items()}
    m = train_step(st, torch.from_numpy(real), torch.from_numpy(z), smooth=True, use_ema=True)
    return dict(jargs=jargs, targs=targs, new=new, metrics=metrics, st=st, m=m, G=G, D=D,
                before=before)


@pytest.fixture(scope="module")
def step_case():
    return run_step_case()


def test_step_losses_match(step_case):
    for k, v in step_case["metrics"].items():
        np.testing.assert_allclose(float(step_case["m"][k]), float(v), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("model", ["G", "D"])
def test_step_gradients_match(step_case, model):
    want = _grads(step_case, model)
    module = step_case["st"].G if model == "G" else step_case["st"].D
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    top, noise = _noise_leaves(want)
    for name, ref in want.items():
        scale = top if name in noise else float(ref.abs().max())
        err = float((got[name] - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("model", ["G", "D"])
def test_step_new_params_and_state_match(step_case, model):
    new, st = step_case["new"], step_case["st"]
    if model == "G":
        want = from_jax_variables({"params": _np(new.params_G), **_np(new.aux_G)})
        got = st.G.state_dict()
    else:
        want = from_jax_variables({"params": _np(new.params_D), **_np(new.aux_D)}, spectral=True)
        got = st.D.state_dict()
    assert set(got) == set(want)
    _, noise = _noise_leaves(_grads(step_case, model))
    for name, ref in want.items():
        g = got[name].numpy()
        if name.rsplit(".", 1)[-1] in ("mean", "var", "u", "v"):  # BN statistics, SN vectors
            np.testing.assert_allclose(g, ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
        elif name in noise:
            assert np.abs(g - ref.numpy()).max() <= 2 * LR, name
        else:
            np.testing.assert_allclose(g, ref.numpy(), rtol=5e-3, atol=5e-5, err_msg=name)


def test_step_ema_matches(step_case):
    want = from_jax_variables(_np(step_case["new"].ema))
    before = step_case["before"]
    _, noise = _noise_leaves(_grads(step_case, "G"))
    for name, ref in want.items():
        got = step_case["st"].ema[name].numpy()
        if name in noise:
            # EMA = 0.999·old + 0.001·new: the new value's ±2·lr freedom, scaled
            assert np.abs(got - ref.numpy()).max() <= 2e-3 * 2 * LR + 1e-7 * np.abs(before[name].numpy()).max(), name
        else:
            np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def _jax_payload(state, jargs):
    return {
        "meta": {"epoch": 1, "args": dict(vars(jargs)), "seed": 0, "Gloss": [0.5], "Dloss": [1.0]},
        "netG_variables": {"params": state.params_G, **state.aux_G},
        "netD_variables": {"params": state.params_D, **state.aux_D},
        "opt_G": state.opt_G, "opt_D": state.opt_D, "ema": state.ema,
    }


def test_port_checkpoint_loads_in_jax(step_case, tmp_path):
    """The port's .ckpt has the reference's tree (keys, shapes, dtypes),
    and the reference resumes a train state from it."""
    st, targs = step_case["st"], step_case["targs"]
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, train_loop.checkpoint_payload(st, targs, 1, 0, [0.5], [1.0]))
    got = jax_ckpt.load_checkpoint(path)
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jpath, _jax_payload(step_case["new"], step_case["jargs"]))
    ref = jax_ckpt.load_checkpoint(jpath)
    body = lambda t: {k: v for k, v in t.items() if k != "meta"}
    shape = lambda t: jax.tree_util.tree_map(lambda a: (np.shape(a), np.asarray(a).dtype.name), body(t))
    assert shape(got) == shape(ref)
    assert got["meta"]["epoch"] == 1 and got["meta"]["Gloss"] == [0.5]
    for k, v in from_jax_variables(got["netG_variables"]).items():
        torch.testing.assert_close(v, st.G.state_dict()[k], rtol=0, atol=0)
    # the reference restores a full TrainState from the port's file
    G, D = step_case["G"], step_case["D"]
    template, _, _ = jax_create(G, D, step_case["jargs"], jax.random.key(0), 2)
    restored, epoch = jax_ckpt.restore_train_state(template, got, 2)
    assert epoch == 1
    np.testing.assert_array_equal(np.asarray(restored.opt_G[0].count), 1)
    np.testing.assert_array_equal(
        np.asarray(restored.params_D["conv0"]["kernel"]),
        np.transpose(st.D.conv0.weight.detach().numpy(), (2, 3, 1, 0)))


def test_jax_checkpoint_loads_in_port(step_case, tmp_path):
    """A .ckpt written by the reference's save_checkpoint loads in the port:
    both models' variables, and the generator through the sampling loader."""
    new, jargs = step_case["new"], step_case["jargs"]
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, _jax_payload(new, jargs))
    ck = port_ckpt.load_checkpoint(path)
    from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
    from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator

    D = PatchDiscriminator(base_ch=8, n_layers_D=2, SN=True)
    D.load_state_dict(from_jax_variables(ck["netD_variables"], spectral=True), strict=True)
    np.testing.assert_array_equal(D.conv0.u.numpy(), np.asarray(new.aux_D["spectral"]["conv0"]["u"]))
    gen, args = port_ckpt.load_generator_from_checkpoint(path, device="cpu", ckpt=ck)
    assert isinstance(gen, ResidualPatchGenerator) and args.G_ch == 8
    np.testing.assert_array_equal(gen.final.conv.weight.detach().numpy(),
                                  np.transpose(np.asarray(new.params_G["final"]["conv"]["kernel"]), (3, 2, 0, 1)))
    ema_gen, _ = port_ckpt.load_generator_from_checkpoint(path, ema=True, device="cpu", ckpt=ck)
    np.testing.assert_array_equal(ema_gen.bn.mean.numpy(), np.asarray(new.ema["batch_stats"]["bn"]["mean"]))


def test_train_cli_writes_checkpoint_that_samples(tmp_path):
    """Two steps of the train CLI at tiny width on the CPU write the
    reference's checkpoints; the port's sample CLI renders from one."""
    from PIL import Image

    from infinite_texture_gans_torch import sample

    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(tmp_path / "tex.png")
    out = tmp_path / "run"
    train_loop.main(TINY + ["--data_path", str(tmp_path / "tex.png"), "--data_ext", "png",
                            "--device", "cpu", "--seed", "3", "--epochs", "1", "--saving_rate", "1",
                            "--fname", str(out)])
    assert sorted(os.listdir(out)) == ["1_1.ckpt", "1__ema.ckpt"]
    ck = port_ckpt.load_checkpoint(str(out / "1_1.ckpt"))
    assert ck["meta"]["epoch"] == 1 and len(ck["meta"]["Gloss"]) == 1
    assert int(ck["opt_G"]["0"]["count"]) == 2  # sampling 8 / batch 4
    sample.main(["--model_path", str(out / "1__ema.ckpt"), "--output_resolution_height", "80",
                 "--output_resolution_width", "72", "--output_name", "c.png", "--device", "cpu"])
    img = np.asarray(Image.open(out / "c.png"))
    assert img.shape == (80, 72, 3) and img.std() > 0


def test_fuse_up_auto_is_refused():
    from infinite_texture_gans_torch.config import check_train_args

    args = prepare_parser().parse_args(TINY + ["--fuse_up", "auto"])
    with pytest.raises(NotImplementedError, match="K9"):
        check_train_args(args)
