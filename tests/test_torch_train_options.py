"""The training options beyond the default step, against the JAX
reference on the CPU in float32 at the reference tests' tiny widths
(G_ch 8, 4 layers, D_ch 8, 2 layers, 48² crops, 2 fake grids): WGAN-GP
(``--loss wgan --gp_weight``), ``--disc_iters`` > 1, the discriminator's
``--norm_layer_D batch`` and ``instance``, and spectral norm in G
(``--spec_norm_G``, BN and SSM).

Each option's step is held to JAX ``make_train_step`` from the same state,
crops and JAX's own draws, recomputed from its key: ``keys = split(key,
disc_iters)``, the latent (and maps) from ``split(keys[it])``, the
penalty's ``eps = uniform(fold_in(keys[it], 7), (n, 1, 1, 1))``. JAX runs
its channels-major tail in interpret mode (``--chw_tail on``), so the fake
reaches D through the stem kernel wherever the reference's wire takes it
there. The tolerances are ``tests/_torch_step_check.py``'s (those of
``tests/test_torch_train_step.py``): losses rtol 1e-4; each gradient leaf
to 1e-4 of its largest reference value (a rounding-noise leaf to 1e-4 of
the model's largest gradient); new parameters rtol 5e-3, atol 5e-5 (a
noise leaf within ``noise_move``, the most Adam can move it in the step on
both sides); BN statistics, SN vectors and the EMA rtol 1e-5. The gradient
penalty alone: its value to rtol 1e-5 and D's gradients as above."""

import contextlib
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
from infinite_texture_gans_tpu.sampling import latents as jax_latents
from infinite_texture_gans_tpu.sampling.latents import build_train_maps, build_train_z
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_tpu.train import losses as jax_losses
from infinite_texture_gans_tpu.train.train_step import create_train_state as jax_create
from infinite_texture_gans_tpu.train.train_step import make_train_step
from infinite_texture_gans_torch.config import check_train_args, prepare_parser
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.train import checkpoint, losses, train_loop
from infinite_texture_gans_torch.train import train_step as port_train_step
from infinite_texture_gans_torch.train.train_step import create_train_state, train_step
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_step_check import assert_step_matches, jax_grads, noise_leaves, np_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "4", "--num_images", "2",
        "--random_crop", "48", "--sampling", "8", "--ema", "--spec_norm_D", "--smooth"]
LR = 2e-4
# Adam with beta1 = 0 moves a parameter by at most lr in its first step and
# lr·sqrt(1 + beta2) in its second: the most one side's k steps move a
# rounding-noise leaf, twice that between the two sides
ADAM_MOVES = (1.0, np.sqrt(1.999))
CASES = {
    "wgan": ["--loss", "wgan", "--gp_weight", "10"],
    "disc_iters2": ["--disc_iters", "2"],
    "norm_batch": ["--norm_layer_D", "batch"],
    "norm_instance": ["--norm_layer_D", "instance"],
    "spec_norm_G[BN]": ["--spec_norm_G"],
    "spec_norm_G[SSM]": ["--spec_norm_G", "--type_norm_G", "SSM", "--map_dim", "2"],
}


def _real(seed=0, n=4, size=48):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, size, size, 3)), -1, 1).astype(np.float32)


def jax_draws(key, args):
    """The draws of JAX's step (train_step.py:256-346) for each D
    iteration: (z, maps or None, eps or None) as numpy arrays."""
    out = []
    keys = jax.random.split(key, args.disc_iters)
    for it in range(args.disc_iters):
        zk, mk = jax.random.split(keys[it])
        z = np.array(build_train_z(zk, 2, 16, 4, 3, 3))
        maps = None
        if args.type_norm_G == "SSM":
            maps = [np.array(m) for m in build_train_maps(mk, 2, args.map_dim, 4, 4, 3, 3)]
        eps = None
        if args.loss == "wgan":
            eps = np.array(jax.random.uniform(jax.random.fold_in(keys[it], 7), (2, 1, 1, 1)))
        out.append((z, maps, eps))
    return out


def port_state(targs, init, seed=0):
    """A port train state carrying JAX's initial variables and EMA."""
    st = create_train_state(targs, 2, "cpu", seed=seed)
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]},
                                            spectral=True), strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]},
                                            spectral=True), strict=True)
    st.ema = from_jax_variables(init["ema"])
    return st


def port_step(st, targs, draws, real):
    """The port's step on JAX's draws: tensors for one D iteration, lists
    of them for several."""
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    z = [t(d[0]) for d in draws]
    maps = [None if d[1] is None else [t(a) for a in d[1]] for d in draws]
    eps = [t(d[2]) for d in draws]
    if len(draws) == 1:
        z, maps, eps = z[0], maps[0], eps[0]
    elif all(m is None for m in maps):
        maps = None
    return train_step(st, torch.from_numpy(real), z, maps, eps=eps, loss_type=targs.loss,
                      smooth=True, gp_weight=targs.gp_weight, use_ema=True)


def _step_kw(jargs):
    return dict(loss_type=jargs.loss, smooth=True, disc_iters=jargs.disc_iters, num_images=2,
                use_ema=True, gp_weight=jargs.gp_weight)


def jax_step64(jargs, real, key, ckpt_path=None):
    """JAX ``make_train_step`` in float64 (x64, every block NHWC) from the
    float32 step's initial state (made again: the float32 step donates
    it; or restored from ``ckpt_path``), crops and key; the latents, maps
    and the penalty's ``eps`` drawn in float32 as the float32 step draws
    them, then widened. Returns its new state as numpy arrays."""
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    if ckpt_path is not None:
        state, _ = jax_ckpt.restore_train_state(state, jax_ckpt.load_checkpoint(ckpt_path), 2)
    uniform = jax.random.uniform
    z32, maps32 = jax_latents.build_train_z, jax_latents.build_train_maps
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_latents, "build_train_z", lambda *a: z32(*a).astype(jnp.float32))
        mp.setattr(jax_latents, "build_train_maps",
                   lambda *a: [m.astype(jnp.float32) for m in maps32(*a)])
        mp.setattr(jax.random, "uniform", lambda k, shape, dtype=jnp.float32, **kw: uniform(
            k, shape, jnp.float32, **kw).astype(dtype))
        G64 = JaxG(**{**jax_g_kwargs(jargs), "dtype": jnp.float64, "chw_tail": "off"})
        D64 = JaxD(**{**jax_d_kwargs(jargs), "dtype": jnp.float64})

        def wide(a):  # new arrays throughout: the step donates its state
            return a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else jnp.array(a)

        step = make_train_step(G64, D64, tx_G, tx_D, **_step_kw(jargs))
        new, _ = step(jax.tree_util.tree_map(wide, state), jnp.asarray(real, jnp.float64), key)
        return np_tree(new)


@contextlib.contextmanager
def g_pass_on_reference_d(st, new, d_updates, out):
    """Within the port's step, right after its last D update (the
    ``d_updates``-th), D's parameters are recorded into ``out`` and set to
    JAX's new ones, so that the G pass runs on JAX's updated D. Adam moves
    the D elements whose gradient the float32 rounding decides (a bias
    before a train-mode BatchNorm, the critic's output bias under WGAN's
    cancelling means, elements near 0) by up to lr either way, and the G
    pass's logits, batch means and power iteration would carry those moves;
    the recorded update is held to JAX's (``assert_step_matches``'
    ``d_params``), and everything else stays the port's own."""
    adam, calls = port_train_step._adam_step, []
    after = from_jax_variables({"params": np_tree(new.params_D)})

    def step(opt):
        adam(opt)
        if opt is st.opt_D:
            calls.append(opt)
            if len(calls) == d_updates:
                with torch.no_grad():
                    for n, p in st.D.named_parameters():
                        out[n] = p.detach().clone()
                        p.copy_(after[n])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train_step, "_adam_step", step)
        yield
    assert len(calls) == d_updates


def run_case(flags):
    jargs = jax_parser().parse_args(TINY + flags + ["--chw_tail", "on"])
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    init = np_tree({"params_G": state.params_G, "aux_G": state.aux_G,
                    "params_D": state.params_D, "aux_D": state.aux_D, "ema": state.ema})
    step = make_train_step(G, D, tx_G, tx_D, **_step_kw(jargs))
    real, key = _real(), jax.random.key(1)
    new, metrics = step(state, jnp.asarray(real), key)

    targs = prepare_parser().parse_args(TINY + flags + ["--chw_tail", "on", "--device", "cpu"])
    check_train_args(targs)
    st = port_state(targs, init)
    assert st.G.emits_chw() == G.emits_chw() == (not targs.spec_norm_G)
    before, d_params = {k: v.clone() for k, v in st.G.state_dict().items()}, {}
    with g_pass_on_reference_d(st, new, targs.disc_iters, d_params):
        m = port_step(st, targs, jax_draws(key, jargs), real)
    return dict(new=new, metrics=metrics, st=st, m=m, before=before, targs=targs,
                d_params=d_params, exact=lambda: jax_step64(jargs, real, key))


@pytest.mark.parametrize("case", list(CASES))
def test_option_step_matches_jax(case):
    """One step of each option against JAX ``make_train_step``: losses (the
    D losses summed over the D iterations), every gradient leaf (D's from
    its last iteration), the new parameters, BN statistics (G's, and D's
    under ``--norm_layer_D batch``), SN vectors (D's, and G's under
    ``--spec_norm_G``) and the EMA, whose keys are JAX's (no SN vectors).
    The claims of the reference's ``test_wgan_gp_train_smoke``,
    ``test_train_step_disc_iters`` and ``test_spec_norm_G_train_smoke``
    (tests/test_train.py:135, :161, :893) at one step, held to JAX's
    numbers; a gradient leaf outside its limit is held to JAX's float64
    step, and an element whose move the rounding decides is held as a
    noise leaf (``assert_step_matches``' ``exact`` and ``element_noise``),
    and the G pass runs on JAX's updated D, the port's update of it held
    to JAX's (:func:`g_pass_on_reference_d`)."""
    r = run_case(CASES[case])
    st, new, targs = r["st"], r["new"], r["targs"]
    k = targs.disc_iters
    noise_move = 2 * LR * sum(ADAM_MOVES[:k])
    assert_step_matches(new, r["metrics"], st, r["m"], r["before"], noise_move=noise_move,
                        exact=r["exact"], element_noise=True, d_params=r["d_params"])
    want_ema = from_jax_variables(np_tree(new.ema))
    assert set(st.ema) == set(want_ema)
    assert not any(name.rsplit(".", 1)[-1] in ("u", "v") for name in st.ema)
    state = st.G.state_dict()
    if targs.spec_norm_G:
        # every conv of G normalised (the start, each block's, the
        # attention's four, the final; the SSM norms' two each), each
        # vector refreshed by the step's forward
        sn = {name for name in state if name.endswith((".u", ".v"))}
        assert sn == set(from_jax_variables({"spectral": np_tree(new.aux_G)["spectral"]},
                                            spectral=True))
        assert {"start.conv.u", "final.conv.v", "attention.attn.o.u"} <= sn
        for name in sn:
            assert not torch.equal(state[name], r["before"][name]), name
    if targs.norm_layer_D == "batch":
        assert {"norm1.scale", "norm1.bias", "norm1.mean", "norm1.var"} <= set(st.D.state_dict())


def _jax_critic_case(norm):
    """An SN critic's variables, its power iteration run three times on a
    batch (the training forwards' refresh), so that sigma is near W's
    largest singular value."""
    flags = [] if norm is None else ["--norm_layer_D", norm]
    jargs = jax_parser().parse_args(TINY + flags)
    D = JaxD(**jax_d_kwargs(jargs))
    v = jax.jit(lambda x: D.init(jax.random.key(2), x, train=True))(jnp.zeros((1, 64, 64, 3)))
    for i in range(3):
        _, new = D.apply(v, jnp.asarray(_real(10 + i)), train=False, update_sn=True,
                         mutable=["spectral"])
        v = {**v, "spectral": new["spectral"]}
    v = np_tree(v)
    rng = np.random.default_rng(6)
    if norm == "batch":  # running statistics away from their (0, 1) init
        bs = v["batch_stats"]["norm1"]
        bs["mean"] = (0.1 * rng.standard_normal(bs["mean"].shape)).astype(np.float32)
        bs["var"] = (1 + 0.2 * rng.random(bs["var"].shape)).astype(np.float32)
    return D, v


@pytest.mark.parametrize("norm", [None, "batch", "instance"])
def test_gradient_penalty_matches_jax(norm):
    """The penalty through the frozen critic (no SN refresh, BatchNorms on
    their running averages) of an SN discriminator, 48² real crops against
    96² fakes (center-cropped to 48², the batch sliced to 2): its value to
    rtol 1e-5 and D's gradients (the double backward through the convs, SN's
    sigma, the norms and the LeakyReLUs) to 1e-4 of each leaf's largest
    reference value. The claim of the reference's
    ``test_gradient_penalty_math`` (tests/test_train.py:112) on a real
    critic."""
    D, v = _jax_critic_case(norm)
    real = _real(3)
    fake = _real(4, n=2, size=96)
    key = jax.random.key(5)
    eps = np.array(jax.random.uniform(key, (2, 1, 1, 1)))
    params = v["params"]
    aux = {k: c for k, c in v.items() if k != "params"}

    def gp_of(p):
        def critic(x):
            out = D.apply({"params": p, **aux}, x, train=False)
            return out[0] if isinstance(out, tuple) else out
        return jax_losses.gradient_penalty(critic, jnp.asarray(real), jnp.asarray(fake), key)

    want, want_g = jax.value_and_grad(gp_of)(params)
    port = PatchDiscriminator(base_ch=8, n_layers_D=2, SN=True, norm_layer=norm).train()
    port.load_state_dict(from_jax_variables(v, spectral=True), strict=True)
    state = {k: t.clone() for k, t in port.state_dict().items()}
    got = losses.gradient_penalty(lambda x: port(x, train=False), torch.from_numpy(real),
                                  torch.from_numpy(fake), torch.from_numpy(eps))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k, t in port.state_dict().items():  # frozen: nothing refreshed or updated
        assert torch.equal(t, state[k]), k
    ref = from_jax_variables({"params": np_tree(want_g)})
    assert set(ref) == {n for n, _ in port.named_parameters()}
    # the conv biases' gradients are 0 in exact arithmetic (the critic's
    # input gradient sees a bias only through the LeakyReLU masks): noise
    # leaves, which the port may leave out of the graph (None)
    top, noise = noise_leaves(ref)
    for name, p in port.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        scale = top if name in noise else float(ref[name].abs().max())
        assert float((grad - ref[name]).abs().max()) <= 1e-4 * scale, name
    assert {n for n in noise if "bias" not in n} == set()


def test_gradient_penalty_math():
    """critic(x) = a·sum(x): the gradient is a everywhere, the per-sample
    norm a·sqrt(H·W·C), the penalty (a·sqrt(HWC) - 1)² to rtol 1e-5, also
    with the real batch larger than the fake (center-cropped to it); an
    ``eps`` of another batch raises (tests/test_train.py:112)."""
    a, h, c = 0.25, 4, 3
    critic = lambda x: a * x.sum(dim=(1, 2, 3))  # noqa: E731
    fake = -torch.ones(2, h, h, c)
    eps = torch.rand(2, 1, 1, 1, generator=torch.Generator().manual_seed(0))
    expect = (a * np.sqrt(h * h * c) - 1.0) ** 2
    for real in (torch.ones(2, h, h, c), torch.ones(3, 8, 8, c)):
        assert float(losses.gradient_penalty(critic, real, fake, eps)) == pytest.approx(
            expect, rel=1e-5)
    with pytest.raises(ValueError, match="eps"):
        losses.gradient_penalty(critic, torch.ones(3, h, h, c), fake, torch.rand(3, 1, 1, 1))


def test_wgan_losses_match_jax():
    """``d_loss_real``, ``d_loss_fake`` and ``g_loss`` under ``wgan`` equal
    the reference's (losses.py:22-42) to rtol 1e-6; an unknown loss raises."""
    logits = np.random.default_rng(2).standard_normal((2, 5, 5, 1)).astype(np.float32)
    t = torch.from_numpy(logits)
    for port_fn, jax_fn in ((losses.d_loss_real, jax_losses.d_loss_real),
                            (losses.d_loss_fake, jax_losses.d_loss_fake),
                            (losses.g_loss, jax_losses.g_loss)):
        np.testing.assert_allclose(float(port_fn("wgan", t)),
                                   float(jax_fn("wgan", jnp.asarray(logits))), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.g_loss("ralsgan", t)


def test_train_args_accept_the_options_and_refuse_the_rest():
    """``check_train_args`` takes every option of this file and multi-image
    data; it refuses the other discriminators with the reference's
    ``ValueError`` (the zoo is not wired into training), and flag values
    no model or dataset takes. ``--gp_weight`` parses with the reference's
    default."""
    for flags in CASES.values():
        check_train_args(prepare_parser().parse_args(TINY + flags))
    check_train_args(prepare_parser().parse_args(TINY + ["--data", "multiple_images"]))
    args = prepare_parser().parse_args(TINY)
    assert args.gp_weight == 10.0 == jax_parser().parse_args([]).gp_weight
    with pytest.raises(ValueError, match="only patch_GAN is wired"):
        check_train_args(prepare_parser().parse_args(TINY + ["--D_model", "residual_GAN"]))
    for bad in (["--loss", "ralsgan"], ["--norm_layer_D", "layer"], ["--disc_iters", "0"],
                ["--data", "video"]):
        with pytest.raises(ValueError):
            check_train_args(prepare_parser().parse_args(TINY + bad))
    with pytest.raises(ValueError):
        PatchDiscriminator(base_ch=8, n_layers_D=2, norm_layer="layer")


CKPT_FLAGS = ["--norm_layer_D", "batch", "--spec_norm_G", "--chw_tail", "on"]


@pytest.fixture(scope="module")
def ckpt_case(tmp_path_factory):
    """JAX's state after one step with D's BatchNorms and SN in G, written
    by JAX's ``save_checkpoint``; JAX's second step on the same crops."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jargs = jax_parser().parse_args(TINY + CKPT_FLAGS)
    G, D = JaxG(**jax_g_kwargs(jargs)), JaxD(**jax_d_kwargs(jargs))
    state, tx_G, tx_D = jax_create(G, D, jargs, jax.random.key(0), 2)
    step = make_train_step(G, D, tx_G, tx_D, loss_type="standard", smooth=True, disc_iters=1,
                           num_images=2, use_ema=True)
    state1, _ = step(state, jnp.asarray(_real(0)), jax.random.key(1))
    path = str(tmp / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, {
        "meta": {"epoch": 1, "args": dict(vars(jargs)), "seed": 0, "Gloss": [0.5], "Dloss": [1.0]},
        "netG_variables": {"params": state1.params_G, **state1.aux_G},
        "netD_variables": {"params": state1.params_D, **state1.aux_D},
        "opt_G": state1.opt_G, "opt_D": state1.opt_D, "ema": state1.ema})
    s1 = np_tree({"aux_G": state1.aux_G, "aux_D": state1.aux_D, "ema": state1.ema})
    key2 = jax.random.key(2)
    state2, metrics2 = step(state1, jnp.asarray(_real(5)), key2)
    return dict(tmp=tmp, path=path, jargs=jargs, G=G, D=D, s1=s1, key2=key2,
                state2=state2, metrics2=metrics2,
                exact2=lambda: jax_step64(jargs, _real(5), key2, ckpt_path=path))


def test_port_resumes_jax_checkpoint_with_d_stats_and_g_spectral(ckpt_case):
    """The port restores JAX's ``.ckpt`` in place: D's ``batch_stats`` into
    its BatchNorms' buffers, G's ``spectral`` vectors into its SN convs,
    the EMA (no SN vectors on either side); then the port's second step on
    JAX's draws is held to JAX's second step as the option steps are
    (Adam's second step: a noise leaf moves by at most lr·sqrt(1 + beta2)
    on each side)."""
    c = ckpt_case
    targs = prepare_parser().parse_args(TINY + CKPT_FLAGS + ["--device", "cpu"])
    st = create_train_state(targs, 1, "cpu", seed=5)
    ptrs = {k: v.data_ptr() for k, v in st.D.state_dict().items()}
    ptrs.update({f"G.{k}": v.data_ptr() for k, v in st.G.state_dict().items()})
    assert checkpoint.restore_train_state(st, checkpoint.load_checkpoint(c["path"]), 1) == 1
    want_d = from_jax_variables({"batch_stats": c["s1"]["aux_D"]["batch_stats"]})
    assert set(want_d) == {"norm1.mean", "norm1.var"}
    for k, v in want_d.items():
        assert torch.equal(st.D.state_dict()[k], v), k
    want_g = from_jax_variables({"spectral": c["s1"]["aux_G"]["spectral"]}, spectral=True)
    assert "start.conv.u" in want_g and "attention.attn.theta.v" in want_g
    for k, v in want_g.items():
        assert torch.equal(st.G.state_dict()[k], v), k
    for k, v in st.D.state_dict().items():
        assert v.data_ptr() == ptrs[k], k  # restored in place
    for k, v in st.G.state_dict().items():
        assert v.data_ptr() == ptrs[f"G.{k}"], k
    assert set(st.ema) == set(from_jax_variables(c["s1"]["ema"]))
    before, d_params = {k: v.clone() for k, v in st.G.state_dict().items()}, {}
    with g_pass_on_reference_d(st, c["state2"], 1, d_params):
        m = port_step(st, targs, jax_draws(c["key2"], c["jargs"]), _real(5))
    assert_step_matches(c["state2"], c["metrics2"], st, m, before,
                        noise_move=2 * LR * ADAM_MOVES[1], exact=c["exact2"],
                        element_noise=True, d_params=d_params)


def test_jax_resumes_port_checkpoint_with_d_stats_and_g_spectral(ckpt_case, tmp_path):
    """The port's ``.ckpt`` after a step has JAX's tree (keys, shapes,
    dtypes), D's ``batch_stats`` and G's ``spectral`` included and an EMA
    of ``params`` and ``batch_stats`` only; JAX restores a train state from
    it with the port's values; a fresh port state resumes from it with D's
    BatchNorm statistics; and the sampling loader rebuilds its generator SN
    off (the raw weights, as the reference's does)."""
    c = ckpt_case
    targs = prepare_parser().parse_args(TINY + CKPT_FLAGS + ["--device", "cpu"])
    st = create_train_state(targs, 1, "cpu", seed=5)
    checkpoint.restore_train_state(st, checkpoint.load_checkpoint(c["path"]), 1)
    port_step(st, targs, jax_draws(c["key2"], c["jargs"]), _real(5))
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, train_loop.checkpoint_payload(st, targs, 2, 0, [0.5, 0.4],
                                                                   [1.0, 0.9]))
    got = jax_ckpt.load_checkpoint(path)
    ref_path = str(tmp_path / "jax.ckpt")
    s2 = c["state2"]
    jax_ckpt.save_checkpoint(ref_path, {
        "meta": {"epoch": 2}, "netG_variables": {"params": s2.params_G, **s2.aux_G},
        "netD_variables": {"params": s2.params_D, **s2.aux_D},
        "opt_G": s2.opt_G, "opt_D": s2.opt_D, "ema": s2.ema})
    ref = jax_ckpt.load_checkpoint(ref_path)
    body = lambda t: {k: v for k, v in t.items() if k != "meta"}  # noqa: E731
    shape = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.shape(a), np.asarray(a).dtype.name), body(t))
    assert shape(got) == shape(ref)
    assert set(got["ema"]) == {"params", "batch_stats"}
    assert "spectral" in got["netG_variables"] and "batch_stats" in got["netD_variables"]

    template, _, _ = jax_create(c["G"], c["D"], c["jargs"], jax.random.key(0), 1)
    restored, epoch = jax_ckpt.restore_train_state(template, got, 1)
    assert epoch == 2
    np.testing.assert_array_equal(np.asarray(restored.aux_D["batch_stats"]["norm1"]["var"]),
                                  st.D.norm1.var.numpy())
    np.testing.assert_array_equal(np.asarray(restored.aux_G["spectral"]["start"]["conv"]["u"]),
                                  st.G.start.conv.u.numpy())

    fresh = create_train_state(targs, 1, "cpu", seed=9)
    assert checkpoint.restore_train_state(fresh, checkpoint.load_checkpoint(path), 1) == 2
    for k, v in st.D.state_dict().items():
        assert torch.equal(fresh.D.state_dict()[k], v), k
    for k, v in st.G.state_dict().items():
        assert torch.equal(fresh.G.state_dict()[k], v), k

    gen, args = checkpoint.load_generator_from_checkpoint(path, device="cpu")
    assert args.spec_norm_G and not gen.SN and gen.emits_chw()
    assert not any(k.endswith((".u", ".v")) for k in gen.state_dict())
    torch.testing.assert_close(gen.start.conv.weight, st.G.start.conv.weight, rtol=0, atol=0)


@pytest.fixture(scope="module")
def texture(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("tex") / "tex.png"
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--loss", "wgan", "--gp_weight", "10", "--disc_iters", "2", "--norm_layer_D", "instance"],
    ["--spec_norm_G"]], ids=["wgan_di2_instance", "spec_norm_G"])
def test_train_cli_option_epoch_samples(texture, tmp_path, flags):
    """One tiny epoch (2 steps) of the train CLI on the CPU with the
    options: finite losses; the epoch's D loss is the reference loop's
    (each step's D losses, summed over its D iterations, weighted by the
    fake and real batches) to rtol 1e-6; the checkpoint stores the flags,
    G's Adam count is the steps and D's the D updates (disc_iters a step, as
    JAX's optax count); the sample CLI renders from the EMA checkpoint."""
    from PIL import Image

    from infinite_texture_gans_torch import sample

    out = tmp_path / "run"
    args = prepare_parser().parse_args(TINY + flags + [
        "--data_path", texture, "--data_ext", "png", "--device", "cpu", "--seed", "3",
        "--epochs", "1", "--saving_rate", "1", "--fname", str(out)])
    steps = []
    _, g_losses, d_losses = train_loop.train(args, step_callback=lambda e, i, m: steps.append(
        {k: float(v) for k, v in m.items()}))
    assert len(steps) == 2 and all(np.isfinite(v) for s in steps for v in s.values())
    d_epoch = sum(s["d_loss_fake"] * 2 + s["d_loss_real"] * 4 for s in steps) / (4 * 2)
    assert d_losses[0] == pytest.approx(d_epoch, rel=1e-6)
    plot = ["1_losses.png"] if importlib.util.find_spec("matplotlib") else []
    assert sorted(os.listdir(out)) == ["1_1.ckpt", "1__ema.ckpt"] + plot
    ck = checkpoint.load_checkpoint(str(out / "1_1.ckpt"))
    for flag in ("loss", "gp_weight", "disc_iters", "norm_layer_D", "spec_norm_G"):
        assert ck["meta"]["args"][flag] == getattr(args, flag), flag
    assert int(ck["opt_G"]["0"]["count"]) == 2
    assert int(ck["opt_D"]["0"]["count"]) == 2 * args.disc_iters
    assert ("spectral" in ck["netG_variables"]) == args.spec_norm_G
    sample.main(["--model_path", str(out / "1__ema.ckpt"), "--output_resolution_height", "80",
                 "--output_resolution_width", "72", "--output_name", "c.png", "--device", "cpu"])
    img = np.asarray(Image.open(out / "c.png"))
    assert img.shape == (80, 72, 3) and img.std() > 0
