"""The discriminator zoo in the PyTorch port against the JAX package's:
``ResDiscriminator`` (unconditional with attention, and each of its four
conditioning methods), ``DCDiscriminator`` and ``SNDiscriminator`` on JAX's
variables, f32 on the CPU: the outputs, the gradients (every parameter and
the input), the updated SN vectors and BN statistics of one train-mode
forward with an SN refresh, within 1e-4 of each tensor's largest value (a
gradient leaf of rounding noise within 1e-4 of the model's largest
gradient; ``tests/test_zoo.py``'s claims beside); ``Dense``'s SN matrix; and the
train CLI's refusal of ``--D_model`` other than ``patch_GAN``, JAX's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.config import prepare_parser as jax_parser
from infinite_texture_gans_tpu.models import discriminator as jd
from infinite_texture_gans_tpu.ops.conv import spectral_normalize as jax_sn
from infinite_texture_gans_tpu.train.train_loop import prepare_models
from infinite_texture_gans_torch.config import check_train_args, prepare_parser
from infinite_texture_gans_torch.models import discriminator as pd
from infinite_texture_gans_torch.ops.conv import Dense, spectral_normalize
from infinite_texture_gans_torch.weights import from_jax_variables
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TOL = 1e-4
N_CLASSES = 5

CASES = {
    "res": (dict(base_ch=8, att=True, SN=True), 32, None),
    "res_concat": (dict(base_ch=8, SN=True, SN_y=True, n_classes=N_CLASSES,
                        cond_method="concat"), 64, "onehot"),
    "res_proj": (dict(base_ch=8, SN=True, SN_y=True, n_classes=N_CLASSES,
                      cond_method="proj"), 64, "onehot"),
    "res_conv1x1": (dict(base_ch=8, SN=True, SN_y=True, n_classes=N_CLASSES,
                         cond_method="conv1x1"), 64, "map"),
    "res_conv3x3": (dict(base_ch=8, att=True, SN=True, n_classes=N_CLASSES,
                         cond_method="conv3x3"), 64, "map"),
    "dc": (dict(base_ch=8, n_layers=3), 64, None),
    "sn": (dict(base_ch=8, SN=True), 64, None),
}


def _models(case):
    kw, _, _ = CASES[case]
    if case.startswith("res"):
        return jd.ResDiscriminator(**kw), pd.ResDiscriminator(**kw)
    if case == "dc":
        return jd.DCDiscriminator(**kw), pd.DCDiscriminator(**kw)
    return jd.SNDiscriminator(**kw), pd.SNDiscriminator(**kw)


def _inputs(case, n=2):
    _, size, ykind = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    y = None
    if ykind == "onehot":
        y = np.eye(N_CLASSES, dtype=np.float32)[[1, 3]]
    elif ykind == "map":  # the block-4 output's size: 64 -> 32 -> 16 -> 8 -> 4
        y = rng.standard_normal((n, 16)).astype(np.float32)
    return x, y


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# a gradient leaf below this share of the model's largest gradient is
# rounding noise (zero in exact arithmetic: the attention's phi bias shifts
# every score of a softmax row alike), held to TOL of that largest instead
NOISE_SHARE = 1e-6


def _close(got: torch.Tensor, want, name, model_top=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    top = float(np.abs(want).max())
    if top < NOISE_SHARE * model_top:
        top = model_top
    err = float(np.abs(got - want).max())
    assert err <= TOL * top, f"{name}: max abs err {err:.3e} > {TOL} x {top:.3e}"


@pytest.fixture(scope="module", params=list(CASES))
def zoo_case(request):
    """JAX's init (attention gates opened), one train-mode forward with an
    SN refresh, its output, gradients and updated collections."""
    case = request.param
    jmod, _ = _models(case)
    x, y = _inputs(case)
    args = (jnp.asarray(x),) + ((jnp.asarray(y),) if y is not None else ())
    init_kw = {} if case == "sn" else {"train": True}
    v = _np(dict(jax.jit(lambda *a: jmod.init(jax.random.key(1), *a, **init_kw))(*args)))
    for node in (v["params"], v["params"].get("attention")):
        if node is not None and "gamma" in node:
            node["gamma"] = np.float32(0.5)
    rest = {k: c for k, c in v.items() if k != "params"}
    apply_kw = dict(init_kw, update_sn=True, mutable=["spectral", "batch_stats"])
    wts = np.random.default_rng(3).standard_normal(jax.eval_shape(
        lambda *a: jmod.apply(v, *a, **apply_kw)[0], *args).shape).astype(np.float32)

    def loss(params, x, *y):
        out, upd = jmod.apply({"params": params, **rest}, x, *y, **apply_kw)
        return jnp.sum(out * wts), (out, upd)

    (_, (out, upd)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], *args)
    return case, v, x, y, wts, np.asarray(out), _np(upd), _np(g_params), np.asarray(g_x)


def test_zoo_matches_jax(zoo_case):
    case, v, x, y, wts, out, upd, g_params, g_x = zoo_case
    _, port = _models(case)
    port.load_state_dict(from_jax_variables(v, spectral=True), strict=True)
    port.train()
    xt = torch.from_numpy(x).requires_grad_()
    args = (xt,) + ((torch.from_numpy(y),) if y is not None else ())
    got = port(*args, update_sn=True)
    (got * torch.from_numpy(wts)).sum().backward()
    _close(got, out, "output")
    _close(xt.grad, g_x, "dx")
    want_grads = from_jax_variables({"params": g_params})
    params = dict(port.named_parameters())
    assert params.keys() == want_grads.keys()
    model_top = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in params.items():
        _close(p.grad, want_grads[name], f"d {name}", model_top)
    want_state = from_jax_variables(upd, spectral=True)
    state = port.state_dict()
    assert want_state and set(want_state) <= set(state)
    for name, t in want_state.items():
        _close(state[name], t, name)
    # tests/test_zoo.py's claims
    if case.startswith("res"):
        assert tuple(got.shape) == (2, 1)
        if y is not None:  # the conditioning branch's own gradient: finite, nonzero
            emb = [p.grad for n, p in params.items() if n.startswith("embed_y.")]
            assert emb and max(float(g.abs().max()) for g in emb) > 0
    elif case == "dc":
        assert got.dim() == 1 and got.shape[0] == 2 * 3
    else:
        assert tuple(got.shape) == (2, 1)


def test_dense_spectral_norm_matches_jax():
    """Dense's SN matrix is its (out, in) weight, JAX's ``kernel.reshape(-1,
    O).T`` of the (in, out) kernel: sigma, the refreshed u and v agree."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((24, 7)).astype(np.float32)  # flax (in, out)
    u = rng.standard_normal(7).astype(np.float32)
    v = rng.standard_normal(24).astype(np.float32)
    wk, ju, jv = jax_sn(jnp.asarray(k), jnp.asarray(u), jnp.asarray(v), True)
    d = Dense(24, 7, sn=True)
    d.load_state_dict(from_jax_variables({"params": {"kernel": k, "bias": np.zeros(7, np.float32)},
                                          "spectral": {"u": u, "v": v}}, spectral=True))
    w, pu, pv = spectral_normalize(d.weight, d.u, d.v, True)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(wk).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    np.testing.assert_allclose(d(torch.from_numpy(x), update_sn=True).detach().numpy(),
                               x @ np.asarray(wk), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["res", "residual_GAN", "DC"])
def test_train_refuses_other_discriminators_as_jax(model):
    """``--D_model`` other than patch_GAN: JAX's ``ValueError``, word for word."""
    with pytest.raises(ValueError) as want:
        prepare_models(jax_parser().parse_args(["--D_model", model]))
    with pytest.raises(ValueError) as got:
        check_train_args(prepare_parser().parse_args(["--D_model", model, "--device", "cpu"]))
    assert str(got.value) == str(want.value)


def test_zoo_rejects_bad_conditioning():
    with pytest.raises(ValueError):
        pd.ResDiscriminator(base_ch=8, n_classes=3, cond_method="bilinear")
    d = pd.ResDiscriminator(base_ch=8, n_classes=3)
    with pytest.raises(ValueError, match="y is required"):
        d(torch.zeros(1, 64, 64, 3))
