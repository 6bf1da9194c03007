"""The port's train-mode generator and its discriminator against the JAX
reference on the CPU in float32, at the reference tests' tiny widths
(tests/test_train.py: G_ch 8, n_layers_G 4, so block 4 runs on the
channels-major tail; D_ch 8, n_layers_D 2 with spectral norm). The JAX side
runs its Pallas tail in interpret mode (``chw_tail='on', fuse_up='off'``).
Weights cross through ``weights.from_jax_variables``; inputs are numpy
arrays drawn from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.models.discriminator import PatchDiscriminator as JaxD
from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxG
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.weights import from_jax_variables

TINY_G = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=4, attention=True, img_ch=3)


def _tree(v):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(v)))


@pytest.fixture(scope="module")
def g_case():
    gen = JaxG(type_norm="BN", padding_mode="local", chw_tail="on", fuse_up="off", **TINY_G)
    z0 = jnp.zeros((1, 14, 14, 16))
    v = _tree(jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(z0))
    rng = np.random.default_rng(3)
    # running stats away from their (0, 1) init; attention gate on
    for bn in jax.tree_util.tree_leaves(v["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    v["params"]["attention"]["attn"]["gamma"] = np.float32(0.3)
    z = rng.standard_normal((2, 14, 14, 16)).astype(np.float32)
    return gen, v, z


def test_generator_train_forward_matches_jax(g_case):
    """Image (channels-major, out_chw) to 1e-4 and the updated running
    statistics to rtol 1e-5."""
    gen, v, z = g_case
    assert gen.emits_chw()
    (img, _), new = gen.apply(v, jnp.asarray(z), train=True, out_chw=True, mutable=["batch_stats"])
    port = ResidualPatchGenerator(**TINY_G)
    port.load_state_dict(from_jax_variables(v), strict=True)
    port.train()
    assert port.emits_chw()
    kernels.reset_launches()
    out, _ = port(torch.from_numpy(z), out_chw=True)
    assert out.shape == img.shape == (2, 3, 96, 96)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(img), atol=1e-4, rtol=0)
    want = from_jax_variables({"batch_stats": _tree(new)["batch_stats"]})
    state = port.state_dict()
    for k, ref in want.items():
        np.testing.assert_allclose(state[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def test_generator_train_nhwc_output_matches_chw(g_case):
    """out_chw only changes the layout of the same image."""
    gen, v, z = g_case
    port = ResidualPatchGenerator(**TINY_G)
    port.load_state_dict(from_jax_variables(v), strict=True)
    a, _ = port.train()(torch.from_numpy(z), out_chw=True)
    port.load_state_dict(from_jax_variables(v), strict=True)
    b, _ = port(torch.from_numpy(z))
    torch.testing.assert_close(a.permute(0, 2, 3, 1), b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def d_case():
    d = JaxD(base_ch=8, n_layers_D=2, kw=4, SN=True)
    v = _tree(jax.jit(lambda x: d.init(jax.random.key(1), x, train=True))(jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(4)
    return d, v, rng


@pytest.mark.parametrize("chw_in", [True, False])
def test_discriminator_matches_jax(d_case, chw_in):
    """Logits to 1e-4 and the spectral-norm vectors after the call to rtol
    1e-5: the channels-major fake through the K13 stem, the NHWC real
    crops through F.conv2d."""
    d, v, rng = d_case
    x = np.clip(rng.standard_normal((2, 48, 48, 3)), -1, 1).astype(np.float32)
    xin = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))) if chw_in else x
    logit, new = d.apply(v, jnp.asarray(xin), train=True, update_sn=True, chw_in=chw_in,
                         mutable=["spectral"])
    port = PatchDiscriminator(base_ch=8, n_layers_D=2, SN=True)
    port.load_state_dict(from_jax_variables(v, spectral=True), strict=True)
    kernels.reset_launches()
    got = port(torch.from_numpy(xin), update_sn=True, chw_in=chw_in)
    assert kernels.LAUNCHES["stem_fwd"] == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logit), atol=1e-4, rtol=0)
    for k, ref in from_jax_variables(_tree(new), spectral=True).items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
