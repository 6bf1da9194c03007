"""The PyTorch port's checkpoint reader and sample CLI: the pure-Python
msgpack decoder against flax, the trained flagship checkpoint through both
frameworks, and PNG output."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxGenerator
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.config import generator_kwargs
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.sampling.infinite import generate_canvas
from infinite_texture_gans_torch.train import checkpoint, msgpack
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


FLAGSHIP = os.path.join(os.path.dirname(__file__), "..", "examples", "241_300ep_ema.ckpt")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_decoder_matches_flax_on_every_type():
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "bf16": jnp.linspace(-3, 3, 10, dtype=jnp.bfloat16),
        "i64": np.array([-(2**40), 7], np.int64),
        "u8": np.arange(5, dtype=np.uint8),
        "scalar": np.float32(2.5),
        "nested": {"ints": [0, 127, 128, -1, -33, 2**16, -(2**31), 2**63 - 1],
                   "float": 1.25, "none": None, "flags": [True, False],
                   "str": "x" * 40, "bytes": b"\x00\xff" * 200},
    }
    blob = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(blob)
    got = msgpack.unpackb(blob)
    np.testing.assert_array_equal(got["f32"], ref["f32"])
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf16"].view(torch.uint16).numpy(), np.asarray(ref["bf16"]).view(np.uint16)
    )
    for key in ("i64", "u8"):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
    assert got["scalar"] == ref["scalar"] and got["nested"] == ref["nested"]
    with pytest.raises(ValueError):
        msgpack.unpackb(blob[:-3])


def test_flagship_checkpoint_bit_equal_to_flax():
    tree = checkpoint.load_checkpoint(FLAGSHIP)
    ref = jax_ckpt.load_checkpoint(FLAGSHIP)
    assert tree["meta"] == ref["meta"]
    got, want = dict(_flat(tree["netG_variables"])), dict(_flat(ref["netG_variables"]))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert got[path].dtype == a.dtype and got[path].shape == a.shape, path
        np.testing.assert_array_equal(got[path], a)


def test_flagship_one_pass_matches_jax():
    """The trained flagship (G_ch 52, n_layers_G 6, attention) one 3x3-grid
    forward in f32 in both frameworks. atol 1e-3: a 13-conv BN stack with
    trained weights accumulates more f32 rounding than the tiny nets."""
    ckpt = checkpoint.load_checkpoint(FLAGSHIP)
    gen, args = checkpoint.load_generator_from_checkpoint(FLAGSHIP, device="cpu", ckpt=ckpt)
    assert (args.G_ch, args.n_layers_G, args.attention) == (52, 6, True)
    assert gen.dtype == torch.bfloat16  # the checkpoint's compute dtype
    kwargs = {**generator_kwargs(args), "num_patches_h": 3, "num_patches_w": 3}
    gen32 = ResidualPatchGenerator(**{**kwargs, "dtype": torch.float32})
    gen32.load_state_dict(gen.state_dict(), strict=True)
    jgen, variables, _ = jax_ckpt.load_generator_from_checkpoint(FLAGSHIP)
    jgen = jgen.clone(dtype=jnp.float32)
    z = np.random.default_rng(0).standard_normal((1, 14, 14, 128)).astype(np.float32)
    ref, _ = jgen.apply(variables, jnp.asarray(z), train=False)
    with torch.no_grad():
        out, _ = gen32.eval()(torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)


def test_cuda_entry_point_never_falls_back_to_cpu():
    """Without device='cpu' the loader targets CUDA: it raises on a machine
    without a card instead of running on the CPU."""
    if torch.cuda.is_available():
        gen, _ = checkpoint.load_generator_from_checkpoint(FLAGSHIP)
        assert next(gen.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            checkpoint.load_generator_from_checkpoint(FLAGSHIP)


def _tiny_checkpoint(path):
    args = {"G_ch": 8, "z_dim": 16, "n_layers_G": 4, "attention": True,
            "padding_mode": "local", "compute_dtype": "float32"}
    gen = JaxGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True)
    v = jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(jnp.zeros((1, 14, 14, 16)))
    jax_ckpt.save_checkpoint(path, {
        "meta": {"args": args},
        "netG_variables": {"params": v["params"], "batch_stats": v["batch_stats"]},
    })


def test_sample_cli_writes_png(tmp_path):
    from PIL import Image

    ckpt = str(tmp_path / "tiny.ckpt")
    _tiny_checkpoint(ckpt)
    sample.main(["--model_path", ckpt, "--device", "cpu", "--output_name", "out.png",
                 "--output_resolution_height", "100", "--output_resolution_width", "70",
                 "--seed", "3", "--batch", "2"])
    imgs = [np.asarray(Image.open(tmp_path / n)) for n in ("out.png", "out_1.png")]
    gen, _ = checkpoint.load_generator_from_checkpoint(ckpt, device="cpu")
    want = generate_canvas(gen, torch.Generator().manual_seed(3), 100, 70,
                           num_images=2, wire="u8")
    for k, img in enumerate(imgs):
        np.testing.assert_array_equal(img, want[k])
    with pytest.raises(ValueError, match="unsupported mesh axis"):  # the reference's error
        sample.main(["--model_path", ckpt, "--device", "cpu", "--mesh", "1"])
