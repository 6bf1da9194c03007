"""The port's public surface against the JAX package's, name for name, and
the last public functions against JAX's.

Every public top-level ``def`` and ``class`` of every module of the JAX
package (read with ``ast``, not imported), and every name an ``__init__``
exports, resolves in the port's mirror module under the same name, or
stands in ``COUNTERPARTS`` (a port name of another spelling or place) or in
``NO_COUNTERPART`` (JAX or flax plumbing, with the reason). The mirror is
the same path in ``infinite_texture_gans_torch``, except that the Pallas
modules map to the files of their CUDA kernels' wrappers."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import grid as jax_grid
from infinite_texture_gans_tpu.train import losses as jax_losses
from infinite_texture_gans_torch.ops import grid
from infinite_texture_gans_torch.train import losses
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "infinite_texture_gans_tpu"
MIRROR = {"ops/pallas_conv.py": "ops/kernels.py", "ops/pallas_ssm.py": "ops/ssm.py"}
JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]

_K = "infinite_texture_gans_torch.ops.kernels"
_S = "infinite_texture_gans_torch.ops.ssm"
_STEP = "infinite_texture_gans_torch.train.train_step"
_DATA = "infinite_texture_gans_torch.data.datasets"

#: "<JAX module>:<name>" -> "<port module>:<attribute path>", for a name the
#: port keeps under another spelling or in another module
COUNTERPARTS = {
    "config.py:prepare_sample_parser": "infinite_texture_gans_torch.sample:prepare_sample_parser",
    "config.py:apply_platform": "infinite_texture_gans_torch:resolve_device",  # --device
    # the in-jit bodies of the device samplers: their methods and functions
    "data/datasets.py:sample_crops_body": f"{_DATA}:DeviceCropSampler.sample",
    "data/datasets.py:broadcast_norm_body": f"{_DATA}:DeviceCropSampler.sample",
    "data/datasets.py:sample_multi_crops_body": f"{_DATA}:sample_multi_crops",
    "data/datasets.py:pick_images_body": f"{_DATA}:pick_images",
    # conv0 is an ops.conv.Conv whose tensors PatchDiscriminator.forward
    # hands to the stem kernel
    "models/discriminator.py:StemConv4x4": f"{_K}:conv4x4s2_stem_chw",
    "ops/conv.py:sn_kernel": "infinite_texture_gans_torch.ops.conv:spectral_normalize",
    "ops/conv.py:conv4x4": "infinite_texture_gans_torch.ops.conv:Conv",  # kernel_size 4
    # the port's wrappers take true widths (no 128-lane padded carry) and
    # return the statistics under want_stats
    "ops/pallas_conv.py:conv3x3_chw_stats": f"{_K}:conv3x3_chw",
    "ops/pallas_conv.py:conv3x3_chw_p": f"{_K}:conv3x3_chw",
    "ops/pallas_conv.py:conv1x1_chw_p": f"{_K}:conv1x1_chw",
    "ops/pallas_conv.py:conv1x1_chw_add_p": f"{_K}:conv1x1_chw_add",
    "ops/pallas_conv.py:conv1x1_chw_add_stats": f"{_K}:conv1x1_chw_add",
    "ops/pallas_conv.py:upsample2_chw_p": f"{_K}:upsample2_chw",
    "ops/pallas_conv.py:upsample2_chw_add_p": f"{_K}:upsample2_chw_add",
    "ops/pallas_conv.py:upconv3x3_chw_p": f"{_K}:upconv3x3_chw",
    "ops/pallas_conv.py:conv4x4s2_stem": f"{_K}:conv4x4s2_stem_chw",
    "ops/pallas_conv.py:conv3x3_chw_reference": f"{_K}:conv3x3_chw_plain",
    "ops/pallas_ssm.py:ssm_embed_fwd_call": f"{_S}:ssm_embed",
    "ops/pallas_ssm.py:ssm_embed_chw_p": f"{_S}:ssm_embed",
    "ops/pallas_ssm.py:ssm_embed_bwd_call": f"{_S}:ssm_embed_bwd",
    "ops/pallas_ssm.py:ssm_embed_chw_reference": f"{_S}:ssm_embed_plain",
    "train/train_loop.py:prepare_device": "infinite_texture_gans_torch.config:train_device",
    "train/train_loop.py:prepare_models": f"{_STEP}:create_train_state",
    "train/train_step.py:make_train_step": f"{_STEP}:train_step",
    "train/train_step.py:make_train_superstep": f"{_STEP}:StepDispatch",
}

_XLA_CACHE = "XLA's persistent compilation cache; PyTorch keeps no compiled executables"
#: "<JAX module>:<name>" -> why the port has no such name
NO_COUNTERPART = {
    "__init__.py:host_cache_fingerprint": _XLA_CACHE,
    "__init__.py:host_cache_dir": _XLA_CACHE,
    "__init__.py:use_host_keyed_cache": _XLA_CACHE,
    "__init__.py:route_cache_for_backend": _XLA_CACHE,
    "__init__.py:cpu_cache_scope": _XLA_CACHE,
    "models/layers.py:RawConvParams": "declares flax parameters for the Pallas path; a torch "
                                      "Conv module holds the tensors the kernels read",
    "train/train_step.py:split_variables": "splits flax's variable collections; a torch Module "
                                           "keeps parameters and buffers apart itself",
    "train/train_step.py:host_key": "a JAX PRNG key committed to the host backend; the port "
                                    "draws from torch.Generator objects on the run's device",
}


def _tree(rel: str) -> ast.Module:
    return ast.parse((JAX_ROOT / rel).read_text())


def exported_names(rel: str) -> list:
    """An ``__init__``'s ``__all__``, else the names it imports."""
    tree = _tree(rel)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names if not (a.asname or a.name).startswith("_")]


def public_names(rel: str) -> list:
    names = [node.name for node in _tree(rel).body
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
             and not node.name.startswith("_")]
    return names + (exported_names(rel) if rel.endswith("__init__.py") else [])


def port_module(rel: str) -> str:
    parts = MIRROR.get(rel, rel)[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["infinite_texture_gans_torch", *parts])


def resolve(target: str):
    module, attrs = target.split(":")
    obj = importlib.import_module(module)
    for attr in attrs.split("."):
        obj = getattr(obj, attr)
    return obj


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(rel):
    port = importlib.import_module(port_module(rel))
    missing = []
    for name in public_names(rel):
        key = f"{rel}:{name}"
        if key in NO_COUNTERPART:
            continue
        if key in COUNTERPARTS:
            assert callable(resolve(COUNTERPARTS[key])), key
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{port.__name__} lacks {missing} (JAX {rel})"


def test_tables_name_real_gaps():
    """Every entry names a public name of its JAX module that the mirror
    lacks under that name, and every reason is given."""
    for key in [*COUNTERPARTS, *NO_COUNTERPART]:
        rel, name = key.split(":")
        assert name in public_names(rel), f"{key}: not a public name of the JAX module"
        assert not hasattr(importlib.import_module(port_module(rel)), name), (
            f"{key}: the port has it under its own name; drop the entry")
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)
    assert all(len(reason) > 20 for reason in NO_COUNTERPART.values())


@pytest.mark.parametrize("rel", JAX_INITS)
def test_subpackage_exports_jax_names(rel):
    port = importlib.import_module(port_module(rel))
    want = exported_names(rel)
    assert set(want) <= set(port.__all__), sorted(set(want) - set(port.__all__))
    for name in port.__all__:
        getattr(port, name)


def test_subpackage_imports_load_no_jax_cuda_or_triton():
    lines = ["import sys"]
    for rel in JAX_INITS:
        lines.append(f"from {port_module(rel)} import {', '.join(exported_names(rel))}")
    lines += [
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'infinite_texture_gans_tpu'))",
        "assert not bad, bad",
        "from infinite_texture_gans_torch.ops import _build",
        "assert _build.library.cache_info().currsize == 0",
    ]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", "\n".join(lines)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["infinite_texture_gans_torch.train.train_loop",
                                    "infinite_texture_gans_torch.utils.quality",
                                    "infinite_texture_gans_torch.sample"])
def test_module_entry_points_run_once(module):
    """``python -m`` of a CLI module: its package's ``__init__`` must not
    import it first (Python warns and runs it twice)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "RuntimeWarning" not in res.stderr, res.stderr
    assert "usage:" in res.stdout


# -- the last public functions against JAX's ----------------------------------

@pytest.mark.parametrize("n,h,w,c,ch,cw,stride", [
    (2, 8, 8, 3, 4, 4, 4),    # non-overlapping
    (1, 6, 6, 1, 4, 4, 2),    # overlapping (tests/test_ops.py's case)
    (2, 10, 14, 3, 4, 6, 2),  # non-square windows and image
    (2, 11, 13, 2, 4, 4, 3),  # windows that do not tile the image
])
def test_crop_images_equals_jax(n, h, w, c, ch, cw, stride):
    x = np.random.default_rng(0).standard_normal((n, h, w, c)).astype(np.float32)
    want = np.asarray(jax_grid.crop_images(jnp.asarray(x), ch, cw, stride))
    got = grid.crop_images(torch.from_numpy(x), ch, cw, stride)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_image_equals_jax():
    x = np.random.default_rng(1).standard_normal((9, 12, 3)).astype(np.float32)
    want = np.asarray(jax_grid.crop_image(jnp.asarray(x), 3, 4, 2))
    got = grid.crop_image(torch.from_numpy(x), 3, 4, 2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,cols", [(3, 3), (2, 4)])
def test_merge_patches_into_image_equals_jax(rows, cols):
    p = np.random.default_rng(2).standard_normal((2 * rows * cols, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jax_grid.merge_patches_into_image(jnp.asarray(p), rows, cols))
    got = grid.merge_patches_into_image(torch.from_numpy(p), rows, cols)
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_images_undoes_merge():
    """Stride equal to the window: crop_images inverts the merge exactly."""
    p = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 6, 6, 2)).astype(np.float32))
    merged = grid.merge_patches_into_image(p, 2, 4)
    assert torch.equal(grid.crop_images(merged, 6, 6, 6), p)


@pytest.mark.parametrize("margin", [1.0, 0.5])
def test_calc_ralsloss_G_equals_jax(margin):
    rng = np.random.default_rng(4)
    real, fake = (rng.standard_normal((4, 1, 5, 5)).astype(np.float32) for _ in range(2))
    want = float(jax_losses.calc_ralsloss_G(jnp.asarray(real), jnp.asarray(fake), margin))
    jr, jf = jax.grad(lambda r, f: jax_losses.calc_ralsloss_G(r, f, margin), (0, 1))(
        jnp.asarray(real), jnp.asarray(fake))
    r, f = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
    got = losses.calc_ralsloss_G(r, f, margin)
    got.backward()
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    for g, j in ((r.grad, jr), (f.grad, jf)):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-6, atol=1e-6 * np.abs(j).max())
