"""Rules of the PyTorch port's sources: no JAX, flax or reference-package
imports, importable on a machine without CUDA, kernels only built on use."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "infinite_texture_gans_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "infinite_texture_gans_tpu")


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "step_parity_study.py",
                                            ROOT / "k10_plan_study.py",
                                            ROOT / "graph_chunk_study.py",
                                            ROOT / "zoo_precision_study.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_cuda_or_jax():
    """Importing every module of the port (and the card scripts) loads no JAX
    module, builds nothing and needs no card."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import infinite_texture_gans_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, step_parity_study, k10_plan_study, graph_chunk_study\n"
        "import zoo_precision_study\n"
        f"bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "from infinite_texture_gans_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_cuda_sources_target_sm90a():
    from infinite_texture_gans_torch.ops import _build

    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.FLAGS
    names = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert names == {"conv3x3_chw", "conv3x3_chw_bwd", "conv1x1_chw", "upsample2_chw", "stem4x4s2",
                     "upconv3x3_chw", "ssm_embed_chw", "ssm_embed_tc", "chw_dx_tc", "chw_dw_tc",
                     "chw_fwd_tc", "stem_fwd_tc", "upconv_fwd_tc", "conv1x1_tc", "upconv_dw_tc",
                     "stem_dw_tc", "stem_dx_tc"}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        site = "pallas_ssm.py" if src.stem.startswith("ssm_embed") else "pallas_conv.py"
        assert site in text and "bound" in text, src.name


def test_upsample2_source_has_no_atomics():
    """K4, K4's adjoint and K10 sum in fixed orders: two calls give the same
    bits (K10's statistics by per-block partials and a last launch)."""
    text = (PACKAGE / "csrc" / "upsample2_chw.cu").read_text()
    assert "atomicAdd" not in text and "block_sum2_atomic" not in text
