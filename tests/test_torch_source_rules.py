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
                                            ROOT / "zoo_precision_study.py",
                                            ROOT / "f32_route_study.py"]


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
        "import zoo_precision_study, f32_route_study\n"
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
    assert names == {"conv3x3_fwd_f32", "conv3x3_chw_bwd", "conv1x1_chw", "conv1x1_dw_f32",
                     "upsample2_chw", "stem_dx_f32", "ssm_embed_chw", "ssm_embed_tc",
                     "chw_dx_tc", "chw_dw_tc", "chw_fwd_tc", "stem_fwd_tc", "upconv_fwd_tc",
                     "conv1x1_tc", "upconv_dw_tc", "stem_dw_tc", "stem_dx_tc", "upconv_dx_f32",
                     "stem_fwd_f32", "conv3x3_dx_f32", "conv3x3_dw_f32", "upconv_fwd_f32",
                     "upconv_dw_f32", "stem_dw_f32"}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        site = "pallas_ssm.py" if src.stem.startswith("ssm_embed") else "pallas_conv.py"
        assert site in text and "bound" in text, src.name


def test_upsample2_source_has_no_atomics():
    """K4, K4's adjoint and K10 sum in fixed orders: two calls give the same
    bits (K10's statistics by per-block partials and a last launch)."""
    text = (PACKAGE / "csrc" / "upsample2_chw.cu").read_text()
    assert "atomicAdd" not in text and "block_sum2_atomic" not in text


# The float32 routes redesigned for the H100: K9 dx and K13's forward, K3-dW
# and K1/K2 (with K5's sums), K6 and K7, K9's forward (with K14) and K9 dW,
# K13 dW, each in a source of its own (K15's backward stays in
# ssm_embed_chw.cu beside its forward);
# (source, C entry point, the source that held the old body, pallas_call site)
F32_REDESIGNED = [
    ("upconv_dx_f32", "itg_upconv3x3_chw_dx", "upconv3x3_chw", "pallas_conv.py:1642"),
    ("stem_fwd_f32", "itg_stem_fwd", "stem_dx_f32", "pallas_conv.py:2769"),
    ("conv1x1_dw_f32", "itg_conv1x1_chw_dw", "conv1x1_chw", "pallas_conv.py:2361"),
    ("conv3x3_fwd_f32", "itg_conv3x3_chw", "conv3x3_chw", "pallas_conv.py:395"),
    ("conv3x3_dx_f32", "itg_conv3x3_chw_dx", "conv3x3_chw_bwd", "pallas_conv.py:775"),
    ("conv3x3_dw_f32", "itg_conv3x3_chw_dw", "conv3x3_chw_bwd", "pallas_conv.py:888"),
    ("upconv_fwd_f32", "itg_upconv3x3_chw", "upconv3x3_chw", "pallas_conv.py:1457"),
    ("upconv_dw_f32", "itg_upconv3x3_chw_dw", "upconv3x3_chw", "pallas_conv.py:1777"),
    ("stem_dw_f32", "itg_stem_dw", "stem_dx_f32", "pallas_conv.py:2840"),
]
# old sources that held nothing but the replaced bodies, deleted with them
F32_OLD_DELETED = {"conv3x3_chw", "upconv3x3_chw"}


# K15's float32 backward, redesigned in place beside its forward
K15_BWD = ("ssm_embed_chw", "itg_ssm_embed_bwd", None, "pallas_ssm.py:392")
# K15's float32 forward and K13 dx, redesigned in place in their sources
K15_FWD = ("ssm_embed_chw", "itg_ssm_embed_fwd", None, "pallas_ssm.py:343")
K13_DX = ("stem_dx_f32", "itg_stem_dx", None, "pallas_conv.py:2977")
IN_PLACE = [K15_BWD, K15_FWD, K13_DX]


@pytest.mark.parametrize("src, entry, old, site", F32_REDESIGNED + IN_PLACE,
                         ids=[r[0] for r in F32_REDESIGNED]
                         + ["ssm_embed_chw", "ssm_embed_chw_fwd", "stem_dx_f32"])
def test_f32_redesigned_sources_target_sm90a(src, entry, old, site):
    """Each redesigned float32 kernel is its own source (K15's backward
    and forward share one; K13 dx was redesigned in its own), built with the
    rest for sm_90a, names the TPU kernel it replaces and its bound on the
    H100, and defines its C entry point; the old body's source no longer
    does, or is gone where it held nothing else."""
    from infinite_texture_gans_torch.ops import _build

    path = _build.CSRC / f"{src}.cu"
    assert path in set(_build.CSRC.glob("*.cu"))
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.FLAGS
    text = path.read_text()
    assert site in text and "What bounds it on the H100" in text
    assert f'extern "C" int {entry}(' in text
    if old is None:
        return
    old_path = _build.CSRC / f"{old}.cu"
    if old in F32_OLD_DELETED:
        assert not old_path.exists()
    else:
        assert f'extern "C" int {entry}(' not in old_path.read_text()


@pytest.mark.parametrize("src", [r[0] for r in F32_REDESIGNED] + ["ssm_embed_chw", "stem_dx_f32"])
def test_f32_redesigned_sources_have_no_atomics(src):
    """K9 dx's and K6's float32 sums (d(scale), d(shift)), K3-dW's, K7's,
    K9's and K13's dW and db, K15's dW2, db2, dW1 and db1 and K5's and K9's
    Σy and Σy² are per-block partials added in a fixed order, and K13's,
    K1's, K9's and K15's forwards and K13 dx sum each output in one order:
    two calls give the same bits."""
    text = (PACKAGE / "csrc" / f"{src}.cu").read_text()
    assert "atomicAdd" not in text and "block_sum2_atomic" not in text


def test_bwd_source_keeps_only_bn_corr():
    """K6's and K7's old bodies left csrc/conv3x3_chw_bwd.cu with their
    redesigns; K8 (bn_corr) stays there, and its header speaks of K8 alone."""
    text = (PACKAGE / "csrc" / "conv3x3_chw_bwd.cu").read_text()
    assert 'extern "C" int itg_bn_corr(' in text
    assert "conv3x3_dx_kernel" not in text and "conv3x3_dw_kernel" not in text
    assert "atomicAdd" not in text and "block_sum2_atomic" not in text
    assert "pallas_conv.py:1061" in text and "pallas_conv.py:775" not in text


def test_stem_dx_source_keeps_only_dx():
    """K13 dW's float32 body left the stem's old source with its redesign,
    which was renamed for what stays: csrc/stem_dx_f32.cu holds K13 dx alone,
    its header speaks of dx's TPU kernel, and the old name is gone."""
    text = (PACKAGE / "csrc" / "stem_dx_f32.cu").read_text()
    assert 'extern "C" int itg_stem_dx(' in text and "itg_stem_dw" not in text
    assert "stem_dw_kernel" not in text and "atomicAdd" not in text
    assert "pallas_conv.py:2977" in text and "pallas_conv.py:2840" not in text
    assert not (PACKAGE / "csrc" / "stem4x4s2.cu").exists()


def test_upconv_fwd_f32_source_serves_k14():
    """K9's float32 forward and K14 (the raster form, given the cached
    half-res borders) are one body: the source names both TPU kernels, and
    the old source of both (with K9 dW) is gone."""
    text = (PACKAGE / "csrc" / "upconv_fwd_f32.cu").read_text()
    assert "pallas_conv.py:1457" in text and "pallas_conv.py:2019" in text
    assert not (PACKAGE / "csrc" / "upconv3x3_chw.cu").exists()
