"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
the first CUDA launch (never at import: the CPU tests import every module),
one ``nvcc`` per source, all started together, into ``build/`` beside the
package. The library's name carries a digest of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused. ``nvcc``'s
output, including ``-Xptxas -v`` (registers, shared memory and spills per
kernel), is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x, w, b, scale, shift, top, left, y, part, s1, s2, n, c, h, w, co, relu, zeros, bf16, to,
    # g, stream
    "itg_conv3x3_chw": [_P] * 11 + [_I] * 10 + [_P],
    # x, w, b, scale, shift, top, left, wp, y, part, s1, s2, n, c, h, w, co, relu, zeros, nc, no,
    # stream (bf16 only)
    "itg_conv3x3_chw_tc": [_P] * 12 + [_I] * 9 + [_P],
    # x, g, w, scale, shift, dx, part, dscale, dshift, n, c, h, w, co, relu, zeros, bf16, cc,
    # groups, stream
    "itg_conv3x3_chw_dx": [_P] * 9 + [_I] * 10 + [_P],
    # x, g, scale, shift, part, dw, db, n, c, h, w, co, relu, zeros, bf16, blocks, slots, rows,
    # stream
    "itg_conv3x3_chw_dw": [_P] * 7 + [_I] * 11 + [_P],
    # x, g, scale, shift, part, dw, db, n, c, h, w, co, relu, zeros, mt, no, cap, stream (bf16
    # only)
    "itg_conv3x3_chw_dw_tc": [_P] * 7 + [_I] * 10 + [_P],
    # x, g, w, scale, shift, wp, dx, part, dscale, dshift, n, c, h, w, co, relu, zeros, nt, no,
    # cap, stream (bf16 only; the same for the up-conv's dx, h and w of x)
    "itg_conv3x3_chw_dx_tc": [_P] * 10 + [_I] * 10 + [_P],
    "itg_upconv3x3_chw_dx_tc": [_P] * 10 + [_I] * 10 + [_P],
    # g, y, alpha, beta2, out, planes, c, hw, bf16, stream
    "itg_bn_corr": [_P] * 5 + [_I] * 4 + [_P],
    # x, w, b, res, y, s1, s2, n, c, hw, co, bf16, stream
    "itg_conv1x1_chw": [_P] * 7 + [_I] * 5 + [_P],
    # x, g, part, dw, db, n, c, hw, co, bf16, blocks, stream
    "itg_conv1x1_chw_dw": [_P] * 5 + [_I] * 6 + [_P],
    # x, w, b, res, wp, y, part, s1, s2, n, c, hw, co, stream (bf16 only)
    "itg_conv1x1_chw_tc": [_P] * 9 + [_I] * 4 + [_P],
    # x, g, part, dw, db, n, c, hw, co, mt, no, cap, stream (bf16 only)
    "itg_conv1x1_chw_dw_tc": [_P] * 5 + [_I] * 7 + [_P],
    # x, y, planes, h, w, bf16, stream
    "itg_upsample2_chw": [_P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    # g, dx, planes, h, w (of dx), bf16, stream
    "itg_upsample2_chw_bwd": [_P, _P] + [_I] * 4 + [_P],
    # x, res, y, part, s1, s2, planes, c, h, w (of x), bx, by, rows, chunk, bf16, stream
    "itg_upsample2_chw_add": [_P] * 6 + [_I] * 9 + [_P],
    # x, w, b, scale, shift, top, left, wp, y, part, s1, s2, n, c, h, w (of x), co, relu, zeros,
    # bf16, to, g, stream
    "itg_upconv3x3_chw": [_P] * 12 + [_I] * 10 + [_P],
    # x, w, b, scale, shift, top, left, wp, y, part, s1, s2, n, c, h, w (of x), co, relu, zeros,
    # nc, no, stream (bf16 only)
    "itg_upconv3x3_chw_tc": [_P] * 12 + [_I] * 9 + [_P],
    # x, g, w, scale, shift, wq, dx, part, dscale, dshift, n, c, h, w (of x), co, relu, zeros,
    # bf16, cc, groups, tiles_h, tiles_w, stream
    "itg_upconv3x3_chw_dx": [_P] * 10 + [_I] * 12 + [_P],
    # x, g, scale, shift, part, dw, db, n, c, h, w (of x), co, relu, zeros, bf16, blocks, slots,
    # rows, stream
    "itg_upconv3x3_chw_dw": [_P] * 7 + [_I] * 11 + [_P],
    # x, g, scale, shift, part, dwc, db, n, c, h, w (of x), co, relu, zeros, mt, no, cap,
    # stream (bf16 only)
    "itg_upconv3x3_chw_dw_tc": [_P] * 7 + [_I] * 10 + [_P],
    # x, w, b, y, n, c, h, w, co, bf16, blocks, stream
    "itg_stem_fwd": [_P] * 4 + [_I] * 7 + [_P],
    # x, w, b, y, n, c, h, w, co, stream (bf16 only)
    "itg_stem_fwd_tc": [_P] * 4 + [_I] * 5 + [_P],
    # x, g, part, dw, db, n, c, h, w, co, bf16, blocks, slots, rows, stream
    "itg_stem_dw": [_P] * 5 + [_I] * 9 + [_P],
    # x, g, part, dw, db, n, c, h, w, co, cap, stream (bf16 only)
    "itg_stem_dw_tc": [_P] * 5 + [_I] * 6 + [_P],
    # g, w, dx, n, c, h, w, co, bf16, stream
    "itg_stem_dx": [_P] * 3 + [_I] * 6 + [_P],
    # g, w, wp, dx, n, c, h, w, co, stream (bf16 only)
    "itg_stem_dx_tc": [_P] * 4 + [_I] * 5 + [_P],
    # maps, w1, b1, w2, b2, y, n, md, hid, h, w, co, warps, stream (float32 only)
    "itg_ssm_embed_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # maps, w1, b1, w2, g, part1, part2, partb2, dw2, db2, dw1, db1, n, md, hid, h, w, co, s2,
    # rows2, stream (float32 only)
    "itg_ssm_embed_bwd": [_P] * 12 + [_I] * 8 + [_P],
    # maps, w1, b1, w2p, b2, y, n, md, hid, h, w, co, nt, stream
    "itg_ssm_embed_tc_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # maps, w1, b1, w2t, g, part1, part2, partb2, dw2, db2, dw1, db1, n, md, hid, h, w, co, s1,
    # s2, stream
    "itg_ssm_embed_tc_bwd": [_P] * 12 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME (/usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def build() -> Path:
    """Compile ``csrc/*.cu`` (in parallel) and link the shared library;
    returns its path. A library already built from the same sources is
    reused."""
    out = BUILD_DIR / f"libitg_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, FLAGS[0], "-shared", "-o", str(tmp_so)] + [str(o) for _, o, _ in jobs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
