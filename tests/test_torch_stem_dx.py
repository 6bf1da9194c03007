"""K13 dx (``kernels.stem_dx``), the stem's input gradient, against the JAX
reference's VJP of ``conv4x4s2_stem_chw`` (an RGB image: C = 3) on the CPU
in float32, at the shapes that the float32 kernel (csrc/stem_dx_f32.cu)
treats apart: odd Co (g staged element by element), Co past one 8-channel
chunk, and g grids that end inside or on the edge of a 16 x 32 tile. On the
CPU the wrapper takes its plain version; the kernel is held to that version
on the card at C from 1 to 4 as well (tests/test_torch_gpu.py,
chip_smoke.py). Tolerance: 1e-4 of the largest reference value (float32
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.ops import pallas_conv as pc
from infinite_texture_gans_torch.ops import kernels as tk
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

GRAD_TOL = 1e-4

# (N, C, H2, W2, Co): g (N, H2, W2, Co) -> dx (N, C, 2 H2, 2 W2)
SHAPES = [(1, 3, 3, 5, 1), (2, 3, 11, 15, 1), (1, 3, 7, 9, 100), (1, 3, 4, 6, 8),
          (3, 3, 5, 17, 64), (1, 3, 8, 40, 12), (2, 3, 9, 13, 7), (1, 3, 17, 33, 9),
          (1, 3, 1, 1, 16), (2, 3, 2, 34, 3), (1, 3, 16, 32, 10), (1, 3, 6, 3, 64)]


def _case(shape, seed=67):
    n, c, h2, w2, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, 2 * h2, 2 * w2)).astype(np.float32)
    k = (co ** -0.5 * rng.standard_normal((4, 4, c, co))).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    g = rng.standard_normal((n, h2, w2, co)).astype(np.float32)
    return x, k, b, g


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stem_dx_matches_jax(shape):
    """dx of the port's K13 (its wrapper on CPU tensors) is the reference's
    VJP within GRAD_TOL of its largest value, in g's dtype and shape."""
    x, k, b, g = _case(shape)
    _, vjp = jax.vjp(pc.conv4x4s2_stem_chw, *(jnp.asarray(a) for a in (x, k, b)))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    got = tk.stem_dx(torch.from_numpy(g), wt)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= GRAD_TOL * float(np.abs(ref).max()), err


@pytest.mark.parametrize("g_shape, w_shape, error, match", [
    ((1, 4, 4, 8), (8, 5, 4, 4), ValueError, "4-channel limit"),
    ((4, 4, 8), (8, 3, 4, 4), ValueError, "expected"),
    ((1, 4, 4, 8), (7, 3, 4, 4), ValueError, "w: shape"),
    ((1, 4, 4, 8), (8, 3, 3, 3), ValueError, "w: shape"),
    ((1, 4, 4, 8), (8, 3, 4, 4), TypeError, "dtype"),
])
def test_stem_dx_refuses(g_shape, w_shape, error, match):
    """C past 4, a g that is not (N, H2, W2, Co), a w that is not (Co, C, 4,
    4) and a g of another dtype than float32 or bfloat16 raise before any
    route is taken."""
    g = torch.zeros(g_shape, dtype=torch.float16 if error is TypeError else torch.float32)
    with pytest.raises(error, match=match):
        tk.stem_dx(g, torch.zeros(w_shape))
