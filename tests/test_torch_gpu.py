"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``; every test skips from the ``cuda`` fixture when no
card is present. Run them on the card with
``python -m pytest tests/test_torch_gpu.py -q -m gpu``."""

import numpy as np
import pytest
import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops.padding import GridPos, SiteState
from infinite_texture_gans_torch.sampling.infinite import (
    canvas_geometry,
    generate_canvas,
    generate_one_pass,
)

pytestmark = pytest.mark.gpu

# f32 with TF32 off: the kernel and cuDNN sum up to 9*C products in other
# orders (and cuDNN may use Winograd transforms), ~1e-6 relative each.
F32_TOL = 1e-4
# bf16: both compute in f32 and round the output once, so an output may sit
# one bf16 ulp (2^-8 relative) apart; allow two.
BF16_TOL = 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref):
    tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
    scale = max(1.0, float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * scale, (err, tol * scale)


def _inputs(dev, dtype, n=2, c=11, co=19, h=13, w=45, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g).to(dev, dtype)
    wt = (0.3 * torch.randn(co, c, 3, 3, generator=g)).to(dev)
    b = torch.randn(co, generator=g).to(dev)
    sc = (1 + 0.3 * torch.randn(c, generator=g)).to(dev)
    sh = (0.3 * torch.randn(c, generator=g)).to(dev)
    return x, wt, b, sc, sh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("co", [3, 8, 19])
def test_conv3x3_kernel_matches_plain(cuda, dtype, outer, co):
    x, w, b, sc, sh = _inputs(cuda, dtype, co=co)
    tk.reset_launches()
    y = tk.conv3x3_chw(x, w, b, sc, sh, True, outer)
    assert tk.LAUNCHES["conv3x3_chw"] == 1
    _assert_close(y, tk.conv3x3_chw_plain(x, w, b, sc, sh, True, outer))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("first_row,first_col,col", [(True, True, 0), (False, False, 1), (False, True, 0), (True, False, 2)])
def test_halo_kernel_matches_plain(cuda, dtype, outer, first_row, first_col, col):
    gh = gw = 3
    x, w, b, sc, sh = _inputs(cuda, dtype, n=1, c=7, co=5, h=12, w=24)
    wtot = 7 * 8
    g = torch.Generator(device="cpu").manual_seed(1)
    site = [torch.randn(s, generator=g).to(cuda, dtype) for s in ((1, 12, 1, 7), (1, 1, wtot + 2, 7), (1, 1, wtot + 2, 7))]
    pos = GridPos(col, first_row, first_col)
    y, s_new = tk.chw_halo_step(x, w, b, sc, sh, True, outer, SiteState(*[s.clone() for s in site]), pos, gh, gw)
    cpu = [t.cpu() for t in (x, w, b, sc, sh)]
    y_ref, s_ref = tk.chw_halo_step(*cpu, True, outer, SiteState(*[s.cpu() for s in site]), pos, gh, gw)
    _assert_close(y.cpu(), y_ref)
    for got, ref in zip(s_new, s_ref):
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_conv1x1_kernel_matches_plain(cuda, dtype, with_res):
    x, _, _, _, _ = _inputs(cuda, dtype, c=37, h=9, w=31)
    w = torch.randn(21, 37, 1, 1, device=cuda)
    b = torch.randn(21, device=cuda)
    res = torch.randn(2, 21, 9, 31, device=cuda).to(dtype) if with_res else None
    y = tk.conv1x1_chw_add(x, w, b, res) if with_res else tk.conv1x1_chw(x, w, b)
    _assert_close(y, tk.conv1x1_chw_plain(x, w, b, res))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_kernel_bit_equal(cuda, dtype):
    x = torch.randn(2, 5, 7, 33, device=cuda).to(dtype)
    assert torch.equal(tk.upsample2_chw(x), tk.upsample2_chw_plain(x))


def test_tail_off_refuses_cuda(cuda):
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, chw_tail="off").to(cuda).eval()
    with pytest.raises(ValueError):
        gen(torch.zeros(1, 14, 14, 16, device=cuda))


def test_raster_canvas_on_card_equals_one_pass(cuda):
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True)
    g = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
        gen.attention.attn.gamma.zero_()
    gen = gen.to(cuda).eval()
    _, _, th, tw = canvas_geometry(160, 224, gen.patch_resolution, 3, 3)
    z = torch.randn(1, th * 4 + 2, tw * 4 + 2, 16, generator=g)
    tk.reset_launches()
    canvas = generate_canvas(gen, None, 160, 224, z_full=z)
    assert tk.LAUNCHES["chw_halo_step"] == 2 * 3 * 3  # 2 sites + final, 2x3 steps
    oracle = generate_one_pass(gen, z, th, tw)[:, :160, :224].cpu().numpy()
    np.testing.assert_allclose(canvas, oracle, atol=5e-4, rtol=0)
