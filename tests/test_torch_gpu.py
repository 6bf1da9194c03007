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
    """K3 against its plain version: bf16 (the tensor cores) the one with W
    and b rounded to bf16, the route's function; f32 (the CUDA cores) the
    plain version itself."""
    x, _, _, _, _ = _inputs(cuda, dtype, c=37, h=9, w=31)
    w = torch.randn(21, 37, 1, 1, device=cuda)
    b = torch.randn(21, device=cuda)
    res = torch.randn(2, 21, 9, 31, device=cuda).to(dtype) if with_res else None
    y = tk.conv1x1_chw_add(x, w, b, res) if with_res else tk.conv1x1_chw(x, w, b)
    plain = tk.conv1x1_chw_tc_plain if dtype == torch.bfloat16 else tk.conv1x1_chw_plain
    _assert_close(y, plain(x, w, b, res))


# K4's shapes: ragged widths (W % 8 != 0: every row, or some rows, copied
# element by element), the flagship's eval blocks 4-6 at N = 1, the SSM
# eval's, and the Experiment-1 / SSM steps' N = 8 ones
UP2_SHAPES = [(2, 5, 7, 33), (2, 3, 4, 5), (1, 7, 3, 35), (3, 2, 5, 9), (1, 104, 48, 48),
              (1, 52, 96, 96), (1, 26, 192, 192), (8, 52, 96, 96), (8, 26, 192, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UP2_SHAPES)
def test_upsample_kernel_bit_equal(cuda, dtype, shape):
    """K4 copies bit for bit (16-byte vectors, element by element where a
    row is ragged or unaligned), one launch a call."""
    x = torch.randn(*shape, device=cuda).to(dtype)
    tk.reset_launches()
    y = tk.upsample2_chw(x)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["upsample2_chw"] == 1
    assert torch.equal(y, tk.upsample2_chw_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 6, 16), (2, 3, 5, 35), (8, 26, 24, 24)])
def test_upsample_kernel_bit_equal_on_offset_view(cuda, dtype, shape):
    """A contiguous view one element into its storage: no row is 16-byte
    aligned, so the kernel copies element by element, still bit for bit."""
    n = int(np.prod(shape))
    x = torch.randn(n + 1, device=cuda).to(dtype)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
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


# --- training kernels (K5 stats, K6, K7, K8, K3 stats and dW, K4 adjoint, K13)
# The sums (Σy, Σy², d(scale), d(shift), dW, db) are float32 reductions in
# another order (and atomics in a run-dependent one): relative 1e-4 of the
# largest reference entry.
SUM_TOL = 1e-4

TRAIN_SHAPES = [(2, 11, 19, 13, 45), (1, 26, 13, 40, 37), (2, 13, 3, 23, 70)]  # n, c, co, h, w


def _assert_sum_close(got, ref, tol=SUM_TOL):
    scale = max(1e-6, float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * scale, (err, tol * scale)


# K6 and K9 dx in bf16 run on the tensor cores, whose weights (for K9 the
# combined 4x4 ones) are rounded to bf16 as the reference rounds them: they
# are held to the plain versions with that rounding (``*_tc_plain``), dx
# within 2^-7 of max|ref| (an output one bf16 ulp apart either way), the
# float32 sums within SUM_TOL. f32 runs the CUDA-core kernels, held to the
# plain versions as before.
def _dx_plain(kind, dtype):
    tc = dtype == torch.bfloat16
    if kind == "conv":
        return tk.conv3x3_chw_dx_tc_plain if tc else tk.conv3x3_chw_dx_plain
    return tk.upconv3x3_chw_dx_tc_plain if tc else tk.upconv3x3_chw_dx_plain


def _assert_dx_close(got, ref):
    dx, dsc, dsh = got
    dx_ref, dsc_ref, dsh_ref = ref
    if dx.dtype == torch.bfloat16:
        err = float((dx.float() - dx_ref.float()).abs().max())
        assert err <= BF16_TOL * float(dx_ref.float().abs().max()), err
    else:
        _assert_close(dx, dx_ref)
    _assert_sum_close(dsc, dsc_ref)
    _assert_sum_close(dsh, dsh_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_conv3x3_train_kernels_match_plain(cuda, dtype, outer, shape):
    n, c, co, h, w = shape
    x, wt, b, sc, sh = _inputs(cuda, dtype, n=n, c=c, co=co, h=h, w=w)
    g = torch.randn(n, co, h, w, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    tk.reset_launches()
    y, s1, s2 = tk.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    y_ref, s1_ref, s2_ref = tk.conv3x3_chw_plain(x, wt, b, sc, sh, True, outer, want_stats=True)
    _assert_close(y, y_ref)
    # the stats are taken of the stored y: hold them to the plain sums of the kernel's own y
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    _assert_dx_close(tk.conv3x3_chw_dx(x, g, wt, sc, sh, True, outer),
                     _dx_plain("conv", dtype)(x, g, wt, sc, sh, True, outer))
    dw, db = tk.conv3x3_chw_dw(x, g, sc, sh, True, outer)
    dw_ref, db_ref = tk.conv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)
    alpha, beta2 = torch.randn(co, device=cuda), torch.randn(co, device=cuda)
    _assert_close(tk.bn_corr(g, y, alpha, beta2), tk.bn_corr_plain(g, y, alpha, beta2))
    assert {k: tk.LAUNCHES[k] for k in ("conv3x3_chw", "conv3x3_chw_dx", "conv3x3_chw_dw", "bn_corr")} \
        == {"conv3x3_chw": 1, "conv3x3_chw_dx": 1, "conv3x3_chw_dw": 1, "bn_corr": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_conv1x1_train_kernels_match_plain(cuda, dtype, shape):
    n, c, co, h, w = shape
    x, _, _, _, _ = _inputs(cuda, dtype, n=n, c=c, h=h, w=w)
    gen = torch.Generator().manual_seed(4)
    wt = torch.randn(co, c, 1, 1, generator=gen).to(cuda)
    b = torch.randn(co, generator=gen).to(cuda)
    res = torch.randn(n, co, h, w, generator=gen).to(cuda, dtype)
    g = torch.randn(n, co, h, w, generator=gen).to(cuda, dtype)
    y, s1, s2 = tk.conv1x1_chw_add(x, wt, b, res, want_stats=True)
    plain = tk.conv1x1_chw_tc_plain if dtype == torch.bfloat16 else tk.conv1x1_chw_plain
    _assert_close(y, plain(x, wt, b, res))
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    dw, db = tk.conv1x1_chw_dw(x, g)
    dw_ref, db_ref = tk.conv1x1_chw_dw_plain(x, g)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 14, 34), (1, 26, 48, 96)])
def test_upsample_adjoint_bit_equal(cuda, dtype, shape):
    g = torch.randn(*shape, device=cuda).to(dtype)
    assert torch.equal(tk.upsample2_chw_bwd(g), tk.upsample2_chw_bwd_plain(g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 20, 70, 64), (1, 3, 48, 36, 96)])  # n, c, h, w, co
def test_stem_kernels_match_plain(cuda, dtype, shape):
    n, c, h, w, co = shape
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, dtype)
    wt = (0.2 * torch.randn(co, c, 4, 4, generator=gen)).to(cuda)
    b = torch.randn(co, generator=gen).to(cuda)
    g = torch.randn(n, h // 2, w // 2, co, generator=gen).to(cuda, dtype)
    tk.reset_launches()
    fwd_plain = tk.stem_fwd_tc_plain if dtype == torch.bfloat16 else tk.stem_fwd_plain
    dx_plain = tk.stem_dx_tc_plain if dtype == torch.bfloat16 else tk.stem_dx_plain
    _assert_close(tk.stem_fwd(x, wt, b), fwd_plain(x, wt, b))
    _assert_close(tk.stem_dx(g, wt), dx_plain(g, wt))
    dw, db = tk.stem_dw(x, g)
    dw_ref, db_ref = tk.stem_dw_plain(x, g)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)
    assert (tk.LAUNCHES["stem_fwd"], tk.LAUNCHES["stem_dx"], tk.LAUNCHES["stem_dw"]) == (1, 1, 1)


# --- K13's forward on the tensor cores, bf16 ---------------------------------
# n, c, h, w, co: the Experiment-1 and SSM steps' stems (N = 8, 384^2 and
# 192^2 -> 64), then Co 8 and 128, odd W/2 and H/2 not a multiple of the
# 4-row tile, W not a multiple of 8 (the element-wise staging), C 1 and 4
STEM_SHAPES = [(8, 3, 384, 384, 64), (8, 3, 192, 192, 64), (2, 3, 22, 30, 8),
               (1, 3, 38, 70, 128), (2, 3, 18, 26, 64), (1, 1, 16, 48, 16), (3, 4, 10, 34, 24)]


def _stem_case(cuda, shape, seed=41):
    """bf16 x, float32 weights (unit-variance outputs) and bias at ``shape``
    (n, c, h, w, co)."""
    n, c, h, w, co = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn(co, c, 4, 4, generator=g) * (16 * c) ** -0.5).to(cuda)
    b = torch.randn(co, generator=g).to(cuda)
    return x, wt, b


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_tc_matches_plain(cuda, shape):
    """bf16 K13 forward runs the tensor-core kernel, held to the plain
    version with w and b rounded to bf16 (an output one bf16 ulp apart
    either way); two calls give the same bits."""
    x, wt, b = _stem_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    y = tk.stem_fwd(x, wt, b)
    again = tk.stem_fwd(x, wt, b)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_stem_fwd_tc"], tk.ROUTE_LAUNCHES["itg_stem_fwd"]) == (2, 0)
    _assert_fwd_close(y, tk.stem_fwd_tc_plain(x, wt, b))
    assert torch.equal(y, again)


@pytest.mark.parametrize("shape", [STEM_SHAPES[1], STEM_SHAPES[4]])
def test_stem_tc_on_offset_view(cuda, shape):
    """x one element into its storage (not 16-byte aligned): the kernel
    stages element by element and gives the aligned copy's bits."""
    x, wt, b = _stem_case(cuda, shape)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    assert torch.equal(tk.stem_fwd(view, wt, b), tk.stem_fwd(x, wt, b))


@pytest.mark.parametrize("shape", [STEM_SHAPES[1], STEM_SHAPES[2]])
def test_stem_tc_check_catches_planted_faults(cuda, shape):
    """The bf16 check above fails on a stem that is slightly wrong: ky and
    kx swapped, the bias dropped, the zero border read as the edge pixel,
    one k16 step (an input channel's 16 taps) skipped."""
    x, wt, b = _stem_case(cuda, shape)
    ref = tk.stem_fwd_tc_plain(x, wt, b)
    _assert_fwd_close(tk.stem_fwd(x, wt, b), ref)
    edge = tk.stem_fwd(torch.nn.functional.pad(x, (2, 2, 2, 2), mode="replicate"), wt, b)
    skip = wt.clone()
    skip[:, 0] = 0
    for bad in (tk.stem_fwd(x, wt.transpose(2, 3).contiguous(), b),
                tk.stem_fwd(x, wt, torch.zeros_like(b)), edge[:, 1:-1, 1:-1].contiguous(),
                tk.stem_fwd(x, skip, b)):
        with pytest.raises(AssertionError):
            _assert_fwd_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_fwd_routes_by_dtype(cuda, dtype):
    """bf16 calls of K13's forward, dW and dx launch their tensor-core entry
    points, f32 calls the CUDA-core ones; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, wt, b = _stem_case(cuda, STEM_SHAPES[2])
    x = x.to(dtype).requires_grad_()
    wt.requires_grad_()
    y = tk.conv4x4s2_stem_chw(x, wt, b)
    y.float().sum().backward()
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_stem_fwd_tc": int(tc), "itg_stem_fwd": int(not tc),
                                 "itg_stem_dw_tc": int(tc), "itg_stem_dw": int(not tc),
                                 "itg_stem_dx_tc": int(tc), "itg_stem_dx": int(not tc)}
    assert (tk.LAUNCHES["stem_fwd"], tk.LAUNCHES["stem_dx"], tk.LAUNCHES["stem_dw"]) == (1, 1, 1)


@pytest.mark.parametrize("co", [4, 12, 100, 136, 256])
def test_stem_tc_any_co_matches_plain(cuda, co):
    """Any --D_ch: Co padded to 8-channel groups with zero weight rows,
    walked in chunks of 64 past 128, and only the valid channels stored
    (element by element where Co is no multiple of 8); held to
    ``stem_fwd_tc_plain``, on the tensor cores alone, two calls bit-equal."""
    x, wt, b = _stem_case(cuda, (2, 3, 22, 70, co))
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    y = tk.stem_fwd(x, wt, b)
    again = tk.stem_fwd(x, wt, b)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_stem_fwd_tc"], tk.ROUTE_LAUNCHES["itg_stem_fwd"]) == (2, 0)
    assert y.shape == (2, 11, 35, co)
    _assert_fwd_close(y, tk.stem_fwd_tc_plain(x, wt, b))
    assert torch.equal(y, again)


def test_stem_tc_refuses_wider(cuda):
    """A bf16 stem wider than a block's shared memory holds raises, naming
    the limit; nothing falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    x, wt, b = _stem_case(cuda, (1, 3, 8, 16, tk.STEM_TC_MAX_CO + 1))
    with pytest.raises(ValueError, match="tensor-core stem forward"):
        tk.stem_fwd(x, wt, b)
    assert tk.ROUTE_LAUNCHES["itg_stem_fwd"] == 0


def test_train_step_bf16_any_d_ch_on_card(cuda):
    """A tiny bf16 training step with --D_ch 100 (no multiple of 8): D's
    stem runs the tensor-core forward on every fake and real batch and the
    tensor-core dW once, and the losses are finite."""
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.train.train_step import create_train_state, train_step

    args = prepare_parser().parse_args(
        ["--G_ch", "8", "--D_ch", "100", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
         "--padding_mode", "local", "--attention", "--spec_norm_D", "--ema", "--num_images", "2",
         "--compute_dtype", "bfloat16"])
    gen = torch.Generator().manual_seed(6)
    real = (torch.rand(4, 48, 48, 3, generator=gen) * 2 - 1).to(cuda)
    z = torch.randn(2, 14, 14, 16, generator=gen).to(cuda)
    st = create_train_state(args, 4, cuda, seed=1)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    metrics = train_step(st, real, z, smooth=True, use_ema=True)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert (tk.ROUTE_LAUNCHES["itg_stem_fwd_tc"], tk.ROUTE_LAUNCHES["itg_stem_fwd"]) == (2, 0)
    assert (tk.ROUTE_LAUNCHES["itg_stem_dw_tc"], tk.ROUTE_LAUNCHES["itg_stem_dw"]) == (1, 0)
    assert (tk.ROUTE_LAUNCHES["itg_stem_dx_tc"], tk.ROUTE_LAUNCHES["itg_stem_dx"]) == (1, 0)


# --- the fused up-conv (K9 forward, dx, dW) and its residual join (K10) ----
# half-res shapes n, c, co, h, w; the small odd ones put every replicate fold
# (corners included) into one tile, and h = 1 folds top and bottom onto the
# same row
UPCONV_SHAPES = [(2, 11, 19, 13, 45), (1, 26, 13, 20, 37), (2, 5, 3, 5, 7), (1, 3, 2, 1, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_kernels_match_plain(cuda, dtype, outer, shape):
    n, c, co, h, w = shape
    x, wt, b, sc, sh = _inputs(cuda, dtype, n=n, c=c, co=co, h=h, w=w)
    g = torch.randn(n, co, 2 * h, 2 * w, generator=torch.Generator().manual_seed(7)).to(cuda, dtype)
    tk.reset_launches()
    # bf16 runs the tensor-core route, whose combined weights are rounded
    plain = tk.upconv3x3_chw_tc_plain if dtype == torch.bfloat16 else tk.upconv3x3_chw_plain
    y_ref = plain(x, wt, b, sc, sh, True, outer)
    _assert_close(tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer), y_ref)
    y, s1, s2 = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    _assert_close(y, y_ref)
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    _assert_dx_close(tk.upconv3x3_chw_dx(x, g, wt, sc, sh, True, outer),
                     _dx_plain("upconv", dtype)(x, g, wt, sc, sh, True, outer))
    dw, db = tk.upconv3x3_chw_dw(x, g, sc, sh, True, outer)
    dw_ref, db_ref = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)
    assert {k: tk.LAUNCHES[k] for k in ("upconv3x3_chw", "upconv3x3_chw_dx", "upconv3x3_chw_dw")} \
        == {"upconv3x3_chw": 2, "upconv3x3_chw_dx": 1, "upconv3x3_chw_dw": 1}


def _dx_case(cuda, kind, shape, seed=12):
    """bf16 inputs of K6 (``kind`` 'conv', g at x's size) or K9 dx ('upconv',
    g at twice it)."""
    n, c, co, h, w = shape
    up = 1 if kind == "conv" else 2
    x, wt, _, sc, sh = _inputs(cuda, torch.bfloat16, n=n, c=c, co=co, h=h, w=w, seed=seed)
    g = torch.randn(n, co, up * h, up * w, generator=torch.Generator().manual_seed(seed)).to(
        cuda, torch.bfloat16)
    return x, g, wt, sc, sh


def _dx_kernel(kind):
    return tk.conv3x3_chw_dx if kind == "conv" else tk.upconv3x3_chw_dx


# the dx kernels' shapes n, c, co, h, w: a ragged one and a main-path one
# (K6: the SSM step's final conv; K9: block 5 of the Experiment-1 step)
DX_SHAPES = {"conv": [(2, 11, 19, 13, 45), (2, 26, 3, 96, 96)],
             "upconv": [(1, 26, 13, 20, 37), (2, 52, 26, 48, 48)]}


@pytest.mark.parametrize("kind", ["conv", "upconv"])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("case", [0, 1])
def test_dx_tc_bits_repeat(cuda, kind, outer, case):
    """The tensor-core dx kernels sum their per-block partials in a fixed
    order, with no atomics: two calls give the same bits."""
    x, g, wt, sc, sh = _dx_case(cuda, kind, DX_SHAPES[kind][case])
    first = _dx_kernel(kind)(x, g, wt, sc, sh, True, outer)
    second = _dx_kernel(kind)(x, g, wt, sc, sh, True, outer)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["conv", "upconv"])
@pytest.mark.parametrize("case", [0, 1])
def test_dx_tc_check_catches_planted_faults(cuda, kind, case):
    """The bf16 check above fails on a dx kernel that is slightly wrong: its
    top border's fold dropped (the first row's interior columns taken from
    the zeros-padding call, which differs there by exactly that fold), one
    input channel's weights x 1.01 (the channel of the largest d(scale)), or
    ky and kx swapped."""
    x, g, wt, sc, sh = _dx_case(cuda, kind, DX_SHAPES[kind][case])
    k, ref = _dx_kernel(kind), _dx_plain(kind, torch.bfloat16)(x, g, wt, sc, sh, True, "replicate")
    got = k(x, g, wt, sc, sh, True, "replicate")
    _assert_dx_close(got, ref)
    no_top = got[0].clone()
    no_top[..., 0, 1:-1] = k(x, g, wt, sc, sh, True, "constant")[0][..., 0, 1:-1]
    w_ch = wt.clone()
    w_ch[:, int(ref[1].abs().argmax())] *= 1.01
    for bad in ((no_top, got[1], got[2]), k(x, g, w_ch, sc, sh, True, "replicate"),
                k(x, g, wt.transpose(2, 3).contiguous(), sc, sh, True, "replicate")):
        with pytest.raises(AssertionError):
            _assert_dx_close(bad, ref)


@pytest.mark.parametrize("kind", ["conv", "upconv"])
@pytest.mark.parametrize("c,co", [(11, 19), (52, 26), (13, 3)])
def test_dx_tc_packs_weights_as_plain(cuda, kind, c, co):
    """The entry point's first launch writes the B operand (its wp scratch)
    bit for bit as ``pack_dx_weights``: K6's flipped taps, K9 dx's 4x4 form
    combined in float32 in the reference's order and then rounded."""
    x, g, wt, sc, sh = _dx_case(cuda, kind, (1, c, co, 8, 16))
    nt, no = tk.dx_tc_plan(c, co)
    taps = 3 if kind == "conv" else 4
    wp = torch.full((8 * nt, taps, taps, 8 * no), float("nan"), device=cuda).to(torch.bfloat16)
    part = torch.empty((tk.DX_TC_MAX_BLOCKS, 2, c), device=cuda)
    dx, dsc, dsh = torch.empty_like(x), torch.empty(c, device=cuda), torch.empty(c, device=cuda)
    entry = "itg_conv3x3_chw_dx_tc" if kind == "conv" else "itg_upconv3x3_chw_dx_tc"
    rc = getattr(tk._lib(), entry)(
        x.data_ptr(), g.data_ptr(), wt.data_ptr(), sc.data_ptr(), sh.data_ptr(), wp.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dsc.data_ptr(), dsh.data_ptr(), 1, c, 8, 16, co, 1, 0, nt,
        no, tk.DX_TC_MAX_BLOCKS, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(wp.cpu(), tk.pack_dx_weights(wt.cpu(), up=kind == "upconv"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_routes_by_dtype(cuda, dtype):
    """bf16 calls of K6 and K9 dx launch the tensor-core entry points, f32
    calls the CUDA-core ones; each counts one launch per call."""
    for k in tk.ROUTE_LAUNCHES:
        tk.ROUTE_LAUNCHES[k] = 0
    tk.reset_launches()
    for kind in ("conv", "upconv"):
        x, g, wt, sc, sh = (t.to(dtype) if t.dtype == torch.bfloat16 else t
                            for t in _dx_case(cuda, kind, DX_SHAPES[kind][0]))
        _dx_kernel(kind)(x, g, wt, sc, sh, True, "replicate")
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {"itg_conv3x3_chw_tc": 0, "itg_conv3x3_chw": 0,
                                 "itg_conv3x3_chw_dx_tc": int(tc), "itg_conv3x3_chw_dx": int(not tc),
                                 "itg_conv3x3_chw_dw_tc": 0, "itg_conv3x3_chw_dw": 0,
                                 "itg_upconv3x3_chw_tc": 0, "itg_upconv3x3_chw": 0,
                                 "itg_upconv3x3_chw_dx_tc": int(tc),
                                 "itg_upconv3x3_chw_dx": int(not tc),
                                 "itg_upconv3x3_chw_dw_tc": 0, "itg_upconv3x3_chw_dw": 0,
                                 "itg_stem_fwd_tc": 0, "itg_stem_fwd": 0,
                                 "itg_stem_dw_tc": 0, "itg_stem_dw": 0,
                                 "itg_stem_dx_tc": 0, "itg_stem_dx": 0,
                                 "itg_conv1x1_chw_tc": 0, "itg_conv1x1_chw": 0,
                                 "itg_conv1x1_chw_dw_tc": 0, "itg_conv1x1_chw_dw": 0}
    assert (tk.LAUNCHES["conv3x3_chw_dx"], tk.LAUNCHES["upconv3x3_chw_dx"]) == (1, 1)


# --- K7 (conv3x3_chw_dw) on the tensor cores, bf16 -------------------------
# n, c, co, h, w: every training shape of the channels-major tail (auto:
# 26 -> 26 at 192^2, 13 -> 13 and 13 -> 3 at 384^2; off adds 52 -> 26 at 192^2
# and 26 -> 13 at 384^2; SSM: 52 -> 26, 26 -> 26 and 26 -> 3 at 192^2), then a
# ragged one (w no multiple of 8: element loads), the plan's widest (C = 64,
# Co = 32) and a C that fills its m16 tile
DW_SHAPES = [(8, 26, 26, 192, 192), (8, 13, 13, 384, 384), (8, 13, 3, 384, 384),
             (8, 52, 26, 192, 192), (8, 26, 13, 384, 384), (8, 26, 3, 192, 192),
             (2, 11, 19, 13, 45), (1, 64, 32, 20, 64), (3, 16, 8, 9, 40)]


def _dw_case(cuda, shape, seed=21):
    """bf16 x and g of K7 at ``shape`` (n, c, co, h, w), float32 scale/shift."""
    n, c, co, h, w = shape
    x, _, _, sc, sh = _inputs(cuda, torch.bfloat16, n=n, c=c, co=co, h=h, w=w, seed=seed)
    g = torch.randn(n, co, h, w, generator=torch.Generator().manual_seed(seed)).to(
        cuda, torch.bfloat16)
    return x, g, sc, sh


def _assert_dw_close(got, ref):
    _assert_sum_close(got[0], ref[0])
    _assert_sum_close(got[1], ref[1])


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_tc_matches_plain(cuda, outer, shape):
    """bf16 K7 runs the tensor-core kernel and computes the plain version's
    function (both operands are bf16 values): dW and db within SUM_TOL."""
    x, g, sc, sh = _dw_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    got = tk.conv3x3_chw_dw(x, g, sc, sh, True, outer)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_conv3x3_chw_dw_tc"], tk.ROUTE_LAUNCHES["itg_conv3x3_chw_dw"]) \
        == (1, 0)
    _assert_dw_close(got, tk.conv3x3_chw_dw_plain(x, g, sc, sh, True, outer))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("case", [0, 6])
def test_dw_tc_bits_repeat(cuda, outer, case):
    """Fixed-order partial sums and no atomics: two calls give the same bits."""
    x, g, sc, sh = _dw_case(cuda, DW_SHAPES[case])
    first = tk.conv3x3_chw_dw(x, g, sc, sh, True, outer)
    second = tk.conv3x3_chw_dw(x, g, sc, sh, True, outer)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [0, 2, 6])
def test_dw_tc_check_catches_planted_faults(cuda, case):
    """The check above fails on a dW that is slightly wrong: one input
    channel's dW x 1.01 (the channel of the largest entry), ky and kx
    swapped, or the replicate ring taken as zeros."""
    x, g, sc, sh = _dw_case(cuda, DW_SHAPES[case])
    ref = tk.conv3x3_chw_dw_plain(x, g, sc, sh, True, "replicate")
    dw, db = tk.conv3x3_chw_dw(x, g, sc, sh, True, "replicate")
    _assert_dw_close((dw, db), ref)
    one = dw.clone()
    c_max = int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())
    one[:, c_max] *= 1.01
    for bad in ((one, db), (dw.transpose(2, 3), db),
                tk.conv3x3_chw_dw(x, g, sc, sh, True, "constant")):
        with pytest.raises(AssertionError):
            _assert_dw_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_routes_by_dtype(cuda, dtype):
    """bf16 calls of K7 launch the tensor-core entry point, f32 calls the
    CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, g, sc, sh = _dw_case(cuda, DW_SHAPES[6])
    tk.conv3x3_chw_dw(x.to(dtype), g.to(dtype), sc, sh, True, "replicate")
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {"itg_conv3x3_chw_tc": 0, "itg_conv3x3_chw": 0,
                                 "itg_conv3x3_chw_dx_tc": 0, "itg_conv3x3_chw_dx": 0,
                                 "itg_conv3x3_chw_dw_tc": int(tc), "itg_conv3x3_chw_dw": int(not tc),
                                 "itg_upconv3x3_chw_tc": 0, "itg_upconv3x3_chw": 0,
                                 "itg_upconv3x3_chw_dx_tc": 0, "itg_upconv3x3_chw_dx": 0,
                                 "itg_upconv3x3_chw_dw_tc": 0, "itg_upconv3x3_chw_dw": 0,
                                 "itg_stem_fwd_tc": 0, "itg_stem_fwd": 0,
                                 "itg_stem_dw_tc": 0, "itg_stem_dw": 0,
                                 "itg_stem_dx_tc": 0, "itg_stem_dx": 0,
                                 "itg_conv1x1_chw_tc": 0, "itg_conv1x1_chw": 0,
                                 "itg_conv1x1_chw_dw_tc": 0, "itg_conv1x1_chw_dw": 0}
    assert tk.LAUNCHES["conv3x3_chw_dw"] == 1


def test_dw_tc_refuses_wider(cuda):
    """A bf16 call outside the route's plan raises, naming the limit; nothing
    falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    for shape in ((1, 65, 3, 8, 16), (1, 13, 33, 8, 16)):
        x, g, sc, sh = _dw_case(cuda, shape)
        with pytest.raises(ValueError, match="tensor-core dW kernel"):
            tk.conv3x3_chw_dw(x, g, sc, sh, True, "replicate")
    assert tk.ROUTE_LAUNCHES["itg_conv3x3_chw_dw"] == 0


# --- K9 dW and K13 dW on the tensor cores, bf16 ------------------------------
# K9 dW, half-res n, c, co, h, w: the Experiment-1 `auto` step's two fused
# blocks (N = 8, 52 -> 26 at 96^2, 26 -> 13 at 192^2), then ragged ones (W
# no multiple of 8 or of the 32-column tile, h = 1 folding both rings onto
# one row) and the plan's widest (C = 64, Co = 32, phase rows on the grid)
UPDW_SHAPES = [(8, 52, 26, 96, 96), (8, 26, 13, 192, 192), (2, 11, 19, 13, 45),
               (1, 64, 32, 10, 40), (3, 13, 3, 5, 7), (1, 3, 2, 1, 3), (2, 26, 13, 9, 36)]


def _updw_case(cuda, shape, seed=31):
    """bf16 x (half-res) and g (full-res) of K9 dW at ``shape`` (n, c, co, h,
    w), float32 scale/shift."""
    n, c, co, h, w = shape
    x, _, _, sc, sh = _inputs(cuda, torch.bfloat16, n=n, c=c, co=co, h=h, w=w, seed=seed)
    g = torch.randn(n, co, 2 * h, 2 * w, generator=torch.Generator().manual_seed(seed)).to(
        cuda, torch.bfloat16)
    return x, g, sc, sh


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", UPDW_SHAPES)
def test_upconv_dw_tc_matches_plain(cuda, outer, shape):
    """bf16 K9 dW runs the tensor-core kernel and computes the plain
    version's function (both operands are bf16 values): dW and db within
    SUM_TOL."""
    x, g, sc, sh = _updw_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    got = tk.upconv3x3_chw_dw(x, g, sc, sh, True, outer)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_dw_tc"],
            tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_dw"]) == (1, 0)
    _assert_dw_close(got, tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("case", [0, 1, 2])
def test_upconv_dw_tc_bits_repeat(cuda, outer, case):
    """Fixed-order partial sums and no atomics: two calls give the same bits."""
    x, g, sc, sh = _updw_case(cuda, UPDW_SHAPES[case])
    first = tk.upconv3x3_chw_dw(x, g, sc, sh, True, outer)
    second = tk.upconv3x3_chw_dw(x, g, sc, sh, True, outer)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [1, 6])
def test_upconv_dw_tc_on_offset_view(cuda, case):
    """x and g one element into their storage (not 16-byte aligned): the
    kernel stages both element by element and gives the aligned copies'
    bits."""
    x, g, sc, sh = _updw_case(cuda, UPDW_SHAPES[case])
    views = []
    for t in (x, g):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        views.append(view)
    got = tk.upconv3x3_chw_dw(*views, sc, sh, True, "replicate")
    for a, b in zip(got, tk.upconv3x3_chw_dw(x, g, sc, sh, True, "replicate")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_upconv_dw_tc_check_catches_planted_faults(cuda, case):
    """The check above fails on a K9 dW that is slightly wrong: one input
    channel's dW x 1.01 (the channel of the largest entry), ky and kx
    swapped, the replicate ring taken as zeros, or db from the even full-res
    rows only."""
    x, g, sc, sh = _updw_case(cuda, UPDW_SHAPES[case])
    ref = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, "replicate")
    dw, db = tk.upconv3x3_chw_dw(x, g, sc, sh, True, "replicate")
    _assert_dw_close((dw, db), ref)
    one = dw.clone()
    one[:, int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())] *= 1.01
    for bad in ((one, db), (dw.transpose(2, 3), db),
                tk.upconv3x3_chw_dw(x, g, sc, sh, True, "constant"),
                (dw, g[:, :, ::2].float().sum(dim=(0, 2, 3)))):
        with pytest.raises(AssertionError):
            _assert_dw_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_dw_routes_by_dtype(cuda, dtype):
    """bf16 calls of K9 dW launch the tensor-core entry point, f32 calls the
    CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, g, sc, sh = _updw_case(cuda, UPDW_SHAPES[2])
    tk.upconv3x3_chw_dw(x.to(dtype), g.to(dtype), sc, sh, True, "replicate")
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_upconv3x3_chw_dw_tc": int(tc),
                                 "itg_upconv3x3_chw_dw": int(not tc)}
    assert tk.LAUNCHES["upconv3x3_chw_dw"] == 1


def test_upconv_dw_tc_refuses_wider(cuda):
    """A bf16 call outside the route's plan raises, naming the limit; nothing
    falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    for shape in ((1, 65, 3, 4, 8), (1, 13, 33, 4, 8)):
        x, g, sc, sh = _updw_case(cuda, shape)
        with pytest.raises(ValueError, match="tensor-core up-conv dW kernel"):
            tk.upconv3x3_chw_dw(x, g, sc, sh, True, "replicate")
    assert tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_dw"] == 0


# K13 dW, n, c, h, w, co: the Experiment-1 and SSM steps' stems (N = 8, 384^2
# and 192^2 -> 64), then --D_ch 8, 128, 100 and 12 (no multiple of 8: g
# staged element by element), odd W/2 and H/2 not a multiple of the 4-row
# tile, W not a multiple of 8 (x staged element by element), C 1 and 4
STEMDW_SHAPES = [(8, 3, 384, 384, 64), (8, 3, 192, 192, 64), (2, 3, 22, 30, 8),
                 (1, 3, 38, 70, 128), (2, 3, 18, 26, 100), (1, 1, 16, 48, 16), (3, 4, 10, 34, 24),
                 (2, 3, 22, 70, 12), (1, 3, 16, 40, 512)]


def _stemdw_case(cuda, shape, seed=51):
    """bf16 x (n, c, h, w) and NHWC g (n, h/2, w/2, co) at ``shape``."""
    n, c, h, w, co = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(n, h // 2, w // 2, co, generator=gen).to(cuda, torch.bfloat16)
    return x, g


@pytest.mark.parametrize("shape", STEMDW_SHAPES)
def test_stem_dw_tc_matches_plain(cuda, shape):
    """bf16 K13 dW runs the tensor-core kernel and computes the plain
    version's function (both operands are bf16 values): dW and db within
    SUM_TOL, for any --D_ch up to the forward's limit."""
    x, g = _stemdw_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    got = tk.stem_dw(x, g)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_stem_dw_tc"], tk.ROUTE_LAUNCHES["itg_stem_dw"]) == (1, 0)
    _assert_dw_close(got, tk.stem_dw_plain(x, g))


@pytest.mark.parametrize("case", [0, 4, 8])
def test_stem_dw_tc_bits_repeat(cuda, case):
    """Fixed-order partial sums and no atomics: two calls give the same bits."""
    x, g = _stemdw_case(cuda, STEMDW_SHAPES[case])
    first, second = tk.stem_dw(x, g), tk.stem_dw(x, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [1, 3])
def test_stem_dw_tc_on_offset_view(cuda, case):
    """x and g one element into their storage (not 16-byte aligned): the
    kernel stages both element by element and gives the aligned copies'
    bits."""
    x, g = _stemdw_case(cuda, STEMDW_SHAPES[case])
    views = []
    for t in (x, g):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        views.append(view)
    for a, b in zip(tk.stem_dw(*views), tk.stem_dw(x, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [1, 4])
def test_stem_dw_tc_check_catches_planted_faults(cuda, case):
    """The check above fails on a K13 dW that is slightly wrong: one input
    channel's dW x 1.01 (the channel of the largest entry), ky and kx
    swapped, the zero border read as the edge pixel, or db from one image
    only."""
    x, g = _stemdw_case(cuda, STEMDW_SHAPES[case])
    ref = tk.stem_dw_plain(x, g)
    dw, db = tk.stem_dw(x, g)
    _assert_dw_close((dw, db), ref)
    one = dw.clone()
    one[:, int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())] *= 1.01
    edge = tk.stem_dw(torch.nn.functional.pad(x, (2, 2, 2, 2), mode="replicate"),
                      torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1)))
    for bad in ((one, db), (dw.transpose(2, 3), db), edge,
                (dw, g[:1].float().sum(dim=(0, 1, 2)))):
        with pytest.raises(AssertionError):
            _assert_dw_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_dw_routes_by_dtype(cuda, dtype):
    """bf16 calls of K13 dW launch the tensor-core entry point, f32 calls
    the CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, g = _stemdw_case(cuda, STEMDW_SHAPES[2])
    tk.stem_dw(x.to(dtype), g.to(dtype))
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_stem_dw_tc": int(tc), "itg_stem_dw": int(not tc)}
    assert tk.LAUNCHES["stem_dw"] == 1


def test_stem_dw_tc_refuses_wider(cuda):
    """A bf16 stem dW wider than the route's limit raises, naming it;
    nothing falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    x, g = _stemdw_case(cuda, (1, 3, 8, 16, tk.STEM_TC_MAX_CO + 1))
    with pytest.raises(ValueError, match="tensor-core stem dW"):
        tk.stem_dw(x, g)
    assert tk.ROUTE_LAUNCHES["itg_stem_dw"] == 0


# K13 dx, n, c, h2, w2, co (g's NHWC shape; dx is (n, c, 2 h2, 2 w2)): the
# Experiment-1 and SSM steps' stems (N = 8, 192^2 and 96^2 x 64), then
# --D_ch 8, 128, 100 and 12 (no multiple of 8: g staged element by element),
# h2 no multiple of the 8-row tile and w2 odd (W no multiple of 8: dx stored
# element by element), C 1 and 4, the widest Co
STEMDX_SHAPES = [(8, 3, 192, 192, 64), (8, 3, 96, 96, 64), (2, 3, 11, 15, 8),
                 (1, 3, 19, 35, 128), (2, 3, 9, 13, 100), (1, 1, 8, 24, 16), (3, 4, 5, 17, 24),
                 (2, 3, 11, 35, 12), (1, 3, 8, 20, 512)]


def _stemdx_case(cuda, shape, seed=61):
    """bf16 NHWC g (n, h2, w2, co) and float32 weights (co, c, 4, 4) at
    ``shape``."""
    n, c, h2, w2, co = shape
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(n, h2, w2, co, generator=gen).to(cuda, torch.bfloat16)
    wt = (torch.randn(co, c, 4, 4, generator=gen) * co ** -0.5).to(cuda)
    return g, wt


@pytest.mark.parametrize("shape", STEMDX_SHAPES)
def test_stem_dx_tc_matches_plain(cuda, shape):
    """bf16 K13 dx runs the tensor-core kernel, held to the plain version
    with w rounded to bf16 (a dx one bf16 ulp apart either way), for any
    --D_ch up to the forward's limit; two calls give the same bits."""
    g, wt = _stemdx_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    dx = tk.stem_dx(g, wt)
    again = tk.stem_dx(g, wt)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_stem_dx_tc"], tk.ROUTE_LAUNCHES["itg_stem_dx"]) == (2, 0)
    n, c, h2, w2, _ = shape
    assert dx.shape == (n, c, 2 * h2, 2 * w2)
    _assert_fwd_close(dx, tk.stem_dx_tc_plain(g, wt))
    assert torch.equal(dx, again)


@pytest.mark.parametrize("case", [1, 3])
def test_stem_dx_tc_on_offset_view(cuda, case):
    """g one element into its storage (not 16-byte aligned): the kernel
    stages it element by element and gives the aligned copy's bits."""
    g, wt = _stemdx_case(cuda, STEMDX_SHAPES[case])
    flat = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda)
    view = flat[1:].view(g.shape)
    view.copy_(g)
    assert view.data_ptr() % 16
    assert torch.equal(tk.stem_dx(view, wt), tk.stem_dx(g, wt))


@pytest.mark.parametrize("case", [1, 2])
def test_stem_dx_tc_check_catches_planted_faults(cuda, case):
    """The check above fails on a K13 dx that is slightly wrong: ky and kx
    swapped, one k16 step (16 output channels) skipped, or g's zero border
    read as the edge pixel."""
    g, wt = _stemdx_case(cuda, STEMDX_SHAPES[case])
    ref = tk.stem_dx_tc_plain(g, wt)
    _assert_fwd_close(tk.stem_dx(g, wt), ref)
    skip = wt.clone()
    skip[: min(16, wt.shape[0] - 1)] = 0
    g_edge = torch.nn.functional.pad(g.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    edge = tk.stem_dx(g_edge.permute(0, 2, 3, 1).contiguous(), wt)[:, :, 2:-2, 2:-2]
    for bad in (tk.stem_dx(g, wt.transpose(2, 3).contiguous()), tk.stem_dx(g, skip), edge):
        with pytest.raises(AssertionError):
            _assert_fwd_close(bad, ref)


@pytest.mark.parametrize("c,co", [(3, 64), (1, 12), (4, 100)])
def test_stem_dx_tc_packs_weights_as_plain(cuda, c, co):
    """The entry point's pack launch writes pack_stem_dx_weights' B operands
    bit for bit (bf16 rounding, zero taps, Co padding)."""
    g, wt = _stemdx_case(cuda, (1, c, 4, 16, co))
    chunks = tk.stem_dx_tc_plan(c, co)
    wp = torch.full((12, 8, tk.STEM_DX_TC_CO_CHUNK * chunks), float("nan"),
                    dtype=torch.bfloat16, device=cuda)
    dx = torch.empty((1, c, 8, 32), dtype=torch.bfloat16, device=cuda)
    rc = tk._lib().itg_stem_dx_tc(g.data_ptr(), wt.data_ptr(), wp.data_ptr(), dx.data_ptr(), 1,
                                  c, 8, 32, co, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(wp.cpu(), tk.pack_stem_dx_weights(wt.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_dx_routes_by_dtype(cuda, dtype):
    """bf16 calls of K13 dx launch the tensor-core entry point, f32 calls
    the CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    g, wt = _stemdx_case(cuda, STEMDX_SHAPES[2])
    tk.stem_dx(g.to(dtype), wt)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_stem_dx_tc": int(tc), "itg_stem_dx": int(not tc)}
    assert tk.LAUNCHES["stem_dx"] == 1


def test_stem_dx_tc_refuses_wider(cuda):
    """A bf16 stem dx wider than the route's limit raises, naming it;
    nothing falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    g, wt = _stemdx_case(cuda, (1, 3, 4, 8, tk.STEM_TC_MAX_CO + 1))
    with pytest.raises(ValueError, match="tensor-core stem dx"):
        tk.stem_dx(g, wt)
    assert tk.ROUTE_LAUNCHES["itg_stem_dx"] == 0


# --- K8 (bn_corr): 16-byte vectors, bit-equal to the plain version ----------
# n, c, h, w: the Experiment-1 step's stats producers (26 channels at 192^2,
# 13 at 384^2), then an odd HW (every other plane starts mid-vector: the
# scalar head and tail) and a plane shorter than one vector
BN_CORR_SHAPES = [(8, 26, 192, 192), (8, 13, 384, 384), (2, 5, 7, 9), (3, 2, 1, 3)]


def _bn_corr_case(cuda, dtype, shape, seed=71):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(*shape, generator=gen).to(cuda, dtype)
    y = torch.randn(*shape, generator=gen).to(cuda, dtype)
    # a correction of a tenth of g's scale, so that it moves every bf16 output
    alpha = (0.1 * torch.randn(shape[1], generator=gen)).to(cuda)
    beta2 = (0.1 * torch.randn(shape[1], generator=gen)).to(cuda)
    return g, y, alpha, beta2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_CORR_SHAPES)
def test_bn_corr_bit_equal(cuda, dtype, shape):
    """K8 repeats the plain version's float32 operations and its one
    rounding: bit-equal, one launch a call."""
    args = _bn_corr_case(cuda, dtype, shape)
    tk.reset_launches()
    assert torch.equal(tk.bn_corr(*args), tk.bn_corr_plain(*args))
    assert tk.LAUNCHES["bn_corr"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1])
def test_bn_corr_bit_equal_on_offset_view(cuda, dtype, which):
    """g (or y) one element into its storage: the planes' vectors start at
    other offsets than out's, and the kernel still gives the plain version's
    bits."""
    args = list(_bn_corr_case(cuda, dtype, BN_CORR_SHAPES[0]))
    flat = torch.empty(args[which].numel() + 1, dtype=dtype, device=cuda)
    view = flat[1:].view(args[which].shape)
    view.copy_(args[which])
    assert view.data_ptr() % 16
    args[which] = view
    assert torch.equal(tk.bn_corr(*args), tk.bn_corr_plain(*args))


def test_bn_corr_check_catches_planted_fault(cuda):
    """The bit-equal check fails on a K8 whose channel index is off by one
    (alpha and beta2 of the neighbouring channel)."""
    g, y, alpha, beta2 = _bn_corr_case(cuda, torch.bfloat16, BN_CORR_SHAPES[2])
    bad = tk.bn_corr(g, y, alpha.roll(1), beta2.roll(1))
    assert not torch.equal(bad, tk.bn_corr_plain(g, y, alpha, beta2))


# --- K1 / K2 (/ K5) on the tensor cores, bf16 -------------------------------
# n, c, co, h, w: every main-path shape (flagship eval at N = 1: blocks 4-6
# and the final conv; the SSM eval's final conv; the Experiment-1 and SSM
# steps at N = 8, 52 -> 26 and 26 -> 13 with stats), then ragged ones (5 x 7,
# 1 x 3, W no multiple of 8) and the plan's widest (C = 128, Co = 64, which
# takes 4-row tiles).
FWD_SHAPES = [(1, 104, 52, 96, 96), (1, 52, 52, 96, 96), (1, 52, 26, 192, 192),
              (1, 26, 26, 192, 192), (1, 26, 13, 384, 384), (1, 13, 13, 384, 384),
              (1, 13, 3, 384, 384), (1, 26, 3, 192, 192), (8, 52, 26, 192, 192),
              (8, 26, 26, 192, 192), (8, 26, 13, 384, 384), (8, 13, 13, 384, 384),
              (8, 13, 3, 384, 384), (2, 11, 19, 5, 7), (1, 5, 3, 1, 3), (2, 13, 3, 23, 70),
              (1, 128, 64, 20, 40)]
FWD_BORDERS = {"none": (False, False), "top": (True, False), "left": (False, True),
               "both": (True, True)}


def _fwd_case(cuda, shape, seed=31):
    """bf16 x and the cached borders (post-norm values: ReLU'd, rounded) of
    K1/K2 at ``shape`` (n, c, co, h, w); float32 weights, bias, fold."""
    n, c, co, h, w = shape
    x, wt, b, sc, sh = _inputs(cuda, torch.bfloat16, n=n, c=c, co=co, h=h, w=w, seed=seed)
    wt = wt * (9 * c) ** -0.5 / 0.3  # unit-variance outputs at every width
    g = torch.Generator().manual_seed(seed + 1)
    top = torch.relu(torch.randn(n, c, w + 2, generator=g)).to(cuda, torch.bfloat16)
    left = torch.relu(torch.randn(n, c, h, generator=g)).to(cuda, torch.bfloat16)
    return x, wt, b, sc, sh, top, left


def _assert_fwd_close(got, ref):
    """y within 2^-7 of max|ref| of the plain version with the route's
    rounded weights (an output one bf16 ulp apart either way)."""
    err = float((got.float() - ref.float()).abs().max())
    assert err <= BF16_TOL * float(ref.float().abs().max()), err


def _assert_stats_close(y, s1, s2):
    """K5's sums are of the stored y: within SUM_TOL of its plain sums."""
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_fwd_tc_matches_plain(cuda, outer, shape):
    """bf16 K1 runs the tensor-core kernel, with and without K5's sums, held
    to the plain version with the route's rounded weights."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    ref = tk.conv3x3_chw_tc_plain(x, wt, b, sc, sh, True, outer)
    y = tk.conv3x3_chw(x, wt, b, sc, sh, True, outer)
    y2, s1, s2 = tk.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_conv3x3_chw_tc"], tk.ROUTE_LAUNCHES["itg_conv3x3_chw"]) == (2, 0)
    _assert_fwd_close(y, ref)
    assert torch.equal(y, y2)
    _assert_stats_close(y2, s1, s2)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("borders", list(FWD_BORDERS))
@pytest.mark.parametrize("shape", [FWD_SHAPES[i] for i in (0, 2, 6, 7, 13, 14, 15)])
def test_fwd_tc_halo_matches_plain(cuda, outer, borders, shape):
    """bf16 K2 (the same kernel given the cached top row and left column) in
    its four border cases, held to its plain version with rounded weights."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, shape)
    t_, l_ = FWD_BORDERS[borders]
    tb, lb = (top if t_ else None), (left if l_ else None)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    y = tk.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, tb, lb)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_conv3x3_chw_tc"], tk.ROUTE_LAUNCHES["itg_conv3x3_chw"]) == (1, 0)
    _assert_fwd_close(y, tk.conv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True, outer, tb, lb))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("case", [0, 8, 13, 15])
def test_fwd_tc_bits_repeat(cuda, outer, case):
    """Fixed-order sums and no atomics: two calls give the same y, Σy and
    Σy²; and an image's y does not depend on the batch around it, which sets
    the tile height (4 rows where 8-row tiles would be fewer than the blocks
    the card holds at once, as at 96^2 and 192^2 for one image; 8 rows for
    eight of them there): each output sums in one order wherever its tile
    lies."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, FWD_SHAPES[case])
    first = tk.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    second = tk.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    one = [t[:1] for t in (x, top, left)]
    eight = [t.expand(8, *t.shape[1:]).contiguous() for t in one]
    alone = tk.conv3x3_chw_halo(one[0], wt, b, sc, sh, True, outer, one[1], one[2])
    batch = tk.conv3x3_chw_halo(eight[0], wt, b, sc, sh, True, outer, eight[1], eight[2])
    assert all(torch.equal(batch[i], alone[0]) for i in range(8))


@pytest.mark.parametrize("shape", [(1, 52, 26, 40, 72), (1, 13, 3, 37, 45)])
def test_fwd_tc_window_bit_equal(cuda, shape):
    """K2 on an interior window of x, given the top row and left column that
    K1's padded post-norm input holds there, equals K1's output bit for bit
    on the window's pixels away from its bottom row and right column (which
    K2 pads from the window's own edge)."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
    r0, c0, hw, ww = 5, 16, 17, 24
    y = tk.conv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    padded = torch.nn.functional.pad(tk.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
    top = padded[:, :, r0, c0 : c0 + ww + 2].contiguous()
    left = padded[:, :, r0 + 1 : r0 + 1 + hw, c0].contiguous()
    win = x[:, :, r0 : r0 + hw, c0 : c0 + ww].contiguous()
    y_win = tk.conv3x3_chw_halo(win, wt, b, sc, sh, True, "replicate", top, left)
    assert torch.equal(y_win[..., :-1, :-1], y[..., r0 : r0 + hw - 1, c0 : c0 + ww - 1])


@pytest.mark.parametrize("case", [2, 8])
def test_fwd_tc_check_catches_planted_faults(cuda, case):
    """The bf16 checks above fail on a forward that is slightly wrong: ky and
    kx swapped in the weights, the replicate ring taken as zeros, K2 ignoring
    its cached top row (the own edge in its place), or one channel's Σy² x
    1.01 (the channel of the largest)."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, FWD_SHAPES[case])
    ref = tk.conv3x3_chw_tc_plain(x, wt, b, sc, sh, True, "replicate")
    y, s1, s2 = tk.conv3x3_chw(x, wt, b, sc, sh, True, "replicate", want_stats=True)
    _assert_fwd_close(y, ref)
    _assert_stats_close(y, s1, s2)
    for bad in (tk.conv3x3_chw(x, wt.transpose(2, 3).contiguous(), b, sc, sh, True, "replicate"),
                tk.conv3x3_chw(x, wt, b, sc, sh, True, "constant")):
        with pytest.raises(AssertionError):
            _assert_fwd_close(bad, ref)
    halo_ref = tk.conv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True, "replicate", top, left)
    _assert_fwd_close(tk.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", top, left), halo_ref)
    with pytest.raises(AssertionError):
        _assert_fwd_close(tk.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", None, left),
                          halo_ref)
    s2_bad = s2.clone()
    s2_bad[int(s2.abs().argmax())] *= 1.01
    with pytest.raises(AssertionError):
        _assert_stats_close(y, s1, s2_bad)


@pytest.mark.parametrize("c,co", [(104, 52), (13, 3), (128, 64), (11, 19)])
def test_fwd_tc_packs_weights_as_plain(cuda, c, co):
    """The entry point's first launch writes the B operand (its wp scratch)
    bit for bit as ``pack_fwd_weights``."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, (1, c, co, 8, 16))
    nc, no = tk.fwd_tc_plan(c, co)
    wp = torch.full((8 * no, 3, 3, 8 * nc), float("nan"), device=cuda).to(torch.bfloat16)
    y = torch.empty((1, co, 8, 16), dtype=torch.bfloat16, device=cuda)
    rc = tk._lib().itg_conv3x3_chw_tc(
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), sc.data_ptr(), sh.data_ptr(), None, None,
        wp.data_ptr(), y.data_ptr(), None, None, None, 1, c, 8, 16, co, 1, 0, nc, no,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(wp.cpu(), tk.pack_fwd_weights(wt.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_routes_by_dtype(cuda, dtype):
    """bf16 calls of K1 and K2 launch the tensor-core entry point, f32 calls
    the CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, FWD_SHAPES[13])
    x, top, left = x.to(dtype), top.to(dtype), left.to(dtype)
    tk.conv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    tk.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", top, left)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {"itg_conv3x3_chw_tc": 2 * tc, "itg_conv3x3_chw": 2 * (not tc),
                                 "itg_conv3x3_chw_dx_tc": 0, "itg_conv3x3_chw_dx": 0,
                                 "itg_conv3x3_chw_dw_tc": 0, "itg_conv3x3_chw_dw": 0,
                                 "itg_upconv3x3_chw_tc": 0, "itg_upconv3x3_chw": 0,
                                 "itg_upconv3x3_chw_dx_tc": 0, "itg_upconv3x3_chw_dx": 0,
                                 "itg_upconv3x3_chw_dw_tc": 0, "itg_upconv3x3_chw_dw": 0,
                                 "itg_stem_fwd_tc": 0, "itg_stem_fwd": 0,
                                 "itg_stem_dw_tc": 0, "itg_stem_dw": 0,
                                 "itg_stem_dx_tc": 0, "itg_stem_dx": 0,
                                 "itg_conv1x1_chw_tc": 0, "itg_conv1x1_chw": 0,
                                 "itg_conv1x1_chw_dw_tc": 0, "itg_conv1x1_chw_dw": 0}
    assert (tk.LAUNCHES["conv3x3_chw"], tk.LAUNCHES["chw_halo_step"]) == (1, 1)


def test_fwd_tc_refuses_wider(cuda):
    """A bf16 call outside the route's plan raises, naming the limit; nothing
    falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    for shape in ((1, 129, 3, 8, 16), (1, 13, 65, 8, 16)):
        x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
        with pytest.raises(ValueError, match="tensor-core conv3x3 forward"):
            tk.conv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    assert tk.ROUTE_LAUNCHES["itg_conv3x3_chw"] == 0


# K10's x shapes (N, C, H, W): small ragged ones, the Experiment-1 step's
# two (N = 8, blocks 5 and 6), the --fuse_up all sub-image's three (N = 1,
# blocks 4-6: the plan's small blocks), an odd W (rows at every offset
# within 16 bytes) and a W of 1 (element by element only)
UP2ADD_SHAPES = [(2, 5, 7, 9), (1, 26, 48, 96), (1, 3, 1, 3), (8, 26, 96, 96), (8, 13, 192, 192),
                 (1, 52, 48, 48), (1, 26, 96, 96), (1, 13, 192, 192), (2, 5, 7, 47), (2, 3, 5, 1)]
# Σy and Σy² against float64 sums of the stored y: the kernel sums float32
# values in one fixed order, at most ~90 deep (64 values a thread at the
# widest plan, a tree over the block's threads, then over the N x chunks
# partials), so each sum sits within 90 x 2^-24 ~ 5.4e-6 of Σ|y| (Σy² for
# the squares) of the exact one: 1e-5 of it leaves a factor of two.
UP2ADD_SUM_TOL = 1e-5


def _up2add_case(cuda, dtype, shape, seed=8):
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, dtype)
    res = torch.randn(n, c, 2 * h, 2 * w, generator=gen).to(cuda, dtype)
    return x, res


def _up2add_sums_ratio(y, s1, s2):
    """The larger of Σy's and Σy²'s worst errors against float64 sums of
    the stored y, each over its limit (UP2ADD_SUM_TOL of Σ|y| or Σy²)."""
    yd = y.double()
    ratios = []
    for got, terms in ((s1, yd), (s2, yd * yd)):
        err = (got.double() - terms.sum(dim=(0, 2, 3))).abs()
        ratios.append(float((err / (UP2ADD_SUM_TOL * terms.abs().sum(dim=(0, 2, 3)))).max()))
    return max(ratios)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UP2ADD_SHAPES)
def test_upsample2_add_kernel_matches_plain(cuda, dtype, shape):
    """K10's y is one rounded float32 add on both sides: bit-equal, with and
    without stats; one entry-point call (1 and 2 device launches) each."""
    x, res = _up2add_case(cuda, dtype, shape)
    tk.reset_launches()
    assert torch.equal(tk.upsample2_chw_add(x, res), tk.upsample2_chw_add_plain(x, res))
    y, s1, s2 = tk.upsample2_chw_add(x, res, want_stats=True)
    assert torch.equal(y, tk.upsample2_chw_add_plain(x, res))
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    assert tk.LAUNCHES["upsample2_chw_add"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1])
def test_upsample2_add_kernel_on_offset_view(cuda, dtype, which):
    """x (or res) a contiguous view one element into its storage: no x (or
    res) row is 16-byte aligned, so those rows go element by element; y and
    the sums still come out as the plain version's."""
    args = list(_up2add_case(cuda, dtype, (2, 13, 24, 48)))
    flat = torch.empty(args[which].numel() + 1, dtype=dtype, device=cuda)
    view = flat[1:].view(args[which].shape)
    view.copy_(args[which])
    assert view.is_contiguous() and view.data_ptr() % 16
    args[which] = view
    y, s1, s2 = tk.upsample2_chw_add(*args, want_stats=True)
    assert torch.equal(y, tk.upsample2_chw_add_plain(*args))
    assert _up2add_sums_ratio(y, s1, s2) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 26, 96, 96), (8, 13, 192, 192), (2, 5, 7, 47)])
def test_upsample2_add_stats_repeatable(cuda, dtype, shape):
    """Fixed-order partials and no atomics: two calls give the same bits
    for y, Σy and Σy²."""
    x, res = _up2add_case(cuda, dtype, shape)
    first = tk.upsample2_chw_add(x, res, want_stats=True)
    second = tk.upsample2_chw_add(x, res, want_stats=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UP2ADD_SHAPES)
def test_upsample2_add_stats_match_float64(cuda, dtype, shape):
    """Σy and Σy² within UP2ADD_SUM_TOL of float64 sums of the stored y."""
    x, res = _up2add_case(cuda, dtype, shape)
    y, s1, s2 = tk.upsample2_chw_add(x, res, want_stats=True)
    assert _up2add_sums_ratio(y, s1, s2) <= 1.0


def test_upsample2_add_check_catches_planted_faults(cuda):
    """The checks above fail on one output element one bf16 step off (the
    bit-equal check) and on sums that lost one block's partial (the
    float64 check): the rows of one (image, row chunk) of one channel, as
    the plan cuts them. The residual is shifted by one, so that a chunk's
    sum is far from zero, as a real activation's mean is."""
    shape = (8, 13, 192, 192)
    x, res = _up2add_case(cuda, torch.bfloat16, shape)
    res += 1.0
    y, s1, s2 = tk.upsample2_chw_add(x, res, want_stats=True)
    assert torch.equal(y, tk.upsample2_chw_add_plain(x, res))
    assert _up2add_sums_ratio(y, s1, s2) <= 1.0
    bad = y.clone()
    bad.view(torch.int16).view(-1)[12345] += 1  # the next bf16 value
    assert not torch.equal(bad, tk.upsample2_chw_add_plain(x, res))
    plan = tk.upsample2_add_plan(*shape, 2, tk._sm_count(y.device.index))
    rows = y[3, 5, 2 * plan.chunk : 4 * plan.chunk].double()  # image 3, chunk 1, channel 5
    lost1, lost2 = s1.clone(), s2.clone()
    lost1[5] -= float(rows.sum())
    lost2[5] -= float((rows * rows).sum())
    assert _up2add_sums_ratio(y, lost1, s2) > 10.0
    assert _up2add_sums_ratio(y, s1, lost2) > 10.0


# --- K14: K9's forward with the raster engine's cached half-res borders ----
# half-res shapes n, c, co, h, w: a small ragged one (h, w no multiple of the
# 32 x 8 tile) and the flagship's block-4 site of a 384^2 sub-image
UPCONV_HALO_SHAPES = [(1, 7, 5, 11, 37), (1, 104, 52, 48, 48)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("borders", ["none", "top", "left", "both"])
@pytest.mark.parametrize("shape", UPCONV_HALO_SHAPES)
def test_upconv_halo_kernel_matches_plain(cuda, dtype, outer, borders, shape):
    n, c, co, h, w = shape
    x, wt, b, sc, sh = _inputs(cuda, dtype, n=n, c=c, co=co, h=h, w=w)
    gen = torch.Generator().manual_seed(11)
    top = torch.relu(torch.randn(n, c, w + 2, generator=gen)).to(cuda, dtype)
    left = torch.relu(torch.randn(n, c, h, generator=gen)).to(cuda, dtype)
    top = top if borders in ("top", "both") else None
    left = left if borders in ("left", "both") else None
    tk.reset_launches()
    y = tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left)
    assert (tk.LAUNCHES["chw_upconv_halo_step"], tk.LAUNCHES["upconv3x3_chw"]) == (1, 0)
    plain = (tk.upconv3x3_chw_halo_tc_plain if dtype == torch.bfloat16
             else tk.upconv3x3_chw_halo_plain)
    _assert_close(y, plain(x, wt, b, sc, sh, True, outer, top, left))
    if borders == "none":  # one kernel body: K9's bits
        assert torch.equal(y, tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer))


# --- K9's forward and K14 on the tensor cores, bf16 ------------------------
# half-res n, c, co, h, w: every main-path shape (the flagship's fused
# blocks 4-6 at eval, N = 1; the Experiment-1 step's blocks 5-6, N = 8),
# then ragged ones (h, w no multiple of the tile; 2w no multiple of 8, whose
# rows store element by element; 1 x 3) and the plan's widest (C = 128, Co =
# 64, 4-row tiles only). Inputs from _fwd_case: unit-variance outputs and a
# unit-scale bias (a dropped one reads well above the bf16 limit).
UPTC_SHAPES = [(1, 104, 52, 48, 48), (1, 52, 26, 96, 96), (1, 26, 13, 192, 192),
               (8, 52, 26, 96, 96), (8, 26, 13, 192, 192), (2, 11, 19, 5, 7), (1, 5, 3, 1, 3),
               (2, 13, 19, 23, 35), (1, 128, 64, 10, 20)]
# each planted fault must read at least this many times the check's limit
UPTC_PLANT = 10.0


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("shape", UPTC_SHAPES)
def test_upconv_tc_matches_plain(cuda, outer, shape):
    """bf16 K9 runs the tensor-core kernel, with and without its sums, held
    to the plain version with the combined weights rounded; the sums are of
    the stored y."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    ref = tk.upconv3x3_chw_tc_plain(x, wt, b, sc, sh, True, outer)
    y = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer)
    y2, s1, s2 = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_tc"], tk.ROUTE_LAUNCHES["itg_upconv3x3_chw"]) == (2, 0)
    _assert_fwd_close(y, ref)
    assert torch.equal(y, y2)
    _assert_stats_close(y2, s1, s2)


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("borders", list(FWD_BORDERS))
@pytest.mark.parametrize("shape", [UPTC_SHAPES[i] for i in (0, 2, 5, 6, 7)])
def test_upconv_tc_halo_matches_plain(cuda, outer, borders, shape):
    """bf16 K14 (the same kernel given the cached half-res top row and left
    column) in its four border cases, held to its rounded plain version;
    with no cache it gives K9's bits."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, shape)
    t_, l_ = FWD_BORDERS[borders]
    tb, lb = (top if t_ else None), (left if l_ else None)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    y = tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, tb, lb)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_upconv3x3_chw_tc"], tk.ROUTE_LAUNCHES["itg_upconv3x3_chw"]) == (1, 0)
    _assert_fwd_close(y, tk.upconv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True, outer, tb, lb))
    if borders == "none":
        assert torch.equal(y, tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer))


@pytest.mark.parametrize("outer", ["replicate", "constant"])
@pytest.mark.parametrize("case", [0, 2, 4, 7])
def test_upconv_tc_bits_repeat(cuda, outer, case):
    """Fixed-order sums and no atomics: two calls give the same y, Σy and
    Σy²; and an image's y does not depend on the batch around it, which sets
    the tile height (4 rows for one image at every flagship shape, 8 rows
    for eight at the training shapes): each output sums in one order
    wherever its tile lies."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, UPTC_SHAPES[case])
    first = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    second = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    one = [t[:1] for t in (x, top, left)]
    eight = [t.expand(8, *t.shape[1:]).contiguous() for t in one]
    alone = tk.upconv3x3_chw_halo(one[0], wt, b, sc, sh, True, outer, one[1], one[2])
    batch = tk.upconv3x3_chw_halo(eight[0], wt, b, sc, sh, True, outer, eight[1], eight[2])
    assert all(torch.equal(batch[i], alone[0]) for i in range(8))


@pytest.mark.parametrize("shape", [(1, 52, 26, 40, 72), (1, 13, 3, 37, 45)])
def test_upconv_tc_window_bit_equal(cuda, shape):
    """K14 on an interior half-res window of x, given the top row and left
    column that K9's padded post-norm half-res input holds there, equals
    K9's output bit for bit on the window's pixels away from its bottom row
    and right column (which K14 pads from the window's own edge): the
    raster gives the one pass's bits."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
    r0, c0, hw, ww = 5, 16, 17, 24
    y = tk.upconv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    padded = torch.nn.functional.pad(tk.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
    top = padded[:, :, r0, c0 : c0 + ww + 2].contiguous()
    left = padded[:, :, r0 + 1 : r0 + 1 + hw, c0].contiguous()
    win = x[:, :, r0 : r0 + hw, c0 : c0 + ww].contiguous()
    y_win = tk.upconv3x3_chw_halo(win, wt, b, sc, sh, True, "replicate", top, left)
    assert torch.equal(y_win[..., :-2, :-2],
                       y[..., 2 * r0 : 2 * (r0 + hw) - 2, 2 * c0 : 2 * (c0 + ww) - 2])


@pytest.mark.parametrize("shape", [UPTC_SHAPES[1], UPTC_SHAPES[7]])
def test_upconv_tc_on_offset_view(cuda, shape):
    """x one element into its storage (not 16-byte aligned): the kernel
    stages element by element and gives the aligned copy's bits."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, shape)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    for outer in ("replicate", "constant"):
        assert torch.equal(tk.upconv3x3_chw(view, wt, b, sc, sh, True, outer),
                           tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer))
        assert torch.equal(tk.upconv3x3_chw_halo(view, wt, b, sc, sh, True, outer, top, left),
                           tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left))


def _plant_ratio(bad, ref):
    """max abs err over the bf16 check's limit (BF16_TOL of max|ref|)."""
    err = float((bad.float() - ref.float()).abs().max())
    return err / (BF16_TOL * float(ref.float().abs().max()))


@pytest.mark.parametrize("case", [0, 3, 5])
def test_upconv_tc_check_catches_planted_faults(cuda, case):
    """The bf16 check fails, by at least UPTC_PLANT times its limit, on a
    forward that is slightly wrong: phases (0, 1) and (1, 0) swapping taps
    (ky and kx swapped in the weights), one slot of phase (0, 0) skipped
    (its products taken out of the kernel's y), K14 reading its cached top
    row's cells as the own edge, the bias dropped."""
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, UPTC_SHAPES[case])
    n, c, co, h, w = UPTC_SHAPES[case]
    ref = tk.upconv3x3_chw_tc_plain(x, wt, b, sc, sh, True, "replicate")
    y = tk.upconv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    _assert_fwd_close(y, ref)
    halo_ref = tk.upconv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True, "replicate", top, left)
    _assert_fwd_close(tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", top, left),
                      halo_ref)
    a_pad = torch.nn.functional.pad(tk.prenorm(x, sc, sh, True).float(), (1, 1, 1, 1),
                                    mode="replicate")
    wc = tk._upconv_phase_weights(wt).to(torch.bfloat16).float().reshape(co, c, 2, 2, 2, 2)
    skipped = y.float()
    skipped[..., 0::2, 0::2] -= torch.nn.functional.conv2d(
        a_pad[:, :, 1 : h + 1, 1 : w + 1], wc[:, :, 0, 0, 1, 1, None, None])
    for fault, bad, r in (
            ("ky<->kx", tk.upconv3x3_chw(x, wt.transpose(2, 3).contiguous(), b, sc, sh, True,
                                         "replicate"), ref),
            ("slot (1, 1) of phase (0, 0) skipped", skipped, ref),
            ("the cached top row read as the own edge",
             tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", None, left), halo_ref),
            ("the bias dropped", tk.upconv3x3_chw(x, wt, torch.zeros_like(b), sc, sh, True,
                                                  "replicate"), ref)):
        assert _plant_ratio(bad, r) >= UPTC_PLANT, fault


@pytest.mark.parametrize("c,co", [(104, 52), (13, 3), (128, 64), (11, 19)])
def test_upconv_tc_packs_weights_as_plain(cuda, c, co):
    """The entry point's first launch writes the B operands (its wp scratch)
    bit for bit as ``pack_upconv_weights``: the combined phase weights in
    float32 in the plain version's order, then rounded."""
    x, wt, b, sc, sh, _, _ = _fwd_case(cuda, (1, c, co, 8, 16))
    nc, no = tk.upconv_tc_plan(c, co)
    wp = torch.full((4, 8 * no, 4, 8 * nc), float("nan"), device=cuda).to(torch.bfloat16)
    y = torch.empty((1, co, 16, 32), dtype=torch.bfloat16, device=cuda)
    rc = tk._lib().itg_upconv3x3_chw_tc(
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), sc.data_ptr(), sh.data_ptr(), None, None,
        wp.data_ptr(), y.data_ptr(), None, None, None, 1, c, 8, 16, co, 1, 0, nc, no,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(wp.cpu(), tk.pack_upconv_weights(wt.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_routes_by_dtype(cuda, dtype):
    """bf16 calls of K9's forward and K14 launch the tensor-core entry
    point, f32 calls the CUDA-core one; each counts one launch per call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, wt, b, sc, sh, top, left = _fwd_case(cuda, UPTC_SHAPES[5])
    x, top, left = x.to(dtype), top.to(dtype), left.to(dtype)
    tk.upconv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    tk.upconv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate", top, left)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_upconv3x3_chw_tc": 2 * tc,
                                 "itg_upconv3x3_chw": 2 * (not tc)}
    assert (tk.LAUNCHES["upconv3x3_chw"], tk.LAUNCHES["chw_upconv_halo_step"]) == (1, 1)


def test_upconv_tc_refuses_wider(cuda):
    """A bf16 call outside the route's plan raises, naming the limit; nothing
    falls back to the CUDA-core kernel."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    for shape in ((1, 129, 3, 8, 16), (1, 13, 65, 8, 16)):
        x, wt, b, sc, sh, _, _ = _fwd_case(cuda, shape)
        with pytest.raises(ValueError, match="tensor-core up-conv forward"):
            tk.upconv3x3_chw(x, wt, b, sc, sh, True, "replicate")
    assert tk.ROUTE_LAUNCHES["itg_upconv3x3_chw"] == 0


def _fuse_all_gen(cuda, dtype=torch.float32):
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True, fuse_up="all",
                                 dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
        gen.attention.attn.gamma.zero_()
    return gen.to(cuda).eval(), g


def test_fuse_all_raster_canvas_on_card_equals_one_pass(cuda):
    """--fuse_up all (block 4 fuses): K14 with half-res conv1 caches in the
    raster, K9 on the one pass. One kernel body sums each output in one
    order wherever its tile lies; the limit covers cuDNN's choices in the
    NHWC blocks."""
    gen, g = _fuse_all_gen(cuda)
    _, _, th, tw = canvas_geometry(160, 224, gen.patch_resolution, 3, 3)
    z = torch.randn(1, th * 4 + 2, tw * 4 + 2, 16, generator=g)
    tk.reset_launches()
    canvas = generate_canvas(gen, None, 160, 224, z_full=z)
    steps = 2 * 3
    assert {k: v for k, v in tk.LAUNCHES.items() if v} == {
        "chw_upconv_halo_step": steps, "chw_halo_step": 2 * steps, "conv1x1_chw": steps,
        "upsample2_chw_add": steps}
    tk.reset_launches()
    oracle = generate_one_pass(gen, z, th, tw)[:, :160, :224].cpu().numpy()
    assert {k: v for k, v in tk.LAUNCHES.items() if v} == {
        "upconv3x3_chw": 1, "conv3x3_chw": 2, "conv1x1_chw": 1, "upsample2_chw_add": 1}
    np.testing.assert_allclose(canvas, oracle, atol=5e-4, rtol=0)


def test_fuse_all_streamed_png_on_card_equals_in_memory(cuda, tmp_path):
    """bf16 under --fuse_up all: the streamed PNG (pinned copies fenced by
    events, one band per canvas row) is the in-memory u8 canvas, byte for
    byte."""
    from infinite_texture_gans_torch.sampling.stream import generate_canvas_streamed, read_png

    gen, _ = _fuse_all_gen(cuda, torch.bfloat16)
    want = generate_canvas(gen, torch.Generator(device=cuda).manual_seed(3), 290, 200, wire="u8")[0]
    path = generate_canvas_streamed(gen, torch.Generator(device=cuda).manual_seed(3), 290, 200,
                                    str(tmp_path / "s.png"), row_group=1)
    np.testing.assert_array_equal(read_png(path), want)


@pytest.mark.parametrize("fuse_up", ["auto", "off"])
def test_train_step_on_card_matches_cpu(cuda, monkeypatch, fuse_up):
    """A tiny fused step on the card with the kernels against the same step
    on the card with the tail's and the stem's plain versions swapped in
    (cuDNN runs the NHWC layers in both), float32 with TF32 off; the losses
    also against the CPU step."""
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.train.train_step import create_train_state, train_step

    args = prepare_parser().parse_args(
        ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
         "--padding_mode", "local", "--attention", "--spec_norm_D", "--ema", "--num_images", "2",
         "--fuse_up", fuse_up])
    gen = torch.Generator().manual_seed(6)
    real = torch.rand(4, 48, 48, 3, generator=gen) * 2 - 1
    z = torch.randn(2, 14, 14, 16, generator=gen)
    twins = {"conv3x3_chw": tk.conv3x3_chw_plain, "conv1x1_chw": tk.conv1x1_chw_plain,
             "conv1x1_chw_add": tk.conv1x1_chw_plain, "upsample2_chw": tk.upsample2_chw_plain,
             "upconv3x3_chw": tk.upconv3x3_chw_plain,
             "upsample2_chw_add": tk.upsample2_chw_add_plain,
             "conv4x4s2_stem_chw": tk.stem_fwd_plain}
    out = {}
    for run in ("cpu", "cuda", "cuda plain"):
        dev = run.split()[0]
        st = create_train_state(args, 4, dev, seed=1)
        tk.reset_launches()
        with monkeypatch.context() as mp:
            if run == "cuda plain":
                for name, fn in twins.items():
                    mp.setattr(tk, name, fn)
            m = train_step(st, real.to(dev), z.to(dev), smooth=True, use_ema=True)
        out[run] = (m, {n: p.grad.cpu() for n, p in st.G.named_parameters()},
                    {n: p.grad.cpu() for n, p in st.D.named_parameters()}, dict(tk.LAUNCHES))
    for ref_run in ("cpu", "cuda plain"):
        for k, ref in out[ref_run][0].items():
            assert abs(float(out["cuda"][0][k]) - float(ref)) <= 1e-4 * abs(float(ref)), (ref_run, k)
    for i in (1, 2):
        # a leaf below 1e-6 of the model's largest gradient is rounding noise
        # (zero in exact arithmetic: a bias that reaches only train-mode
        # BatchNorms): held to 1e-3 of the model's largest gradient
        want = out["cuda plain"][i]
        top = max(float(r.abs().max()) for r in want.values())
        for name, ref in want.items():
            scale = float(ref.abs().max())
            scale = top if scale < 1e-6 * top else scale
            assert float((out["cuda"][i][name] - ref).abs().max()) <= 1e-3 * scale, name
    assert not any(out["cuda plain"][3].values())
    launches = out["cuda"][3]
    assert launches["stem_fwd"] == 2 and launches["stem_dw"] == 1 and launches["stem_dx"] == 1
    if fuse_up == "off":  # block4 conv1/conv2, final
        assert launches["conv3x3_chw_dx"] == launches["conv3x3_chw_dw"] == 3
        assert launches["upconv3x3_chw"] == launches["upsample2_chw_add"] == 0
    else:  # block4 fuses: conv1 is K9, the shortcut joins through K10
        assert launches["conv3x3_chw_dx"] == launches["conv3x3_chw_dw"] == 2
        assert (launches["upconv3x3_chw"], launches["upconv3x3_chw_dx"], launches["upconv3x3_chw_dw"],
                launches["upsample2_chw_add"], launches["upsample2_chw"]) == (1, 1, 1, 1, 0)


# --- the SSM embed chain K15 (forward, backward) and the SSM generator -----
# shapes n, md, h, w, hid, co: the models' hid 128 with H and W that are no
# multiple of 8 or of the kernels' tiles, md 1 and 3, and tiny odd ones
SSM_SHAPES = [(2, 1, 13, 45, 128, 19), (1, 3, 20, 37, 128, 104), (2, 3, 5, 7, 32, 8),
              (1, 1, 1, 3, 16, 3)]


# The bf16 route's dW1 and db1 sum d_pre, which it rounds to bf16: where the
# kernel's float32 d_act and the plain version's float64 one straddle a
# rounding midpoint, the two round a bf16 step apart, and those steps add up
# to 2.2e-4 of max|ref| at SSM_SHAPES (H100, this file; dW2 and db2, with
# the kernels' own float32 pre-activation in the plain version, to 2e-7).
# A planted dW1 x 1.01 is 1e-2 of max|ref|.
DPRE_TOL = 5e-4


def _ssm_inputs(cuda, dtype, shape, seed=9):
    n, md, h, w, hid, co = shape
    gen = torch.Generator().manual_seed(seed)
    maps = torch.randn(n, md, h + 4, w + 4, generator=gen).to(cuda, dtype)
    w1 = (torch.randn(hid, md, 3, 3, generator=gen) / (3 * md**0.5)).to(cuda)
    b1 = (0.1 * torch.randn(hid, generator=gen)).to(cuda)
    w2 = (torch.randn(co, hid, 3, 3, generator=gen) / (3 * hid**0.5)).to(cuda)
    b2 = (0.1 * torch.randn(co, generator=gen)).to(cuda)
    g = torch.randn(n, co, h, w, generator=gen).to(cuda, dtype)
    return maps, w1, b1, w2, b2, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_ssm_embed_kernels_match_plain(cuda, dtype, shape):
    """f32 (CUDA cores) within the f32 limits; bf16 (tensor cores): the
    forward within the bf16 limit, the backward's sums within SUM_TOL (dW1
    and db1 DPRE_TOL) of the plain version that applies the route's
    roundings of the hidden activation, w2 and d_pre
    (``ssm.ssm_embed_bwd_tc_plain``)."""
    from infinite_texture_gans_torch.ops import ssm

    maps, w1, b1, w2, b2, g = _ssm_inputs(cuda, dtype, shape)
    tk.reset_launches()
    _assert_close(ssm.ssm_embed(maps, w1, b1, w2, b2), ssm.ssm_embed_plain(maps, w1, b1, w2, b2))
    got = ssm.ssm_embed_bwd(maps, w1, b1, w2, g)
    tc = dtype == torch.bfloat16
    plain = ssm.ssm_embed_bwd_tc_plain if tc else ssm.ssm_embed_bwd_plain
    ref = plain(maps, w1, b1, w2, g)
    print(f"[reading] {shape} {dtype}: max abs err / max|ref| dW2, db2, dW1, db1",
          [float((a - r).abs().max() / r.abs().max().clamp_min(1e-6)) for a, r in zip(got, ref)])
    for a, r, tol in zip(got, ref, (SUM_TOL, SUM_TOL) + (DPRE_TOL if tc else SUM_TOL,) * 2):
        _assert_sum_close(a, r, tol)
    assert (tk.LAUNCHES["ssm_embed"], tk.LAUNCHES["ssm_embed_bwd"]) == (1, 1)


@pytest.mark.parametrize("shape", [SSM_SHAPES[1], (4, 1, 64, 80, 128, 52)])
def test_ssm_embed_bwd_bf16_check_catches_planted_faults(cuda, shape):
    """The check above fails on a tensor-core backward that is slightly
    wrong: dW1 x 1.01, or dW1 or dW2 with dy and dx swapped."""
    from infinite_texture_gans_torch.ops import ssm

    maps, w1, b1, w2, _, g = _ssm_inputs(cuda, torch.bfloat16, shape)
    dw2, _, dw1, _ = ssm.ssm_embed_bwd(maps, w1, b1, w2, g)
    ref_w2, _, ref_w1, _ = ssm.ssm_embed_bwd_tc_plain(maps, w1, b1, w2, g)
    _assert_sum_close(dw2, ref_w2)
    _assert_sum_close(dw1, ref_w1, DPRE_TOL)
    for bad, ref, tol in ((dw1 * 1.01, ref_w1, DPRE_TOL), (dw1.transpose(2, 3), ref_w1, DPRE_TOL),
                          (dw2.transpose(2, 3), ref_w2, SUM_TOL)):
        with pytest.raises(AssertionError):
            _assert_sum_close(bad, ref, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_embed_routes_by_dtype(cuda, dtype):
    """bf16 calls launch the tensor-core entry points, f32 calls the
    CUDA-core ones; each counts one launch per call."""
    from infinite_texture_gans_torch.ops import ssm

    maps, w1, b1, w2, b2, g = _ssm_inputs(cuda, dtype, SSM_SHAPES[0])
    for k in ssm.ROUTE_LAUNCHES:
        ssm.ROUTE_LAUNCHES[k] = 0
    ssm.ssm_embed(maps, w1, b1, w2, b2)
    ssm.ssm_embed_bwd(maps, w1, b1, w2, g)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert ssm.ROUTE_LAUNCHES == {"itg_ssm_embed_tc_fwd": int(tc), "itg_ssm_embed_tc_bwd": int(tc),
                                  "itg_ssm_embed_fwd": int(not tc), "itg_ssm_embed_bwd": int(not tc)}


@pytest.mark.parametrize("shape", [SSM_SHAPES[1], (4, 1, 64, 80, 128, 52)])
def test_ssm_embed_bwd_bf16_bits_repeat(cuda, shape):
    """The tensor-core backward sums its partials in a fixed order, with no
    atomics: two calls give the same bits."""
    from infinite_texture_gans_torch.ops import ssm

    maps, w1, b1, w2, _, g = _ssm_inputs(cuda, torch.bfloat16, shape)
    first = ssm.ssm_embed_bwd(maps, w1, b1, w2, g)
    second = ssm.ssm_embed_bwd(maps, w1, b1, w2, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_embed_window_bit_equal(cuda, dtype):
    """Each K15 output sums its products in one fixed order, so a window of
    the maps gives the same bits as the same window of the whole output."""
    from infinite_texture_gans_torch.ops import ssm

    gen = torch.Generator().manual_seed(10)
    maps = torch.randn(1, 1, 100 + 4, 150 + 4, generator=gen).to(cuda, dtype)
    w1 = (torch.randn(128, 1, 3, 3, generator=gen) / 3).to(cuda)
    b1 = (0.1 * torch.randn(128, generator=gen)).to(cuda)
    w2 = (torch.randn(52, 128, 3, 3, generator=gen) / 34).to(cuda)
    b2 = (0.1 * torch.randn(52, generator=gen)).to(cuda)
    full = ssm.ssm_embed(maps, w1, b1, w2, b2)
    for r0, c0, h, w in ((0, 0, 37, 61), (13, 29, 64, 96), (36, 54, 64, 96)):
        win = ssm.ssm_embed(maps[..., r0 : r0 + h + 4, c0 : c0 + w + 4].contiguous(), w1, b1, w2, b2)
        assert torch.equal(win, full[..., r0 : r0 + h, c0 : c0 + w]), (r0, c0)


def _ssm_gen(cuda, gamma=0.0):
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True, type_norm="SSM", map_dim=2)
    g = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
        gen.attention.attn.gamma.fill_(gamma)
    return gen.to(cuda).eval(), g


def test_ssm_raster_canvas_on_card_equals_one_pass(cuda):
    """K15 sums each output in one fixed order, so the raster's channels-
    major SSM sites give the one pass's bits; the limit covers cuDNN's
    algorithm choices in the NHWC blocks."""
    from infinite_texture_gans_torch.sampling import latents

    gen, g = _ssm_gen(cuda)
    _, _, th, tw = canvas_geometry(160, 224, gen.patch_resolution, 3, 3)
    z = torch.randn(1, th * 4 + 2, tw * 4 + 2, 16, generator=g)
    maps = latents.build_maps_full(g, 1, 2, 4, 4, th, tw, device="cpu")
    tk.reset_launches()
    canvas = generate_canvas(gen, None, 160, 224, z_full=z, maps_full=maps)
    assert tk.LAUNCHES["ssm_embed"] == 3 * 2 * 3  # block 4's three SSM sites, 2x3 steps
    assert tk.LAUNCHES["chw_halo_step"] == 3 * 2 * 3
    oracle = generate_one_pass(gen, z, th, tw, maps_full=maps)[:, :160, :224].cpu().numpy()
    np.testing.assert_allclose(canvas, oracle, atol=5e-4, rtol=0)


def test_ssm_train_step_on_card_matches_plain(cuda, monkeypatch):
    """A tiny SSM step on the card with the kernels against the same step
    with the tail's, K15's and the stem's plain versions, float32 with TF32
    off."""
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.ops import ssm
    from infinite_texture_gans_torch.sampling.latents import build_train_maps
    from infinite_texture_gans_torch.train.train_step import create_train_state, train_step

    args = prepare_parser().parse_args(
        ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
         "--padding_mode", "local", "--attention", "--spec_norm_D", "--num_images", "2",
         "--type_norm_G", "SSM", "--map_dim", "2"])
    gen = torch.Generator().manual_seed(6)
    real = torch.rand(4, 48, 48, 3, generator=gen) * 2 - 1
    z = torch.randn(2, 14, 14, 16, generator=gen)
    maps = build_train_maps(gen, 2, 2, 4, 4, 3, 3, device="cpu")
    out = {}
    for run in ("cuda", "cuda plain"):
        st = create_train_state(args, 4, cuda, seed=1)
        tk.reset_launches()
        with monkeypatch.context() as mp:
            if run == "cuda plain":
                for name in ("conv3x3_chw", "conv1x1_chw_add", "upsample2_chw"):
                    mp.setattr(tk, name, getattr(tk, name.replace("_add", "") + "_plain"))
                mp.setattr(tk, "conv4x4s2_stem_chw", tk.stem_fwd_plain)
                mp.setattr(ssm, "ssm_embed", ssm.ssm_embed_plain)
            m = train_step(st, real.to(cuda), z.to(cuda), [a.to(cuda) for a in maps], smooth=True)
        out[run] = (m, {n: p.grad.cpu() for n, p in st.G.named_parameters()}, dict(tk.LAUNCHES))
    for k, ref in out["cuda plain"][0].items():
        assert abs(float(out["cuda"][0][k]) - float(ref)) <= 1e-4 * abs(float(ref)), k
    want = out["cuda plain"][1]
    top = max(float(r.abs().max()) for r in want.values())
    for name, ref in want.items():
        scale = float(ref.abs().max())
        scale = top if scale < 1e-6 * top else scale
        assert float((out["cuda"][1][name] - ref).abs().max()) <= 1e-3 * scale, name
    assert not any(out["cuda plain"][2].values())
    launches = out["cuda"][2]
    # block 4's bn1, bn2, bn3; conv1 (stats), conv2, final; SSM never fuses
    assert (launches["ssm_embed"], launches["ssm_embed_bwd"], launches["conv3x3_chw"]) == (3, 3, 3)
    assert (launches["bn_corr"], launches["upsample2_chw"], launches["upconv3x3_chw"]) == (1, 1, 0)


# --- K3 and K3-dW on the tensor cores, bf16 ---------------------------------
# n, c, co, h, w: the main path's K3 shapes (eval at N = 1: BN blocks 4-6,
# the `all` half-res shortcut, SSM blocks 4-5; the steps at N = 8, the
# shortcut and its dx form), ragged ones (C and Co no multiples of 8, HW no
# multiple of a tile or of 8), more than 64 output channels (a second block
# along Co) and the widest C (768).
CONV1X1_SHAPES = [(1, 104, 52, 96, 96), (1, 52, 26, 192, 192), (1, 26, 13, 384, 384),
                  (1, 104, 52, 48, 48), (1, 52, 26, 96, 96), (1, 26, 13, 192, 192),
                  (8, 52, 26, 96, 96), (8, 26, 52, 96, 96), (8, 26, 13, 192, 192),
                  (8, 13, 26, 192, 192), (8, 52, 26, 192, 192), (8, 26, 52, 192, 192),
                  (8, 26, 13, 384, 384), (2, 37, 21, 9, 31), (2, 11, 19, 5, 7), (1, 5, 3, 1, 3),
                  (3, 13, 70, 10, 40), (2, 130, 9, 12, 20), (1, 768, 100, 8, 24)]
# the dW's: the main path's (N = 8), ragged ones, and C + Co = 96 (the
# CUDA-core kernel's widest) in each plan that takes it
CONV1X1_DW_SHAPES = [(8, 52, 26, 96, 96), (8, 26, 13, 192, 192), (8, 52, 26, 192, 192),
                     (8, 26, 13, 384, 384), (2, 37, 21, 9, 31), (2, 11, 19, 5, 7),
                     (1, 5, 3, 1, 3), (3, 13, 3, 23, 70), (2, 48, 48, 20, 30),
                     (2, 64, 32, 16, 16), (2, 95, 1, 9, 40), (2, 1, 95, 9, 40),
                     (2, 33, 63, 17, 17), (2, 70, 26, 24, 24), (2, 20, 76, 13, 50)]


def _conv1x1_case(cuda, shape, seed=41, bias=1.0):
    """bf16 x and res (n, co, h, w), float32 W (co, c) at unit output
    variance and b (unit scale: a dropped bias reads above the limit)."""
    n, c, co, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn(co, c, generator=g) * c ** -0.5).to(cuda)
    b = (bias * torch.randn(co, generator=g)).to(cuda)
    res = torch.randn(n, co, h, w, generator=g).to(cuda, torch.bfloat16)
    return x, wt, b, res


def _conv1x1_elem_limit(x, wt, b, res, ref):
    """Each y's limit: one bf16 step of the reference value (2^-7 of it,
    covering a rounding either way) and a bound on the float32 sums' reorder,
    4 (C + 2) 2^-24 of Σ|terms| (kernel and plain version add the same exact
    products, the bias and the residual in other orders; the tensor cores'
    accumulation may round toward zero)."""
    c = x.shape[1]
    mag = torch.nn.functional.conv2d(x.float().abs(), wt.abs().to(torch.bfloat16).float()
                                     .reshape(wt.shape[0], c, 1, 1))
    mag = mag + b.to(torch.bfloat16).float().abs().reshape(1, -1, 1, 1)
    if res is not None:
        mag = mag + res.float().abs()
    return 2.0**-7 * ref.float().abs() + 4 * (c + 2) * 2.0**-24 * mag


def _assert_conv1x1_close(y, x, wt, b, res):
    """bf16 K3 against the plain version with W and b rounded to bf16: within
    2^-7 of max|ref|, and each y within its own limit (_conv1x1_elem_limit)."""
    ref = tk.conv1x1_chw_tc_plain(x, wt, b, res)
    _assert_fwd_close(y, ref)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= _conv1x1_elem_limit(x, wt, b, res, ref)).all()), float(err.max())


@pytest.mark.parametrize("variant", ["plain", "res", "res_stats"])
@pytest.mark.parametrize("shape", CONV1X1_SHAPES)
def test_conv1x1_tc_matches_plain(cuda, variant, shape):
    """bf16 K3 runs the tensor-core kernel (without and with the residual,
    with the sums of the stored y), held to the rounded plain version."""
    x, wt, b, res = _conv1x1_case(cuda, shape)
    res = None if variant == "plain" else res
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    if variant == "res_stats":
        y, s1, s2 = tk.conv1x1_chw_add(x, wt, b, res, want_stats=True)
    else:
        y = tk.conv1x1_chw_add(x, wt, b, res) if res is not None else tk.conv1x1_chw(x, wt, b)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_conv1x1_chw_tc"], tk.ROUTE_LAUNCHES["itg_conv1x1_chw"]) == (1, 0)
    _assert_conv1x1_close(y, x, wt, b, res)
    if variant == "res_stats":
        _assert_stats_close(y, s1, s2)


@pytest.mark.parametrize("case", [0, 3, 6, 13, 17])
def test_conv1x1_tc_bits_repeat(cuda, case):
    """Fixed-order sums and no atomics: two calls give the same y, Σy and
    Σy²; and a pixel's y does not depend on the tiling (the tile size follows
    the shape): a window of x, or one image alone, gives the same bits as the
    whole batch there."""
    x, wt, b, res = _conv1x1_case(cuda, CONV1X1_SHAPES[case])
    first = tk.conv1x1_chw_add(x, wt, b, res, want_stats=True)
    second = tk.conv1x1_chw_add(x, wt, b, res, want_stats=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    h, w = x.shape[2:]
    win = (slice(None), slice(None), slice(h // 3, h // 3 + max(1, h // 2)),
           slice(w // 4, w // 4 + max(1, w // 2)))
    y_win = tk.conv1x1_chw_add(x[win].contiguous(), wt, b, res[win].contiguous())
    assert torch.equal(y_win, first[0][win])
    eight = [t[:1].expand(8, *t.shape[1:]).contiguous() for t in (x, res)]
    batch = tk.conv1x1_chw_add(eight[0], wt, b, eight[1])
    alone = tk.conv1x1_chw_add(x[:1].contiguous(), wt, b, res[:1].contiguous())
    assert all(torch.equal(batch[i], alone[0]) for i in range(8))


@pytest.mark.parametrize("case", [3, 8])
def test_conv1x1_tc_check_catches_planted_faults(cuda, case):
    """The checks above fail on a K3 that is slightly wrong: one input
    channel's weights x 1.01 (the column of the largest weight), the bias
    dropped, the residual dropped, one k16 step (input channels 0-15)
    skipped, or one channel's Σy² x 1.01."""
    x, wt, b, res = _conv1x1_case(cuda, CONV1X1_SHAPES[case])
    y, s1, s2 = tk.conv1x1_chw_add(x, wt, b, res, want_stats=True)
    _assert_conv1x1_close(y, x, wt, b, res)
    w_ch = wt.clone()
    w_ch[:, int(wt.abs().amax(dim=0).argmax())] *= 1.01
    skip = wt.clone()
    skip[:, :16] = 0
    for bad in (tk.conv1x1_chw_add(x, w_ch, b, res), tk.conv1x1_chw_add(x, wt, 0 * b, res),
                tk.conv1x1_chw(x, wt, b), tk.conv1x1_chw_add(x, skip, b, res)):
        with pytest.raises(AssertionError):
            _assert_conv1x1_close(bad, x, wt, b, res)
    s2_bad = s2.clone()
    s2_bad[int(s2.abs().argmax())] *= 1.01
    with pytest.raises(AssertionError):
        _assert_stats_close(y, s1, s2_bad)


@pytest.mark.parametrize("c,co", [(104, 52), (13, 3), (37, 21), (768, 100), (26, 52)])
def test_conv1x1_tc_packs_weights_as_plain(cuda, c, co):
    """The B operand the kernel stages (written to wp) is
    ``pack_conv1x1_weights`` bit for bit."""
    x, wt, b, _ = _conv1x1_case(cuda, (1, c, co, 4, 16))
    ks, no = tk.conv1x1_tc_plan(c, co)
    wp = torch.full((8 * no, 16 * ks), float("nan"), device=cuda).to(torch.bfloat16)
    y = torch.empty((1, co, 4, 16), dtype=torch.bfloat16, device=cuda)
    rc = tk._lib().itg_conv1x1_chw_tc(
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), None, wp.data_ptr(), y.data_ptr(), None, None,
        None, 1, c, 64, co, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(wp.cpu(), tk.pack_conv1x1_weights(wt.cpu()))
    _assert_conv1x1_close(y, x, wt, b, None)


def _conv1x1_dw_case(cuda, shape, seed=43):
    n, c, co, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g).to(cuda, torch.bfloat16)
    gy = torch.randn(n, co, h, w, generator=g).to(cuda, torch.bfloat16)
    return x, gy


def _assert_1x1_dw_close(got, ref):
    _assert_sum_close(got[0], ref[0])
    _assert_sum_close(got[1], ref[1])


@pytest.mark.parametrize("shape", CONV1X1_DW_SHAPES)
def test_conv1x1_dw_tc_matches_plain(cuda, shape):
    """bf16 K3-dW runs the tensor-core kernel and computes the plain
    version's function (both operands are bf16 values): dW and db within
    SUM_TOL."""
    x, gy = _conv1x1_dw_case(cuda, shape)
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    got = tk.conv1x1_chw_dw(x, gy)
    torch.cuda.synchronize()
    assert (tk.ROUTE_LAUNCHES["itg_conv1x1_chw_dw_tc"], tk.ROUTE_LAUNCHES["itg_conv1x1_chw_dw"]) \
        == (1, 0)
    _assert_1x1_dw_close(got, tk.conv1x1_chw_dw_plain(x, gy))


@pytest.mark.parametrize("case", [0, 2, 4, 8])
def test_conv1x1_dw_tc_bits_repeat(cuda, case):
    """Fixed-order partial sums and no atomics: two calls give the same bits."""
    x, gy = _conv1x1_dw_case(cuda, CONV1X1_DW_SHAPES[case])
    first = tk.conv1x1_chw_dw(x, gy)
    second = tk.conv1x1_chw_dw(x, gy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _drop_last_tile(x, gy, tile=256):
    """The plain dW and db without the last pixel tile of each image (the
    ragged one where H W is no multiple of the tile)."""
    hw = x.shape[2] * x.shape[3]
    keep = (hw - 1) // tile * tile
    xf, gf = x.flatten(2)[..., :keep], gy.flatten(2)[..., :keep]
    return (torch.einsum("nop,ncp->oc", gf.float(), xf.float()), gf.float().sum(dim=(0, 2)))


@pytest.mark.parametrize("case", [0, 4, 13])
def test_conv1x1_dw_tc_check_catches_planted_faults(cuda, case):
    """The check above fails on a dW that is slightly wrong: one input
    channel's dW x 1.01 (the channel of the largest entry), the last pixel
    tile of each image dropped, or db taken from one image only."""
    x, gy = _conv1x1_dw_case(cuda, CONV1X1_DW_SHAPES[case])
    ref = tk.conv1x1_chw_dw_plain(x, gy)
    dw, db = tk.conv1x1_chw_dw(x, gy)
    _assert_1x1_dw_close((dw, db), ref)
    one = dw.clone()
    one[:, int(ref[0].abs().amax(dim=0).argmax())] *= 1.01
    for bad in ((one, db), _drop_last_tile(x, gy), (dw, gy[:1].float().sum(dim=(0, 2, 3)))):
        with pytest.raises(AssertionError):
            _assert_1x1_dw_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_routes_by_dtype(cuda, dtype):
    """bf16 calls of K3 (and its dx form) and K3-dW launch the tensor-core
    entry points, f32 calls the CUDA-core ones; each counts one launch per
    call."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    tk.reset_launches()
    x, wt, b, res = _conv1x1_case(cuda, CONV1X1_SHAPES[14])
    x, res = x.to(dtype).requires_grad_(), res.to(dtype)
    wt = wt.requires_grad_()
    y = tk.conv1x1_chw_add(x, wt, b, res)
    torch.autograd.grad(y.float().sum(), (x, wt))
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert tk.ROUTE_LAUNCHES == {**dict.fromkeys(tk.ROUTE_LAUNCHES, 0),
                                 "itg_conv1x1_chw_tc": 2 * tc, "itg_conv1x1_chw": 2 * (not tc),
                                 "itg_conv1x1_chw_dw_tc": int(tc),
                                 "itg_conv1x1_chw_dw": int(not tc)}
    assert (tk.LAUNCHES["conv1x1_chw"], tk.LAUNCHES["conv1x1_chw_dw"]) == (2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_refuses_wider(cuda, dtype):
    """A call outside the kernels' limits raises, naming them, on both
    routes; nothing is launched."""
    tk.ROUTE_LAUNCHES.update(dict.fromkeys(tk.ROUTE_LAUNCHES, 0))
    x, wt, b, _ = _conv1x1_case(cuda, (1, 769, 3, 4, 8))
    with pytest.raises(ValueError, match="768-channel limit"):
        tk.conv1x1_chw(x.to(dtype), wt, b)
    for shape in ((1, 65, 64, 4, 8), (1, 90, 7, 4, 8)):
        x, gy = _conv1x1_dw_case(cuda, shape)
        with pytest.raises(ValueError, match=r"C\*Co <= 4096, C\+Co <= 96"):
            tk.conv1x1_chw_dw(x.to(dtype), gy.to(dtype))
    assert not any(v for k, v in tk.ROUTE_LAUNCHES.items() if "conv1x1" in k)


# --- CUDA graphs: the train loop's step and the raster's canvas rows ------


def _launch_counts():
    from infinite_texture_gans_torch.ops import ssm

    return dict(tk.LAUNCHES), dict(tk.ROUTE_LAUNCHES), dict(ssm.ROUTE_LAUNCHES)


def _reset_counts():
    from infinite_texture_gans_torch.ops import ssm

    tk.reset_launches()
    for counter in (tk.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES):
        counter.update(dict.fromkeys(counter, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["BN", "all", "SSM"])
def test_graphed_canvas_equals_eager(cuda, kind, dtype):
    """The raster as CUDA graph replays paints the eager canvas byte for
    byte, with the same launches, for row groups of all and 1: a cold
    canvas (5 rows: both kinds' eager warm-up rows, the capture of the
    rest), a second (the capture of the first row) and a warm one
    (replays only). A one-row canvas captures nothing; a second one
    captures its row."""
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True, dtype=dtype,
                                 type_norm="SSM" if kind == "SSM" else "BN", map_dim=2,
                                 fuse_up="all" if kind == "all" else "auto")
    g = torch.Generator(device="cpu").manual_seed(4)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    gen = gen.to(cuda).eval()
    for rg in (None, 1):
        for wire in ("u8", "f32"):
            out = {}
            for form in ("eager", "cold", "second", "warm"):
                _reset_counts()
                out[form] = (generate_canvas(gen, torch.Generator(device=cuda).manual_seed(5), 290,
                                             200, row_group=rg, wire=wire,
                                             graphs=form != "eager"), _launch_counts())
                if form == "cold":
                    assert set(gen.raster_rows[(1, 3)].graphs) == {False}
            for form in ("cold", "second", "warm"):
                np.testing.assert_array_equal(out[form][0], out["eager"][0], err_msg=form)
                assert out[form][1] == out["eager"][1], form
            assert set(gen.raster_rows[(1, 3)].graphs) == {False, True}
            gen.raster_rows.clear()
    for captured in (set(), {True}):  # one row of 3 sub-images: captured the second time
        generate_canvas(gen, torch.Generator(device=cuda).manual_seed(5), 64, 200)
        assert set(gen.raster_rows[(1, 3)].graphs) == captured


def _graph_args(tmp_path, recipe):
    from PIL import Image

    from infinite_texture_gans_torch.config import prepare_parser

    tex = tmp_path / "tex.png"
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (56, 64, 3), dtype=np.uint8)).save(tex)
    flags = {"auto": [], "off": ["--fuse_up", "off"],
             "SSM": ["--type_norm_G", "SSM", "--map_dim", "2"],
             "wgan": ["--loss", "wgan", "--gp_weight", "10", "--disc_iters", "2"],
             "batch_di2": ["--norm_layer_D", "batch", "--disc_iters", "2"],
             "spec_norm_G": ["--spec_norm_G"]}[recipe]
    return prepare_parser().parse_args(
        ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
         "--padding_mode", "local", "--attention", "--spec_norm_D", "--ema", "--smooth",
         "--num_images", "2", "--batch_size", "4", "--random_crop", "48", "--data_path", str(tex),
         "--data_ext", "png", "--sampling", "24", "--epochs", "1", "--saving_rate", "1",
         "--seed", "2", "--fname", str(tmp_path / "cp"), "--device", "cuda"] + flags)


@pytest.mark.parametrize("recipe", ["auto", "off", "SSM", "wgan", "batch_di2", "spec_norm_G"])
def test_graphed_train_equals_eager(cuda, tmp_path, recipe):
    """The train loop with its default dispatch (6 steps: two eager warm-up
    steps, a capture, replays) against one step per dispatch, from one
    seed, in bf16 (whose kernels sum in a fixed order): every step's
    losses, the last step's gradients and every parameter and buffer
    bit-equal; the same launches in every step, by kernel and by entry
    point. The training options too: WGAN-GP (its penalty's weights drawn
    in the captured step, its double backward captured), D's BatchNorms
    with 2 D updates a step, SN in G."""
    from infinite_texture_gans_torch.ops import ssm
    from infinite_texture_gans_torch.train import train_loop

    runs = {}
    for spd in (1, 0):
        args = _graph_args(tmp_path, recipe)
        args.steps_per_dispatch, args.compute_dtype = spd, "bfloat16"
        log = []
        _reset_counts()
        state, _, _ = train_loop.train(args, step_callback=lambda e, i, m: log.append(
            ({k: float(v) for k, v in m.items()}, dict(tk.LAUNCHES))))
        torch.cuda.synchronize()
        leaves = {f"{m}.{n}.grad": p.grad for m, module in (("G", state.G), ("D", state.D))
                  for n, p in module.named_parameters()}
        leaves.update({f"{m}.{k}": v for m, module in (("G", state.G), ("D", state.D))
                       for k, v in module.state_dict().items()})
        runs[spd] = (log, leaves, dict(tk.ROUTE_LAUNCHES), dict(ssm.ROUTE_LAUNCHES))
    assert len(runs[0][0]) == 6
    assert runs[0][0] == runs[1][0]  # losses and cumulative launches, step by step
    assert runs[0][2:] == runs[1][2:]
    for name, ref in runs[1][1].items():
        assert torch.equal(runs[0][1][name], ref), name


def _train_tensors(state):
    """Every tensor of a train state a resume restores, by name."""
    out = {f"{m}.{k}": v for m, module in (("G", state.G), ("D", state.D))
           for k, v in module.state_dict().items()}
    for m, module, opt in (("G", state.G, state.opt_G), ("D", state.D, state.opt_D)):
        for n, p in module.named_parameters():
            out.update({f"adam.{m}.{n}.{k}": v for k, v in opt.state[p].items()})
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    return out


def test_graphed_resume_equals_uninterrupted(cuda, tmp_path):
    """A graphed bf16 run of 2 epochs (4 steps each: two eager warm-up steps,
    a capture, replays), resumed in a fresh ``train`` from ``2_2.ckpt``
    without ``--seed``, ends where the uninterrupted 4-epoch graphed run
    ends: the same loss histories and every parameter, buffer, Adam and EMA
    tensor bit-equal (bf16 kernels sum in a fixed order), and the same
    launches as the uninterrupted run's last 2 epochs. The per-epoch
    ``manual_seed`` of the generator that the captured step holds reaches
    its replays."""
    from infinite_texture_gans_torch.ops import ssm
    from infinite_texture_gans_torch.train import checkpoint, train_loop

    def run(name, epochs, seed, resume=None):
        (tmp_path / name).mkdir()
        args = _graph_args(tmp_path / name, "auto")
        args.compute_dtype, args.sampling, args.saving_rate = "bfloat16", 16, 2
        args.epochs, args.seed, args.resume = epochs, seed, resume
        marks = []
        _reset_counts()
        state, g, d = train_loop.train(args, step_callback=lambda e, i, m: marks.append(
            (e, dict(tk.LAUNCHES), dict(tk.ROUTE_LAUNCHES), dict(ssm.ROUTE_LAUNCHES))))
        torch.cuda.synchronize()
        return args, state, g, d, marks

    run("half", 2, None)
    drawn = checkpoint.load_checkpoint(str(tmp_path / "half" / "cp" / "2_2.ckpt"))["meta"]["seed"]
    full = run("full", 4, drawn)
    resumed = run("resumed", 4, None, str(tmp_path / "half" / "cp" / "2_2.ckpt"))
    assert resumed[0].seed == drawn
    assert (resumed[2], resumed[3]) == (full[2], full[3]) and len(full[2]) == 4
    got = _train_tensors(resumed[1])
    for k, v in _train_tensors(full[1]).items():
        assert torch.equal(got[k], v), k
    # launches of epochs 3-4: the uninterrupted run's from the end of epoch 2 on
    at2 = [m for m in full[4] if m[0] == 1][-1]
    for a, b, c in zip(full[4][-1][1:], at2[1:], resumed[4][-1][1:]):
        assert {k: a[k] - b[k] for k in a} == c


def test_save_in_flight_during_capture(cuda, tmp_path, monkeypatch):
    """A save whose device-to-host copy runs while the main thread captures
    the step: the worker's copy (on its own stream) neither breaks the
    capture nor lands in the graph, and the file holds the tensors as they
    were at submit. Then the train loop where an epoch is shorter than the
    warm-up (2 steps an epoch, ``--saving_rate 1``), so the epoch-1 save is
    in flight while epoch 2 captures its step: each file holds the state of
    its epoch."""
    import threading

    from infinite_texture_gans_torch.ops.graphs import CountedGraph
    from infinite_texture_gans_torch.train import checkpoint, train_loop

    capturing, copied = threading.Event(), threading.Event()

    class Held(checkpoint.AsyncCheckpointer):
        @staticmethod
        def _to_host(payload, event, stream):
            assert capturing.wait(60)
            out = checkpoint.AsyncCheckpointer._to_host(payload, event, stream)
            copied.set()
            return out

    big = torch.arange(1 << 22, device=cuda, dtype=torch.float32)
    saver = Held()
    saver.submit(str(tmp_path / "held.ckpt"), {"meta": {"k": 1}, "x": big})
    big.add_(1.0)  # after submit: the file keeps the snapshot
    x = torch.ones(1 << 20, device=cuda)
    graph = CountedGraph()

    def body():
        y = x * 2
        capturing.set()
        assert copied.wait(60)  # the worker copied while this capture was open
        return y + 1

    with torch.cuda.device(cuda):
        y = graph.capture(body)
    saver.wait()
    x.fill_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 7.0))
    got = checkpoint.load_checkpoint(str(tmp_path / "held.ckpt"))
    np.testing.assert_array_equal(got["x"], np.arange(1 << 22, dtype=np.float32))

    from infinite_texture_gans_torch.weights import from_jax_variables

    args = _graph_args(tmp_path, "auto")
    args.compute_dtype, args.sampling, args.epochs, args.steps_per_dispatch = "bfloat16", 8, 3, 0
    states, snaps = [], {}
    create = train_loop.create_train_state
    monkeypatch.setattr(train_loop, "create_train_state",
                        lambda *a, **kw: states.append(create(*a, **kw)) or states[0])

    def on_step(epoch, i, m):
        if i == 1:  # an epoch's last step: the state its save holds
            torch.cuda.synchronize()
            snaps[epoch] = {f"{name}.{k}": v.detach().cpu().clone()
                            for name, module in (("G", states[0].G), ("D", states[0].D))
                            for k, v in module.state_dict().items()}

    train_loop.train(args, step_callback=on_step)
    for epoch in range(3):
        ck = checkpoint.load_checkpoint(str(tmp_path / "cp" / f"3_{epoch + 1}.ckpt"))
        assert ck["meta"]["epoch"] == epoch + 1
        assert int(ck["opt_G"]["0"]["count"]) == 2 * (epoch + 1)
        for name in ("G", "D"):
            for k, v in from_jax_variables(ck[f"net{name}_variables"], spectral=True).items():
                assert torch.equal(v, snaps[epoch][f"{name}.{k}"]), (epoch, name, k)


def test_capture_holds_off_the_cyclic_collector(cuda):
    """A captured graph left in a reference cycle (as a dispatch whose
    method a closure wraps) is freed when Python's cyclic collector next
    runs. Freed inside another capture, it invalidates that capture;
    ``CountedGraph.capture`` keeps the collector from running while it
    captures (here it would run at every allocation), so the capture
    replays and the garbage goes after it."""
    import gc
    import weakref

    from infinite_texture_gans_torch.ops.graphs import CountedGraph

    x = torch.ones(1 << 20, device=cuda)

    def garbage():
        old = CountedGraph()
        with torch.cuda.device(cuda):
            old.capture(lambda: x * 2)
        cycle = {"graph": old}
        cycle["self"] = cycle
        return weakref.ref(old)

    gc.disable()
    try:  # the mechanism: the collector run by hand inside a capture
        freed = garbage()
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream(),
                                  capture_error_mode="thread_local"):
                y = x + 1
                gc.collect()
                y = y + 1
        assert freed() is None
    finally:
        gc.enable()
    torch.cuda.synchronize()

    during = []

    def spy(phase, info):
        if phase == "start":
            during.append(torch.cuda.is_current_stream_capturing())

    thresholds = gc.get_threshold()
    gc.callbacks.append(spy)
    gc.set_threshold(1, 1, 1)
    try:
        freed = garbage()
        graph = CountedGraph()

        def body():
            junk = [[i] for i in range(1000)]  # a collection per allocation, were it on
            return x + len(junk)

        with torch.cuda.device(cuda):
            y = graph.capture(body)
        gc.collect()
    finally:
        gc.callbacks.remove(spy)
        gc.set_threshold(*thresholds)
    assert during and not any(during)
    assert freed() is None
    x.fill_(2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 1002.0))


def _multi_dir(tmp_path, n=6, size=64):
    """n constant images of one value 15 + 30 i each (a drawn pixel names
    its image; every value >= 1, so padding would read -1)."""
    from PIL import Image

    d = tmp_path / "multi"
    d.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(np.full((size + 4 * i, size, 3), 15 + 30 * i, np.uint8)).save(d / f"{i}.png")
    return str(d)


@pytest.mark.parametrize("over_cap", [False, True])
def test_multi_image_graphed_train_equals_eager(cuda, tmp_path, monkeypatch, over_cap):
    """``--data multiple_images`` in bf16: the train loop's graphed dispatch
    (the crops drawn in the captured step from the stack on the card)
    against eager steps, from one seed: every step's losses, launches and
    every parameter and buffer bit-equal. Over the cap (``over_cap``), a
    rotating window of 2 of 6 images swaps before every chunk of 3 steps
    into the storages the captured step reads, in both runs alike, and the
    eager run's batches come from the chunk's window only."""
    from infinite_texture_gans_torch.data import datasets as D
    from infinite_texture_gans_torch.train import train_loop
    from infinite_texture_gans_torch.train.train_step import StepDispatch

    if over_cap:
        monkeypatch.setattr(D.DeviceMultiImageSampler, "MAX_DEVICE_MB",
                            (64 + 20) * 64 * 3 * 4.5 / 2**20)
    d = _multi_dir(tmp_path)
    seen = []
    sample = D.sample_multi_crops

    def watched(imgs, *a, **k):
        out = sample(imgs, *a, **k)
        if not torch.cuda.is_current_stream_capturing():
            seen.append((imgs[:, 0, 0, 0].tolist(), out[:, 0, 0, 0].tolist()))
        return out

    monkeypatch.setattr(D, "sample_multi_crops", watched)
    runs = {}
    for form in ("eager", "graphed"):
        args = _graph_args(tmp_path, "auto")
        args.data, args.data_path, args.sampling = "multiple_images", d, 24
        args.compute_dtype = "bfloat16"
        args.steps_per_dispatch = 3 if over_cap else (1 if form == "eager" else 0)
        log = []
        _reset_counts()
        with monkeypatch.context() as mp:
            if form == "eager" and over_cap:  # chunks of 3, stepped eagerly
                mp.setattr(train_loop, "StepDispatch",
                           lambda *a, graphed, **k: StepDispatch(*a, graphed=False, **k))
            state, _, _ = train_loop.train(args, step_callback=lambda e, i, m: log.append(
                ({k: float(v) for k, v in m.items()}, dict(tk.LAUNCHES))))
        torch.cuda.synchronize()
        runs[form] = (log, {f"{m}.{k}": v for m, module in (("G", state.G), ("D", state.D))
                            for k, v in module.state_dict().items()})
    assert len(runs["eager"][0]) == 6 and runs["eager"][0] == runs["graphed"][0]
    for name, ref in runs["eager"][1].items():
        assert torch.equal(runs["graphed"][1][name], ref), name
    assert seen
    for window, drawn in seen:
        assert {round((v + 1) * 127.5) for v in drawn} <= {round(v) for v in window}


def test_rotating_swap_during_captured_run(cuda, tmp_path):
    """A window swap between replays of a captured sampler: each replay
    draws from the window swapped in before it (its staged copy came from
    pinned memory on a side stream), never from the last one."""
    from infinite_texture_gans_torch.data import datasets as D
    from infinite_texture_gans_torch.ops.graphs import CountedGraph, on_side_stream

    d = _multi_dir(tmp_path, n=5, size=48)
    cap = (48 + 16) * 48 * 3 * 4.5 / 2**20
    s, why = D.DeviceMultiImageSampler.maybe_build(
        D.MultipleImagesDataset(d, "png", random_crop=32), cuda, max_mb=cap, seed=4)
    assert isinstance(s, D.RotatingMultiImageSampler), why
    rng = torch.Generator(device=cuda).manual_seed(1)
    s.prepare_epoch(0)
    s.next_window()
    on_side_stream(lambda: s.sample(rng, 16))
    graph = CountedGraph()
    with torch.cuda.device(cuda):
        out = graph.capture(lambda: s.sample(rng, 16), generators=(rng,))
    for _ in range(8):
        window = s.next_window()
        graph.replay()
        ids = ((out[:, 0, 0, 0].float().cpu() + 1) * 127.5).round().long()
        assert set(((ids - 15) // 30).tolist()) <= set(window.tolist()), window


@pytest.mark.parametrize("kind", ["BN", "all", "SSM"])
def test_diag_canvas_equals_raster_on_card(cuda, kind):
    """The batched-diagonal engine (K2 / K14 given per-lane borders) against
    the raster on the card: f32 (TF32 off) within 1e-4 at lanes 1-3; bf16
    u8 at lanes 1 byte-equal to the raster with its launches, and at lanes
    2 and 3 byte-equal to canvas 0 of the raster at the same batch (cuDNN
    picks its algorithms by batch size, so only a raster at the diagonal's
    batch shares its roundings)."""
    from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag
    from infinite_texture_gans_torch.sampling.infinite import canvas_latents

    for dtype in (torch.float32, torch.bfloat16):
        gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True, dtype=dtype,
                                     type_norm="SSM" if kind == "SSM" else "BN", map_dim=2,
                                     fuse_up="all" if kind == "all" else "auto")
        g = torch.Generator(device="cpu").manual_seed(4)
        with torch.no_grad():
            for p in gen.parameters():
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
        gen = gen.to(cuda).eval()
        lat = [canvas_latents(gen, torch.Generator(device=cuda).manual_seed(5 + k), 290, 230)[1:]
               for k in range(3)]
        wire = "f32" if dtype == torch.float32 else "u8"
        _reset_counts()
        ref = generate_canvas(gen, None, 290, 230, z_full=lat[0][0], maps_full=lat[0][1],
                              wire=wire, graphs=False)
        want = _launch_counts()
        for lanes in (1, 2, 3):
            _reset_counts()
            out = generate_canvas_diag(gen, None, 290, 230, lanes=lanes, z_full=lat[0][0],
                                       maps_full=lat[0][1], wire=wire)
            if lanes == 1:
                assert _launch_counts() == want
            if wire == "f32":
                assert float(np.abs(out - ref).max()) <= 1e-4, lanes
                continue
            maps = None if kind != "SSM" else [torch.cat(m) for m in
                                               zip(*(m for _, m in lat[:lanes]))]
            batched = generate_canvas(gen, None, 290, 230,
                                      z_full=torch.cat([z for z, _ in lat[:lanes]]),
                                      maps_full=maps, wire=wire, graphs=False)[:1]
            np.testing.assert_array_equal(out, batched, err_msg=str(lanes))


# --- reference .pth files, the utilities and the zoo on the card -------------


def test_pth_canvas_equals_ckpt_canvas_on_card(cuda, tmp_path):
    """A bf16 port ``.ckpt`` through ``sample --export_pth`` on the card: the
    ``.pth`` renders the ``.ckpt``'s u8 canvas byte for byte, with the same
    launches, and re-exports bit for bit."""
    import argparse

    from infinite_texture_gans_torch import sample
    from infinite_texture_gans_torch.train.checkpoint import (
        load_generator_from_checkpoint,
        save_checkpoint,
    )
    from infinite_texture_gans_torch.weights import to_jax_variables

    torch.manual_seed(0)
    gen = ResidualPatchGenerator(z_dim=16, G_ch=8, n_layers_G=4, attention=True,
                                 padding_mode="local")
    with torch.no_grad():
        gen.attention.attn.gamma.fill_(0.3)
    args = dict(z_dim=16, G_ch=8, n_layers_G=4, attention=True, padding_mode="local",
                compute_dtype="bfloat16")
    ckpt, pth, again = (str(tmp_path / n) for n in ("g.ckpt", "g.pth", "again.pth"))
    save_checkpoint(ckpt, {"meta": {"args": args},
                           "netG_variables": to_jax_variables(gen.state_dict())})
    sample.main(["--model_path", ckpt, "--export_pth", pth])
    sample.main(["--model_path", pth, "--export_pth", again])
    canvases = []
    for path in (ckpt, pth):
        g, _ = load_generator_from_checkpoint(path, device=cuda)
        tk.reset_launches()
        canvases.append(generate_canvas(g, torch.Generator(device=cuda).manual_seed(3), 290, 230,
                                        wire="u8"))
        canvases.append(dict(tk.LAUNCHES))
    np.testing.assert_array_equal(canvases[0], canvases[2])
    assert canvases[1] == canvases[3] and canvases[1]["chw_halo_step"] > 0
    with torch.serialization.safe_globals([argparse.Namespace]):
        a, b = (torch.load(p, weights_only=True)["netG_state_dict"] for p in (pth, again))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_quality_report_on_card_matches_cpu(cuda):
    """The default pyramid's report on the card within 1e-3 of the CPU's
    (f32, TF32 off)."""
    from infinite_texture_gans_torch.utils import quality

    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (160, 200, 3)).astype(np.float32)
    gen = rng.uniform(-1, 1, (256, 192, 3)).astype(np.float32)
    got = quality.texture_quality_report(src, gen, quality.random_conv_features(device=cuda))
    want = quality.texture_quality_report(src, gen, quality.random_conv_features(device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-3), k


@pytest.mark.parametrize("cls,kw", [
    ("ResDiscriminator", dict(base_ch=8, att=True)),
    ("ResDiscriminator", dict(base_ch=8, n_classes=5, cond_method="concat")),
    ("ResDiscriminator", dict(base_ch=8, n_classes=5, cond_method="proj", SN_y=True)),
    ("ResDiscriminator", dict(base_ch=8, n_classes=5, cond_method="conv1x1")),
    ("ResDiscriminator", dict(base_ch=8, n_classes=5, cond_method="conv3x3", att=True)),
    ("DCDiscriminator", dict(base_ch=8)),
    ("SNDiscriminator", dict(base_ch=8, SN=True)),
])
def test_zoo_on_card_matches_cpu(cuda, cls, kw):
    """A train-mode forward with an SN refresh and a backward on the card,
    float64: the output, every gradient and the updated SN / BN state within
    1e-4 of each tensor's largest value of the CPU's (a gradient leaf of
    rounding noise, below 1e-6 of the largest gradient, within 1e-4 of
    that). Float64, as ``chip_smoke.py``'s zoo phase holds each tensor: a
    float32 tensor's deviation swings with the input draw (cancellation in
    the backward), so the phase holds float32 by the gradients' median over
    several draws."""
    import copy

    from infinite_texture_gans_torch.models import discriminator

    torch.manual_seed(0)
    cpu = getattr(discriminator, cls)(**kw, dtype=torch.float64).double().train()
    for name, p in cpu.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.5)
    card = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 64, 3, generator=g, dtype=torch.float64)
    y = None
    if kw.get("n_classes"):
        y = (torch.eye(5, dtype=torch.float64)[[1, 3]] if kw["cond_method"] in ("concat", "proj")
             else torch.randn(2, 16, generator=g, dtype=torch.float64))
    res = []
    for model, dev in ((cpu, torch.device("cpu")), (card, cuda)):
        xt = x.to(dev, copy=True).requires_grad_()
        out = model(xt, *([y.to(dev)] if y is not None else []), update_sn=True)
        (out * torch.linspace(-1, 1, out.numel(), device=dev, dtype=out.dtype).reshape(
            out.shape)).sum().backward()
        res.append((out.detach().cpu(), xt.grad.cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {n: t.cpu() for n, t in model.state_dict().items()}))
    (o0, dx0, g0, s0), (o1, dx1, g1, s1) = res
    top = max(float(v.abs().max()) for v in g0.values())
    pairs = [(o1, o0, 0.0), (dx1, dx0, 0.0)] + [(g1[n], g0[n], top) for n in g0]
    pairs += [(s1[n], s0[n], 0.0) for n in s0]
    for got, ref, model_top in pairs:
        scale = float(ref.abs().max())
        scale = model_top if scale < 1e-6 * model_top else scale
        assert float((got - ref).abs().max()) <= 1e-4 * scale


def test_peak_flops_on_card(cuda):
    from infinite_texture_gans_torch.utils import flops

    peaks = flops.CARD_PEAKS.get(torch.cuda.get_device_name(cuda))
    assert flops.peak_flops(cuda) == (peaks.bf16_flop_per_s if peaks else None)
    assert flops.peak_flops("cpu") is None
