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


# --- training kernels (K5 stats, K6, K7, K8, K3 stats and dW, K4 adjoint, K13)
# The sums (Σy, Σy², d(scale), d(shift), dW, db) are float32 reductions in
# another order (and atomics in a run-dependent one): relative 1e-4 of the
# largest reference entry.
SUM_TOL = 1e-4

TRAIN_SHAPES = [(2, 11, 19, 13, 45), (1, 26, 13, 40, 37)]  # n, c, co, h, w


def _assert_sum_close(got, ref):
    scale = max(1e-6, float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    assert err <= SUM_TOL * scale, (err, SUM_TOL * scale)


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
    dx, dsc, dsh = tk.conv3x3_chw_dx(x, g, wt, sc, sh, True, outer)
    dx_ref, dsc_ref, dsh_ref = tk.conv3x3_chw_dx_plain(x, g, wt, sc, sh, True, outer)
    _assert_close(dx, dx_ref)
    _assert_sum_close(dsc, dsc_ref)
    _assert_sum_close(dsh, dsh_ref)
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
    _assert_close(y, tk.conv1x1_chw_plain(x, wt, b, res))
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
    _assert_close(tk.stem_fwd(x, wt, b), tk.stem_fwd_plain(x, wt, b))
    _assert_close(tk.stem_dx(g, wt), tk.stem_dx_plain(g, wt))
    dw, db = tk.stem_dw(x, g)
    dw_ref, db_ref = tk.stem_dw_plain(x, g)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)
    assert (tk.LAUNCHES["stem_fwd"], tk.LAUNCHES["stem_dx"], tk.LAUNCHES["stem_dw"]) == (1, 1, 1)


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
    y_ref = tk.upconv3x3_chw_plain(x, wt, b, sc, sh, True, outer)
    _assert_close(tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer), y_ref)
    y, s1, s2 = tk.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
    _assert_close(y, y_ref)
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    dx, dsc, dsh = tk.upconv3x3_chw_dx(x, g, wt, sc, sh, True, outer)
    dx_ref, dsc_ref, dsh_ref = tk.upconv3x3_chw_dx_plain(x, g, wt, sc, sh, True, outer)
    _assert_close(dx, dx_ref)
    _assert_sum_close(dsc, dsc_ref)
    _assert_sum_close(dsh, dsh_ref)
    dw, db = tk.upconv3x3_chw_dw(x, g, sc, sh, True, outer)
    dw_ref, db_ref = tk.upconv3x3_chw_dw_plain(x, g, sc, sh, True, outer)
    _assert_sum_close(dw, dw_ref)
    _assert_sum_close(db, db_ref)
    assert {k: tk.LAUNCHES[k] for k in ("upconv3x3_chw", "upconv3x3_chw_dx", "upconv3x3_chw_dw")} \
        == {"upconv3x3_chw": 2, "upconv3x3_chw_dx": 1, "upconv3x3_chw_dw": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 7, 9), (1, 26, 48, 96), (1, 3, 1, 3)])
def test_upsample2_add_kernel_matches_plain(cuda, dtype, shape):
    """K10's y is one rounded float32 add on both sides: bit-equal."""
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, dtype)
    res = torch.randn(n, c, 2 * h, 2 * w, generator=gen).to(cuda, dtype)
    tk.reset_launches()
    assert torch.equal(tk.upsample2_chw_add(x, res), tk.upsample2_chw_add_plain(x, res))
    y, s1, s2 = tk.upsample2_chw_add(x, res, want_stats=True)
    assert torch.equal(y, tk.upsample2_chw_add_plain(x, res))
    _assert_sum_close(s1, y.float().sum(dim=(0, 2, 3)))
    _assert_sum_close(s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
    assert tk.LAUNCHES["upsample2_chw_add"] == 2


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_ssm_embed_kernels_match_plain(cuda, dtype, shape):
    from infinite_texture_gans_torch.ops import ssm

    n, md, h, w, hid, co = shape
    gen = torch.Generator().manual_seed(9)
    maps = torch.randn(n, md, h + 4, w + 4, generator=gen).to(cuda, dtype)
    w1 = (torch.randn(hid, md, 3, 3, generator=gen) / (3 * md**0.5)).to(cuda)
    b1 = (0.1 * torch.randn(hid, generator=gen)).to(cuda)
    w2 = (torch.randn(co, hid, 3, 3, generator=gen) / (3 * hid**0.5)).to(cuda)
    b2 = (0.1 * torch.randn(co, generator=gen)).to(cuda)
    g = torch.randn(n, co, h, w, generator=gen).to(cuda, dtype)
    tk.reset_launches()
    _assert_close(ssm.ssm_embed(maps, w1, b1, w2, b2), ssm.ssm_embed_plain(maps, w1, b1, w2, b2))
    for got, ref in zip(ssm.ssm_embed_bwd(maps, w1, b1, w2, g), ssm.ssm_embed_bwd_plain(maps, w1, b1, w2, g)):
        _assert_sum_close(got, ref)
    assert (tk.LAUNCHES["ssm_embed"], tk.LAUNCHES["ssm_embed_bwd"]) == (1, 1)


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
