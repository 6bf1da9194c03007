"""The superstep's dispatch on the CPU: the plan, the chunked train loop and
the step with its draws, against the JAX plan and the port's per-step
loop; and the raster's static-buffer row function against the raster loop
it replaced. On the CPU both run eagerly with the code that the card
captures as CUDA graphs (``tests/test_torch_gpu.py`` replays them)."""

import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.train.train_step import dispatch_chunk as jax_dispatch_chunk
from infinite_texture_gans_tpu.train.train_step import dispatch_plan as jax_dispatch_plan
from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops.padding import (
    GridPos,
    finalize_row,
    init_halo_state,
    rotate_rows,
)
from infinite_texture_gans_torch.sampling import latents
from infinite_texture_gans_torch.sampling.infinite import (
    _to_uint8,
    canvas_latents,
    dispatch_groups,
    generate_canvas,
)
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.train_step import (
    StepDispatch,
    create_train_state,
    dispatch_chunk,
    dispatch_plan,
    train_step,
)
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "2", "--num_images", "2",
        "--random_crop", "32", "--ema", "--spec_norm_D", "--smooth", "--device", "cpu"]
SSM = ["--type_norm_G", "SSM", "--map_dim", "2"]


@pytest.mark.parametrize("steps", [1, 7, 10, 125, 127, 251])
@pytest.mark.parametrize("cap", [0, 1, 3, 32, 64, 128])
def test_dispatch_plan_matches_jax(steps, cap):
    assert dispatch_chunk(steps, cap) == jax_dispatch_chunk(steps, cap)
    assert dispatch_plan(steps, cap) == jax_dispatch_plan(steps, cap)


def test_dispatch_plan_reference_cases():
    """The cases of the reference's tests/test_train.py:450-460."""
    assert (dispatch_chunk(125, 128), dispatch_chunk(125, 32), dispatch_chunk(127, 64),
            dispatch_chunk(10, 1)) == (125, 25, 1, 1)
    assert [dispatch_plan(*a) for a in ((125, 128), (127, 64), (127, 128), (251, 128), (10, 1),
                                        (1, 128))] == [(125, 0), (64, 63), (127, 0), (128, 123),
                                                       (1, 0), (1, 0)]


@pytest.fixture(scope="module")
def texture(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("tex") / "tex.png"
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(path)
    return str(path)


def _bits_equal(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


def test_chunked_train_equals_per_step(texture, tmp_path):
    """--steps_per_dispatch 3 over 7 steps (plan (3, 1): a remainder chunk)
    gives the epoch losses, parameters and checkpoint tree of
    --steps_per_dispatch 1 from the same seed, bit for bit."""
    assert dispatch_plan(7, 3) == (3, 1)
    runs = {}
    for spd in ("3", "1"):
        steps = []
        args = prepare_parser().parse_args(TINY + [
            "--data_path", texture, "--data_ext", "png", "--sampling", "14", "--epochs", "1",
            "--saving_rate", "1", "--seed", "4", "--steps_per_dispatch", spd,
            "--fname", str(tmp_path / spd)])
        state, g_losses, d_losses = train_loop.train(
            args, step_callback=lambda e, i, m: steps.append({k: float(v) for k, v in m.items()}))
        runs[spd] = (state, g_losses, d_losses, steps,
                     checkpoint.load_checkpoint(str(tmp_path / spd / "1_1.ckpt")))
    (s3, g3, d3, st3, ck3), (s1, g1, d1, st1, ck1) = runs["3"], runs["1"]
    assert len(st3) == len(st1) == 7 and st3 == st1
    assert (g3, d3) == (g1, d1)
    for a, b in ((s3.G, s1.G), (s3.D, s1.D)):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            _bits_equal(va, vb, k)
    flat = lambda t, p="": ({f"{p}{k}": v for kk, vv in t.items()  # noqa: E731
                             for k, v in flat(vv, f"{p}{kk}/").items()}
                            if isinstance(t, dict) else {p: t})
    f3, f1 = flat({k: v for k, v in ck3.items() if k != "meta"}), flat(
        {k: v for k, v in ck1.items() if k != "meta"})
    assert f3.keys() == f1.keys()
    for k in f3:
        np.testing.assert_array_equal(np.asarray(f3[k]), np.asarray(f1[k]), err_msg=k)
    assert int(ck3["opt_G"]["0"]["count"]) == 7


@pytest.mark.parametrize("norm", ["BN", "SSM"])
def test_dispatched_step_equals_train_step(texture, norm):
    """StepDispatch's step (its draws, static loss sums and learning rates
    written per chunk), run eagerly, equals the per-step loop of
    ``train_step`` bit for bit, with --decay_lr exp across an epoch
    boundary."""
    args = prepare_parser().parse_args(TINY + (SSM if norm == "SSM" else []) + [
        "--data_path", texture, "--data_ext", "png", "--decay_lr", "exp", "--lr_G", "1e-2",
        "--lr_D", "1e-2"])
    sampler = DeviceCropSampler(SingleImageDataset(texture, "png", None, 32, 8), "cpu")
    a = create_train_state(args, 2, "cpu", seed=1)
    b = create_train_state(args, 2, "cpu", seed=1)
    dispatch = StepDispatch(a, sampler, torch.Generator().manual_seed(6), args)
    rng = torch.Generator().manual_seed(6)
    G = b.G
    for epoch in range(2):
        dispatch.begin_epoch()
        d_sum = g_sum = 0.0
        dispatch.set_lr()
        for _ in range(2):
            got = dispatch.step()
            real = sampler.sample(rng, args.batch_size)
            z = latents.build_train_z(rng, 2, G.z_dim, G.base_res, 3, 3, device="cpu")
            maps = None
            if norm == "SSM":
                maps = latents.build_train_maps(rng, 2, G.map_dim, G.n_layers_G, G.base_res, 3, 3,
                                                device="cpu")
            want = train_step(b, real, z, maps, smooth=True, use_ema=True)
            for k in want:
                _bits_equal(got[k], want[k], k)
            d_sum = d_sum + want["d_loss_fake"] * 2 + want["d_loss_real"] * 2
            g_sum = g_sum + want["g_loss"] * 2
        _bits_equal(dispatch.d_sum, d_sum, "d_sum")
        _bits_equal(dispatch.g_sum, g_sum, "g_sum")
    assert a.step == b.step == 4
    assert float(a.opt_G.param_groups[0]["lr"]) == pytest.approx(1e-2 * 0.99)
    for x, y in ((a.G, b.G), (a.D, b.D)):
        for (k, va), vb in zip(x.state_dict().items(), y.state_dict().values()):
            _bits_equal(va, vb, k)
    for k in a.ema:
        _bits_equal(a.ema[k], b.ema[k], k)
    for oa, ob in ((a.opt_G, b.opt_G), (a.opt_D, b.opt_D)):
        for pa, pb in zip(oa.state.values(), ob.state.values()):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                _bits_equal(pa[k], pb[k], k)


def _assemble_band(subs_g, kept_rows, kept_cols, as_uint8):
    """The old trimming of a group of canvas rows (n_rows, steps_w, N,
    gh*P, gw*P, C) into one band (N, n_rows * kept_rows, canvas_w, C): the
    columns' kept parts and the last column's right part, joined."""
    main = subs_g[:, :, :, :kept_rows, :kept_cols]
    tail = subs_g[:, -1, :, :kept_rows, kept_cols:]
    if as_uint8:
        main, tail = _to_uint8(main), _to_uint8(tail)
    n, steps_w, N, kr, kc, C = main.shape
    band_main = main.permute(2, 0, 3, 1, 4, 5).reshape(N, n * kr, steps_w * kc, C)
    band_tail = tail.permute(1, 0, 2, 3, 4).reshape(N, n * kr, -1, C)
    return torch.cat([band_main, band_tail], dim=2)


@torch.no_grad()
def _raster_canvas_oracle(gen, z_full, maps_full, out_h, out_w, row_group, as_uint8):
    """The raster loop as it was before the row function: sub-images in a
    Python loop over the halo dict, rotated with ``rotate_rows``, each
    group's rows stacked and trimmed at once, painted into the canvas."""
    P, gh, gw, base = gen.patch_resolution, gen.num_patches_h, gen.num_patches_w, gen.base_res
    steps_h, steps_w = (int(np.ceil((o / P - 1) / (g - 1))) for o, g in ((out_h, gh), (out_w, gw)))
    steps_h, steps_w = max(1, steps_h), max(1, steps_w)
    tot_h, tot_w = steps_h * (gh - 1) + 1, steps_w * (gw - 1) + 1
    canvas = torch.zeros((z_full.shape[0], tot_h * P, tot_w * P, gen.img_ch),
                         dtype=torch.uint8 if as_uint8 else torch.float32)
    halo = init_halo_state(gen.site_specs(), z_full.shape[0], gh, gw, tot_w, dtype=gen.dtype,
                           device="cpu")
    for r0, n, kept_rows in dispatch_groups(steps_h, gh, P, row_group or steps_h):
        rows = []
        for r in range(r0, r0 + n):
            strip, map_strips = latents.row_strips(z_full, maps_full, r, base, gh)
            subs = []
            for c in range(steps_w):
                c0 = c * (gw - 1) * base
                maps_sub = None
                if map_strips is not None:
                    maps_sub = [m[:, :, c * (gw - 1) * (2**i) * base:
                                  c * (gw - 1) * (2**i) * base + gw * (2**i) * base + 4]
                                for i, m in enumerate(map_strips)]
                out, halo = gen(strip[:, :, c0:c0 + gw * base + 2], maps_sub, halo=halo,
                                pos=GridPos(c, r == 0, c == 0))
                subs.append(out)
            halo = {k: rotate_rows(finalize_row(s, gen.outer_padding)) for k, s in halo.items()}
            rows.append(torch.stack(subs))
        band = _assemble_band(torch.stack(rows), kept_rows, (gw - 1) * P, as_uint8)
        canvas[:, r0 * (gh - 1) * P: r0 * (gh - 1) * P + band.shape[1]] = band.to(canvas.dtype)
    return canvas[:, :out_h, :out_w].numpy()


@pytest.mark.parametrize("kind", ["BN", "all", "SSM"])
def test_row_function_equals_raster_loop(kind):
    """The static-buffer row function (eager on the CPU) paints the canvas
    of the raster loop it replaced byte for byte, for both wires, a
    cropped width and row groups of 1, 2 and all: the claim of the
    reference's tests/test_halo.py:154 for its one-dispatch engine."""
    torch.manual_seed(0)
    gen = ResidualPatchGenerator(z_dim=8, G_ch=8, n_layers_G=4, attention=True,
                                 type_norm="SSM" if kind == "SSM" else "BN", map_dim=2,
                                 fuse_up="all" if kind == "all" else "auto").eval()
    if kind == "all":
        assert gen.eval_fuse_blocks() == {4}
    with torch.no_grad():  # a live attention gate and BN statistics
        gen.attention.attn.gamma.fill_(0.5)
        for name, buf in gen.named_buffers():
            buf.copy_(torch.rand_like(buf) + (0.5 if name.endswith("var") else -0.5))
    out_h, out_w = 190, 100  # 3 x 2 sub-images of 96^2, both sides cropped
    _, z, maps = canvas_latents(gen, torch.Generator().manual_seed(3), out_h, out_w)
    for wire in ("u8", "f32"):
        want = _raster_canvas_oracle(gen, z, maps, out_h, out_w, None, wire == "u8")
        for rg in (None, 1, 2):
            got = generate_canvas(gen, None, out_h, out_w, z_full=z, maps_full=maps,
                                  row_group=rg, wire=wire)
            np.testing.assert_array_equal(got, want, err_msg=f"{wire} row_group {rg}")
