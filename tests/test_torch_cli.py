"""The port's CLIs against the reference's: the sample CLI's file names and
formats, the train CLI's flags of the reference, and ``--profile_dir``."""

import os

import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.sample import save_image as jax_save_image
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.config import (
    check_train_args,
    generator_kwargs,
    prepare_parser,
    train_device,
)
from infinite_texture_gans_torch.parallel import make_mesh
from infinite_texture_gans_torch.sampling.infinite import generate_canvas
from infinite_texture_gans_torch.sampling.stream import read_png
from infinite_texture_gans_torch.train import checkpoint, train_loop
from infinite_texture_gans_torch.train.train_step import create_train_state
from infinite_texture_gans_torch.weights import to_jax_variables
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

TINY = ["--G_ch", "8", "--D_ch", "8", "--z_dim", "16", "--n_layers_G", "4", "--n_layers_D", "2",
        "--padding_mode", "local", "--attention", "--batch_size", "2", "--num_images", "2",
        "--random_crop", "32", "--ema", "--spec_norm_D", "--smooth", "--device", "cpu"]
# the README's training recipe (reference Experiment-1)
README_RECIPE = ["--data_path", "datasets/241.jpg", "--random_crop", "192", "--n_layers_G", "6",
                 "--n_layers_D", "4", "--attention", "--padding_mode", "local", "--type_norm",
                 "BN", "--spec_norm_D", "--smooth", "--ema", "--sampling", "8000", "--epochs",
                 "300", "--fname", "results/241", "--compute_dtype", "bfloat16"]
# the reference's flags the port's parser lacked, at values other than their defaults
REFERENCE_FLAGS = {"leak_D": ("0.2", 0.2), "padding_size": ("2", 2),
                   "conv_reduction": ("3", 3), "num_gpus": ("1", 1), "dev_num": ("1", 1),
                   "gpu_list": ("1", [1]), "num_workers": ("2", 2), "chw_tail": ("on", "on"),
                   "resize_h": ("40", 40), "resize_w": ("48", 48)}
# the README's multi-image recipe (all three bundled textures)
MULTI_RECIPE = ["--data", "multiple_images", "--data_path", "datasets/multi"] + README_RECIPE[2:]


@pytest.fixture(scope="module")
def texture(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("tex") / "tex.png"
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
    return str(path)


def _tiny_ckpt(path):
    args = prepare_parser().parse_args(TINY)
    st = create_train_state(args, 1, "cpu", seed=2)
    checkpoint.save_checkpoint(path, {"meta": {"args": dict(vars(args))},
                                      "netG_variables": to_jax_variables(st.G.state_dict())})


def test_sample_cli_names_and_formats(tmp_path):
    """A .jpg name is written under that name through PIL, byte for byte
    the reference's ``save_image`` of the same u8 canvas; a .png name goes
    through the port's PNG writer; the default is the reference's
    ``241_generated.jpg``; ``--stream`` adds .png."""
    ckpt = str(tmp_path / "tiny.ckpt")
    _tiny_ckpt(ckpt)
    assert sample.prepare_sample_parser().parse_args(["--model_path", ckpt]).output_name == \
        "241_generated.jpg"
    common = ["--model_path", ckpt, "--device", "cpu", "--output_resolution_height", "70",
              "--output_resolution_width", "90", "--seed", "3"]
    sample.main(common + ["--output_name", "x.jpg"])
    sample.main(common + ["--output_name", "y.png"])
    sample.main(common + ["--output_name", "s", "--stream"])
    gen, _ = checkpoint.load_generator_from_checkpoint(ckpt, device="cpu")
    want = generate_canvas(gen, torch.Generator().manual_seed(3), 70, 90, wire="u8")[0]
    jax_save_image(want, str(tmp_path / "ref.jpg"))
    assert (tmp_path / "x.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()
    np.testing.assert_array_equal(read_png(str(tmp_path / "y.png")), want)  # filter 0: write_png
    np.testing.assert_array_equal(read_png(str(tmp_path / "s.png")), want)
    assert not (tmp_path / "x.jpg.png").exists()


def test_train_cli_takes_reference_flags(texture, tmp_path, capsys):
    """The README's recipe with each of the reference's ten flags parses
    (``--resize_h/--resize_w`` too: a single image takes no resize, as in
    the reference); a one-step run stores them in the checkpoint's
    ``meta.args``; more than one device passes the checks and makes a
    data-parallel mesh (``--num_gpus 2``; ``--gpu_list`` alone keeps one
    device, as the reference's does: tests/test_torch_parallel.py runs
    them); ``--dev_num`` picks the
    card; ``--num_workers`` warns; the multi-image recipe passes the
    checks."""
    extra = [x for flag, (v, _) in REFERENCE_FLAGS.items() for x in (f"--{flag}", v)]
    args = prepare_parser().parse_args(README_RECIPE + extra)
    assert {f: getattr(args, f) for f in REFERENCE_FLAGS} == {
        f: want for f, (_, want) in REFERENCE_FLAGS.items()}
    assert args.type_norm_G == "BN" and args.steps_per_dispatch == 0 and args.profile_dir is None
    check_train_args(args)
    multi = prepare_parser().parse_args(MULTI_RECIPE + ["--resize_h", "450", "--resize_w", "600"])
    check_train_args(multi)
    assert (multi.data, multi.resize_h, multi.resize_w) == ("multiple_images", 450, 600)
    assert train_device(args) == "cuda:1" and generator_kwargs(args)["chw_tail"] == "auto"
    for several, size in ((["--num_gpus", "2"], 2), (["--gpu_list", "0", "1"], None),
                          (["--num_gpus", "2", "--gpu_list", "0", "1"], 2)):
        a = prepare_parser().parse_args(README_RECIPE + several)
        check_train_args(a)
        mesh = make_mesh(a.mesh, a.num_gpus, a.gpu_list, device="cpu")
        assert (mesh.size if mesh else None) == size
    out = tmp_path / "run"
    train_loop.main(TINY + extra + ["--data_path", texture, "--data_ext", "png", "--sampling", "2",
                                    "--seed", "1", "--saving_rate", "1", "--fname", str(out)])
    assert "--num_workers is ignored" in capsys.readouterr().out
    stored = checkpoint.load_checkpoint(str(out / "1_1.ckpt"))["meta"]["args"]
    assert {f: stored[f] for f in REFERENCE_FLAGS} == {
        f: want for f, (_, want) in REFERENCE_FLAGS.items()}
    assert stored["device"] == "cpu"


def test_train_cli_refuses_nhwc_tail_on_card():
    """``--chw_tail off`` (the all-NHWC tail, a CPU reference path) is
    refused at the CLI on the card, before any data or state is built; on
    the CPU it passes."""
    for device in ("cuda", "cuda:1"):
        with pytest.raises(ValueError, match="--chw_tail off is a CPU reference path"):
            check_train_args(prepare_parser().parse_args(
                README_RECIPE + ["--chw_tail", "off", "--device", device]))
    check_train_args(prepare_parser().parse_args(README_RECIPE + ["--chw_tail", "off",
                                                                  "--device", "cpu"]))


def test_train_cli_profile_dir(texture, tmp_path):
    """``--profile_dir`` writes a torch.profiler trace of the first epoch's
    steps 0-4, dispatched one by one."""
    prof = tmp_path / "prof"
    args = prepare_parser().parse_args(TINY + [
        "--data_path", texture, "--data_ext", "png", "--sampling", "12", "--seed", "1",
        "--saving_rate", "1", "--fname", str(tmp_path / "run"), "--profile_dir", str(prof)])
    train_loop.train(args)
    assert os.listdir(prof) == ["train_steps_0-4.json"]
    assert os.path.getsize(prof / "train_steps_0-4.json") > 0
