"""Flags: the training parser and the model constructors' keyword arguments.

Port of ``prepare_parser``, ``dict_to_args``, ``generator_kwargs`` and
``discriminator_kwargs`` from ``infinite_texture_gans_tpu/config.py``. A
checkpoint stores the training flags (``meta.args``); flags it lacks take
the defaults below, which are the reference parser's defaults for the same
flags. The training parser keeps the reference's flag names and defaults
(``--fuse_up auto`` trains the subpixel-fused up-conv tail,
``--steps_per_dispatch 0`` dispatches K steps at a time, on the card as
replays of a captured CUDA graph) and adds ``--device`` ('cuda' by
default).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

GENERATOR_DEFAULTS: Dict[str, Any] = {
    "attention": False,
    "img_ch": 3,
    "G_ch": 52,
    "leak_G": 0,
    "z_dim": 128,
    "spec_norm_G": False,
    "n_layers_G": 6,
    "base_res": 4,
    "padding_mode": "zeros",
    "type_norm_G": "BN",
    "map_dim": 1,
    "num_patches_width": 3,
    "num_patches_height": 3,
    "outer_padding": "replicate",
    "compute_dtype": "float32",
    "fuse_up": "auto",
}

def prepare_parser() -> argparse.ArgumentParser:
    """The training flags (the reference's names and defaults, and the
    port's ``--device``). Flags of the reference that the port does not act
    on yet are refused by :func:`check_train_args`; ``--leak_D``,
    ``--padding_size`` and ``--conv_reduction`` are stored and not used, as
    in the reference's patch models."""
    p = argparse.ArgumentParser(description="Train the texture GAN (PyTorch port).")
    a = p.add_argument
    # data
    a("--data", type=str, default="single_image",
      help="type of data: single_image, or multiple_images (a directory)")
    a("--data_path", type=str, default="datasets/241.jpg", help="data path")
    a("--data_ext", type=str, default="jpg", help="data extension: jpg, png or txt")
    a("--center_crop", type=int, default=None, help="center cropping")
    a("--random_crop", type=int, default=None, help="random cropping")
    a("--resize_h", type=int, default=None, help="resize for h (multiple_images; with --resize_w)")
    a("--resize_w", type=int, default=None, help="resize for w (multiple_images; with --resize_h)")
    a("--sampling", type=int, default=8000,
      help="virtual dataset length per epoch; multiple_images: also draws that many files "
           "where the directory holds more")
    # models
    a("--D_model", type=str, default="patch_GAN", help="discriminator model (patch_GAN)")
    a("--attention", action="store_true", default=False, help="attention in the generator")
    a("--img_ch", type=int, default=3, help="image channels")
    a("--G_ch", type=int, default=52, help="base channel multiplier for G")
    a("--D_ch", type=int, default=64, help="base channel multiplier for D")
    a("--leak_G", type=float, default=0, help="leaky relu slope in G, 0 uses ReLU")
    a("--leak_D", type=float, default=0,
      help="leaky relu slope in D (stored; the patch D's slope is 0.2)")
    a("--z_dim", type=int, default=128, help="latent dimension")
    a("--spec_norm_D", default=False, action="store_true", help="spectral normalization in D")
    a("--spec_norm_G", default=False, action="store_true", help="spectral normalization in G")
    a("--n_layers_D", type=int, default=4, help="number of layers in D")
    a("--n_layers_G", type=int, default=6, help="number of layers in G")
    a("--norm_layer_D", type=str, default=None,
      help="normalization layer in D after conv1 ... conv{n_layers_D-1}: batch or instance "
           "(default none)")
    a("--base_res", type=int, default=4, help="base resolution for G")
    a("--padding_mode", type=str, default="zeros",
      help="padding in G: zeros (pad-1 convs, one patch per image) or local")
    a("--type_norm_G", type=str, default="BN", help="normalization in G: BN or SSM")
    a("--map_dim", type=int, default=1, help="channels of the SSM modulation maps")
    # optimizers
    a("--lr_G", type=float, default=2e-4, help="G learning rate")
    a("--lr_D", type=float, default=2e-4, help="D learning rate")
    a("--beta1", type=float, default=0, help="Adam beta1")
    a("--beta2", type=float, default=0.999, help="Adam beta2")
    a("--batch_size", type=int, default=64, help="discriminator batch size")
    # training
    a("--loss", type=str, default="standard",
      help="loss function: standard (BCE), hinge or wgan (WGAN-GP: the critic loss plus "
           "gp_weight x the gradient penalty on real/fake interpolates)")
    a("--gp_weight", type=float, default=10.0,
      help="WGAN-GP gradient-penalty weight (only with --loss wgan)")
    a("--disc_iters", type=int, default=1, help="D updates per G update")
    a("--epochs", type=int, default=1, help="number of epochs")
    a("--saving_rate", type=int, default=30, help="save a checkpoint every saving_rate epochs")
    a("--ema", action="store_true", default=False, help="keep an EMA of G's weights")
    a("--ema_decay", type=float, default=0.999, help="EMA decay rate")
    a("--decay_lr", type=str, default=None, help="learning-rate decay: exp or step")
    a("--seed", type=int, default=None,
      help="None for a random seed (with --resume: the checkpoint's seed)")
    a("--resume", type=str, default=None,
      help="path to a full .ckpt to resume training from (params, optimizer, EMA, epoch)")
    a("--smooth", default=False, action="store_true", help="smooth the real labels (0.9)")
    # patch generation
    a("--num_images", type=int, default=8, help="fake grids per step")
    a("--num_patches_width", type=int, default=3, help="patches along the width")
    a("--num_patches_height", type=int, default=3, help="patches along the height")
    a("--outer_padding", type=str, default="replicate", help="replicate or constant (zeros)")
    a("--padding_size", type=int, default=1, help="local padding size (stored)")
    a("--conv_reduction", type=int, default=2,
      help="spatial reduction after the convolution (stored)")
    # devices
    a("--num_gpus", type=int, default=1, help="number of devices (1)")
    a("--dev_num", type=int, default=0, help="card index: --device cuda runs on cuda:<dev_num>")
    a("--gpu_list", nargs="+", default=None, type=int,
      help="device indices when num_gpus > 1 (one device)")
    a("--num_workers", type=int, default=0,
      help="data loader workers (ignored: crops are drawn on the device)")
    a("--fname", type=str, default="models_cp", help="folder to save checkpoints")
    a("--compute_dtype", type=str, default="float32", help="float32 or bfloat16")
    a("--chw_tail", type=str, default="auto",
      help="channels-major kernels for the generator's small-channel tail: auto (or on) "
           "runs them, off keeps every block NHWC (a CPU reference path)")
    a("--fuse_up", type=str, default="auto", choices=["auto", "off"],
      help="subpixel-fused upsample+conv in the tail blocks while training: "
           "'auto' fuses (K9, K10), 'off' upsamples first")
    a("--profile_dir", type=str, default=None,
      help="if set, write a torch.profiler trace of steps 0-4 here "
           "(forces --steps_per_dispatch 1 so the trace stays small)")
    a("--steps_per_dispatch", type=int, default=0,
      help="train steps per dispatch (the crops drawn on the device): 0 = auto (the "
           "largest divisor of steps-per-epoch <= 128, or chunks of 128 and a remainder); "
           "1 disables. On the card a dispatch of K > 1 replays a captured CUDA graph of "
           "the step; the same numerics as per-step dispatch")
    a("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def check_train_args(args: argparse.Namespace) -> None:
    """Refuse the training options the port does not implement yet (several
    devices), flag values no model or dataset takes, and ``--chw_tail off``
    (a CPU reference path) on the card. ``--D_model`` other than
    ``patch_GAN`` gets the reference's refusal: the other discriminators
    (``models/discriminator.py``) are a model zoo that the training
    pipeline does not wire."""
    if args.D_model != "patch_GAN":
        raise ValueError(f"--D_model {args.D_model}: only patch_GAN is wired into the training "
                         "pipeline (reference utils.py:205-208)")
    valid = {"data": ("single_image", "multiple_images"),
             "loss": ("standard", "hinge", "wgan"), "padding_mode": ("local", "zeros"),
             "type_norm_G": ("BN", "SSM"), "norm_layer_D": (None, "batch", "instance")}
    for flag, allowed in valid.items():
        if getattr(args, flag) not in allowed:
            raise ValueError(f"--{flag} {getattr(args, flag)!r}: one of {allowed}")
    if args.disc_iters < 1:
        raise ValueError(f"--disc_iters {args.disc_iters}: at least 1")
    if args.num_gpus > 1 or len(args.gpu_list or ()) > 1:
        raise NotImplementedError(
            f"--num_gpus {args.num_gpus} / --gpu_list {args.gpu_list}: data-parallel training "
            "(the reference's parallel/) is not ported yet; the port trains on one device")
    if args.chw_tail == "off" and args.device != "cpu":
        raise ValueError(f"--chw_tail off is a CPU reference path; a {args.device} generator "
                         "runs the tail kernels")


def train_device(args: argparse.Namespace) -> str:
    """The training device: ``--device``, with ``cuda`` taken as
    ``cuda:<dev_num>``."""
    return f"cuda:{args.dev_num}" if args.device == "cuda" else args.device


def dict_to_args(d: Dict[str, Any]) -> argparse.Namespace:
    """Namespace from a checkpoint-stored config, defaults filled in."""
    return argparse.Namespace(**{**GENERATOR_DEFAULTS, **d})


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if getattr(args, "compute_dtype", "float32") == "bfloat16" else torch.float32


def generator_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """Constructor kwargs for ResidualPatchGenerator from a config namespace.

    ``chw_tail`` ('auto', 'on' taken as 'auto', or 'off': every block NHWC,
    a CPU reference path) selects the generator's tail. ``fuse_up`` 'auto' or
    'off' selects the training tail (at eval both run unfused); 'all' trains
    as 'auto' and also fuses the eval tail (K9 on the one pass, K14
    ``chw_upconv_halo_step`` in the raster engine). The train CLI offers
    'auto' and 'off', as the reference's does; the sample CLI's
    ``--fuse_up`` sets 'all'."""
    tail = getattr(args, "chw_tail", "auto")
    return dict(
        z_dim=args.z_dim,
        G_ch=args.G_ch,
        base_res=args.base_res,
        n_layers_G=args.n_layers_G,
        attention=args.attention,
        img_ch=args.img_ch,
        leak=args.leak_G,
        SN=args.spec_norm_G,
        type_norm=args.type_norm_G,
        map_dim=args.map_dim,
        padding_mode=args.padding_mode,
        outer_padding=args.outer_padding,
        num_patches_h=args.num_patches_height,
        num_patches_w=args.num_patches_width,
        dtype=_dtype(args),
        fuse_up=args.fuse_up,
        chw_tail={"on": "auto"}.get(tail, tail),
    )


def discriminator_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    return dict(base_ch=args.D_ch, n_layers_D=args.n_layers_D, img_ch=args.img_ch,
                SN=args.spec_norm_D, norm_layer=args.norm_layer_D, dtype=_dtype(args))
