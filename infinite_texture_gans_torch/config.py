"""The part of the config system needed to rebuild a generator.

Port of ``dict_to_args`` and ``generator_kwargs`` from
``infinite_texture_gans_tpu/config.py``: a checkpoint stores the training
flags (``meta.args``); flags it lacks take the defaults below, which are the
reference parser's defaults for the same flags.
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
    "num_patches_width": 3,
    "num_patches_height": 3,
    "outer_padding": "replicate",
    "compute_dtype": "float32",
    "fuse_up": "auto",
}


def dict_to_args(d: Dict[str, Any]) -> argparse.Namespace:
    """Namespace from a checkpoint-stored config, defaults filled in."""
    return argparse.Namespace(**{**GENERATOR_DEFAULTS, **d})


def generator_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """Constructor kwargs for ResidualPatchGenerator from a config namespace.

    The stored ``chw_tail`` is the reference's TPU placement flag and is not
    read: the port's generator picks its tail itself. ``fuse_up`` 'auto' and
    'off' differ only in training; 'all' (the fused eval up-conv) is not
    ported yet and is refused."""
    if args.fuse_up == "all":
        raise NotImplementedError("fuse_up='all' is not ported yet; use 'auto'")
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
        padding_mode=args.padding_mode,
        outer_padding=args.outer_padding,
        num_patches_h=args.num_patches_height,
        num_patches_w=args.num_patches_width,
        dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
    )
