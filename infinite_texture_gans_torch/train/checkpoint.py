"""Write and read framework ``.ckpt`` checkpoints; rebuild the generator.

Port of ``save_checkpoint`` (:35-56), ``load_checkpoint`` and
``load_generator_from_checkpoint`` of
``infinite_texture_gans_tpu/train/checkpoint.py``. File layout
(docs/CHECKPOINT.md): ``MAGIC``, a little-endian u64 length, the JSON
metadata (``meta.args`` holds the training flags), then the flax msgpack
body, written and read by the port's own encoder and decoder
(``train/msgpack.py``), so checkpoints cross between the two packages in
both directions. The reference ``.pth`` import is not ported yet.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.config import dict_to_args, generator_kwargs
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.train import msgpack
from infinite_texture_gans_torch.weights import from_jax_variables

MAGIC = b"ITGTPU1\n"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """``payload``: nested dicts of arrays (numpy arrays, numpy scalars or
    tensors) plus JSON-serialisable metadata under 'meta'; the reference's
    ``save_checkpoint`` format."""
    body = {k: v for k, v in payload.items() if k != "meta"}
    meta_blob = json.dumps(payload.get("meta", {})).encode()
    blob = msgpack.packb(body)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(meta_blob)))
        f.write(meta_blob)
        f.write(blob)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The stored trees (numpy arrays; bfloat16 as torch tensors) plus the
    metadata under 'meta'."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(
                f"{path}: not a framework .ckpt (reference .pth import is not ported yet)"
            )
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode())
        tree = msgpack.unpackb(f.read())
    tree["meta"] = meta
    return tree


def load_generator_from_checkpoint(
    path: str, ema: Optional[bool] = None, *, device="cuda",
    ckpt: Optional[Dict[str, Any]] = None, fuse_up: Optional[str] = None,
):
    """Rebuild the eval generator from a checkpoint's stored config (SN off,
    3x3 grid, as the reference does) and load its weights.

    ``ema``: use the stored EMA snapshot when the checkpoint has one.
    ``fuse_up`` overrides the stored one ('all': the fused eval tail, as
    the reference's sample CLI clones the generator with its flag).
    Returns (generator in eval mode on ``device``, args namespace)."""
    dev = resolve_device(device)
    if ckpt is None:
        ckpt = load_checkpoint(path)
    args = dict_to_args(ckpt["meta"]["args"])
    if fuse_up is not None:
        args.fuse_up = fuse_up
    kwargs = generator_kwargs(args)
    # the eval tail is the port's choice: a stored --chw_tail off (a CPU
    # reference path in the port, a TPU placement in the reference) would
    # refuse the card
    kwargs.update(SN=False, num_patches_h=3, num_patches_w=3, chw_tail="auto")
    gen = ResidualPatchGenerator(**kwargs)
    if ema and ckpt.get("ema"):
        variables = {"params": ckpt["ema"]["params"], "batch_stats": ckpt["ema"]["batch_stats"]}
    else:
        variables = ckpt["netG_variables"]
    gen.load_state_dict(from_jax_variables(variables), strict=True)
    return gen.to(dev).eval(), args
