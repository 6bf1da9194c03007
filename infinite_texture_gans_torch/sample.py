"""Inference CLI: ``python -m infinite_texture_gans_torch.sample``.

Port of ``infinite_texture_gans_tpu/sample.py`` for local-padding
checkpoints: loads a framework ``.ckpt``, rebuilds the generator from the
config stored in it, generates the canvas with the halo-cache raster engine
(uint8 wire) and writes PNG files next to the checkpoint. Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.sampling.infinite import generate_canvas
from infinite_texture_gans_torch.train.checkpoint import load_generator_from_checkpoint

# Flags of the reference CLI whose engines are not ported yet.
NOT_PORTED = ("stream", "mesh", "diag_lanes", "tiles", "export_pth")


def prepare_sample_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_resolution_height", type=int, default=384)
    p.add_argument("--output_resolution_width", type=int, default=384)
    p.add_argument("--output_name", type=str, default="241_generated.png",
                   help="PNG file name, written next to the checkpoint")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch", type=int, default=1, help="number of canvases")
    p.add_argument("--row_group", type=int, default=None,
                   help="canvas rows held on the device at once (default: all)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--stream", action="store_true", help="not ported yet")
    p.add_argument("--tiles", action="store_true", help="not ported yet")
    p.add_argument("--mesh", type=str, default=None, help="not ported yet")
    p.add_argument("--diag_lanes", type=int, default=None, help="not ported yet")
    p.add_argument("--export_pth", type=str, default=None, help="not ported yet")
    return p


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, C) uint8 with C in {1, 3} -> 8-bit grayscale or RGB PNG."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"expected (H, W, 1|3) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_batch(imgs: np.ndarray, saving_path: str) -> None:
    """Save every canvas: the first at the requested name, the rest as
    ``<stem>_k<ext>``."""
    stem, ext = os.path.splitext(saving_path)
    for k in range(imgs.shape[0]):
        path = saving_path if k == 0 else f"{stem}_{k}{ext}"
        write_png(path, imgs[k])
        print("The image is saved as:", path)


def main(argv=None) -> None:
    args_sample = prepare_sample_parser().parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args_sample, flag):
            raise SystemExit(f"--{flag} is not ported to the PyTorch package yet")
    device = resolve_device(args_sample.device)
    gen, args = load_generator_from_checkpoint(args_sample.model_path, device=device)
    print(args)
    seed = args_sample.seed if args_sample.seed is not None else 0
    rng = torch.Generator(device=device).manual_seed(seed)
    img_u8 = generate_canvas(
        gen,
        rng,
        output_resolution_height=args_sample.output_resolution_height,
        output_resolution_width=args_sample.output_resolution_width,
        num_images=args_sample.batch,
        progress=True,
        row_group=args_sample.row_group,
        wire="u8",
    )
    name = args_sample.output_name
    if not name.endswith(".png"):
        name += ".png"
    save_batch(img_u8, os.path.join(os.path.dirname(args_sample.model_path), name))


if __name__ == "__main__":
    main()
