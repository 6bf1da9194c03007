"""Inference CLI: ``python -m infinite_texture_gans_torch.sample``.

Port of ``infinite_texture_gans_tpu/sample.py``: loads a framework
``.ckpt`` or a reference ``.pth``, rebuilds the generator from the config
stored in it. ``--export_pth PATH`` writes the checkpoint's generator (and
a ``.ckpt``'s discriminator) as a reference ``.pth`` instead of sampling
(``utils/torch_export.py``; a ``.pth`` input re-exports its imported tree,
so ``.pth -> .pth`` keeps the state dict bit for bit). A
local-padding checkpoint generates the canvas with the halo-cache raster engine
(uint8 wire; on the card a canvas row whose kind came up before is one
CUDA graph replay) and writes the images next to the checkpoint under the
name given (a ``.png`` through the port's PNG writer, any other suffix
through PIL, as the reference saves); ``--stream`` writes one canvas straight into a PNG
(``sampling/stream.py``; ``.png`` is added to a name without it), and
``--fuse_up all`` runs the fused eval tail (K9 on the one pass, K14 in the
raster engine); ``--diag_lanes L`` generates the canvas L rows at a time
(``sampling/diag.py``, the batched-diagonal engine; eager), the ``--batch``
canvases in one batch. A zeros-padding checkpoint (the reference's branch,
:196-214) runs one pass on a latent of ``output_resolution_height / S``
squared (S = 2^(n_layers_G-1)), or ``--tiles`` (``sampling/tiled.py``);
``--stream`` then renders in memory. ``--mesh data:N`` generates one
local-padding canvas with its rows pipelined over N devices
(``parallel/wavefront.py``: one process per device, started here), in
memory or, with ``--stream``, in slabs of ``--slab_rows`` canvas rows
written by rank 0: the single-device canvas byte for byte. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.parallel.mesh import current_axis, make_mesh, run_ranks
from infinite_texture_gans_torch.parallel.wavefront import (
    generate_canvas_wavefront,
    generate_canvas_wavefront_streamed,
)
from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag
from infinite_texture_gans_torch.sampling.infinite import _to_uint8, generate_canvas
from infinite_texture_gans_torch.sampling.stream import StreamingPNGWriter, generate_canvas_streamed
from infinite_texture_gans_torch.sampling.tiled import sample_from_gen
from infinite_texture_gans_torch.train.checkpoint import (
    load_checkpoint,
    load_generator_from_checkpoint,
)
from infinite_texture_gans_torch.utils.torch_export import export_generator_pth

def prepare_sample_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_resolution_height", type=int, default=384)
    p.add_argument("--output_resolution_width", type=int, default=384)
    p.add_argument("--output_name", type=str, default="241_generated.jpg",
                   help="image file name, written next to the checkpoint; its suffix picks "
                        "the format")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch", type=int, default=1, help="number of canvases")
    p.add_argument("--row_group", type=int, default=None,
                   help="canvas rows held on the device at once (default: all)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--stream", action="store_true",
                   help="stream one canvas straight into its PNG: O(band) host memory")
    p.add_argument("--fuse_up", type=str, default="auto", choices=["auto", "all", "off"],
                   help="'all' fuses every channels-major block's upsample -> BN -> ReLU -> "
                        "conv1 at eval (half-res halo caches); 'auto' and 'off' run the "
                        "unfused eval tail")
    p.add_argument("--tiles", action="store_true",
                   help="zeros-padding checkpoints: tiled inference (tile 32, pad 16)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh, e.g. 'data:8': the wavefront engine, the canvas's rows "
                        "pipelined over that many devices (local-padding checkpoints, one image)")
    p.add_argument("--slab_rows", type=int, default=8,
                   help="--mesh with --stream: canvas rows per wavefront slab (O(slab) memory "
                        "on every device)")
    p.add_argument("--diag_lanes", type=int, default=None,
                   help="local-padding checkpoints: generate this many canvas rows per "
                        "generator call (the batched-diagonal engine; needs 3+ patch columns)")
    p.add_argument("--export_pth", type=str, default=None,
                   help="write the checkpoint as a reference-format .pth at this path and exit "
                        "(no sampling)")
    return p


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, C) uint8 with C in {1, 3} -> 8-bit grayscale or RGB PNG."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"expected (H, W, 1|3) uint8, got {img.shape} {img.dtype}")
    writer = StreamingPNGWriter(path, img.shape[0], img.shape[1], img.shape[2], compress_level=6)
    writer.write_rows(img)
    writer.close()


def save_image(img: np.ndarray, path: str) -> None:
    """(H, W, C) uint8 -> the file at ``path``: :func:`write_png` for a
    ``.png`` name, PIL for any other suffix (the reference's
    ``save_image``, which saves a one-channel image as grayscale)."""
    if path.lower().endswith(".png"):
        write_png(path, img)
        return
    from PIL import Image

    Image.fromarray(img[:, :, 0] if img.shape[-1] == 1 else img).save(path)


def save_batch(imgs: np.ndarray, saving_path: str) -> None:
    """Save every canvas: the first at the requested name, the rest as
    ``<stem>_k<ext>``."""
    stem, ext = os.path.splitext(saving_path)
    for k in range(imgs.shape[0]):
        path = saving_path if k == 0 else f"{stem}_{k}{ext}"
        save_image(imgs[k], path)
        print("The image is saved as:", path)


def _mesh_rank(args_sample: argparse.Namespace) -> None:
    """One rank of ``--mesh``: the checkpoint's generator on the rank's
    device and the latents of the single-device run (the same seed), the
    wavefront canvas; rank 0 writes it."""
    device = current_axis().device
    gen = load_generator_from_checkpoint(args_sample.model_path, device=device,
                                         fuse_up=args_sample.fuse_up)[0]
    rng = torch.Generator(device=device).manual_seed(
        args_sample.seed if args_sample.seed is not None else 0)
    path = os.path.join(os.path.dirname(args_sample.model_path), args_sample.output_name)
    size = (args_sample.output_resolution_height, args_sample.output_resolution_width)
    if args_sample.stream:
        if not path.endswith(".png"):
            path += ".png"
        generate_canvas_wavefront_streamed(gen, rng, *size, path, slab_rows=args_sample.slab_rows,
                                           progress=True)
        print("The image is saved as:", path)
        return
    img_u8 = generate_canvas_wavefront(gen, rng, *size, wire="u8", progress=True)
    if img_u8 is not None:
        save_batch(img_u8, path)


def main(argv=None) -> None:
    args_sample = prepare_sample_parser().parse_args(argv)
    device = resolve_device(args_sample.device)
    ckpt = load_checkpoint(args_sample.model_path)
    # an export keeps the stored flags as they are
    gen, args, variables = load_generator_from_checkpoint(
        args_sample.model_path, device=device, ckpt=ckpt,
        fuse_up=None if args_sample.export_pth else args_sample.fuse_up, with_variables=True)
    print(args)
    if args_sample.export_pth:
        meta = ckpt["meta"]
        export_generator_pth(args_sample.export_pth, variables, args, epoch=meta.get("epoch"),
                             gloss=meta.get("Gloss"), dloss=meta.get("Dloss"),
                             seed=meta.get("seed"), d_variables=ckpt.get("netD_variables"),
                             d_norm_layer=getattr(args, "norm_layer_D", None))
        print("Exported reference .pth checkpoint:", args_sample.export_pth)
        return
    mesh = None
    if args_sample.mesh:
        if args.padding_mode != "local":
            print("Warning: --mesh requires a local-padding checkpoint (the wavefront pipelines "
                  "the halo protocol); generating single-device")
        else:
            mesh = make_mesh(args_sample.mesh, device=device.type)
            if mesh is None:
                print(f"Warning: --mesh {args_sample.mesh} resolves to a single device; "
                      "generating with the single-device engine")
    if mesh is not None:
        if args_sample.batch > 1:
            print("Warning: --mesh generates a single image; ignoring --batch")
        print(f"mesh: data:{mesh.size} on {', '.join(mesh.devices)} ({mesh.backend})")
        run_ranks(_mesh_rank, mesh, (args_sample,))
        return
    seed = args_sample.seed if args_sample.seed is not None else 0
    rng = torch.Generator(device=device).manual_seed(seed)
    path = os.path.join(os.path.dirname(args_sample.model_path), args_sample.output_name)
    if args.padding_mode != "local":
        if args_sample.stream:
            print("Warning: --stream requires a local-padding checkpoint; the zeros-padding "
                  "path generates in memory instead")
        img = sample_from_gen(gen, rng, num_images=args_sample.batch,
                              base_res=args_sample.output_resolution_height // (
                                  2 ** (gen.n_layers_G - 1)),
                              tiles=args_sample.tiles)
        save_batch(_to_uint8(img).cpu().numpy(), path)
        return
    if args_sample.stream:
        if not path.endswith(".png"):
            path += ".png"
        if args_sample.batch > 1:
            print("Warning: --stream writes one PNG; generating a single image")
        generate_canvas_streamed(
            gen, rng, args_sample.output_resolution_height, args_sample.output_resolution_width,
            path, progress=True, row_group=args_sample.row_group or 4,
        )
        print("The image is saved as:", path)
        return
    size = dict(output_resolution_height=args_sample.output_resolution_height,
                output_resolution_width=args_sample.output_resolution_width,
                num_images=args_sample.batch, progress=True, wire="u8")
    if args_sample.diag_lanes:
        img_u8 = generate_canvas_diag(gen, rng, lanes=args_sample.diag_lanes, **size)
    else:
        img_u8 = generate_canvas(gen, rng, row_group=args_sample.row_group, **size)
    save_batch(img_u8, path)


if __name__ == "__main__":
    main()
