"""sampling of the PyTorch port (see the package docstring)."""

from infinite_texture_gans_torch.sampling.latents import (
    build_maps_full,
    build_train_maps,
    build_train_z,
    build_z_full,
    slice_sub_maps,
    slice_sub_z,
    truncated_normal_z,
)
from infinite_texture_gans_torch.sampling.infinite import (
    generate_canvas,
    generate_one_pass,
    sample_from_gen_patch_by_patch_train,
)
from infinite_texture_gans_torch.sampling.stream import (
    StreamingPNGWriter,
    generate_canvas_streamed,
)
from infinite_texture_gans_torch.sampling.tiled import sample_from_gen, tile_process
from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag

__all__ = [
    "StreamingPNGWriter",
    "generate_canvas_streamed",
    "build_z_full",
    "build_maps_full",
    "build_train_z",
    "build_train_maps",
    "slice_sub_z",
    "slice_sub_maps",
    "truncated_normal_z",
    "generate_canvas",
    "generate_canvas_diag",
    "generate_one_pass",
    "sample_from_gen_patch_by_patch_train",
    "sample_from_gen",
    "tile_process",
]
