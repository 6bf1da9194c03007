"""ops of the PyTorch port (see the package docstring): the grid layout,
local padding and the halo cache, and the channels-major kernels' wrappers
(``kernels.py``; the CUDA sources build at their first launch)."""

from infinite_texture_gans_torch.ops.grid import (
    crop_image,
    crop_images,
    grid_to_patches,
    merge_patches_into_image,
    patches_to_grid,
    upsample_nearest,
)
from infinite_texture_gans_torch.ops.kernels import conv1x1_chw, conv1x1_chw_add, conv3x3_chw
from infinite_texture_gans_torch.ops.padding import (
    GridPos,
    SiteSpec,
    SiteState,
    finalize_row,
    halo_pad_step,
    init_halo_state,
    local_pad,
    rotate_rows,
)

__all__ = [
    "grid_to_patches",
    "patches_to_grid",
    "merge_patches_into_image",
    "crop_images",
    "crop_image",
    "upsample_nearest",
    "conv3x3_chw",
    "conv1x1_chw",
    "conv1x1_chw_add",
    "SiteSpec",
    "SiteState",
    "GridPos",
    "local_pad",
    "halo_pad_step",
    "init_halo_state",
    "finalize_row",
    "rotate_rows",
]
