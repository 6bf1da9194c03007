"""Several devices: data-parallel training and multi-device generation.

Port of ``infinite_texture_gans_tpu/parallel/`` on ``torch.distributed``
(one process per device; NCCL between cards, gloo between CPU
processes): ``mesh.py`` (the data axis and its ranks), ``sharded.py``
(images over the ranks, or one canvas's width) and ``wavefront.py`` (one
canvas's rows pipelined across the ranks, whole or streamed in slabs).
"""

from infinite_texture_gans_torch.parallel.mesh import make_mesh, replicate, shard_batch
from infinite_texture_gans_torch.parallel.sharded import generate_one_pass_sharded, shard_images
from infinite_texture_gans_torch.parallel.wavefront import (
    generate_canvas_wavefront,
    generate_canvas_wavefront_streamed,
    schedule_constants,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "generate_one_pass_sharded",
    "shard_images",
    "generate_canvas_wavefront",
    "generate_canvas_wavefront_streamed",
    "schedule_constants",
]
