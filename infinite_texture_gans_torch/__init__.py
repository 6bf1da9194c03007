"""PyTorch / CUDA port of the infinite-texture GAN framework.

A second package beside ``infinite_texture_gans_tpu`` (the JAX reference,
which this package never imports). The module layout mirrors the reference
so each module's counterpart is easy to find: ``ops/`` (grid, padding,
convolutions and the hand-written CUDA kernels of ``csrc/``), ``models/``,
``sampling/``, ``data/``, ``train/``, ``config.py`` and ``sample.py``.

This package ports the generation path (a trained checkpoint is loaded,
rebuilt as an eval-mode generator and run through the halo-cache raster
engine, in memory or streamed into a PNG, fused under the sample CLI's
``--fuse_up all``, or several canvas rows at a time by the batched-diagonal
engine) and the training step (``train/train_loop.py``, on one texture or a
directory of them, which writes checkpoints in the reference's format),
whose train CLI defaults to the reference's ``--fuse_up auto`` (the
subpixel-fused up-conv tail) and also takes ``off``. Checkpoints are the
framework's ``.ckpt`` or the reference's PyTorch ``.pth``, read safely and
written back by ``sample --export_pth`` (``utils/torch_import.py``,
``utils/torch_export.py``); ``utils/`` also holds the FLOP count, the stall
watchdog and the texture-quality metrics, and ``models/discriminator.py``
the reference's discriminator zoo. On the card both paths issue CUDA graphs
(``ops/graphs.py``): the train loop replays a captured step, the raster
engine a captured canvas row of each kind met more than once. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version, and both paths run eagerly.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, so no entry point silently moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
