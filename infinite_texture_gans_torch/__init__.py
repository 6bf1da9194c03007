"""PyTorch / CUDA port of the infinite-texture GAN framework.

A second package beside ``infinite_texture_gans_tpu`` (the JAX reference,
which this package never imports). The module layout mirrors the reference
so each module's counterpart is easy to find: ``ops/`` (grid, padding,
convolutions and the hand-written CUDA kernels of ``csrc/``), ``models/``,
``sampling/``, ``data/``, ``train/``, ``config.py`` and ``sample.py``.

This package ports the generation path (a trained checkpoint is loaded,
rebuilt as an eval-mode generator and run through the halo-cache raster
engine) and the Experiment-1 training step with ``--fuse_up off``
(``train/train_loop.py``, which writes checkpoints in the reference's
format). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
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
