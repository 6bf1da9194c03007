"""GAN losses: standard (BCE with logits) and hinge.

Port of ``infinite_texture_gans_tpu/train/losses.py`` (:17-42). Labels
support one-sided smoothing (``--smooth``: real label 0.9, also the G
target). The losses are taken in float32 whatever the logits' compute type.
WGAN-GP is not ported yet (it changes the G->D image wire; ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOSSES = ("standard", "hinge")


def _check(loss_type: str) -> None:
    if loss_type not in LOSSES:
        raise NotImplementedError(f"--loss {loss_type}: only {LOSSES} are ported yet")


def _bce_mean(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy(logits, label).mean()."""
    x = logits.float()
    return -(label * F.logsigmoid(x) + (1.0 - label) * F.logsigmoid(-x)).mean()


def d_loss_real(loss_type: str, real_logit: torch.Tensor, label_t: float = 1.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type == "hinge":
        return torch.relu(1.0 - real_logit.float()).mean()
    return _bce_mean(real_logit, label_t)


def d_loss_fake(loss_type: str, fake_logit: torch.Tensor, label_f: float = 0.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type == "hinge":
        return torch.relu(1.0 + fake_logit.float()).mean()
    return _bce_mean(fake_logit, label_f)


def g_loss(loss_type: str, fake_logit: torch.Tensor, label_t: float = 1.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type == "hinge":
        return -fake_logit.float().mean()
    return _bce_mean(fake_logit, label_t)
