"""GAN losses: standard (BCE with logits), hinge and WGAN, the WGAN-GP
gradient penalty, and the relativistic-average LS loss.

Port of ``infinite_texture_gans_tpu/train/losses.py``. Labels
support one-sided smoothing (``--smooth``: real label 0.9, also the G
target). The losses are taken in float32 whatever the logits' compute type.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

LOSSES = ("standard", "hinge", "wgan")


def _check(loss_type: str) -> None:
    if loss_type not in LOSSES:
        raise ValueError(f"--loss {loss_type}: one of {LOSSES}")


def _bce_mean(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy(logits, label).mean()."""
    x = logits.float()
    return -(label * F.logsigmoid(x) + (1.0 - label) * F.logsigmoid(-x)).mean()


def d_loss_real(loss_type: str, real_logit: torch.Tensor, label_t: float = 1.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type == "hinge":
        return torch.relu(1.0 - real_logit.float()).mean()
    if loss_type == "wgan":
        return -real_logit.float().mean()
    return _bce_mean(real_logit, label_t)


def d_loss_fake(loss_type: str, fake_logit: torch.Tensor, label_f: float = 0.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type == "hinge":
        return torch.relu(1.0 + fake_logit.float()).mean()
    if loss_type == "wgan":
        return fake_logit.float().mean()
    return _bce_mean(fake_logit, label_f)


def g_loss(loss_type: str, fake_logit: torch.Tensor, label_t: float = 1.0) -> torch.Tensor:
    _check(loss_type)
    if loss_type in ("hinge", "wgan"):
        return -fake_logit.float().mean()
    return _bce_mean(fake_logit, label_t)


def _center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    top, left = (x.shape[1] - h) // 2, (x.shape[2] - w) // 2
    return x[:, top:top + h, left:left + w]


def gradient_penalty(critic: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The WGAN-GP penalty (Gulrajani et al. 2017) as the reference takes it:
    both NHWC batches center-cropped to the smaller spatial size and sliced
    to the smaller batch n, ``x_hat = eps·real + (1-eps)·fake`` with ``eps``
    of shape (n, 1, 1, 1) (the caller draws it), the gradient of
    ``sum(critic(x_hat))`` with respect to ``x_hat`` kept in the graph
    (``create_graph``), so that a backward of the penalty reaches the
    critic's parameters through it; per-sample norms in float32 with 1e-12
    inside the square root; ``mean((‖g‖ - 1)²)``. The double backward runs
    through ``critic``'s own operations: it must not hold an autograd
    Function without one (the D stem's kernel on channels-major input)."""
    h, w = min(real.shape[1], fake.shape[1]), min(real.shape[2], fake.shape[2])
    n = min(real.shape[0], fake.shape[0])
    if tuple(eps.shape) != (n, 1, 1, 1):
        raise ValueError(f"eps is {tuple(eps.shape)}, not ({n}, 1, 1, 1)")
    real, fake = _center_crop(real, h, w)[:n], _center_crop(fake, h, w)[:n]
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(critic(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt(g.float().square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norms - 1.0).square().mean()


def calc_ralsloss_G(real: torch.Tensor, fake: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """The reference's relativistic-average LS loss for G (unused by its
    training loop; kept for parity of the components)."""
    return ((real - fake.mean() + margin) ** 2).mean() + ((fake - real.mean() - margin) ** 2).mean()
