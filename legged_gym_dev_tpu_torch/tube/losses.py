"""Quantile ("pinball through Huber") tube losses.

Counterpart of ``legged_gym_dev_tpu/tube/losses.py``. Each loss is
``loss(fw, w, data) -> scalar``: the asymmetric alpha weighting makes the
regressor estimate the alpha-quantile of the tube width (``fw >= w`` with
probability about alpha), and the Huber wrapper bounds the gradient on
outliers.

``|x|`` is ``fast_tube._abs``, whose derivative at 0 is +1 as
``jnp.abs``'s (``torch.abs`` gives 0): a row whose residual is exactly 0
then has JAX's gradient.
"""
from __future__ import annotations

import torch

from ..solver.fast_tube import _abs


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Mean Huber loss of x against zero (``nn.HuberLoss`` semantics)."""
    absx = _abs(x)
    return torch.mean(torch.where(absx <= delta, 0.5 * x * x,
                                  delta * (absx - 0.5 * delta)))


def _pinball(residual: torch.Tensor, alpha) -> torch.Tensor:
    return torch.where(residual > 0, alpha * residual,
                       (1.0 - alpha) * _abs(residual))


def scalar_tube_loss(fw, w, data=None, *, alpha: float = 0.9,
                     delta: float = 1.0) -> torch.Tensor:
    """Asymmetric quantile residual through Huber."""
    return huber(_pinball(w - fw, alpha), delta)


# The one-shot horizon loss is the scalar one.
scalar_horizon_tube_loss = scalar_tube_loss


def vector_tube_loss(fw, w, data=None, *, alpha: float = 0.9,
                     delta: float = 1.0) -> torch.Tensor:
    """Per-dim pinball summed over dims, then Huber."""
    return huber(torch.sum(_pinball(w - fw, alpha), dim=-1), delta)


def alpha_scalar_tube_loss(fw, w, data, *, delta: float = 1.0):
    """The quantile level alpha read from the last input column."""
    return huber(_pinball(w - fw, data[:, -1:]), delta)


def alpha_vector_tube_loss(fw, w, data, *, delta: float = 1.0):
    """Vector variant of the alpha-conditioned loss."""
    return huber(torch.sum(_pinball(w - fw, data[:, -1:]), dim=-1), delta)


def error_loss(fe, e, data=None) -> torch.Tensor:
    """Plain MSE for signed error-dynamics regression."""
    return torch.mean((fe - e) ** 2)


LOSS_REGISTRY = {
    "ScalarTubeLoss": scalar_tube_loss,
    "ScalarHorizonTubeLoss": scalar_horizon_tube_loss,
    "VectorTubeLoss": vector_tube_loss,
    "AlphaScalarTubeLoss": alpha_scalar_tube_loss,
    "AlphaVectorTubeLoss": alpha_vector_tube_loss,
    "ErrorLoss": error_loss,
}
