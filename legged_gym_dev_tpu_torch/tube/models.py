"""Tube-width network: the MLP as an ``nn.Module``.

Counterpart of ``legged_gym_dev_tpu/tube/models.py``. Weights are stored as
the JAX package stores them, ``W`` of shape ``(in, out)`` applied as
``x @ W + b`` (not ``nn.Linear``'s ``(out, in)``), so parameters carry over
without transposes (``interop.mlp_from_numpy``). Everything here is plain
``torch.matmul``: the JAX package computes it outside any Pallas kernel.

``MLP.create`` draws the initial weights; ``tube.train`` trains them under
autograd. ``save_mlp`` / ``load_mlp`` are the port's model file (the JAX
package pickles a flax pytree, which needs flax to read).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no linear threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def softplus_beta(x, beta: float = 5.0):
    """Softplus with sharpness beta (torch Softplus(beta), threshold 20)."""
    bx = beta * x
    return torch.where(bx > 20.0, x, _softplus(bx) / beta)


_ACTIVATIONS = {
    "softplus_b5": lambda x: softplus_beta(x, 5.0),
    "softplus": _softplus,
    "relu": F.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "none": lambda x: x,
}

# Exact derivatives of the activations above, for the analytic Jacobian.
_ACT_DERIVS = {
    "softplus_b5": lambda x: torch.sigmoid(5.0 * x),
    "softplus": torch.sigmoid,
    "relu": lambda x: (x > 0.0).to(x.dtype),
    "tanh": lambda x: 1.0 - torch.tanh(x) ** 2,
    "elu": lambda x: torch.where(x > 0.0, torch.ones_like(x), torch.exp(x)),
    "none": torch.ones_like,
}


class MLP(nn.Module):
    """Hidden layers with an activation, a linear output layer, an optional
    final activation and an optional scalar ``out_scale`` applied after it.
    Inputs carry any leading axes; the network acts on the last one."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor],
                 activation: str = "softplus_b5",
                 final_activation: str = "none",
                 out_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.weights = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in weights])
        self.biases = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in biases])
        self.activation = activation
        self.final_activation = final_activation
        if out_scale is None:
            self.out_scale = None
        else:
            self.register_buffer("out_scale", out_scale)

    @classmethod
    def create(cls, gen: torch.Generator, input_size: int, output_dim: int,
               num_units: int = 128, num_layers: int = 2,
               activation: str = "softplus_b5",
               final_activation: str = "none") -> "MLP":
        """Kaiming-uniform fan-in weights and biases (``nn.Linear``'s
        default) drawn from ``gen``, on its device."""
        sizes = [input_size] + [num_units] * num_layers + [output_dim]
        ws, bs = [], []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / float(np.sqrt(fan_in))
            for shape, out in (((fan_in, fan_out), ws), ((fan_out,), bs)):
                u = torch.rand(shape, generator=gen, device=gen.device)
                out.append(-bound + u * (2.0 * bound))
        return cls(ws, bs, activation=activation,
                   final_activation=final_activation)

    def _hidden(self, x):
        """Hidden activations and pre-activations, and the output's
        pre-activation."""
        act = _ACTIVATIONS[self.activation]
        h = x
        acts_pre = []
        for W, b in zip(self.weights[:-1], self.biases[:-1]):
            a = h @ W + b
            acts_pre.append(a)
            h = act(a)
        return acts_pre, h @ self.weights[-1] + self.biases[-1]

    def forward(self, x):
        _, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        if self.out_scale is not None:
            out = out * self.out_scale
        return out

    def value_and_jacobian(self, x):
        """(out, J) with J[..., o, i] = d out_o / d x_i, as the explicit
        product chain W_L^T D_{L-1} ... D_1 W_1^T."""
        dact = _ACT_DERIVS[self.activation]
        acts_pre, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        # M = d out_pre / d (layer input), shaped (..., h_k, out)
        M = self.weights[-1].expand(x.shape[:-1] + self.weights[-1].shape)
        for W, a in zip(reversed(list(self.weights[:-1])), reversed(acts_pre)):
            M = W @ (dact(a)[..., :, None] * M)
        if self.final_activation != "none":
            M = M * _ACT_DERIVS[self.final_activation](out_pre)[..., None, :]
        J = M.transpose(-1, -2)
        if self.out_scale is not None:
            out = out * self.out_scale
            J = J * self.out_scale
        return out, J

    def value_and_vjp(self, x, ct):
        """(out, J^T ct): one explicit backward pass."""
        dact = _ACT_DERIVS[self.activation]
        acts_pre, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        u = ct
        if self.out_scale is not None:
            out = out * self.out_scale
            u = u * self.out_scale
        if self.final_activation != "none":
            u = u * _ACT_DERIVS[self.final_activation](out_pre)
        u = u @ self.weights[-1].T
        for W, a in zip(reversed(list(self.weights[:-1])), reversed(acts_pre)):
            u = (dact(a) * u) @ W.T
        return out, u


def save_mlp(model: MLP, path) -> None:
    """The port's tube-model file: ``torch.save`` of the weights, biases,
    activation names and ``out_scale`` (CPU tensors)."""
    torch.save({
        "weights": [w.detach().cpu() for w in model.weights],
        "biases": [b.detach().cpu() for b in model.biases],
        "activation": model.activation,
        "final_activation": model.final_activation,
        "out_scale": (None if model.out_scale is None
                      else model.out_scale.detach().cpu()),
    }, path)


def load_mlp(path, device=None) -> MLP:
    """The ``MLP`` a ``save_mlp`` file holds, on ``device`` (``None``: the
    CUDA card)."""
    from ..utils.runtime import resolve_device

    dev = resolve_device(device)
    d = torch.load(path, map_location=dev, weights_only=True)
    return MLP(d["weights"], d["biases"], activation=d["activation"],
               final_activation=d["final_activation"],
               out_scale=d["out_scale"])
