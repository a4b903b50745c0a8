"""Tube-width network: the MLP as an ``nn.Module``.

Counterpart of ``legged_gym_dev_tpu/tube/models.py``. Weights are stored as
the JAX package stores them, ``W`` of shape ``(in, out)`` applied as
``x @ W + b`` (not ``nn.Linear``'s ``(out, in)``), so parameters carry over
without transposes (``interop.mlp_from_numpy``). Everything here is plain
``torch``: the JAX package computes it outside any Pallas kernel.

An ``MLP`` is shared (weights ``(in, out)``, biases ``(out,)``, one network
for every input row; ``torch.matmul``) or per scenario, the JAX package's
vmapped MLP pytree: weights ``(B, in, out)``, biases ``(B, out)``,
``out_scale`` ``(B,)`` or a scalar (``MLP.stack``). The per-scenario form
acts on inputs ``(..., B, in)`` whose second-to-last axis is the scenario
axis, through ``einsum`` over it (a batched matmul).

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


def _matmul(h, W):
    """``h @ W`` for a shared ``W (in, out)``; per scenario (``W (B, in,
    out)``, ``h (..., B, in)``) the product on the scenario axis."""
    if W.ndim == 3:
        return torch.einsum("...bi,bio->...bo", h, W)
    return h @ W


def _matmul_t(u, W):
    """``u @ W^T``, shared or per scenario as ``_matmul``."""
    if W.ndim == 3:
        return torch.einsum("...bo,bio->...bi", u, W)
    return u @ W.T


class MLP(nn.Module):
    """Hidden layers with an activation, a linear output layer, an optional
    final activation and an optional ``out_scale`` applied after it.
    Inputs carry any leading axes; the network acts on the last one (per
    scenario, the second-to-last is the scenario axis)."""

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

    @classmethod
    def stack(cls, mlps: Sequence["MLP"], device=None) -> "MLP":
        """The per-scenario form of shared MLPs of one architecture, one a
        scenario, on ``device`` (None = the CUDA card). A missing
        ``out_scale`` counts as 1.0 when another MLP has one."""
        from ..utils.runtime import resolve_device

        dev = resolve_device(device)
        m0 = mlps[0]
        if any(m.per_scenario or m.activation != m0.activation
               or m.final_activation != m0.final_activation
               or [w.shape for w in m.weights]
               != [w.shape for w in m0.weights] for m in mlps):
            raise ValueError("stack needs shared MLPs of one architecture")

        def st(ts):
            return torch.stack([t.detach().to(dev) for t in ts])

        scales = [m.out_scale for m in mlps]
        out_scale = (None if all(s is None for s in scales) else st(
            [torch.ones((), device=dev) if s is None else s.reshape(())
             for s in scales]))
        return cls([st(ws) for ws in zip(*[m.weights for m in mlps])],
                   [st(bs) for bs in zip(*[m.biases for m in mlps])],
                   activation=m0.activation,
                   final_activation=m0.final_activation, out_scale=out_scale)

    def replace(self, **kw) -> "MLP":
        """A new MLP with the fields ``kw`` names (``weights``, ``biases``,
        ``activation``, ``final_activation``, ``out_scale``) swapped and the
        others' tensors shared: flax.struct's ``replace``, so that
        ``model.replace(out_scale=s)`` gives the calibrated net. A float
        ``out_scale`` becomes a float32 tensor on the weights' device."""
        fields = dict(weights=list(self.weights), biases=list(self.biases),
                      activation=self.activation,
                      final_activation=self.final_activation,
                      out_scale=self.out_scale)
        unknown = set(kw) - set(fields)
        if unknown:
            raise TypeError(f"MLP has no fields {sorted(unknown)}")
        fields.update(kw)
        s = fields["out_scale"]
        if s is not None and not isinstance(s, torch.Tensor):
            fields["out_scale"] = torch.as_tensor(
                s, dtype=torch.float32, device=fields["weights"][0].device)
        return MLP(**fields)

    @property
    def per_scenario(self) -> bool:
        return self.weights[0].ndim == 3

    @property
    def batch_size(self):
        """The scenario count of the per-scenario form, else None."""
        return self.weights[0].shape[0] if self.per_scenario else None

    def select(self, rows) -> "MLP":
        """The per-scenario MLP of scenarios ``rows`` (a slice or an index
        tensor), as a new module on the same device."""
        if not self.per_scenario:
            raise ValueError("select needs a per-scenario MLP")
        s = self.out_scale
        return MLP([w[rows] for w in self.weights],
                   [b[rows] for b in self.biases], self.activation,
                   self.final_activation,
                   None if s is None else (s[rows] if s.ndim else s))

    @classmethod
    def cat(cls, parts: Sequence["MLP"], device=None) -> "MLP":
        """Per-scenario MLPs joined along the scenario axis on ``device``
        (default: the first part's)."""
        m0 = parts[0]
        dev = m0.weights[0].device if device is None else device

        def cat(ts):
            return torch.cat([t.detach().to(dev) for t in ts])

        s = [m.out_scale for m in parts]
        if s[0] is not None and s[0].ndim == 0:
            out_scale = s[0].to(dev)
        else:
            out_scale = None if s[0] is None else cat(s)
        return cls([cat(ws) for ws in zip(*[m.weights for m in parts])],
                   [cat(bs) for bs in zip(*[m.biases for m in parts])],
                   m0.activation, m0.final_activation, out_scale)

    def _scale(self, ndim_extra: int):
        """``out_scale`` against an output with ``ndim_extra`` axes after
        the scenario axis."""
        s = self.out_scale
        if s is not None and s.ndim == 1 and self.per_scenario:
            return s.reshape(s.shape + (1,) * ndim_extra)
        return s

    def _hidden(self, x):
        """Hidden activations and pre-activations, and the output's
        pre-activation."""
        act = _ACTIVATIONS[self.activation]
        h = x
        acts_pre = []
        for W, b in zip(self.weights[:-1], self.biases[:-1]):
            a = _matmul(h, W) + b
            acts_pre.append(a)
            h = act(a)
        return acts_pre, _matmul(h, self.weights[-1]) + self.biases[-1]

    def forward(self, x):
        _, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        if self.out_scale is not None:
            out = out * self._scale(1)
        return out

    def value_and_jacobian(self, x):
        """(out, J) with J[..., o, i] = d out_o / d x_i, as the explicit
        product chain W_L^T D_{L-1} ... D_1 W_1^T."""
        dact = _ACT_DERIVS[self.activation]
        acts_pre, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        # M = d out_pre / d (layer input), shaped (..., h_k, out)
        W_out = self.weights[-1]
        M = W_out.expand(x.shape[:-1] + W_out.shape[-2:])
        for W, a in zip(reversed(list(self.weights[:-1])), reversed(acts_pre)):
            M = W @ (dact(a)[..., :, None] * M)
        if self.final_activation != "none":
            M = M * _ACT_DERIVS[self.final_activation](out_pre)[..., None, :]
        J = M.transpose(-1, -2)
        if self.out_scale is not None:
            out = out * self._scale(1)
            J = J * self._scale(2)
        return out, J

    def value_and_vjp(self, x, ct):
        """(out, J^T ct): one explicit backward pass."""
        dact = _ACT_DERIVS[self.activation]
        acts_pre, out_pre = self._hidden(x)
        out = _ACTIVATIONS[self.final_activation](out_pre)
        u = ct
        if self.out_scale is not None:
            out = out * self._scale(1)
            u = u * self._scale(1)
        if self.final_activation != "none":
            u = u * _ACT_DERIVS[self.final_activation](out_pre)
        u = _matmul_t(u, self.weights[-1])
        for W, a in zip(reversed(list(self.weights[:-1])), reversed(acts_pre)):
            u = _matmul_t(dact(a) * u, W)
        return out, u


def save_mlp(model: MLP, path) -> None:
    """The port's tube-model file: ``torch.save`` of the weights, biases,
    activation names and ``out_scale`` (CPU tensors), of either form."""
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
