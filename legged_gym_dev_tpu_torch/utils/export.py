"""Policy export: TorchScript, a ``torch.export`` program (``.pt2``) and
ONNX.

Counterpart of ``legged_gym_dev_tpu/utils/export.py``, taking the port's
``ActorCritic`` / ``ActorCriticRecurrent`` instead of flax parameters:

- ``export_policy_torchscript``: the actor as an eval-mode
  ``nn.Sequential`` through ``torch.jit.script``;
- ``export_policy_lstm_torchscript``: a stateful module whose ``forward``
  advances its ``hidden_state`` / ``cell_state`` buffers and whose
  ``reset_memory`` clears them (the recurrent policy of a deployment);
- ``export_policy_exported`` / ``load_policy_exported``: a serialized
  portable graph of the actor (``torch.export.export`` +
  ``torch.export.save``), the port's counterpart of the JAX module's
  StableHLO artifact;
- ``export_policy_onnx``: ONNX where the ``onnx`` package is installed,
  else ``None``.

The JAX module's ``export_policy_savedmodel`` (TensorFlow) has no
counterpart here. Each module is built on the device the policy's weights
lie on.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import torch
from torch import nn


def _actor(model) -> nn.Sequential:
    """An eval-mode copy of the policy's actor MLP (its mean head)."""
    return copy.deepcopy(model.actor).eval()


def _prepare(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def export_policy_torchscript(model, path: str) -> str:
    """The actor of an ``ActorCritic`` as a TorchScript module."""
    _prepare(path)
    torch.jit.script(_actor(model)).save(path)
    return path


class PolicyExporterLSTM(nn.Module):
    """A recurrent actor with its LSTM state in buffers (batch 1):
    ``forward`` advances them, ``reset_memory`` clears them.

    The port's ``LSTMCell`` is flax's ``OptimizedLSTMCell``: gates
    [i, f, g, o] stacked as ``torch.nn.LSTMCell`` stacks them, input
    kernels without bias, so ``bias_ih`` is 0."""

    def __init__(self, model):
        super().__init__()
        lstm = model.lstm
        hidden = lstm.hidden
        self.cell = nn.LSTMCell(lstm.weight_ih.shape[1], hidden)
        with torch.no_grad():
            self.cell.weight_ih.copy_(lstm.weight_ih)
            self.cell.weight_hh.copy_(lstm.weight_hh)
            self.cell.bias_ih.zero_()
            self.cell.bias_hh.copy_(lstm.bias_hh)
        self.cell.to(lstm.weight_ih.device)
        self.actor = _actor(model)
        dev = lstm.weight_ih.device
        self.register_buffer("hidden_state", torch.zeros(1, hidden,
                                                         device=dev))
        self.register_buffer("cell_state", torch.zeros(1, hidden,
                                                       device=dev))

    def forward(self, x):
        h, c = self.cell(x, (self.hidden_state, self.cell_state))
        self.hidden_state[:] = h
        self.cell_state[:] = c
        return self.actor(h)

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state[:] = 0.0
        self.cell_state[:] = 0.0


def export_policy_lstm_torchscript(model, path: str) -> str:
    """The actor of an ``ActorCriticRecurrent`` as a stateful TorchScript
    module (``PolicyExporterLSTM``)."""
    _prepare(path)
    torch.jit.script(PolicyExporterLSTM(model).eval()).save(path)
    return path


def export_policy_exported(model, obs_dim: int, path: str,
                           batch: Optional[int] = None) -> str:
    """The actor as a ``torch.export`` program saved to ``path`` (.pt2),
    with a dynamic batch axis unless ``batch`` fixes it."""
    actor = _actor(model)
    dev = next(actor.parameters()).device
    example = torch.zeros((batch or 2, obs_dim), device=dev)
    dyn = None if batch else ({0: torch.export.Dim("batch")},)
    program = torch.export.export(actor, (example,), dynamic_shapes=dyn)
    _prepare(path)
    torch.export.save(program, path)
    return path


def load_policy_exported(path: str) -> Callable:
    """The saved program of ``export_policy_exported`` as a callable
    module."""
    return torch.export.load(path).module()


def export_policy_onnx(model, obs_dim: int, path: str) -> Optional[str]:
    """The actor as an ONNX model, or ``None`` where the ``onnx`` package
    (which torch's exporter writes through) is not installed; neither the
    CPU test environment nor the card's machine has it."""
    try:
        import onnx  # noqa: F401
    except Exception:
        return None

    actor = _actor(model)
    dev = next(actor.parameters()).device
    _prepare(path)
    torch.onnx.export(
        actor, (torch.zeros(1, obs_dim, device=dev),), path,
        input_names=["obs"], output_names=["actions"],
        dynamic_axes={"obs": {0: "batch"}, "actions": {0: "batch"}},
        dynamo=False)
    return path
