"""ANYdrive LSTM actuator network.

Counterpart of ``legged_gym_dev_tpu/sim/actuator_net.py``: a per-joint
2-layer LSTM(8) over (position error, velocity) inputs producing joint
torque, evaluated every physics substep with its hidden and cell state
carried in the env state and zeroed on resets. Weights load from the
reference's TorchScript checkpoint (``from_torchscript``: the state dict's
``lstm.*``, ``linear.*`` and ``out_scale``, and the module's ``in_scale``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from ..utils.runtime import resolve_device

HIDDEN = 8
LAYERS = 2


@dataclasses.dataclass
class ActuatorNetLSTM:
    w_ih: tuple            # per layer (4H, in)
    w_hh: tuple            # per layer (4H, H)
    b_ih: tuple            # per layer (4H,)
    b_hh: tuple            # per layer (4H,)
    out_w: torch.Tensor    # (1, H)
    out_b: torch.Tensor    # (1,)
    out_scale: torch.Tensor  # ()
    in_scale: torch.Tensor   # (2,) input normalization [pos_err, vel]

    def replace(self, **kw) -> "ActuatorNetLSTM":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_torchscript(cls, path: str, device=None) -> "ActuatorNetLSTM":
        dev = resolve_device(device)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no actuator net at {path}")
        mod = torch.jit.load(path, map_location="cpu")
        sd = mod.state_dict()

        def g(x):
            return x.detach().to(dtype=torch.float32, device=dev)

        return cls(
            w_ih=tuple(g(sd[f"lstm.weight_ih_l{i}"]) for i in range(LAYERS)),
            w_hh=tuple(g(sd[f"lstm.weight_hh_l{i}"]) for i in range(LAYERS)),
            b_ih=tuple(g(sd[f"lstm.bias_ih_l{i}"]) for i in range(LAYERS)),
            b_hh=tuple(g(sd[f"lstm.bias_hh_l{i}"]) for i in range(LAYERS)),
            out_w=g(sd["linear.weight"]),
            out_b=g(sd["linear.bias"]),
            out_scale=g(sd["out_scale"]).reshape(()),
            in_scale=g(mod.in_scale).reshape(-1),
        )

    def __call__(self, x: torch.Tensor, hidden: torch.Tensor,
                 cell: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One step. x: (N, 2); hidden/cell: (LAYERS, N, H). Returns
        (torque (N,), hidden', cell'); gate order [input, forget, cell,
        output], as torch's LSTM."""
        h_new, c_new = [], []
        inp = x * self.in_scale
        for l in range(LAYERS):
            gates = (inp @ self.w_ih[l].T + self.b_ih[l]
                     + hidden[l] @ self.w_hh[l].T + self.b_hh[l])
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * cell[l] + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            h_new.append(h)
            c_new.append(c)
            inp = h
        tau = (inp @ self.out_w.T + self.out_b)[..., 0] * self.out_scale
        return tau, torch.stack(h_new), torch.stack(c_new)
