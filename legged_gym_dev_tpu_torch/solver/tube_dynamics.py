"""Tube-width dynamics used as NLP constraints, batch-leading.

Counterpart of ``legged_gym_dev_tpu/solver/tube_dynamics.py``. Each function
maps the planned trajectory ``z (B, N+1, n)``, ``v (B, N, m)``, the widths
``w``, the error history ``e (B, H_rev)`` and the input history
``v_prev (B, H_rev, m)`` to the predicted widths ``fw (B, N)``. Ported: l1,
l2 and the NN one-shot tube; the rolling-window tubes are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch


def l1_tube(scaling: float) -> Callable:
    """fw_k = scaling * sum_j |v_kj|."""

    def fn(z, v, w, e, v_prev, params):
        return scaling * torch.sum(torch.abs(v), dim=-1)

    return fn


def l2_tube(scaling: float) -> Callable:
    """fw_k = scaling * sum_j v_kj^2."""

    def fn(z, v, w, e, v_prev, params):
        return scaling * torch.sum(v * v, dim=-1)

    return fn


def nn_oneshot_tube() -> Callable:
    """One-shot NN tube: input ``[e (H_rev), z_0[2:], vec_F(v_total)]`` with
    ``v_total = [v_prev; v]`` flattened column-major (CasADi ``reshape``
    semantics), exactly as the JAX package lays it out."""

    def fn(z, v, w, e, v_prev, params):
        B = z.shape[0]
        v_total = torch.cat([v_prev, v], dim=-2)              # (B, H+N, m)
        v_flat = v_total.transpose(-1, -2).reshape(B, -1)     # column-major
        x = torch.cat([e.reshape(B, -1), z[:, 0, 2:], v_flat], dim=-1)
        return params(x)

    return fn


def get_tube_dynamics(tube_dyn: str, N: int, scaling: float = 0.5,
                      window_size: int = 10) -> Callable:
    if tube_dyn == "l1":
        return l1_tube(scaling)
    if tube_dyn == "l2":
        return l2_tube(scaling)
    if tube_dyn == "NN_oneshot":
        return nn_oneshot_tube()
    if tube_dyn in ("l1_rolling", "l2_rolling"):
        raise NotImplementedError(f"Tube dynamics '{tube_dyn}' is not ported")
    raise ValueError(f"Tube dynamics '{tube_dyn}' not implemented")
