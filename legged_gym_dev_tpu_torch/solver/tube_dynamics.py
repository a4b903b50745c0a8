"""Tube-width dynamics used as NLP constraints, batch-leading.

Counterpart of ``legged_gym_dev_tpu/solver/tube_dynamics.py``. Each function
maps the planned trajectory ``z (B, N+1, n)``, ``v (B, N, m)``, the widths
``w``, the error history ``e (B, H_rev)`` and the input history
``v_prev (B, H_rev, m)`` to the predicted widths ``fw (B, N)``: l1, l2,
their rolling-window means and the NN one-shot tube. The generic solver
differentiates them in forward mode (``torch.func``), so ``|v|`` is
``_abs``, whose derivative at 0 is +1 as ``jnp.abs``'s (``torch.abs``
gives 0).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def _abs(x):
    """|x| whose derivative at 0 is +1, as JAX's (torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


def l1_tube(scaling: float) -> Callable:
    """fw_k = scaling * sum_j |v_kj|."""

    def fn(z, v, w, e, v_prev, params):
        return scaling * torch.sum(_abs(v), dim=-1)

    return fn


def l2_tube(scaling: float) -> Callable:
    """fw_k = scaling * sum_j v_kj^2."""

    def fn(z, v, w, e, v_prev, params):
        return scaling * torch.sum(v * v, dim=-1)

    return fn


@functools.lru_cache(maxsize=None)
def _rolling_matrix(N: int, window: int) -> np.ndarray:
    """A[i, j] = 1/min(window, i+1) for max(i-window+1, 0) <= j <= i."""
    A = np.zeros((N, N), np.float32)
    for i in range(N):
        lo = max(i - window + 1, 0)
        A[i, lo:i + 1] = 1.0 / min(window, i + 1)
    A.setflags(write=False)
    return A


def _rolling(per_step: Callable, window: int, N: int) -> Callable:
    """fw = A @ per_step(v) with A = _rolling_matrix(N, window), its
    transpose held once per device."""
    At = {}

    def fn(z, v, w, e, v_prev, params):
        if v.device not in At:
            At[v.device] = torch.tensor(_rolling_matrix(N, window).T,
                                        device=v.device)
        return per_step(v) @ At[v.device]

    return fn


def l1_rolling_tube(scaling: float, window: int, N: int) -> Callable:
    """Rolling mean of the per-step l1 tube."""
    return _rolling(lambda v: scaling * torch.sum(_abs(v), dim=-1), window, N)


def l2_rolling_tube(scaling: float, window: int, N: int) -> Callable:
    """Rolling mean of the per-step l2 tube."""
    return _rolling(lambda v: scaling * torch.sum(v * v, dim=-1), window, N)


def nn_oneshot_tube() -> Callable:
    """One-shot NN tube: input ``[e (H_rev), z_0[2:], vec_F(v_total)]`` with
    ``v_total = [v_prev; v]`` flattened column-major (CasADi ``reshape``
    semantics), exactly as the JAX package lays it out. ``params`` is a
    shared ``MLP`` or a per-scenario one (its scenario axis the batch
    axis of ``x``)."""

    def fn(z, v, w, e, v_prev, params):
        B = z.shape[0]
        v_total = torch.cat([v_prev, v], dim=-2)              # (B, H+N, m)
        v_flat = v_total.transpose(-1, -2).reshape(B, -1)     # column-major
        x = torch.cat([e.reshape(B, -1), z[:, 0, 2:], v_flat], dim=-1)
        return params(x)

    return fn


def get_tube_dynamics(tube_dyn: str, N: int, scaling: float = 0.5,
                      window_size: int = 10) -> Callable:
    """Registry lookup, as the JAX package's."""
    if tube_dyn == "l1":
        return l1_tube(scaling)
    if tube_dyn == "l2":
        return l2_tube(scaling)
    if tube_dyn == "l1_rolling":
        return l1_rolling_tube(scaling, window_size, N)
    if tube_dyn == "l2_rolling":
        return l2_rolling_tube(scaling, window_size, N)
    if tube_dyn == "NN_oneshot":
        return nn_oneshot_tube()
    raise ValueError(f"Tube dynamics '{tube_dyn}' not implemented")
