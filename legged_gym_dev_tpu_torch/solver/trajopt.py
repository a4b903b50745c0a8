"""Tube trajectory-optimization problem data and warm starts, batch-leading.

Counterpart of ``legged_gym_dev_tpu/solver/trajopt.py``: ``PROBLEM_DICT``,
``TrajOptParams``, the warm starts and ``TrajOptSolution``. The generic
dense solve drivers (``solve_tube``, ``solve_nominal``) are not ported yet.

Where the JAX package vmaps over a pytree of per-scenario leaves, here every
per-scenario field carries a leading batch axis ``B``. Two things are shared
by the whole batch instead: the ROM (``rom``) and the tube network
(``tube_params``, one ``MLP``), where the JAX package may hold one per
scenario.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.rom import RomDynamics
from ..utils.runtime import resolve_device
from .al_solver import ALConfig, ALSolution

# Benchmark problem library (obstacle centers as (K, 2) rows).
PROBLEM_DICT = {
    "gap": {
        "start": np.array([0.3, 0.3]), "goal": np.array([1.5, 1.5]),
        "obs": {"c": np.array([[1.0, 0.0], [0.75, 1.5]]),
                 "r": np.array([0.5, 0.5])},
        "vel_max": 0.2, "pos_max": 10.0, "dt": 0.1,
    },
    "right": {
        "start": np.array([0.5, 0.0]), "goal": np.array([2.0, 0.0]),
        "obs": {"c": np.array([[1.0, 1.0], [0.625, -0.625]]),
                 "r": np.array([0.5, 0.5])},
        "vel_max": 1.0, "pos_max": 10.0, "dt": 0.1,
    },
    "right_wide": {
        "start": np.array([0.5, 0.0]), "goal": np.array([2.0, 0.0]),
        "obs": {"c": np.array([[1.0, 1.0], [1.25, -1.25]]),
                 "r": np.array([0.5, 0.5])},
        "vel_max": 1.0, "pos_max": 10.0, "dt": 0.1,
    },
}


@dataclass(frozen=True)
class TrajOptParams:
    """Per-scenario NLP data; every tensor field is batch-leading."""

    rom: RomDynamics
    Lq: torch.Tensor        # (B, n, n) chol factor of Q (state cost)
    Lr: torch.Tensor        # (B, m, m) chol factor of R (input cost)
    Lqf: torch.Tensor       # (B, n, n) chol factor of Qf (terminal cost)
    sqrt_qw: torch.Tensor   # (B,) sqrt of tube-width cost Qw
    z0: torch.Tensor        # (B, n) initial ROM projection
    zf: torch.Tensor        # (B, n) goal
    obs_c: torch.Tensor     # (B, K, 2) obstacle centers
    obs_r: torch.Tensor     # (B, K) obstacle radii
    w_max: torch.Tensor     # (B,) tube width upper bound
    e_hist: torch.Tensor    # (B, H_rev) tracking-error history
    v_prev: torch.Tensor    # (B, H_rev, m) applied-input history
    z_ref: torch.Tensor     # (B, N+1, n) tracking reference (track_ref)
    v_ref: torch.Tensor     # (B, N, m)
    tube_params: Any = None  # MLP shared by the batch, or None

    @classmethod
    def create(cls, rom, N, H_rev, Q, R, z0, zf, obs_c, obs_r, Qw=0.0,
               Qf=None, w_max=1.0, e_hist=None, v_prev=None, z_ref=None,
               v_ref=None, tube_params=None, batch=None, device=None):
        """Build batch-leading params from numpy-like inputs.

        Each per-scenario input may be given once for the whole batch (the
        single-scenario shape) or per scenario (with a leading ``B`` axis).
        ``B`` is ``batch`` if given, else the leading axis of ``z0`` when it
        is 2-D, else 1.
        """
        dev = resolve_device(device)
        n, m = rom.n, rom.m
        if batch is None:
            batch = np.shape(z0)[0] if np.ndim(z0) == 2 else 1

        def per_scenario(x, shape):
            x = np.asarray(x, np.float32)
            if x.shape != tuple(shape):
                x = x.reshape((-1,) + tuple(shape))
            return torch.as_tensor(
                np.array(np.broadcast_to(x, (batch,) + shape)), device=dev)

        def chol(M):
            # 0.5||r||^2 must equal the reference's sum d^T Q d: scale by
            # sqrt(2), as the JAX package does.
            M = torch.as_tensor(np.asarray(M, np.float32), device=dev)
            Lc = torch.linalg.cholesky(
                M + 1e-12 * torch.eye(M.shape[-1], device=dev))
            Lc = Lc * float(np.sqrt(np.float32(2.0)))
            return Lc.expand((batch,) + Lc.shape[-2:]).contiguous()

        Qf = Q if Qf is None else Qf
        zeros = np.zeros
        return cls(
            rom=rom.to(dev),
            Lq=chol(Q), Lr=chol(R), Lqf=chol(Qf),
            sqrt_qw=per_scenario(np.sqrt(2.0 * np.asarray(Qw, np.float32)),
                                 ()),
            z0=per_scenario(z0, (n,)), zf=per_scenario(zf, (n,)),
            obs_c=per_scenario(obs_c, np.shape(obs_c)[-2:]),
            obs_r=per_scenario(obs_r, np.shape(obs_r)[-1:]),
            w_max=per_scenario(w_max, ()),
            e_hist=per_scenario(zeros(H_rev) if e_hist is None else e_hist,
                                (H_rev,)),
            v_prev=per_scenario(zeros((H_rev, m)) if v_prev is None
                                else v_prev, (H_rev, m)),
            z_ref=per_scenario(zeros((N + 1, n)) if z_ref is None else z_ref,
                               (N + 1, n)),
            v_ref=per_scenario(zeros((N, m)) if v_ref is None else v_ref,
                               (N, m)),
            tube_params=(None if tube_params is None
                         else tube_params.to(dev)),
        )

    @property
    def batch_size(self) -> int:
        return self.z0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.z0.device

    def replace(self, **kw) -> "TrajOptParams":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "TrajOptParams":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = None if v is None else v.to(device)
        return TrajOptParams(**kw)


# ---------------------------------------------------------------------------
# Warm starts
# ---------------------------------------------------------------------------

def warm_start_interpolate(start, goal, N, dt, m=None):
    """Straight line from ``start (B, n)`` to ``goal (B, n)``."""
    alpha = torch.linspace(0.0, 1.0, N + 1, device=start.device)[:, None]
    z_init = start[:, None, :] + alpha * (goal - start)[:, None, :]
    v_init = torch.diff(z_init, dim=1) / dt
    if m is not None and m != z_init.shape[-1]:
        # State-difference inputs only make sense when the input drives
        # every state dim (SingleInt2D); otherwise start from zeros.
        v_init = torch.zeros(z_init.shape[0], N, m, device=start.device)
    return z_init, v_init


def warm_start_constant(point, N, m):
    B = point.shape[0]
    return (point[:, None, :].expand(B, N + 1, point.shape[-1]).clone(),
            torch.zeros(B, N, m, device=point.device))


def get_warm_start(kind: str, p: TrajOptParams, N: int,
                   cfg: ALConfig = ALConfig()):
    """'start' | 'goal' | 'interpolate'. The generic-solver 'nominal' warm
    start is not ported (``fast_tube.solve_tube_fast`` has its own)."""
    m = p.rom.m
    if kind == "start":
        return warm_start_constant(p.z0, N, m)
    if kind == "goal":
        return warm_start_constant(p.zf, N, m)
    if kind == "interpolate":
        return warm_start_interpolate(p.z0, p.zf, N, p.rom.dt, m=m)
    if kind == "nominal":
        raise NotImplementedError(
            "the generic-solver 'nominal' warm start is not ported")
    raise ValueError(f"Warm start '{kind}' not implemented")


def get_tube_warm_start(tube_ws, tube_fn, z_init, v_init, p: TrajOptParams,
                        N: int):
    """'evaluate' | scalar."""
    B = z_init.shape[0]
    if isinstance(tube_ws, str) and tube_ws == "evaluate":
        fw = tube_fn(z_init, v_init, torch.zeros(B, N + 1, device=p.device),
                     p.e_hist, p.v_prev, p.tube_params)
        return torch.cat([torch.zeros(B, 1, device=p.device), fw], dim=1)
    return torch.ones(B, N + 1, device=p.device) * float(tube_ws)


class TrajOptSolution(NamedTuple):
    z: torch.Tensor             # (B, N+1, n)
    v: torch.Tensor             # (B, N, m)
    w: Optional[torch.Tensor]   # (B, N+1)
    sol: ALSolution
