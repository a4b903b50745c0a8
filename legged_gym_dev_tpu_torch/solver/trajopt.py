"""Tube trajectory-optimization problem assembly and solve entry points,
batch-leading.

Counterpart of ``legged_gym_dev_tpu/solver/trajopt.py``: ``PROBLEM_DICT``,
``TrajOptParams``, packing and bounds, the NLP functions
(``build_nlp_fns``), the warm starts and the generic dense solves
(``solve_nominal``, ``solve_tube``, ``solve_tube_batched``) on
``al_solver.solve_al``.

Decision vector layout (one row per scenario):
    x = [ z.flatten()   ((N+1)*n, row-major)
          v.flatten()   (N*m)
          w             (N+1, only tube problems) ]

Where the JAX package vmaps over a pytree of per-scenario leaves, here every
per-scenario field carries a leading batch axis ``B``. The ROM (``rom``) and
the tube network (``tube_params``, an ``MLP``) come in two forms: shared by
the whole batch (a float ``dt``, ``(n,)`` bounds, one network; the fast
path), or per scenario, as the JAX package's vmapped pytree holds them (a
``(B,)`` ``dt`` and/or ``(B, n)`` bounds, ``(B, in, out)`` weights; see
``core.rom`` and ``tube.models``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.rom import RomDynamics
from ..utils.runtime import resolve_device
from .al_solver import ALConfig, ALSolution, solve_al

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
    tube_params: Any = None  # MLP, shared or per scenario, or None

    @classmethod
    def create(cls, rom, N, H_rev, Q, R, z0, zf, obs_c, obs_r, Qw=0.0,
               Qf=None, w_max=1.0, e_hist=None, v_prev=None, z_ref=None,
               v_ref=None, tube_params=None, batch=None, device=None):
        """Build batch-leading params from numpy-like inputs.

        Each per-scenario input may be given once for the whole batch (the
        single-scenario shape) or per scenario (with a leading ``B`` axis).
        ``B`` is ``batch`` if given, else the leading axis of ``z0`` when it
        is 2-D, else the scenario count of a per-scenario ROM or tube
        network, else 1. A per-scenario ROM or network must have ``B``
        scenarios.
        """
        dev = resolve_device(device)
        n, m = rom.n, rom.m
        sizes = {x.batch_size for x in (rom, tube_params)
                 if x is not None and x.batch_size is not None}
        if batch is None:
            batch = (np.shape(z0)[0] if np.ndim(z0) == 2
                     else (sizes.pop() if len(sizes) == 1 else 1))
        if sizes - {batch}:
            raise ValueError(f"per-scenario ROM or tube network of "
                             f"{sorted(sizes)} scenarios for a batch of "
                             f"{batch}")

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
# Packing and bounds
# ---------------------------------------------------------------------------

def pack_x(z, v, w=None):
    """(B, N+1, n), (B, N, m)[, (B, N+1)] -> x (B, D)."""
    B = z.shape[0]
    parts = [z.reshape(B, -1), v.reshape(B, -1)]
    if w is not None:
        parts.append(w.reshape(B, -1))
    return torch.cat(parts, dim=-1)


def unpack_x(x, N, n, m, with_w):
    """x (B, D) -> z (B, N+1, n), v (B, N, m), w (B, N+1) or None."""
    B = x.shape[0]
    nz, nv = (N + 1) * n, N * m
    z = x[:, :nz].reshape(B, N + 1, n)
    v = x[:, nz:nz + nv].reshape(B, N, m)
    w = x[:, nz + nv:] if with_w else None
    return z, v, w


def make_bounds(p: TrajOptParams, N: int, with_w: bool):
    """Box bounds (B, D) from the ROM's state and input limits (shared or
    per scenario) and the tube-width cap."""
    B, rom = p.batch_size, p.rom

    def rows(zb, vb):
        if zb.ndim == vb.ndim == 1:
            return torch.cat([zb.repeat(N + 1), vb.repeat(N)]).expand(B, -1)
        return torch.cat([zb.expand(B, -1).repeat(1, N + 1),
                          vb.expand(B, -1).repeat(1, N)], dim=-1)

    lb = rows(rom.z_min, rom.v_min)
    ub = rows(rom.z_max, rom.v_max)
    if with_w:
        lb = torch.cat([lb, torch.zeros(B, N + 1, device=p.device)], dim=-1)
        ub = torch.cat([ub, p.w_max[:, None].expand(B, N + 1)], dim=-1)
    return lb, ub


# ---------------------------------------------------------------------------
# NLP functions
# ---------------------------------------------------------------------------

def build_nlp_fns(n: int, m: int, N: int, with_tube: bool,
                  tube_fn: Optional[Callable] = None, track_ref: bool = False):
    """Batch-leading (r_fn, h_fn, g_fn) of the (tube) trajopt NLP.

    Objective: quadratic state/input cost toward the goal (or the
    reference, ``track_ref``) plus Qw w^2. Equalities: dynamics, the
    initial condition's position dims and the tube-width dynamics.
    Inequalities: tube-inflated circular obstacle avoidance.
    """

    def r_fn(x, p: TrajOptParams):
        B = x.shape[0]
        z, v, w = unpack_x(x, N, n, m, with_tube)
        if track_ref:
            z_goal, v_goal = p.z_ref, p.v_ref
        else:
            z_goal = p.zf[:, None, :].expand(B, N + 1, n)
            v_goal = torch.zeros_like(v)
        r_state = (z[:, :-1] - z_goal[:, :-1]) @ p.Lq
        r_term = ((z[:, -1:] - z_goal[:, -1:]) @ p.Lqf)[:, 0]
        r_input = (v - v_goal) @ p.Lr
        parts = [r_state.reshape(B, -1), r_term, r_input.reshape(B, -1)]
        if with_tube:
            parts.append(p.sqrt_qw[:, None] * w)
        return torch.cat(parts, dim=-1)

    def h_fn(x, p: TrajOptParams):
        B = x.shape[0]
        z, v, w = unpack_x(x, N, n, m, with_tube)
        h_dyn = (p.rom.f(z[:, :-1], v) - z[:, 1:]).reshape(B, -1)
        h_ic = z[:, 0, :2] - p.z0[:, :2]
        parts = [h_dyn, h_ic]
        if with_tube:
            fw = tube_fn(z, v, w, p.e_hist, p.v_prev, p.tube_params)
            parts.append(fw - w[:, 1:])
        return torch.cat(parts, dim=-1)

    def g_fn(x, p: TrajOptParams):
        B = x.shape[0]
        z, v, w = unpack_x(x, N, n, m, with_tube)
        d = z[:, :, None, :2] - p.obs_c[:, None, :, :]     # (B, N+1, K, 2)
        dist_sq = torch.sum(d * d, dim=-1)                 # (B, N+1, K)
        radius = p.obs_r[:, None, :]
        if with_tube:
            radius = radius + w[:, :, None]
        return (dist_sq - radius * radius).reshape(B, -1)

    return r_fn, h_fn, g_fn


# ---------------------------------------------------------------------------
# Warm starts
# ---------------------------------------------------------------------------

def warm_start_interpolate(start, goal, N, dt, m=None):
    """Straight line from ``start (B, n)`` to ``goal (B, n)``; ``dt`` a
    float or ``(B,)``."""
    alpha = torch.linspace(0.0, 1.0, N + 1, device=start.device)[:, None]
    z_init = start[:, None, :] + alpha * (goal - start)[:, None, :]
    if isinstance(dt, torch.Tensor):
        dt = dt.reshape(-1, 1, 1)
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
                   cfg: ALConfig = ALConfig(),
                   nominal_ws: str = "interpolate"):
    """'start' | 'goal' | 'interpolate' | 'nominal' (the generic nominal
    solve from ``nominal_ws``, on ``p``'s device)."""
    m = p.rom.m
    if kind == "start":
        return warm_start_constant(p.z0, N, m)
    if kind == "goal":
        return warm_start_constant(p.zf, N, m)
    if kind == "interpolate":
        return warm_start_interpolate(p.z0, p.zf, N, p.rom.dt, m=m)
    if kind == "nominal":
        z, v, _ = solve_nominal(p, N, cfg=cfg, warm_start=nominal_ws,
                                device=p.device)
        return z, v
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


# ---------------------------------------------------------------------------
# Generic (dense) solves
# ---------------------------------------------------------------------------

def solve_nominal(p: TrajOptParams, N: int, cfg: ALConfig = ALConfig(),
                  warm_start: str = "interpolate", x_init=None,
                  device=None) -> tuple:
    """Nominal (no-tube) trajectory optimization of the batch on
    ``device`` (None = the CUDA card). Returns (z, v, ALSolution)."""
    p = p.to(resolve_device(device))
    n, m = p.rom.n, p.rom.m
    r_fn, h_fn, g_fn = build_nlp_fns(n, m, N, with_tube=False)
    if x_init is None:
        z_init, v_init = get_warm_start(warm_start, p, N, cfg)
        x_init = pack_x(z_init, v_init)
    lb, ub = make_bounds(p, N, with_w=False)
    sol = solve_al(r_fn, h_fn, g_fn, x_init, p, lb, ub, cfg,
                   device=p.device)
    z, v, _ = unpack_x(sol.x, N, n, m, False)
    return z, v, sol


def solve_tube(p: TrajOptParams, tube_fn: Callable, N: int, H_rev: int,
               cfg: ALConfig = ALConfig(), warm_start: str = "start",
               nominal_ws: str = "interpolate", tube_ws="evaluate",
               track_warm: bool = False, x_init=None, lam0=None, mu0=None,
               return_trace: bool = False, device=None):
    """Tube trajectory optimization of the batch on ``device`` (None = the
    CUDA card). Returns a TrajOptSolution (plus the per-outer trace dict
    with ``return_trace``, see ``debug.trace_to_csv``).

    ``track_warm`` makes the objective track the warm-start trajectory
    instead of the goal point.
    """
    p = p.to(resolve_device(device))
    n, m = p.rom.n, p.rom.m
    if x_init is None:
        z_init, v_init = get_warm_start(warm_start, p, N, cfg,
                                        nominal_ws=nominal_ws)
        w_init = get_tube_warm_start(tube_ws, tube_fn, z_init, v_init, p, N)
        x_init = pack_x(z_init, v_init, w_init)
        if track_warm:
            p = p.replace(z_ref=z_init, v_ref=v_init)
    r_fn, h_fn, g_fn = build_nlp_fns(n, m, N, with_tube=True,
                                     tube_fn=tube_fn, track_ref=track_warm)
    lb, ub = make_bounds(p, N, with_w=True)
    out = solve_al(r_fn, h_fn, g_fn, x_init, p, lb, ub, cfg, lam0=lam0,
                   mu0=mu0, return_trace=return_trace, device=p.device)
    sol, trace = out if return_trace else (out, None)
    z, v, w = unpack_x(sol.x, N, n, m, True)
    res = TrajOptSolution(z=z, v=v, w=w, sol=sol)
    return (res, trace) if return_trace else res


def solve_tube_batched(p_batch: TrajOptParams, tube_fn, N, H_rev,
                       cfg: ALConfig = ALConfig(), device=None,
                       **kw) -> TrajOptSolution:
    """The JAX package's vmap over the scenario batch; here ``solve_tube``
    takes the batch already."""
    return solve_tube(p_batch, tube_fn, N, H_rev, cfg, device=device, **kw)
