"""Structured (stage-wise) tube-MPC solve and closed loop, batch-major.

Counterpart of ``legged_gym_dev_tpu/solver/fast_tube.py``: the staged
problem description, the stage-form residuals, packing and bounds, the
tube solve (``solve_tube_fast``, whose JAX twin is single-scenario and
vmapped; here it takes the batch) and the receding-horizon closed loop.
The variables of stage k are ``u_k = [z_k, w_k, v_k]``; a staged iterate is
``(B, N+1, b)``. The array-form reference solver
(``solve_tube_fast_single_array``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.runtime import fp32_matmul, resolve_device
from .al_solver import ALConfig
from .staged_scalar import solve_staged_scalar
from .trajopt import (
    TrajOptParams,
    TrajOptSolution,
    get_tube_warm_start,
    get_warm_start,
)
from .tube_dynamics import _abs, get_tube_dynamics


class StagedProblem(NamedTuple):
    """Static description of the staged NLP."""

    n: int
    m: int
    N: int
    K: int            # obstacles
    tube_kind: str    # 'l1' | 'l2' | 'nn'
    scaling: float
    track_ref: bool


# ---------------------------------------------------------------------------
# Stage-form residuals
# ---------------------------------------------------------------------------

def _split(u, sp: StagedProblem):
    """(B, S, b) -> z (B, N+1, n), w (B, N+1), v (B, N, m)."""
    n = sp.n
    return u[:, :, :n], u[:, :, n], u[:, :-1, n + 1:]


def _tube_fw(sp: StagedProblem, z, v, p: TrajOptParams):
    if sp.tube_kind == "l1":
        return sp.scaling * torch.sum(_abs(v), dim=-1)
    if sp.tube_kind == "l2":
        return sp.scaling * torch.sum(v * v, dim=-1)
    B = z.shape[0]
    v_total = torch.cat([p.v_prev, v], dim=1)
    x_in = torch.cat([p.e_hist.reshape(B, -1), z[:, 0, 2:],
                      v_total.transpose(1, 2).reshape(B, -1)], dim=-1)
    return p.tube_params(x_in)


def _residuals(sp: StagedProblem, u, p: TrajOptParams):
    """(r, h, g), each (B, .), in the layout of the JAX package."""
    n, m, N = sp.n, sp.m, sp.N
    B = u.shape[0]
    z, w, v = _split(u, sp)
    if sp.track_ref:
        z_goal, v_goal = p.z_ref, p.v_ref
    else:
        z_goal = p.zf[:, None, :].expand(B, N + 1, n)
        v_goal = torch.zeros_like(v)
    r = torch.cat([
        ((z[:, :-1] - z_goal[:, :-1]) @ p.Lq).reshape(B, -1),
        ((z[:, -1:] - z_goal[:, -1:]) @ p.Lqf).reshape(B, -1),
        ((v - v_goal) @ p.Lr).reshape(B, -1),
        p.sqrt_qw[:, None] * w,
    ], dim=-1)
    h_dyn = (p.rom.f(z[:, :-1], v) - z[:, 1:]).reshape(B, -1)
    h_ic = z[:, 0, :2] - p.z0[:, :2]
    h_tube = _tube_fw(sp, z, v, p) - w[:, 1:]
    h = torch.cat([h_dyn, h_ic, h_tube], dim=-1)
    d = z[:, :, None, :2] - p.obs_c[:, None, :, :]
    g = (torch.sum(d * d, dim=-1)
         - (p.obs_r[:, None, :] + w[:, :, None]) ** 2).reshape(B, -1)
    return r, h, g


# ---------------------------------------------------------------------------
# Packing, bounds, solve
# ---------------------------------------------------------------------------

def pack_staged(z, w, v, n, m, N):
    B = z.shape[0]
    u = torch.zeros(B, N + 1, n + 1 + m, dtype=z.dtype, device=z.device)
    u[:, :, :n] = z
    u[:, :, n] = w
    u[:, :-1, n + 1:] = v
    return u


def unpack_staged(u, n, m, N):
    return u[:, :, :n], u[:, :, n], u[:, :-1, n + 1:]


def staged_bounds(p: TrajOptParams, n, m, N):
    """Box bounds (B, N+1, b); stage N's padded v slot is pinned to 0."""
    B = p.batch_size
    b = n + 1 + m
    lb = torch.zeros(B, N + 1, b, device=p.device)
    ub = torch.zeros(B, N + 1, b, device=p.device)
    lb[:, :, :n] = p.rom.z_min
    ub[:, :, :n] = p.rom.z_max
    ub[:, :, n] = p.w_max[:, None]
    lb[:, :-1, n + 1:] = p.rom.v_min
    ub[:, :-1, n + 1:] = p.rom.v_max
    return lb, ub


def _staged_problem(p, N, tube_kind, scaling, track_ref):
    return StagedProblem(n=p.rom.n, m=p.rom.m, N=N, K=p.obs_r.shape[-1],
                         tube_kind=("nn" if tube_kind == "NN_oneshot"
                                    else tube_kind),
                         scaling=scaling, track_ref=track_ref)


def solve_tube_fast(p: TrajOptParams, N: int, H_rev: int,
                    tube_kind: str = "l1", scaling: float = 0.5,
                    cfg: ALConfig = ALConfig(),
                    warm_start: str = "interpolate", tube_ws="evaluate",
                    track_warm: bool = False, z_init=None, v_init=None):
    """Structured tube solve of the batch in ``p`` on ``p``'s device."""
    n, m = p.rom.n, p.rom.m
    sp = _staged_problem(p, N, tube_kind, scaling, track_warm)
    if z_init is None:
        if warm_start == "nominal":
            # The staged l1 path with zero tube scaling is the no-tube
            # problem (w stays at its 0 warm start, Qw=0 leaves it free).
            nom = solve_tube_fast(p, N, H_rev, tube_kind="l1", scaling=0.0,
                                  cfg=cfg, warm_start="interpolate",
                                  tube_ws=0.0)
            z_init, v_init = nom.z, nom.v
        else:
            z_init, v_init = get_warm_start(warm_start, p, N, cfg)
    tube_fn = get_tube_dynamics(
        "NN_oneshot" if sp.tube_kind == "nn" else sp.tube_kind, N, scaling)
    with fp32_matmul():
        w_init = get_tube_warm_start(tube_ws, tube_fn, z_init, v_init, p, N)
    if track_warm:
        p = p.replace(z_ref=z_init, v_ref=v_init)
    u0 = pack_staged(z_init, w_init, v_init, n, m, N)
    lb_u, ub_u = staged_bounds(p, n, m, N)
    sol = solve_staged_scalar(sp, p, u0, lb_u, ub_u, cfg)
    z, w, v = unpack_staged(sol.x.reshape(p.batch_size, N + 1, -1), n, m, N)
    return TrajOptSolution(z=z, v=v, w=w, sol=sol)


def solve_tube_fast_batched(p_batch: TrajOptParams, N, H_rev,
                            tube_kind="l1", scaling=0.5,
                            cfg: ALConfig = ALConfig(), device=None, **kw):
    """Entry point: the batched tube solve on ``device`` (None = the CUDA
    card; raises without one)."""
    p_batch = p_batch.to(resolve_device(device))
    return solve_tube_fast(p_batch, N, H_rev, tube_kind=tube_kind,
                           scaling=scaling, cfg=cfg, **kw)


# ---------------------------------------------------------------------------
# Closed-loop receding horizon on the structured solver
# ---------------------------------------------------------------------------

def closed_loop_tube_mpc_fast(
    p: TrajOptParams,
    robot,
    tube_kind: str = "l1",
    scaling: float = 0.5,
    H: int = 75,
    N: int = 50,
    H_rev: int = 10,
    Kp: float = 10.0,
    Kd: float = 10.0,
    cfg_first: ALConfig = ALConfig(),
    cfg_loop: ALConfig = ALConfig(outer_iters=5, inner_iters=6),
    warm_start: str = "interpolate",
    tube_ws="evaluate",
    exec_tol: float = 1e-3,
    device=None,
):
    """Receding-horizon tube MPC of the whole batch: every tick re-solves
    every scenario, warm-started from its last solution and multipliers.

    Execution gate: a re-solve violating constraints by more than
    ``exec_tol`` is not executed; the loop keeps following the last
    feasible plan, advanced one stage per tick (``adopted`` False).
    Returns (z, v, w, pz_x, viol, adopted) traces, batch-leading:
    (B, H+1, n), (B, H, m), (B, H+1), (B, H+1, .), (B, H), (B, H).
    """
    dev = resolve_device(device)
    p = p.to(dev)
    robot = robot.to(dev)
    n, m = p.rom.n, p.rom.m
    B = p.batch_size
    S = N + 1
    sp = _staged_problem(p, N, tube_kind, scaling, False)
    out0 = solve_tube_fast(p, N, H_rev, tube_kind=tube_kind, scaling=scaling,
                           cfg=cfg_first, warm_start=warm_start,
                           tube_ws=tube_ws)
    lb_u, ub_u = staged_bounds(p, n, m, N)
    x0 = torch.cat([p.z0[:, :2], torch.zeros(B, 2, device=dev)], dim=-1)
    rows = torch.arange(B, device=dev)

    sol = out0.sol
    u_exec = sol.x.reshape(B, S, -1)
    # age starts at -1 so an infeasible first solve still executes its
    # stage-0 input (no older plan exists to fall back to).
    age = torch.full((B,), -1, dtype=torch.int64, device=dev)
    z_cur, x_cur, e_hist, v_prev, p_cur = p.z0, x0, p.e_hist, p.v_prev, p
    trace = {k: [] for k in ("z", "v", "w", "pzx", "viol", "adopt")}
    with fp32_matmul():
        for _ in range(H):
            u = sol.x.reshape(B, S, -1)
            adopt = sol.viol < exec_tol
            u_exec = torch.where(adopt[:, None, None], u, u_exec)
            age = torch.where(adopt, torch.zeros_like(age),
                              torch.clamp_max(age + 1, N - 1))
            z_sol, w_sol, v_sol = unpack_staged(u_exec, n, m, N)
            nxt = torch.clamp_max(age + 1, N - 1)
            z_tgt = z_sol[rows, age]
            v_tgt = v_sol[rows, nxt]

            u_pd = robot.clip_v_z(x_cur, Kp * (z_tgt - x_cur[:, :2])
                                  + Kd * (v_tgt - x_cur[:, 2:]))
            x_next = robot.f(x_cur, u_pd)
            pz_x_next = robot.proj_z(x_next)

            v_apply = v_sol[rows, age]
            z_next = p_cur.rom.f(z_cur, v_apply)

            pz_x_cur = robot.proj_z(x_cur)
            e_new = torch.linalg.vector_norm(z_cur - pz_x_cur, dim=-1)
            e_hist = torch.cat([e_hist[:, 1:], e_new[:, None]], dim=1)
            v_prev = torch.cat([v_prev[:, 1:], v_apply[:, None]], dim=1)

            p_cur = p_cur.replace(z0=z_next, e_hist=e_hist, v_prev=v_prev)
            sol_new = solve_staged_scalar(
                sp, p_cur, u, lb_u, ub_u, cfg_loop,
                lam0=sol.lam, mu0=sol.mu, rho_init=sol.rho)
            trace["z"].append(z_next)
            trace["v"].append(v_apply)
            trace["w"].append(w_sol[rows, torch.clamp_max(age + 1, N)])
            trace["pzx"].append(pz_x_next)
            trace["viol"].append(sol_new.viol)
            trace["adopt"].append(adopt)
            sol, z_cur, x_cur = sol_new, z_next, x_next
    st = {k: torch.stack(v, dim=1) for k, v in trace.items()}
    return (
        torch.cat([p.z0[:, None], st["z"]], dim=1),
        st["v"],
        torch.cat([torch.zeros(B, 1, device=dev), st["w"]], dim=1),
        torch.cat([robot.proj_z(x0)[:, None], st["pzx"]], dim=1),
        st["viol"],
        st["adopt"],
    )
