"""Closed-loop receding-horizon tube MPC on the generic dense solver,
batch-leading.

Counterpart of ``legged_gym_dev_tpu/solver/mpc.py``: each tick the plan's
current input advances the ROM, a double-integrator robot PD-tracks the
plan, the error and input histories roll, and the NLP is re-solved warm
from the previous primal and dual solution and penalty. The JAX package
scans one scenario and vmaps the batch; here a Python loop of ``H`` ticks
acts on the whole batch (no host sync inside it), and every trace carries
a leading batch axis.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple

import torch

from ..core.rom import DoubleInt2D
from ..utils.runtime import fp32_matmul, resolve_device
from .al_solver import ALConfig, solve_al
from .trajopt import (
    TrajOptParams,
    build_nlp_fns,
    make_bounds,
    solve_tube,
    unpack_x,
)


@dataclass(frozen=True)
class MPCConfig:
    """Static closed-loop configuration."""

    H: int = 75
    N: int = 50
    H_rev: int = 10
    Kp: float = 10.0
    Kd: float = 10.0

    def replace(self, **kw) -> "MPCConfig":
        return replace(self, **kw)


class MPCTrace(NamedTuple):
    z: torch.Tensor        # (B, H+1, n) planned ROM trajectory executed
    v: torch.Tensor        # (B, H, m) applied ROM inputs
    w: torch.Tensor        # (B, H+1) tube widths along the executed path
    x: torch.Tensor        # (B, H+1, nx) tracked robot states
    u: torch.Tensor        # (B, H, mx) robot inputs
    pz_x: torch.Tensor     # (B, H+1, n) robot state projections
    z_sol: torch.Tensor    # (B, H, N+1, n) per-tick plans
    v_sol: torch.Tensor    # (B, H, N, m)
    w_sol: torch.Tensor    # (B, H, N+1)
    viol: torch.Tensor     # (B, H) solver violation per re-solve
    converged: torch.Tensor  # (B, H) solver convergence per re-solve
    adopted: torch.Tensor  # (B, H) bool: the plan executed this tick was
    #                        fresh (False: the re-solve violated the
    #                        constraints and the last feasible plan ran)


def closed_loop_tube_mpc(
    p: TrajOptParams,
    tube_fn: Callable,
    robot: DoubleInt2D,
    mpc: MPCConfig = MPCConfig(),
    al_first: ALConfig = ALConfig(outer_iters=15),
    al_loop: ALConfig = ALConfig(outer_iters=4, inner_iters=6),
    warm_start: str = "nominal",
    tube_ws="evaluate",
    exec_tol: float = 1e-3,
    device=None,
) -> MPCTrace:
    """H receding-horizon re-solves of the batch on ``device`` (None = the
    CUDA card) with a PD-tracked double integrator.

    ``al_loop`` runs fewer iterations than the first solve: every re-solve
    is warm-started from the previous primal and dual solution.

    Execution gate: a re-solve whose violation exceeds ``exec_tol`` is not
    executed; the loop keeps following the last feasible plan, advanced
    one stage per tick. If the first solve is infeasible there is no older
    plan and it executes regardless.
    """
    dev = resolve_device(device)
    p = p.to(dev)
    robot = robot.to(dev)
    N, H_rev = mpc.N, mpc.H_rev
    n, m = p.rom.n, p.rom.m
    B = p.batch_size

    out0 = solve_tube(p, tube_fn, N, H_rev, al_first, warm_start=warm_start,
                      tube_ws=tube_ws, device=dev)
    r_fn, h_fn, g_fn = build_nlp_fns(n, m, N, with_tube=True,
                                     tube_fn=tube_fn)
    lb, ub = make_bounds(p, N, with_w=True)

    x0 = torch.cat([p.z0[:, :2], torch.zeros(B, 2, device=dev)], dim=-1)
    rows = torch.arange(B, device=dev)
    sol = out0.sol
    x_exec = sol.x
    # age starts at -1 so an infeasible first solve still executes its
    # stage-0 input (there is no older plan to fall back to).
    age = torch.full((B,), -1, dtype=torch.int64, device=dev)
    z_cur, x_cur, e_hist, v_prev, p_cur = p.z0, x0, p.e_hist, p.v_prev, p
    keys = ("z", "v", "w", "x", "u", "pz_x", "z_sol", "v_sol", "w_sol",
            "viol", "converged", "adopted")
    tr = {k: [] for k in keys}
    with fp32_matmul():
        for _ in range(mpc.H):
            # Adopt the fresh plan only if it satisfies the constraints;
            # otherwise advance along the last feasible plan.
            adopt = sol.viol < exec_tol
            x_exec = torch.where(adopt[:, None], sol.x, x_exec)
            age = torch.where(adopt, torch.zeros_like(age),
                              torch.clamp_max(age + 1, N - 1))
            z_sol, v_sol, w_sol = unpack_x(x_exec, N, n, m, True)
            z_tgt = z_sol[rows, age]
            v_tgt = v_sol[rows, torch.clamp_max(age + 1, N - 1)]

            # PD-track the plan with the double integrator.
            u = robot.clip_v_z(x_cur, mpc.Kp * (z_tgt - x_cur[:, :2])
                               + mpc.Kd * (v_tgt - x_cur[:, 2:]))
            x_next = robot.f(x_cur, u)
            pz_x_next = robot.proj_z(x_next)

            # Execute the plan's current input on the ROM.
            v_apply = v_sol[rows, age]
            z_next = p_cur.rom.f(z_cur, v_apply)

            # Roll the histories.
            e_new = torch.linalg.vector_norm(z_cur - robot.proj_z(x_cur),
                                             dim=-1)
            e_hist = torch.cat([e_hist[:, 1:], e_new[:, None]], dim=1)
            v_prev = torch.cat([v_prev[:, 1:], v_apply[:, None]], dim=1)

            # Re-solve warm from the previous primal, duals and penalty.
            p_cur = p_cur.replace(z0=z_next, e_hist=e_hist, v_prev=v_prev)
            sol_new = solve_al(r_fn, h_fn, g_fn, sol.x, p_cur, lb, ub,
                               al_loop, lam0=sol.lam, mu0=sol.mu,
                               rho_init=sol.rho, device=dev)
            for k, val in zip(keys, (
                    z_next, v_apply, w_sol[rows, torch.clamp_max(age + 1, N)],
                    x_next, u, pz_x_next, z_sol, v_sol, w_sol, sol_new.viol,
                    sol_new.converged, adopt)):
                tr[k].append(val)
            sol, z_cur, x_cur = sol_new, z_next, x_next

    st = {k: torch.stack(v, dim=1) for k, v in tr.items()}
    return MPCTrace(
        z=torch.cat([p.z0[:, None], st["z"]], dim=1),
        v=st["v"],
        w=torch.cat([torch.zeros(B, 1, device=dev), st["w"]], dim=1),
        x=torch.cat([x0[:, None], st["x"]], dim=1),
        u=st["u"],
        pz_x=torch.cat([robot.proj_z(x0)[:, None], st["pz_x"]], dim=1),
        z_sol=st["z_sol"], v_sol=st["v_sol"], w_sol=st["w_sol"],
        viol=st["viol"], converged=st["converged"], adopted=st["adopted"],
    )


def closed_loop_tube_mpc_batched(p_batch, tube_fn, robot,
                                 mpc: MPCConfig = MPCConfig(),
                                 **kw) -> MPCTrace:
    """The JAX package's vmap over scenarios; here
    ``closed_loop_tube_mpc`` takes the batch already."""
    return closed_loop_tube_mpc(p_batch, tube_fn, robot, mpc, **kw)
