"""Batched augmented-Lagrangian Gauss-Newton NLP solver, dense.

Counterpart of ``legged_gym_dev_tpu/solver/al_solver.py``: ``ALConfig``
(every field and default unchanged), ``ALSolution`` and the generic dense
solver ``solve_al`` / ``solve_al_batched``. The staged solver
(``staged_scalar.py``) shares the config and the result.

The NLP comes as batch-leading functions of the decision vectors
``x (B, D)`` and the scenario data ``p``: a least-squares residual ``r``
(cost 0.5 ||r||^2), equalities ``h(x, p) = 0``, inequalities
``g(x, p) >= 0`` and box bounds. Scenarios are independent, so each
function's rows are its scenarios'. Where the JAX package vmaps one
scenario's solve, here every step acts on the whole batch:

- Jacobians by forward mode: ``torch.func.jvp`` over the D unit tangents
  at once (``vmap``), as ``jax.jacfwd``; each scenario's rows depend on
  its own x only, so one tangent per coordinate gives every scenario's
  Jacobian, (B, rows, D);
- the projected Gauss-Newton step on the AL merit with Jacobi scaling, a
  dense Cholesky (``torch.linalg.cholesky_ex``) and one refinement pass;
  the JAX package computes it with ``cho_factor`` / ``cho_solve`` outside
  any Pallas kernel. A factorization that fails (``info != 0``, where
  JAX's gives NaNs and the NaN step fails its line search) fails the line
  search here too: x stays;
- a 10-step Armijo line search, fixed trip counts, per-scenario
  convergence frozen by ``torch.where``: no early exit, no host sync.

Runs in full fp32 (TF32 off), as the JAX solver at
``default_matmul_precision("highest")``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from ..utils.runtime import fp32_matmul, resolve_device


@dataclass(frozen=True)
class ALConfig:
    """Static solver configuration."""

    outer_iters: int = 20
    inner_iters: int = 10
    ls_iters: int = 10
    rho0: float = 100.0
    rho_growth: float = 5.0
    rho_max: float = 3e4
    viol_reduction: float = 0.5
    tol_feas: float = 1e-5
    tol_grad: float = 1e-3
    reg: float = 1e-7
    ls_backtrack: float = 0.5
    armijo: float = 1e-4
    # Pure quadratic-penalty mode: multipliers stay at their initial values
    # (the restoration phase).
    penalty_only: bool = False
    # Stage-structured linear solve (staged_scalar.py):
    # "pallas" = the port's hand-written CUDA kernels
    #   (ops/block_tridiag_kernels.py: one single-RHS solve per inner step,
    #   the factor-once multi-RHS solve for the NN Woodbury basis); on CPU
    #   tensors their plain PyTorch versions;
    # "thomas" = the entry-form block-Thomas in plain PyTorch;
    # "cr" = block cyclic reduction in plain PyTorch (single-RHS solves;
    #   the NN tube's multi-RHS solves take "thomas", as in JAX);
    # "auto" = "thomas" below 128 stages, "cr" from there.
    linsolve: str = "auto"
    # NN-oneshot Woodbury basis refresh: "inner" (exact, every inner step),
    # "outer" (once per outer), or an int k >= 1 (every k inner steps).
    nn_basis_refresh: object = "inner"

    def replace(self, **kw) -> "ALConfig":
        return replace(self, **kw)


class ALSolution(NamedTuple):
    """Batch-leading solver result: one row per scenario."""

    x: torch.Tensor            # (B, D) solution (staged: (B, S*b))
    lam: torch.Tensor          # (B, E) equality multipliers
    mu: torch.Tensor           # (B, I) inequality multipliers (>= 0)
    viol: torch.Tensor         # (B,) max constraint violation
    grad_norm: torch.Tensor    # (B,) projected-gradient inf-norm at x
    obj: torch.Tensor          # (B,) objective value
    rho: torch.Tensor          # (B,) final penalty
    converged: torch.Tensor    # (B,) bool
    outer_used: torch.Tensor   # (B,) outer iterations until convergence


def jacobian(fn: Callable, x: torch.Tensor, p) -> torch.Tensor:
    """Per-scenario Jacobians (B, rows, D) of the batch-leading ``fn(x, p)``
    by forward mode over the D unit tangents."""
    B, D = x.shape
    tangents = torch.eye(D, dtype=x.dtype, device=x.device)[:, None, :]
    cols = vmap(lambda t: jvp(lambda xx: fn(xx, p), (x,),
                              (t.expand(B, D),))[1])(tangents)
    return cols.permute(1, 2, 0)                        # (B, rows, D)


def _mv(J: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """J^T y per scenario: (B, rows, D), (B, rows) -> (B, D)."""
    return (y[:, None, :] @ J)[:, 0]


def _merit_terms(r_fn, h_fn, g_fn, x, p, lam, mu, rho):
    """PHR merit (B,) and the residuals; rho is (B, 1)."""
    r, h, g = r_fn(x, p), h_fn(x, p), g_fn(x, p)
    act = torch.clamp_min(mu - rho * g, 0.0)
    merit = (0.5 * torch.sum(r * r, dim=-1) + torch.sum(lam * h, dim=-1)
             + 0.5 * rho[:, 0] * torch.sum(h * h, dim=-1)
             + (0.5 / rho[:, 0]) * torch.sum(act * act - mu * mu, dim=-1))
    return merit, r, h, g, act


def solve_al(r_fn: Callable, h_fn: Callable, g_fn: Callable,
             x0: torch.Tensor, p, lb: torch.Tensor, ub: torch.Tensor,
             cfg: ALConfig = ALConfig(), lam0: Optional[torch.Tensor] = None,
             mu0: Optional[torch.Tensor] = None, rho_init=None,
             return_trace: bool = False, device=None) -> ALSolution:
    """Solve a batch of NLPs on ``device`` (None = the CUDA card; raises
    without one):

        min_x 0.5||r(x,p)||^2  s.t.  h(x,p)=0,  g(x,p)>=0,  lb<=x<=ub.

    x0 (B, D); lb, ub broadcastable to it; ``p`` an object with a ``to``
    method (``TrajOptParams``) or None; lam0 (B, E), mu0 (B, I) and
    rho_init ((B,) or a float) warm-start the multipliers and the penalty.
    With ``return_trace=True`` also returns the per-outer-iteration stats
    (viol / grad_norm / rho / obj / converged), each (B, outer_iters).
    """
    dev = resolve_device(device)
    x0 = x0.to(dev)
    p = p.to(dev) if p is not None else None
    lb = lb.to(dev).expand_as(x0)
    ub = ub.to(dev).expand_as(x0)
    with fp32_matmul():
        return _solve_al_impl(r_fn, h_fn, g_fn, x0, p, lb, ub, cfg,
                              None if lam0 is None else lam0.to(dev),
                              None if mu0 is None else mu0.to(dev),
                              rho_init, return_trace)


def _solve_al_impl(r_fn, h_fn, g_fn, x0, p, lb, ub, cfg, lam0, mu0,
                   rho_init, return_trace):
    B, D = x0.shape
    dt, dev = x0.dtype, x0.device
    E = h_fn(x0, p).shape[-1]
    I = g_fn(x0, p).shape[-1]

    lam = torch.zeros(B, E, dtype=dt, device=dev) if lam0 is None else lam0
    mu = torch.zeros(B, I, dtype=dt, device=dev) if mu0 is None else mu0
    if rho_init is None:
        rho = torch.full((B, 1), cfg.rho0, dtype=dt, device=dev)
    elif isinstance(rho_init, torch.Tensor):
        rho = rho_init.to(device=dev, dtype=dt).reshape(-1, 1).expand(B, 1)
    else:
        rho = torch.full((B, 1), float(rho_init), dtype=dt, device=dev)

    def clip(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    eye = torch.eye(D, dtype=dt, device=dev)
    eps_b = 1e-9 + 1e-6 * (ub - lb)

    def inner_step(x, lam, mu, rho):
        """One projected Gauss-Newton step on the AL merit."""
        merit, r, h, g, act = _merit_terms(r_fn, h_fn, g_fn, x, p, lam, mu,
                                           rho)
        Jr = jacobian(r_fn, x, p)
        Jh = jacobian(h_fn, x, p)
        Jg = jacobian(g_fn, x, p)
        grad = _mv(Jr, r) + _mv(Jh, lam + rho * h) - _mv(Jg, act)

        # Freeze variables pinned at a bound with the gradient pushing
        # outward (projected Newton).
        at_lb = (x <= lb + eps_b) & (grad > 0.0)
        at_ub = (x >= ub - eps_b) & (grad < 0.0)
        free = ~(at_lb | at_ub)
        fmask = free.to(dt)

        # GN normal equations, Jacobi-scaled, with one refinement pass.
        active = (act > 0.0).to(dt)
        JrT, JhT, JgT = (J.transpose(-1, -2) for J in (Jr, Jh, Jg))
        rho3 = rho[:, :, None]
        H = (JrT @ Jr + rho3 * (JhT @ Jh)
             + (rho3 * (JgT * active[:, None, :])) @ Jg)
        H = (H * fmask[:, :, None] * fmask[:, None, :]
             + torch.diag_embed(1.0 - fmask))
        gf = grad * fmask
        s = torch.rsqrt(torch.clamp_min(torch.diagonal(H, 0, -2, -1), 1e-12))
        Hs = H * s[:, :, None] * s[:, None, :] + cfg.reg * eye
        gs = gf * s
        L, info = torch.linalg.cholesky_ex(Hs)
        factored = info == 0
        L = torch.where(factored[:, None, None], L, eye)

        def cho_solve(v):
            return torch.cholesky_solve(v[:, :, None], L)[:, :, 0]

        y = cho_solve(-gs)
        y = y + cho_solve(-gs - (Hs @ y[:, :, None])[:, :, 0])
        d = torch.where(free & factored[:, None], y * s, 0.0)

        # Backtracking projected line search (Armijo on the AL merit).
        dir_deriv = torch.sum(grad * d, dim=-1)
        alpha = 1.0
        best_x, done = x, ~factored
        for _ in range(cfg.ls_iters):
            x_try = clip(x + alpha * d)
            m_try = _merit_terms(r_fn, h_fn, g_fn, x_try, p, lam, mu,
                                 rho)[0]
            ok = (m_try <= merit + cfg.armijo * alpha * dir_deriv) & ~done
            best_x = torch.where(ok[:, None], x_try, best_x)
            done = done | ok
            alpha *= cfg.ls_backtrack
        # Projected-gradient inf-norm as the stationarity measure.
        pg = x - clip(x - grad)
        return best_x, torch.amax(torch.abs(pg), dim=-1)

    def lagrangian_pg(x, lam, mu):
        r = r_fn(x, p)
        grad_L = _mv(jacobian(r_fn, x, p), r)
        if E > 0:
            grad_L = grad_L + _mv(jacobian(h_fn, x, p), lam)
        if I > 0:
            grad_L = grad_L - _mv(jacobian(g_fn, x, p), mu)
        pg = x - clip(x - grad_L)
        return r, torch.amax(torch.abs(pg), dim=-1)

    x = clip(x0)
    prev_viol = torch.full((B,), float("inf"), dtype=dt, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    outer_used = torch.zeros(B, dtype=torch.int32, device=dev)
    trace = {k: [] for k in ("viol", "grad_norm", "rho", "obj",
                             "converged")}
    for _ in range(cfg.outer_iters):
        x_new, frozen = x, torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(cfg.inner_iters):
            x3, gnorm = inner_step(x_new, lam, mu, rho)
            # Freeze once stationary on the current subproblem; a failed
            # line search keeps x for this iteration without freezing.
            frozen2 = frozen | (gnorm < cfg.tol_grad * 0.1)
            x_new = torch.where(frozen[:, None], x_new, x3)
            frozen = frozen2
        x_new = torch.where(converged[:, None], x, x_new)

        h, g = h_fn(x_new, p), g_fn(x_new, p)
        zero = torch.zeros(B, dtype=dt, device=dev)
        viol = torch.maximum(
            torch.amax(torch.abs(h), dim=-1) if E > 0 else zero,
            torch.amax(torch.clamp_min(-g, 0.0), dim=-1) if I > 0 else zero)
        # First-order multiplier updates.
        if cfg.penalty_only:
            lam_new, mu_new = lam, mu
        else:
            lam_new = torch.where(converged[:, None], lam, lam + rho * h)
            mu_new = torch.where(converged[:, None], mu,
                                 torch.clamp_min(mu - rho * g, 0.0))
        # Penalty growth if feasibility stalls.
        grow = viol > cfg.viol_reduction * prev_viol
        rho_new = torch.where(
            (converged | ~grow)[:, None], rho,
            torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max))

        # Stationarity of the Lagrangian at the new multipliers, with a
        # scale-aware dual tolerance.
        r, gnorm = lagrangian_pg(x_new, lam_new, mu_new)
        r2 = torch.sum(r * r, dim=-1)
        obj_scale = 1.0 + torch.sqrt(r2)
        now_conv = (viol < cfg.tol_feas) & (gnorm < cfg.tol_grad * obj_scale)
        outer_used = torch.where(converged, outer_used, outer_used + 1)
        converged = converged | now_conv
        for k, v in (("viol", viol), ("grad_norm", gnorm),
                     ("rho", rho_new[:, 0]), ("obj", 0.5 * r2),
                     ("converged", converged)):
            trace[k].append(v)
        x, lam, mu, rho, prev_viol = x_new, lam_new, mu_new, rho_new, viol

    r, gnorm = lagrangian_pg(x, lam, mu)
    sol = ALSolution(x=x, lam=lam, mu=mu, viol=prev_viol, grad_norm=gnorm,
                     obj=0.5 * torch.sum(r * r, dim=-1), rho=rho[:, 0],
                     converged=converged, outer_used=outer_used)
    if not return_trace:
        return sol
    empty = {k: torch.zeros(B, 0, dtype=torch.bool if k == "converged"
                            else dt, device=dev) for k in trace}
    return sol, {k: torch.stack(v, dim=1) if v else empty[k]
                 for k, v in trace.items()}


def solve_al_batched(r_fn, h_fn, g_fn, x0, p, lb, ub,
                     cfg: ALConfig = ALConfig(), lam0=None, mu0=None,
                     rho_init=None, device=None) -> ALSolution:
    """The JAX package's vmap wrapper; here ``solve_al`` takes the batch
    already."""
    return solve_al(r_fn, h_fn, g_fn, x0, p, lb, ub, cfg, lam0=lam0,
                    mu0=mu0, rho_init=rho_init, device=device)
