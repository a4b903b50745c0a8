"""Feasibility restoration and local-infeasibility certification, batched.

Counterpart of ``legged_gym_dev_tpu/solver/restoration.py``. The batched
AL solver always returns its final iterate, even for scenarios whose
constraints cannot be met; every scenario is classified as one of four
verdicts:

1. restoration: re-solve with the objective replaced by a proximal term
   and the violation minimized by the quadratic penalty, then a projected
   gradient polish on ``theta = 0.5 ||h||^2 + 0.5 ||min(g, 0)||^2``;
2. escalation: an AL restoration from the polished point, the
   stay-at-start witness, and a second restoration from the interpolate
   warm start;
3. certificate: a stationary theta > 0 (small projected gradient, or a
   polish that found no descent direction) certifies local infeasibility.

``jax.value_and_grad`` of theta becomes ``torch.autograd.grad`` of the
batch-summed theta: scenarios are independent, so each scenario's rows of
the gradient are its own gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.runtime import fp32_matmul, resolve_device
from .al_solver import ALConfig, ALSolution
from .fast_tube import _residuals, _tube_fw, pack_staged
from .staged_scalar import solve_staged_scalar
from .trajopt import warm_start_interpolate

# Verdict codes (int32 per scenario).
VERDICT_FEASIBLE = 0     # original solve satisfied all constraints (< tol)
VERDICT_RESTORED = 1     # original iterate violated, restoration found a
#                          feasible point (the solve failed, not the problem)
VERDICT_INFEASIBLE = 2   # certified locally infeasible (stationary theta > 0)
VERDICT_FAILED = 3       # violating and not certified: solver failure

VERDICT_NAMES = ("feasible", "restored", "infeasible", "failed")


class CertResult(NamedTuple):
    verdict: torch.Tensor        # (B,) int32, one of the VERDICT_* codes
    u_restored: torch.Tensor     # (B, S, b) restored staged iterate
    viol_restored: torch.Tensor  # (B,) max constraint violation there
    theta: torch.Tensor          # (B,) violation measure there
    theta_pg: torch.Tensor       # (B,) projected-gradient inf-norm of theta
    stalled: torch.Tensor        # (B,) bool: the polish found no descent
    #                              direction down to step 1e-9


def _clip(u, lb_u, ub_u):
    return torch.minimum(torch.maximum(u, lb_u), ub_u)


def _theta_fn(sp, p):
    def theta_of(uu):
        _, h, g = _residuals(sp, uu, p)
        gneg = torch.clamp_max(g, 0.0)
        return 0.5 * (torch.sum(h * h, dim=-1) + torch.sum(gneg * gneg, -1))

    return theta_of


def _value_and_grad(theta_of, u):
    """Per-scenario theta (B,) and its gradient (B, S, b)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        th = theta_of(uu)
        (gr,) = torch.autograd.grad(th.sum(), uu)
    return th.detach(), gr


def _pg_norm(u, gr, lb_u, ub_u):
    pg = u - _clip(u - gr, lb_u, ub_u)
    return torch.amax(torch.abs(pg), dim=(1, 2))


def _theta_and_pg(sp, p, u, lb_u, ub_u):
    """Violation measure theta and its projected gradient at u."""
    th, gr = _value_and_grad(_theta_fn(sp, p), u)
    return th, _pg_norm(u, gr, lb_u, ub_u)


def _pgd_polish(sp, p, u0, lb_u, ub_u, iters: int = 256):
    """Projected gradient descent on theta with an adaptive step per
    scenario; a step driven below 1e-9 means backtracking found no descent
    direction (Clarke stationarity of theta)."""
    theta_of = _theta_fn(sp, p)
    u = u0
    th, gr = _value_and_grad(theta_of, u0)
    step = torch.ones(u0.shape[0], dtype=u0.dtype, device=u0.device)
    for _ in range(iters):
        cand = _clip(u - step[:, None, None] * gr, lb_u, ub_u)
        thc, grc = _value_and_grad(theta_of, cand)
        ok = thc < th - 1e-14
        u = torch.where(ok[:, None, None], cand, u)
        th = torch.where(ok, thc, th)
        gr = torch.where(ok[:, None, None], grc, gr)
        step = torch.where(ok, torch.clamp_max(step * 1.3, 1e3), step * 0.5)
    return u, th, _pg_norm(u, gr, lb_u, ub_u), step < 1e-9


def restore_feasibility(sp, p, u0, lb_u, ub_u,
                        cfg: Optional[ALConfig] = None,
                        prox: float = 1.0) -> ALSolution:
    """Minimize constraint violation from ``u0 (B, S, b)`` with a proximal
    objective (track the current iterate with weight ``prox``), multipliers
    frozen at zero (``penalty_only``)."""
    n, m = sp.n, sp.m
    if cfg is None:
        cfg = ALConfig(outer_iters=4, inner_iters=12, ls_iters=20,
                       rho0=1e3, penalty_only=True)
    B = u0.shape[0]
    sL = math.sqrt(2.0 * prox)

    def eye(k):
        return (sL * torch.eye(k, device=u0.device)).expand(B, k, k)

    p_feas = p.replace(
        Lq=eye(n), Lr=eye(m), Lqf=eye(n),
        sqrt_qw=torch.zeros_like(p.sqrt_qw),
        z_ref=u0[:, :, :n], v_ref=u0[:, :-1, n + 1:n + 1 + m],
    )
    return solve_staged_scalar(sp._replace(track_ref=True), p_feas, u0,
                               lb_u, ub_u, cfg)


def certify_staged(sp, p, u_final, viol_final, lb_u, ub_u,
                   cfg: Optional[ALConfig] = None,
                   tol: float = 1e-3, escalate: bool = True) -> CertResult:
    """Classify each scenario's solve outcome, on ``p``'s device.

    u_final (B, S, b) staged iterates of the tube solve; viol_final (B,)
    their ``sol.viol``; lb_u/ub_u broadcastable to u_final.
    """
    with fp32_matmul():
        return _certify(sp, p, u_final, viol_final, lb_u, ub_u, cfg, tol,
                        escalate)


def _certify(sp, p, u_final, viol_final, lb_u, ub_u, cfg, tol, escalate):
    n, m, N = sp.n, sp.m, sp.N
    B = u_final.shape[0]
    lb_u = lb_u.expand(u_final.shape)
    ub_u = ub_u.expand(u_final.shape)

    def viol_of(uu):
        _, h, g = _residuals(sp, uu, p)
        return torch.maximum(torch.amax(torch.abs(h), dim=-1),
                             torch.amax(torch.clamp_min(-g, 0.0), dim=-1))

    def stationary_of(pg, th, stalled):
        return stalled | (pg < 1e-4 + 1e-2 * torch.sqrt(2.0 * th))

    def pick(better, new, old):
        return torch.where(better.reshape((B,) + (1,) * (new.dim() - 1)),
                           new, old)

    sol_r = restore_feasibility(sp, p, u_final, lb_u, ub_u, cfg)
    u_r, th, pg, stalled = _pgd_polish(
        sp, p, sol_r.x.reshape(u_final.shape), lb_u, ub_u)
    viol_r = viol_of(u_r)
    stationary = stationary_of(pg, th, stalled)

    if escalate:
        # Continuation pass: AL restoration (multiplier updates on) from
        # the polished point; converges to exact feasibility at finite rho
        # whenever the scenario is feasible.
        cfg_al = ALConfig(outer_iters=8, inner_iters=12, ls_iters=20,
                          rho0=1e3, penalty_only=False)
        sol_al = restore_feasibility(sp, p, u_r, lb_u, ub_u, cfg_al)
        u_al, th_al, pg_al, stalled_al = _pgd_polish(
            sp, p, sol_al.x.reshape(u_final.shape), lb_u, ub_u, iters=128)
        viol_al = viol_of(u_al)
        stationary_al = stationary_of(pg_al, th_al, stalled_al)
        better_al = viol_al < viol_r
        u_r = pick(better_al, u_al, u_r)
        viol_r = pick(better_al, viol_al, viol_r)
        th = pick(better_al, th_al, th)
        pg = pick(better_al, pg_al, pg)
        stalled = pick(better_al, stalled_al, stalled)
        stationary = stationary | stationary_al

        # Stay-at-start witness: z == z0, v = 0, w = tube(0). For the
        # integrator ROMs it satisfies dynamics, IC and tube rows exactly.
        z_stay = p.z0[:, None, :].expand(B, N + 1, n)
        v_stay = torch.zeros(B, N, m, device=u_final.device)
        fw_stay = _tube_fw(sp, z_stay, v_stay, p)
        w_stay = torch.cat([torch.zeros(B, 1, device=u_final.device),
                            fw_stay], dim=1)
        u_stay = _clip(pack_staged(z_stay, w_stay, v_stay, n, m, N),
                       lb_u, ub_u)
        viol_stay = viol_of(u_stay)
        better_stay = viol_stay < viol_r
        u_r = pick(better_stay, u_stay, u_r)
        viol_r = pick(better_stay, viol_stay, viol_r)
        # (theta/pg/stalled keep the descent attempt's values: the stay
        # candidate is a feasibility witness, not a theta minimizer.)

        z_i, v_i = warm_start_interpolate(p.z0, p.zf, N, p.rom.dt, m=m)
        u_i = _clip(pack_staged(
            z_i, torch.zeros(B, N + 1, device=u_final.device), v_i, n, m, N),
            lb_u, ub_u)
        cfg2 = ALConfig(outer_iters=6, inner_iters=16, ls_iters=24,
                        rho0=1e3, penalty_only=True)
        sol_r2 = restore_feasibility(sp, p, u_i, lb_u, ub_u, cfg2)
        u_r2, th2, pg2, stalled2 = _pgd_polish(
            sp, p, sol_r2.x.reshape(u_final.shape), lb_u, ub_u, iters=512)
        viol_r2 = viol_of(u_r2)
        stationary2 = stationary_of(pg2, th2, stalled2)
        better2 = viol_r2 < viol_r
        u_r = pick(better2, u_r2, u_r)
        viol_r = pick(better2, viol_r2, viol_r)
        th = pick(better2, th2, th)
        pg = pick(better2, pg2, pg)
        stalled = pick(better2, stalled2, stalled)
        stationary = stationary | stationary2

    feas0 = viol_final < tol
    feas_r = viol_r < tol
    verdict = torch.where(
        feas0, VERDICT_FEASIBLE,
        torch.where(feas_r, VERDICT_RESTORED,
                    torch.where(stationary, VERDICT_INFEASIBLE,
                                VERDICT_FAILED))).to(torch.int32)
    return CertResult(verdict=verdict, u_restored=u_r,
                      viol_restored=viol_r, theta=th, theta_pg=pg,
                      stalled=stalled)


def certify_staged_batched(sp, p_batch, u_final, viol_final, lb_u, ub_u,
                           cfg: Optional[ALConfig] = None,
                           tol: float = 1e-3, escalate: bool = True,
                           device=None) -> CertResult:
    """Entry point: verdicts of a batch on ``device`` (None = the CUDA
    card; raises without one)."""
    dev = resolve_device(device)
    return certify_staged(sp, p_batch.to(dev), u_final.to(dev),
                          viol_final.to(dev), lb_u.to(dev), ub_u.to(dev),
                          cfg=cfg, tol=tol, escalate=escalate)
