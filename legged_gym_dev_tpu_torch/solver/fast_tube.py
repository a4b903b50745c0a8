"""Structured (stage-wise) tube-MPC solve and closed loop, batch-major.

Counterpart of ``legged_gym_dev_tpu/solver/fast_tube.py``: the staged
problem description, the stage-form residuals, packing and bounds, the
tube solve (``solve_tube_fast``, whose JAX twin is single-scenario and
vmapped; here it takes the batch) and the receding-horizon closed loop.
The variables of stage k are ``u_k = [z_k, w_k, v_k]``; a staged iterate is
``(B, N+1, b)``. The ROM and the tube network may be shared or per scenario
(``solver.trajopt``); every path here takes both.

``solve_tube_fast_single`` dispatches to the entry-form solver
(``staged_scalar.solve_staged_scalar``, on the card through the
block-tridiagonal kernels); ``solve_tube_fast_single_array`` is the
array-form AL Gauss-Newton on (B, S, b, b) blocks with the plain
block-Thomas of ``block_tridiag.py``, the parity reference of the entry
form.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from ..utils.runtime import fp32_matmul, resolve_device
from .al_solver import ALConfig, ALSolution
from .block_tridiag import (
    block_tridiag_factor,
    block_tridiag_solve,
    woodbury_solve,
)
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


def _stage_layout(n: int, m: int):
    b = n + 1 + m
    return b, slice(0, n), n, slice(n + 1, n + 1 + m)


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


def _merit(sp, u, p, lam, mu, rho):
    """The AL merit (B,); rho (B, 1)."""
    r, h, g = _residuals(sp, u, p)
    act = torch.clamp_min(mu - rho * g, 0.0)
    return (0.5 * torch.sum(r * r, dim=-1) + torch.sum(lam * h, dim=-1)
            + 0.5 * rho[:, 0] * torch.sum(h * h, dim=-1)
            + (0.5 / rho[:, 0]) * torch.sum(act * act - mu * mu, dim=-1))


# ---------------------------------------------------------------------------
# Stage-form GN assembly (array form)
# ---------------------------------------------------------------------------

def _assemble(sp: StagedProblem, u, p: TrajOptParams, lam, mu, rho,
              grad_rho=None):
    """grad (B, S, b), diagonal blocks D (B, S, b, b), sub-diagonal blocks
    L (B, S-1, b, b) and, for the NN tube, the Woodbury factor
    U_nn (B, S, b, N) = sqrt(rho) J_tube^T; rho (B, 1).

    ``grad_rho`` (default rho) is the penalty of the gradient terms only:
    the outer convergence test passes 0.0, so grad is the plain
    Lagrangian gradient; the Hessian blocks always use rho."""
    if grad_rho is None:
        grad_rho = rho
    if isinstance(grad_rho, torch.Tensor):
        gr2, gr3 = grad_rho, grad_rho[:, :, None]
    else:
        gr2 = gr3 = grad_rho
    n, m, N, K = sp.n, sp.m, sp.N, sp.K
    b, iz, iw, iv = _stage_layout(n, m)
    S = N + 1
    B = u.shape[0]
    dt, dev = u.dtype, u.device
    z, w, v = _split(u, sp)
    rho3, rho4 = rho[:, :, None], rho[:, :, None, None]

    r, h, g = _residuals(sp, u, p)
    E_dyn = N * n
    h_dyn = h[:, :E_dyn].reshape(B, N, n)
    h_ic = h[:, E_dyn:E_dyn + 2]
    h_tube = h[:, E_dyn + 2:]
    lam_dyn = lam[:, :E_dyn].reshape(B, N, n)
    lam_ic = lam[:, E_dyn:E_dyn + 2]
    lam_tube = lam[:, E_dyn + 2:]
    act = torch.clamp_min(mu - rho * g, 0.0).reshape(B, S, K)
    act_grad = torch.clamp_min(mu - gr2 * g, 0.0).reshape(B, S, K)

    if sp.track_ref:
        z_goal, v_goal = p.z_ref, p.v_ref
    else:
        z_goal = p.zf[:, None, :].expand(B, S, n)
        v_goal = torch.zeros_like(v)

    D = torch.zeros(B, S, b, b, dtype=dt, device=dev)
    L = torch.zeros(B, S - 1, b, b, dtype=dt, device=dev)
    grad = torch.zeros(B, S, b, dtype=dt, device=dev)

    # ---- objective (r-part): Hobj = J_r^T J_r, grad += J_r^T r ----------
    Qz = p.Lq @ p.Lq.transpose(-1, -2)          # = 2 Q
    Qzf = p.Lqf @ p.Lqf.transpose(-1, -2)
    Rv = p.Lr @ p.Lr.transpose(-1, -2)
    qw2 = p.sqrt_qw ** 2
    D[:, :-1, iz, iz] += Qz[:, None]
    D[:, -1, iz, iz] += Qzf
    D[:, :-1, iv, iv] += Rv[:, None]
    D[:, :, iw, iw] += qw2[:, None]
    grad[:, :-1, iz] += (z[:, :-1] - z_goal[:, :-1]) @ Qz.transpose(-1, -2)
    grad[:, -1, iz] += ((z[:, -1:] - z_goal[:, -1:])
                        @ Qzf.transpose(-1, -2))[:, 0]
    grad[:, :-1, iv] += (v - v_goal) @ Rv.transpose(-1, -2)
    grad[:, :, iw] += qw2[:, None] * w

    # ---- dynamics: per-stage linearization A_k, B_k ----------------------
    zs, vs = z[:, :-1].reshape(B * N, n), v.reshape(B * N, m)
    if isinstance(p.rom.dt, torch.Tensor):
        # per-scenario dt: each stage's row carries its scenario's
        def f_row(zk, vk, dtk):
            return replace(p.rom, dt=dtk).f(zk[None], vk[None])[0]

        A, Bk = torch.func.vmap(torch.func.jacfwd(f_row, argnums=(0, 1)))(
            zs, vs, p.rom.dt.repeat_interleave(N))
    else:
        def f_single(zk, vk):
            return p.rom.f(zk[None], vk[None])[0]

        A, Bk = torch.func.vmap(torch.func.jacfwd(
            f_single, argnums=(0, 1)))(zs, vs)
    A, Bk = A.reshape(B, N, n, n), Bk.reshape(B, N, n, m)
    lh = lam_dyn + gr3 * h_dyn                                  # (B, N, n)
    D[:, :-1, iz, iz] += rho4 * torch.einsum("bkij,bkil->bkjl", A, A)
    D[:, :-1, iz, iv] += rho4 * torch.einsum("bkij,bkil->bkjl", A, Bk)
    D[:, :-1, iv, iz] += rho4 * torch.einsum("bkij,bkil->bkjl", Bk, A)
    D[:, :-1, iv, iv] += rho4 * torch.einsum("bkij,bkil->bkjl", Bk, Bk)
    D[:, 1:, iz, iz] += rho4 * torch.eye(n, dtype=dt, device=dev)
    # L_k rows: z_{k+1}; cols: (z_k, v_k): -rho [A_k, B_k]
    L[:, :, iz, iz] += -rho4 * A
    L[:, :, iz, iv] += -rho4 * Bk
    grad[:, :-1, iz] += torch.einsum("bkij,bki->bkj", A, lh)
    grad[:, :-1, iv] += torch.einsum("bkij,bki->bkj", Bk, lh)
    grad[:, 1:, iz] += -lh

    # ---- initial condition ----------------------------------------------
    lh_ic = lam_ic + gr2 * h_ic
    D[:, 0, 0, 0] += rho[:, 0]
    D[:, 0, 1, 1] += rho[:, 0]
    grad[:, 0, 0] += lh_ic[:, 0]
    grad[:, 0, 1] += lh_ic[:, 1]

    # ---- obstacles (active rows) ----------------------------------------
    # row J_ki: dz = 2(z_k[:2] - c_i), dw = -2(r_i + w_k); rho * active *
    # J^T J on the stage diagonal, grad -= J^T act
    dzc = 2.0 * (z[:, :, None, :2] - p.obs_c[:, None, :, :])   # (B,S,K,2)
    dwc = -2.0 * (p.obs_r[:, None, :] + w[:, :, None])          # (B,S,K)
    arow = (act > 0.0).to(dt)
    D[:, :, :2, :2] += rho4 * torch.einsum("bsk,bski,bskj->bsij", arow,
                                           dzc, dzc)
    cross = rho3 * torch.einsum("bsk,bski,bsk->bsi", arow, dzc, dwc)
    D[:, :, :2, iw] += cross
    D[:, :, iw, :2] += cross
    D[:, :, iw, iw] += rho * torch.einsum("bsk,bsk,bsk->bs", arow, dwc, dwc)
    grad[:, :, :2] += -torch.einsum("bski,bsk->bsi", dzc, act_grad)
    grad[:, :, iw] += -torch.einsum("bsk,bsk->bs", dwc, act_grad)

    # ---- tube dynamics ---------------------------------------------------
    U_nn = None
    lh_t = lam_tube + gr2 * h_tube                              # (B, N)
    if sp.tube_kind in ("l1", "l2"):
        if sp.tube_kind == "l1":
            t = sp.scaling * torch.sign(v)                      # (B, N, m)
        else:
            t = 2.0 * sp.scaling * v
        D[:, :-1, iv, iv] += rho4 * torch.einsum("bki,bkj->bkij", t, t)
        D[:, 1:, iw, iw] += rho
        # L_k rows: w_{k+1}; cols: v_k: -rho t_k
        L[:, :, iw, iv] += -rho3 * t
        grad[:, :-1, iv] += t * lh_t[:, :, None]
        grad[:, 1:, iw] += -lh_t
    else:
        # dense NN rows through Woodbury: J_tube (N, S*b) from the net's
        # Jacobian in (z0_rest, v) plus -I on w[1:]
        H = p.e_hist.shape[-1]
        v_total = torch.cat([p.v_prev, v], dim=1)
        x_in = torch.cat([p.e_hist.reshape(B, -1), z[:, 0, 2:],
                          v_total.transpose(1, 2).reshape(B, -1)], dim=-1)
        _, J_full = p.tube_params.value_and_jacobian(x_in)  # (B, N, n_in)
        Jt = torch.zeros(B, N, S, b, dtype=dt, device=dev)
        Jt[:, :, 0, 2:n] = J_full[:, :, H:H + n - 2]
        off = H + n - 2
        for j in range(m):
            Jt[:, :, :-1, n + 1 + j] = J_full[:, :, off + H:off + H + N]
            off += H + N
        rows = torch.arange(N, device=dev)
        Jt[:, rows, rows + 1, iw] += -1.0
        U_nn = torch.sqrt(rho4) * torch.movedim(Jt, 1, -1)
        grad = grad + torch.einsum("brsc,br->bsc", Jt, lh_t)

    return grad, D, L, U_nn


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
    """Box bounds (B, N+1, b) from the ROM's (shared or per-scenario)
    bounds; stage N's padded v slot is pinned to 0."""
    B = p.batch_size
    b = n + 1 + m
    lb = torch.zeros(B, N + 1, b, device=p.device)
    ub = torch.zeros(B, N + 1, b, device=p.device)

    def stages(t):
        return t[:, None, :] if t.ndim == 2 else t

    lb[:, :, :n] = stages(p.rom.z_min)
    ub[:, :, :n] = stages(p.rom.z_max)
    ub[:, :, n] = p.w_max[:, None]
    lb[:, :-1, n + 1:] = stages(p.rom.v_min)
    ub[:, :-1, n + 1:] = stages(p.rom.v_max)
    return lb, ub


def _staged_problem(p, N, tube_kind, scaling, track_ref):
    return StagedProblem(n=p.rom.n, m=p.rom.m, N=N, K=p.obs_r.shape[-1],
                         tube_kind=("nn" if tube_kind == "NN_oneshot"
                                    else tube_kind),
                         scaling=scaling, track_ref=track_ref)


def solve_tube_fast_single(sp: StagedProblem, p: TrajOptParams, u0, lb_u,
                           ub_u, cfg: ALConfig = ALConfig(), lam0=None,
                           mu0=None, rho_init=None) -> ALSolution:
    """AL-GN on the staged layout of a scenario batch: the entry-form
    solver (``staged_scalar.solve_staged_scalar``), for every tube kind;
    the dense NN tube rows ride as an entry-form Woodbury correction
    there. ``solve_tube_fast_single_array`` is its parity reference."""
    return solve_staged_scalar(sp, p, u0, lb_u, ub_u, cfg, lam0=lam0,
                               mu0=mu0, rho_init=rho_init)


def solve_tube_fast_single_array(sp: StagedProblem, p: TrajOptParams, u0,
                                 lb_u, ub_u, cfg: ALConfig = ALConfig(),
                                 lam0=None, mu0=None,
                                 rho_init=None) -> ALSolution:
    """Array-form staged AL-GN: (B, S, b, b) blocks through the plain
    block-Thomas (and Woodbury for the NN tube), the fixed
    outer x inner schedule with no host sync, in full fp32.

    u0 (B, S, b); lb_u / ub_u broadcastable to it; lam0 (B, E), mu0
    (B, I), rho_init (B,) or a float."""
    with fp32_matmul():
        return _solve_array(sp, p, u0, lb_u, ub_u, cfg, lam0, mu0,
                            rho_init)


def _solve_array(sp, p, u0, lb_u, ub_u, cfg, lam0, mu0, rho_init):
    B, S, b = u0.shape
    dt, dev = u0.dtype, u0.device
    lb_u, ub_u = lb_u.expand(B, S, b), ub_u.expand(B, S, b)
    _, h0, g0 = _residuals(sp, u0, p)
    E, I = h0.shape[-1], g0.shape[-1]
    lam = torch.zeros(B, E, dtype=dt, device=dev) if lam0 is None else lam0
    mu = torch.zeros(B, I, dtype=dt, device=dev) if mu0 is None else mu0
    if rho_init is None:
        rho = torch.full((B, 1), cfg.rho0, dtype=dt, device=dev)
    elif isinstance(rho_init, torch.Tensor):
        rho = rho_init.reshape(B, 1).to(dt)
    else:
        rho = torch.full((B, 1), float(rho_init), dtype=dt, device=dev)
    eye = torch.eye(b, dtype=dt, device=dev)
    alphas = torch.pow(
        torch.tensor(cfg.ls_backtrack, dtype=dt, device=dev),
        torch.arange(cfg.ls_iters, dtype=dt, device=dev))
    rows = torch.arange(B, device=dev)

    def clip(x):
        return torch.minimum(torch.maximum(x, lb_u), ub_u)

    def pg_norm(u, grad):
        return torch.amax(torch.abs(u - clip(u - grad)), dim=(1, 2))

    def inner_step(u, lam, mu, rho):
        merit = _merit(sp, u, p, lam, mu, rho)
        grad, D, L, U_nn = _assemble(sp, u, p, lam, mu, rho)

        eps_b = 1e-9 + 1e-6 * (ub_u - lb_u)
        at_lb = (u <= lb_u + eps_b) & (grad > 0.0)
        at_ub = (u >= ub_u - eps_b) & (grad < 0.0)
        free = ~(at_lb | at_ub)
        fm = free.to(dt)
        D = (D * fm[..., :, None] * fm[..., None, :]
             + eye * (1.0 - fm)[..., :, None] * eye)
        D = D + (cfg.reg + 1e-6 * rho)[:, :, None, None] * eye
        L = L * fm[:, 1:, :, None] * fm[:, :-1, None, :]
        gf = grad * fm

        fac = block_tridiag_factor(D, L)
        if U_nn is not None:
            d = -woodbury_solve(fac, U_nn * fm[..., None], gf)
        else:
            d = -block_tridiag_solve(fac, gf)
        d = torch.where(free, d, 0.0)
        dir_deriv = torch.sum(grad * d, dim=(1, 2))

        # parallel Armijo backtracking: every candidate step evaluated,
        # the first (largest) passing alpha taken
        u_trys = clip(u[None] + alphas[:, None, None, None] * d[None])
        m_trys = torch.stack([_merit(sp, ut, p, lam, mu, rho)
                              for ut in u_trys])               # (ls, B)
        ok = m_trys <= merit + cfg.armijo * alphas[:, None] * dir_deriv
        idx = torch.argmax(ok.to(torch.int32), dim=0)
        u_new = torch.where(torch.any(ok, dim=0)[:, None, None],
                            u_trys[idx, rows], u)
        return u_new, pg_norm(u, grad)

    u = clip(u0)
    prev_viol = torch.full((B,), float("inf"), dtype=dt, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    outer_used = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(cfg.outer_iters):
        u2 = u
        frozen = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(cfg.inner_iters):
            u3, gnorm = inner_step(u2, lam, mu, rho)
            frozen2 = frozen | (gnorm < cfg.tol_grad * 0.1)
            u2 = torch.where(frozen[:, None, None], u2, u3)
            frozen = frozen2
        conv3 = converged[:, None, None]
        u_new = torch.where(conv3, u, u2)

        r, h, g = _residuals(sp, u_new, p)
        viol = torch.maximum(torch.amax(torch.abs(h), dim=-1),
                             torch.amax(torch.clamp_min(-g, 0.0), dim=-1))
        conv2 = converged[:, None]
        lam_new = torch.where(conv2, lam, lam + rho * h)
        mu_new = torch.where(conv2, mu, torch.clamp_min(mu - rho * g, 0.0))
        grow = viol > cfg.viol_reduction * prev_viol
        rho_new = torch.where((converged | ~grow)[:, None], rho,
                              torch.clamp_max(rho * cfg.rho_growth,
                                              cfg.rho_max))
        grad, _, _, _ = _assemble(sp, u_new, p, lam_new, mu_new, rho,
                                  grad_rho=0.0)
        gnorm = pg_norm(u_new, grad)
        obj_scale = 1.0 + torch.sqrt(torch.sum(r * r, dim=-1))
        now_conv = (viol < cfg.tol_feas) & (gnorm < cfg.tol_grad * obj_scale)
        outer_used = torch.where(converged, outer_used, outer_used + 1)
        converged = converged | now_conv
        u, lam, mu, rho, prev_viol = u_new, lam_new, mu_new, rho_new, viol

    r, _, _ = _residuals(sp, u, p)
    grad, _, _, _ = _assemble(sp, u, p, lam, mu, rho, grad_rho=0.0)
    return ALSolution(
        x=u.reshape(B, -1), lam=lam, mu=mu, viol=prev_viol,
        grad_norm=pg_norm(u, grad), obj=0.5 * torch.sum(r * r, dim=-1),
        rho=rho[:, 0], converged=converged, outer_used=outer_used)


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
    sol = solve_tube_fast_single(sp, p, u0, lb_u, ub_u, cfg)
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
