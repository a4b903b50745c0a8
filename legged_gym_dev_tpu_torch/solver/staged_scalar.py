"""Scalar-entry staged tube solve, batch-major.

Counterpart of ``legged_gym_dev_tpu/solver/staged_scalar.py``: the same
augmented-Lagrangian Gauss-Newton algorithm on the same entry-form objects,
written for a whole scenario batch at once instead of one scenario under
``vmap``:

- every per-stage entry (gradient, GN diagonal/sub-diagonal block entries,
  residuals, iterate coordinates) is a ``(B, S)``-like tensor;
- a per-scenario scalar is a ``(B, 1)`` tensor (multipliers' and penalties'
  companions, merits, norms), so it broadcasts against the entries;
- the parallel line search's candidate axis leads: ``(ls_iters, B, S)``;
- multi-RHS blocks (the NN tube's Woodbury basis) are ``(B, S, R)``.

Zero entries are Python ``0.0`` and are skipped exactly as in the JAX
package (``_is0/_mul/_add/_sub``), so the sparsity of the staged blocks is
exploited the same way. A per-scenario ROM gives its ``dt``-valued Jacobian
entries as ``(B, 1)`` columns where the shared ROM gives floats; both reach
the KKT entries as ``(B, S)`` / ``(B, S-1)`` tensors of the same shapes.
The fixed schedule has no early exit and the loop makes no host
synchronisation: per-scenario convergence and freezing are
``torch.where`` masks.

Linear solves (``ALConfig.linsolve``): "pallas" goes to the hand-written
CUDA kernels of ``ops/block_tridiag_kernels.py`` (their plain versions on
CPU tensors); "thomas", and "auto" below 128 stages, to
``factor_solve_entries`` here; "cr", and "auto" from 128 stages, to the
block cyclic reduction ``cr_solve_entries`` for the single-RHS solves of
the l1/l2 tubes (the NN tube's solves take "thomas" then, as in JAX).
``LGDT_PALLAS_MULTIRHS=0`` in the environment (read at import into
``_PALLAS_MULTIRHS``, as in JAX) keeps "pallas" for the single right-hand
side solves and sends the NN tube's multi-RHS Woodbury solves to
``factor_solve_entries``.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..ops.block_tridiag_kernels import (
    block_tridiag_multirhs_entries,
    block_tridiag_solve_entries,
)
from ..ops.blocked_chol import blocked_cho_solve, blocked_cholesky
from ..utils.runtime import fp32_matmul
from .al_solver import ALConfig, ALSolution


# ---------------------------------------------------------------------------
# symbolic-zero helpers
# ---------------------------------------------------------------------------

def _is0(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


def _mul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    return a * b


def _add(a, b):
    if _is0(a):
        return b
    if _is0(b):
        return a
    return a + b


def _sub(a, b):
    if _is0(b):
        return a
    if _is0(a):
        return -b
    return a - b


def _col(x):
    """Per-scenario values (B,) -> (B, 1)."""
    return x[:, None]


def _sum(x):
    """Sum over the stage axis, keeping it: (..., B, T) -> (..., B, 1)."""
    return torch.sum(x, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# entry-form residual pieces
# ---------------------------------------------------------------------------

def _split_e(u_e, sp):
    n, m = sp.n, sp.m
    z_e = list(u_e[:n])                                  # each (..., B, S)
    w = u_e[n]
    v_e = [u_e[n + 1 + j][..., :-1] for j in range(m)]   # each (..., B, N)
    return z_e, w, v_e


def _nn_input(sp, z_e, v_e, p):
    """The tube net's input ``[e_hist, z0[2:], vec_F([v_prev; v])]``; the
    entries may carry a leading candidate axis."""
    lead = torch.broadcast_shapes(*[vj.shape[:-1] for vj in v_e])
    H = p.e_hist.shape[-1]
    parts = [p.e_hist.expand(lead + (H,))]
    for i in range(2, sp.n):
        parts.append(z_e[i][..., 0:1].expand(lead + (1,)))
    for j in range(sp.m):
        parts.append(p.v_prev[:, :, j].expand(lead + (H,)))
        parts.append(v_e[j].expand(lead + v_e[j].shape[-1:]))
    return torch.cat(parts, dim=-1)


def _tube_fw_e(sp, z_e, v_e, p):
    if sp.tube_kind == "l1":
        fw = 0.0
        for vj in v_e:
            fw = _add(fw, sp.scaling * torch.abs(vj))
        return fw
    if sp.tube_kind == "l2":
        fw = 0.0
        for vj in v_e:
            fw = _add(fw, sp.scaling * vj * vj)
        return fw
    return p.tube_params(_nn_input(sp, z_e, v_e, p))


def _h_entries(sp, z_e, w, v_e, p):
    """(h_dyn list n of (..., B, N), h_ic list 2 of (..., B, 1),
    h_tube (..., B, N))."""
    zk = [z[..., :-1] for z in z_e]
    f_e = p.rom.f_entries(zk, v_e)
    h_dyn = [f_e[i] - z_e[i][..., 1:] for i in range(sp.n)]
    h_ic = [z_e[0][..., 0:1] - p.z0[:, 0:1], z_e[1][..., 0:1] - p.z0[:, 1:2]]
    h_tube = _tube_fw_e(sp, z_e, v_e, p) - w[..., 1:]
    return h_dyn, h_ic, h_tube


def _g_entries(z_e, w, p, K):
    gs = []
    for k in range(K):
        d0 = z_e[0] - p.obs_c[:, k, 0:1]
        d1 = z_e[1] - p.obs_c[:, k, 1:2]
        rw = p.obs_r[:, k:k + 1] + w
        gs.append(d0 * d0 + d1 * d1 - rw * rw)          # (..., B, S)
    return gs


def _goals(sp, p):
    n, m = sp.n, sp.m
    if sp.track_ref:
        return ([p.z_ref[:, :, i] for i in range(n)],
                [p.v_ref[:, :, j] for j in range(m)])
    return [p.zf[:, i:i + 1] for i in range(n)], [0.0 for _ in range(m)]


def _objective_r2(sp, z_e, w, v_e, p):
    """sum(r^2) per scenario, (..., B, 1)."""
    n, m = sp.n, sp.m
    zg, vg = _goals(sp, p)
    dz = [z_e[i] - zg[i] for i in range(n)]
    dv = [_sub(v_e[j], vg[j]) for j in range(m)]

    r2 = 0.0
    for i in range(n):
        row = 0.0
        rowf = 0.0
        for j in range(n):
            row = _add(row, _mul(dz[j], p.Lq[:, j, i:i + 1]))
            rowf = _add(rowf, _mul(dz[j][..., -1:], p.Lqf[:, j, i:i + 1]))
        if not _is0(row):
            r2 = _add(r2, _sum(row[..., :-1] ** 2))
        if not _is0(rowf):
            r2 = _add(r2, rowf ** 2)
    for i in range(m):
        row = 0.0
        for j in range(m):
            row = _add(row, _mul(dv[j], p.Lr[:, j, i:i + 1]))
        if not _is0(row):
            r2 = _add(r2, _sum(row ** 2))
    r2 = _add(r2, _col(p.sqrt_qw) ** 2 * _sum(w * w))
    return r2


def _split_lam(sp, lam):
    N, n = sp.N, sp.n
    B = lam.shape[0]
    return (lam[:, : N * n].reshape(B, N, n), lam[:, N * n: N * n + 2],
            lam[:, N * n + 2:])


def _merit_e(sp, u_e, p, lam, mu, rho):
    """PHR augmented-Lagrangian merit per scenario, (..., B, 1).
    lam (B, E), mu (B, I), rho (B, 1); entries may carry a leading
    candidate axis."""
    n, K = sp.n, sp.K
    z_e, w, v_e = _split_e(u_e, sp)
    r2 = _objective_r2(sp, z_e, w, v_e, p)
    h_dyn, h_ic, h_tube = _h_entries(sp, z_e, w, v_e, p)
    lam_dyn, lam_ic, lam_tube = _split_lam(sp, lam)

    lin = 0.0
    quad = 0.0
    for i in range(n):
        lin = _add(lin, _sum(lam_dyn[:, :, i] * h_dyn[i]))
        quad = _add(quad, _sum(h_dyn[i] ** 2))
    for i in range(2):
        lin = _add(lin, lam_ic[:, i:i + 1] * h_ic[i])
        quad = _add(quad, h_ic[i] ** 2)
    lin = _add(lin, _sum(lam_tube * h_tube))
    quad = _add(quad, _sum(h_tube ** 2))

    g_list = _g_entries(z_e, w, p, K)
    mu_sk = mu.reshape(mu.shape[0], sp.N + 1, K)
    ineq = 0.0
    for k in range(K):
        mu_k = mu_sk[:, :, k]
        act = torch.clamp_min(mu_k - rho * g_list[k], 0.0)
        ineq = _add(ineq, _sum(act * act - mu_k * mu_k))

    return 0.5 * r2 + lin + 0.5 * rho * quad + (0.5 / rho) * ineq


# ---------------------------------------------------------------------------
# entry-form GN assembly
# ---------------------------------------------------------------------------

def _bcast_N(x, N, like):
    if _is0(x):
        return 0.0
    if isinstance(x, (int, float)):
        return torch.full((N,), float(x), dtype=like.dtype, device=like.device)
    if x.shape[-1] != N:        # a per-scenario (B, 1) column
        return x.expand(x.shape[:-1] + (N,))
    return x


def _assemble_e(sp, u_e, p, lam, mu, rho, grad_rho=None, nn_need_U=True):
    """Entry-form GN system of the whole batch (all tube kinds).

    Returns:
      grad_e: list b of (B, S),
      D_e:    b x b nested list, lower triangle populated ((B, S) or 0.0),
      L_e:    b x b nested list of ((B, S-1) or 0.0), rows = stage k+1,
      U_e:    None (l1/l2) or list b of ((B, S, N) or 0.0), the
              sqrt(rho)-scaled dense tube-row Jacobian for the Woodbury
              correction.

    ``nn_need_U=False`` (NN tube) skips the full tube-net Jacobian and
    takes the exact gradient through one VJP.
    """
    if grad_rho is None:
        grad_rho = rho
    n, m, N, K = sp.n, sp.m, sp.N, sp.K
    b = n + 1 + m
    S = N + 1
    iw = n
    ref = u_e[0]
    B = ref.shape[0]
    dev, dt = ref.device, ref.dtype

    z_e, w, v_e = _split_e(u_e, sp)
    zk = [z[..., :-1] for z in z_e]
    h_dyn, h_ic, h_tube = _h_entries(sp, z_e, w, v_e, p)
    g_list = _g_entries(z_e, w, p, K)
    lam_dyn, lam_ic, lam_tube = _split_lam(sp, lam)
    zg, vg = _goals(sp, p)

    zeros_S = torch.zeros(B, S, dtype=dt, device=dev)
    ones_N = torch.ones(N, dtype=dt, device=dev)
    zero_1 = torch.zeros(1, dtype=dt, device=dev)
    one_head = torch.cat([ones_N, zero_1])
    one_tail = torch.cat([torch.zeros(N, dtype=dt, device=dev),
                          torch.ones(1, dtype=dt, device=dev)])
    one_s1 = torch.cat([zero_1, ones_N])
    e0 = torch.zeros(S, dtype=dt, device=dev)
    e0[0] = 1.0

    def pad_head(x):
        """(B, N), (B, 1) or scalar stage-k<N term -> (B, S) with 0 at
        stage N."""
        if _is0(x):
            return 0.0
        if isinstance(x, (int, float)) or x.shape[-1] != N:
            return x * one_head
        return F.pad(x, (0, 1))

    def shift1(x):
        """(B, N), (B, 1) or scalar stage-(k+1) term -> (B, S) with 0 at
        stage 0."""
        if _is0(x):
            return 0.0
        if isinstance(x, (int, float)) or x.shape[-1] != N:
            return x * one_s1
        return F.pad(x, (1, 0))

    grad = [0.0] * b
    D = [[0.0] * b for _ in range(b)]      # lower triangle (i >= j)
    L = [[0.0] * b for _ in range(b)]

    # ---- objective --------------------------------------------------------
    Qz = p.Lq @ p.Lq.transpose(-1, -2)
    Qzf = p.Lqf @ p.Lqf.transpose(-1, -2)
    Rv = p.Lr @ p.Lr.transpose(-1, -2)
    dz = [z_e[i] - zg[i] for i in range(n)]
    dv = [_sub(v_e[j], vg[j]) for j in range(m)]
    for i in range(n):
        for j in range(i + 1):
            D[i][j] = _add(D[i][j], Qz[:, i, j:j + 1] * one_head
                           + Qzf[:, i, j:j + 1] * one_tail)
        gz = 0.0
        for j in range(n):
            gz = _add(gz, dz[j] * Qz[:, j, i:i + 1])
        gzf = 0.0
        for j in range(n):
            gzf = _add(gzf, dz[j][:, -1:] * Qzf[:, j, i:i + 1])
        grad[i] = _add(grad[i], _add(gz * one_head, gzf * one_tail))
    for i in range(m):
        for j in range(i + 1):
            D[n + 1 + i][n + 1 + j] = _add(
                D[n + 1 + i][n + 1 + j], Rv[:, i, j:j + 1] * one_head)
        gv = 0.0
        for j in range(m):
            gv = _add(gv, _mul(dv[j], Rv[:, j, i:i + 1]))
        grad[n + 1 + i] = _add(grad[n + 1 + i], pad_head(gv))
    qw2 = _col(p.sqrt_qw) ** 2
    D[iw][iw] = _add(D[iw][iw], qw2 * torch.ones(S, dtype=dt, device=dev))
    grad[iw] = _add(grad[iw], qw2 * w)

    # ---- dynamics ---------------------------------------------------------
    A, Bj = p.rom.f_jac_entries(zk, v_e)
    lh = [lam_dyn[:, :, i] + grad_rho * h_dyn[i] for i in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = 0.0
            for l in range(n):
                acc = _add(acc, _mul(A[l][i], A[l][j]))
            D[i][j] = _add(D[i][j], _mul(rho, pad_head(acc)))
        D[i][i] = _add(D[i][i], rho * one_s1)
    for i in range(m):
        for j in range(i + 1):
            acc = 0.0
            for l in range(n):
                acc = _add(acc, _mul(Bj[l][i], Bj[l][j]))
            D[n + 1 + i][n + 1 + j] = _add(
                D[n + 1 + i][n + 1 + j], _mul(rho, pad_head(acc)))
    for i in range(m):          # cross (v_i, z_j): row v (later), col z
        for j in range(n):
            acc = 0.0
            for l in range(n):
                acc = _add(acc, _mul(A[l][j], Bj[l][i]))
            D[n + 1 + i][j] = _add(D[n + 1 + i][j], _mul(rho, pad_head(acc)))
    for i in range(n):
        for j in range(n):
            L[i][j] = _sub(L[i][j], _mul(rho, _bcast_N(A[i][j], N, ref)))
        for j in range(m):
            L[i][n + 1 + j] = _sub(
                L[i][n + 1 + j], _mul(rho, _bcast_N(Bj[i][j], N, ref)))
    for j in range(n):
        acc = 0.0
        for i in range(n):
            acc = _add(acc, _mul(A[i][j], lh[i]))
        grad[j] = _add(grad[j], pad_head(acc))
        grad[j] = _add(grad[j], shift1(-lh[j]))
    for j in range(m):
        acc = 0.0
        for i in range(n):
            acc = _add(acc, _mul(Bj[i][j], lh[i]))
        grad[n + 1 + j] = _add(grad[n + 1 + j], pad_head(acc))

    # ---- initial condition ------------------------------------------------
    for i in range(2):
        D[i][i] = _add(D[i][i], rho * e0)
        lh_ic = lam_ic[:, i:i + 1] + grad_rho * h_ic[i]
        grad[i] = _add(grad[i], lh_ic * e0)

    # ---- obstacles ---------------------------------------------------------
    mu_sk = mu.reshape(B, S, K)
    for k in range(K):
        g_k = g_list[k]
        act = torch.clamp_min(mu_sk[:, :, k] - rho * g_k, 0.0)
        act_grad = torch.clamp_min(mu_sk[:, :, k] - grad_rho * g_k, 0.0)
        arow = (act > 0.0).to(dt)
        dzc = [2.0 * (z_e[0] - p.obs_c[:, k, 0:1]),
               2.0 * (z_e[1] - p.obs_c[:, k, 1:2])]
        dwc = -2.0 * (p.obs_r[:, k:k + 1] + w)
        for a in range(2):
            for c in range(a + 1):
                D[a][c] = _add(D[a][c], rho * arow * dzc[a] * dzc[c])
            D[iw][a] = _add(D[iw][a], rho * arow * dzc[a] * dwc)
            grad[a] = _sub(grad[a], dzc[a] * act_grad)
        D[iw][iw] = _add(D[iw][iw], rho * arow * dwc * dwc)
        grad[iw] = _sub(grad[iw], dwc * act_grad)

    # ---- tube dynamics ------------------------------------------------------
    lh_t = lam_tube + grad_rho * h_tube
    U_e = None
    if sp.tube_kind in ("l1", "l2"):
        t_e = []
        for j in range(m):
            if sp.tube_kind == "l1":
                t_e.append(sp.scaling * torch.sign(v_e[j]))
            else:
                t_e.append(2.0 * sp.scaling * v_e[j])
        for i in range(m):
            for j in range(i + 1):
                D[n + 1 + i][n + 1 + j] = _add(
                    D[n + 1 + i][n + 1 + j], rho * pad_head(t_e[i] * t_e[j]))
        D[iw][iw] = _add(D[iw][iw], rho * one_s1)
        for j in range(m):
            L[iw][n + 1 + j] = _sub(L[iw][n + 1 + j], rho * t_e[j])
            grad[n + 1 + j] = _add(grad[n + 1 + j], pad_head(t_e[j] * lh_t))
        grad[iw] = _add(grad[iw], shift1(-lh_t))
    else:
        # NN one-shot: the tube rows Jt = [dfw/d(z0_rest, v), -I on w[1:]]
        # are dense across stages. GN keeps the banded D/L tube-free and
        # carries rho * Jt^T Jt as the Woodbury factor U = sqrt(rho) Jt^T.
        H_rev = p.e_hist.shape[-1]
        x_in = _nn_input(sp, z_e, v_e, p)                 # (B, n_in)
        if not nn_need_U:
            _, gvec = p.tube_params.value_and_vjp(x_in, lh_t)
            off = H_rev
            for i in range(2, n):
                grad[i] = _add(grad[i], gvec[:, off + i - 2:off + i - 1] * e0)
            off += n - 2
            for j in range(m):
                gv_j = gvec[:, off + H_rev: off + H_rev + N]
                grad[n + 1 + j] = _add(grad[n + 1 + j], pad_head(gv_j))
                off += H_rev + N
            grad[iw] = _add(grad[iw], shift1(-lh_t))
            grad = [g if not _is0(g) else zeros_S for g in grad]
            return grad, D, L, None
        _, J_full = p.tube_params.value_and_jacobian(x_in)   # (B, N, n_in)
        off = H_rev
        Jz = J_full[:, :, off: off + (n - 2)]
        off += n - 2
        Jv_list = []
        for j in range(m):
            Jv_list.append(J_full[:, :, off + H_rev: off + H_rev + N])
            off += H_rev + N
        sq = torch.sqrt(rho)[:, :, None]                  # (B, 1, 1)
        U_e = [0.0] * b
        for i in range(2, n):
            Ui = torch.zeros(B, S, N, dtype=dt, device=dev)
            Ui[:, 0, :] = Jz[:, :, i - 2]
            U_e[i] = sq * Ui
            grad[i] = _add(grad[i],
                           _sum(Jz[:, :, i - 2] * lh_t) * e0)
        for j in range(m):
            JvT = Jv_list[j].transpose(-1, -2)            # (B, stages, rows)
            U_e[n + 1 + j] = sq * F.pad(JvT, (0, 0, 0, 1))
            grad[n + 1 + j] = _add(grad[n + 1 + j],
                                   pad_head((JvT @ lh_t[:, :, None])[..., 0]))
        shift = torch.eye(S, N, dtype=dt, device=dev).roll(1, dims=0)
        U_e[iw] = -sq * shift
        grad[iw] = _add(grad[iw], shift1(-lh_t))

    grad = [g if not _is0(g) else zeros_S for g in grad]
    return grad, D, L, U_e


def _cap_psize(N):
    """Panel size for the blocked capacitance Cholesky (None -> library)."""
    return next((c for c in (10, 8, 6, 5, 4) if N % c == 0), None)


# ---------------------------------------------------------------------------
# entry-form block-Thomas factor + solve ("thomas")
# ---------------------------------------------------------------------------

def _chol_e(Sij, b):
    """Scalar Cholesky of a symmetric block given as lower-entry lists."""
    c = [[None] * b for _ in range(b)]
    for j in range(b):
        acc = Sij[j][j]
        for k in range(j):
            acc = _sub(acc, _mul(c[j][k], c[j][k]))
        d = torch.sqrt(torch.clamp_min(acc, 1e-12))
        c[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, b):
            acc2 = Sij[i][j] if i >= j else Sij[j][i]
            for k in range(j):
                acc2 = _sub(acc2, _mul(c[i][k], c[j][k]))
            c[i][j] = _mul(acc2, inv)
    return c


def _chol_solve_e(c, r, b):
    """Solve (L L^T) x = r with scalar entries; r entries may be 0.0."""
    y = [None] * b
    for i in range(b):
        acc = r[i]
        for k in range(i):
            acc = _sub(acc, _mul(c[i][k], y[k]))
        y[i] = 0.0 if _is0(acc) else acc / c[i][i]
    x = [None] * b
    for i in reversed(range(b)):
        acc = y[i]
        for k in range(i + 1, b):
            acc = _sub(acc, _mul(c[k][i], x[k]))
        x[i] = 0.0 if _is0(acc) else acc / c[i][i]
    return x


def factor_solve_entries(D_e, L_e, rhs_e, b):
    """Block-Thomas factor + forward/backward substitution, scalar entries.

    D_e: b x b lower lists of (B, S) tensors; L_e: b x b lists of
    ((B, S-1) or 0.0); rhs_e: list b of (B, S), or of (B, S, R) for R
    right-hand sides sharing the factor. Returns list b matching rhs.
    """
    multi = rhs_e[0].dim() == 3
    rhs = [r if multi else r[:, :, None] for r in rhs_e]  # (B, S, R)
    S = rhs[0].shape[1]
    Lmask = [[not _is0(L_e[i][j]) for j in range(b)] for i in range(b)]

    def coef(x, k):
        """Stage k of a coefficient entry as (B, 1) (or 0.0)."""
        return 0.0 if _is0(x) else x[:, k:k + 1]

    def fill(v, like):
        return torch.zeros_like(like) if _is0(v) else v

    c = _chol_e([[coef(D_e[i][j], 0) for j in range(i + 1)]
                 for i in range(b)], b)
    y = [fill(v, rhs[0][:, 0]) for v in
         _chol_solve_e(c, [r[:, 0] for r in rhs], b)]
    chol_all = [c]
    y_all = [y]
    for k in range(1, S):
        Lm = [[coef(L_e[i][j], k - 1) for j in range(b)] for i in range(b)]
        # W = S_prev^{-1} L^T, column j solves rhs[l] = L[j][l]
        W = [[None] * b for _ in range(b)]
        for j in range(b):
            if not any(Lmask[j][l] for l in range(b)):
                for l in range(b):
                    W[l][j] = 0.0
                continue
            col = _chol_solve_e(c, [Lm[j][l] for l in range(b)], b)
            for l in range(b):
                W[l][j] = col[l]
        Sk = [[None] * (i + 1) for i in range(b)]
        for i in range(b):
            for j in range(i + 1):
                acc = coef(D_e[i][j], k)
                for l in range(b):
                    acc = _sub(acc, _mul(Lm[i][l], W[l][j]))
                Sk[i][j] = acc
        c = _chol_e(Sk, b)
        ry = []
        for i in range(b):
            acc = rhs[i][:, k]
            for l in range(b):
                acc = _sub(acc, _mul(Lm[i][l], y[l]))
            ry.append(acc)
        y = [fill(v, rhs[0][:, k]) for v in _chol_solve_e(c, ry, b)]
        chol_all.append(c)
        y_all.append(y)

    # backward: x_k = y_k - chol_solve(c_k, L_k^T x_{k+1})
    x_next = y_all[-1]
    x_all = [None] * S
    x_all[-1] = x_next
    for k in range(S - 2, -1, -1):
        Lm = [[coef(L_e[i][j], k) for j in range(b)] for i in range(b)]
        r = []
        for i in range(b):
            acc = 0.0
            for l in range(b):
                acc = _add(acc, _mul(Lm[l][i], x_next[l]))
            r.append(acc)
        corr = _chol_solve_e(chol_all[k], r, b)
        x_next = [y_all[k][i] - corr[i] if not _is0(corr[i])
                  else y_all[k][i] for i in range(b)]
        x_all[k] = x_next
    out = [torch.stack([x_all[k][i] for k in range(S)], dim=1)
           for i in range(b)]
    return out if multi else [o[:, :, 0] for o in out]


# ---------------------------------------------------------------------------
# kernel routing (linsolve="pallas")
# ---------------------------------------------------------------------------
#
# The JAX package reaches its Pallas kernel through a custom_vmap rule that
# collects the vmapped scenarios into the kernel's lane dimension. Here the
# entries are batch-major already, so the entry lists go straight to the
# kernel wrappers (the hand-written CUDA kernels; their plain versions on
# CPU), symbolic zeros and all: the kernels read each entry in place and a
# structural zero as 0, and only the lower triangle of D.

# Read once, as in JAX (tests and chip_smoke.py set the attribute).
_PALLAS_MULTIRHS = os.environ.get("LGDT_PALLAS_MULTIRHS", "1") == "1"


# ---------------------------------------------------------------------------
# entry-form block cyclic reduction ("cr")
# ---------------------------------------------------------------------------
#
# Block-Thomas runs 2(S-1) dependent stage steps per solve. Cyclic
# reduction eliminates the odd-indexed stages level by level:
# ceil(log2(S)) levels, each a few elementwise ops over a halved stage
# axis, at 2-3x the operations. Stable for the SPD systems the
# freeze-masked GN assembly produces.

# "auto" linsolve switches to cyclic reduction at this stage count.
_CR_AUTO_MIN_S = 128


def _slc(x, sl):
    return 0.0 if _is0(x) else x[..., sl]


def _pad_last(x, front, back):
    if _is0(x) or (front == 0 and back == 0):
        return x
    return F.pad(x, (front, back))


def _full(x, like):
    """Entry x (tensor or 0.0) as a tensor of ``like``'s shape."""
    return torch.zeros_like(like) if _is0(x) else x.expand(like.shape)


def _solve_cols_e(c, M, b):
    """B^{-1} M for a full entry matrix M (columns solved independently)."""
    R = [[None] * b for _ in range(b)]
    for j in range(b):
        col = _chol_solve_e(c, [M[l][j] for l in range(b)], b)
        for l in range(b):
            R[l][j] = col[l]
    return R


def _transpose_e(A, b):
    return [[A[j][i] for j in range(b)] for i in range(b)]


def _matmul_e(A, Bm, b):
    C = [[0.0] * b for _ in range(b)]
    for i in range(b):
        for j in range(b):
            acc = 0.0
            for l in range(b):
                acc = _add(acc, _mul(A[i][l], Bm[l][j]))
            C[i][j] = acc
    return C


def _matvec_e(A, x, b):
    out = []
    for i in range(b):
        acc = 0.0
        for l in range(b):
            acc = _add(acc, _mul(A[i][l], x[l]))
        out.append(acc)
    return out


def cr_solve_entries(D_e, L_e, rhs_e, b):
    """Solve the symmetric block-tridiagonal system by cyclic reduction.

    The interface of ``factor_solve_entries`` for one right-hand side:
    ``D_e`` the b x b lower-entry lists of (..., S) diagonal blocks,
    ``L_e[i][j]`` entry (i, j) of the sub-diagonal block coupling stage
    k+1 to stage k ((..., S-1) or 0.0), ``rhs_e`` list b of (..., S).
    Returns the solution as a list b of (..., S).
    """
    S = rhs_e[0].shape[-1]
    if S == 1:
        c = _chol_e([[D_e[i][j] for j in range(i + 1)] for i in range(b)], b)
        x = _chol_solve_e(c, list(rhs_e), b)
        return [_full(v, rhs_e[0]) for v in x]

    S_o, S_e = S // 2, (S + 1) // 2     # odd-stage / even-stage counts
    n_lo = (S - 1) // 2                 # number of L_odd blocks

    B_ol = [[_slc(D_e[i][j], slice(1, None, 2)) for j in range(i + 1)]
            for i in range(b)]
    B_el = [[_slc(D_e[i][j], slice(0, None, 2)) for j in range(i + 1)]
            for i in range(b)]
    # A_{2j+1} (odd row 2j+1 <- even col 2j) and A_{2j+2} (even <- odd)
    A_ev = [[_slc(L_e[i][j], slice(0, None, 2)) for j in range(b)]
            for i in range(b)]
    A_od = [[_slc(L_e[i][j], slice(1, None, 2)) for j in range(b)]
            for i in range(b)]
    r_o = [_slc(r, slice(1, None, 2)) for r in rhs_e]
    r_ev = [_slc(r, slice(0, None, 2)) for r in rhs_e]

    c_o = _chol_e(B_ol, b)
    V = _solve_cols_e(c_o, A_ev, b)                 # B_o^{-1} A_{2j+1}
    y = [_full(v, r_o[0]) for v in _chol_solve_e(c_o, r_o, b)]

    c_ot = [[_slc(c_o[i][j], slice(0, n_lo)) for j in range(i + 1)]
            for i in range(b)]
    U = _solve_cols_e(c_ot, _transpose_e(A_od, b), b)  # B_o^{-1} A_{2j+2}^T

    # Schur terms onto the even stages
    T_r = _matmul_e(_transpose_e(A_ev, b), V, b)    # A^T B^{-1} A  at i=j
    A_odt = [[_slc(A_od[i][j], slice(0, n_lo)) for j in range(b)]
             for i in range(b)]
    T_l = _matmul_e(A_odt, U, b)                    # A B^{-1} A^T at i=j+1
    V_t = [[_slc(V[i][j], slice(0, n_lo)) for j in range(b)]
           for i in range(b)]
    A_new = _matmul_e(A_odt, V_t, b)                # couples even i, i-1
    A_new = [[0.0 if _is0(A_new[i][j]) else -A_new[i][j] for j in range(b)]
             for i in range(b)]

    D_new = [[None] * (i + 1) for i in range(b)]
    for i in range(b):
        for j in range(i + 1):
            acc = B_el[i][j]
            acc = _sub(acc, _pad_last(T_r[i][j], 0, S_e - S_o))
            acc = _sub(acc, _pad_last(T_l[i][j], 1, S_e - 1 - n_lo))
            D_new[i][j] = _full(acc, r_ev[0])

    t1 = _matvec_e(A_odt, [_slc(v, slice(0, n_lo)) for v in y], b)
    t2 = _matvec_e(_transpose_e(A_ev, b), y, b)
    r_new = []
    for i in range(b):
        acc = r_ev[i]
        acc = _sub(acc, _pad_last(t1[i], 1, S_e - 1 - n_lo))
        acc = _sub(acc, _pad_last(t2[i], 0, S_e - S_o))
        r_new.append(_full(acc, r_ev[0]))

    x_even = cr_solve_entries(D_new, A_new, r_new, b)

    # back-substitute the odd stages
    xe_a = [x[..., :S_o] for x in x_even]
    xe_b = [_pad_last(x[..., 1:1 + n_lo], 0, S_o - n_lo) for x in x_even]
    corr_a = _matvec_e(V, xe_a, b)
    U_p = [[_pad_last(U[i][j], 0, S_o - n_lo) for j in range(b)]
           for i in range(b)]
    corr_b = _matvec_e(U_p, xe_b, b)
    x_odd = [_full(_sub(_sub(y[i], corr_a[i]), corr_b[i]), r_o[0])
             for i in range(b)]

    # interleave even/odd back to stage order
    out = []
    for i in range(b):
        pair = torch.stack([x_even[i][..., :S_o], x_odd[i]], dim=-1)
        flat = pair.reshape(pair.shape[:-2] + (2 * S_o,))
        if S_e > S_o:
            flat = torch.cat([flat, x_even[i][..., -1:]], dim=-1)
        out.append(flat)
    return out


def _linsolve(cfg, S):
    linsolve = cfg.linsolve
    if linsolve == "auto":
        linsolve = "cr" if S >= _CR_AUTO_MIN_S else "thomas"
    return linsolve


# ---------------------------------------------------------------------------
# AL loop in entry form
# ---------------------------------------------------------------------------

def solve_staged_scalar(sp, p, u0, lb_u, ub_u, cfg: ALConfig = ALConfig(),
                        lam0=None, mu0=None, rho_init=None) -> ALSolution:
    """AL Gauss-Newton staged tube solve of a scenario batch.

    u0 (B, S, b) staged iterate; lb_u/ub_u broadcastable to it; lam0 (B, E),
    mu0 (B, I), rho_init (B,) or a float. Runs in full fp32 (TF32 off), as
    the JAX solver runs at ``default_matmul_precision("highest")``.
    """
    with fp32_matmul():
        return _solve_staged_scalar_impl(sp, p, u0, lb_u, ub_u, cfg,
                                         lam0, mu0, rho_init)


def _solve_staged_scalar_impl(sp, p, u0, lb_u, ub_u, cfg, lam0, mu0,
                              rho_init) -> ALSolution:
    n, m, N, K = sp.n, sp.m, sp.N, sp.K
    b = n + 1 + m
    S = N + 1
    E = N * n + 2 + N
    I = S * K
    B = u0.shape[0]
    dev, dt = u0.device, u0.dtype
    lb_u = lb_u.expand(B, S, b)
    ub_u = ub_u.expand(B, S, b)

    u0_e = tuple(u0[:, :, i] for i in range(b))
    lb_e = tuple(lb_u[:, :, i] for i in range(b))
    ub_e = tuple(ub_u[:, :, i] for i in range(b))
    eps_e = tuple(1e-9 + 1e-6 * (ub_e[i] - lb_e[i]) for i in range(b))

    def clip(x, i):
        return torch.minimum(torch.maximum(x, lb_e[i]), ub_e[i])

    lam = torch.zeros(B, E, dtype=dt, device=dev) if lam0 is None else lam0
    mu = torch.zeros(B, I, dtype=dt, device=dev) if mu0 is None else mu0
    if rho_init is None:
        rho = torch.full((B, 1), cfg.rho0, dtype=dt, device=dev)
    elif isinstance(rho_init, torch.Tensor):
        rho = rho_init.reshape(B, 1).to(dt)
    else:
        rho = torch.full((B, 1), float(rho_init), dtype=dt, device=dev)

    def residuals_of(u_e):
        z_e, w, v_e = _split_e(u_e, sp)
        h_dyn, h_ic, h_tube = _h_entries(sp, z_e, w, v_e, p)
        g_list = _g_entries(z_e, w, p, K)
        return z_e, w, v_e, h_dyn, h_ic, h_tube, g_list

    def flat_h(h_dyn, h_ic, h_tube):
        return torch.cat([torch.stack(h_dyn, dim=-1).reshape(B, -1),
                          torch.cat(h_ic, dim=-1), h_tube], dim=-1)

    def flat_g(g_list):
        return torch.stack(g_list, dim=-1).reshape(B, -1)

    def pg_norm(u_e, grad_e):
        gn = torch.zeros(B, 1, dtype=dt, device=dev)
        for i in range(b):
            pg = u_e[i] - clip(u_e[i] - grad_e[i], i)
            gn = torch.maximum(
                gn, torch.amax(torch.abs(pg), dim=-1, keepdim=True))
        return gn

    nn_refresh = cfg.nn_basis_refresh
    if isinstance(nn_refresh, str):
        if nn_refresh not in ("inner", "outer"):
            raise ValueError(
                "ALConfig.nn_basis_refresh must be 'inner', 'outer', or an "
                f"int >= 1; got {nn_refresh!r}")
    else:
        nn_refresh = int(nn_refresh)
        if nn_refresh < 1:
            raise ValueError(
                "ALConfig.nn_basis_refresh int value must be >= 1; got "
                f"{nn_refresh}")
    nn_frozen_basis = sp.tube_kind == "nn" and nn_refresh != "inner"
    nn_chunk = (cfg.inner_iters if nn_refresh == "outer"
                else nn_refresh if nn_frozen_basis else 0)
    psize = _cap_psize(N)

    def cap_factor(C):
        if psize is not None:
            return blocked_cholesky(C, p=psize)
        return torch.linalg.cholesky(C)

    def cap_solve(Lc, rhs):
        if psize is not None:
            return blocked_cho_solve(Lc, rhs, p=psize)
        return torch.cholesky_solve(rhs[..., None], Lc)[..., 0]

    def masked_system(u_e, grad_e, D_e, L_e, rho):
        """Bound-freeze mask + masked GN system."""
        fm = []
        for i in range(b):
            at_lb = (u_e[i] <= lb_e[i] + eps_e[i]) & (grad_e[i] > 0.0)
            at_ub = (u_e[i] >= ub_e[i] - eps_e[i]) & (grad_e[i] < 0.0)
            fm.append((~(at_lb | at_ub)).to(dt))
        reg = cfg.reg + 1e-6 * rho
        Dm = [[0.0] * b for _ in range(b)]
        for i in range(b):
            for j in range(i + 1):
                if _is0(D_e[i][j]) and i != j:
                    Dm[i][j] = torch.zeros(B, S, dtype=dt, device=dev)
                    continue
                v = _mul(D_e[i][j], fm[i] * fm[j])
                if i == j:
                    v = _add(v, (1.0 - fm[i]) + reg)
                Dm[i][j] = (v if not _is0(v)
                            else torch.zeros(B, S, dtype=dt, device=dev))
        Lm = [[0.0] * b for _ in range(b)]
        for i in range(b):
            for j in range(b):
                Lm[i][j] = _mul(L_e[i][j], fm[i][:, 1:] * fm[j][:, :-1])
        gf = [grad_e[i] * fm[i] for i in range(b)]
        return fm, Dm, Lm, gf

    linsolve = _linsolve(cfg, S)

    def msolve(Dm, Lm, rhs_m):
        if linsolve == "pallas" and _PALLAS_MULTIRHS:
            return block_tridiag_multirhs_entries(Dm, Lm, rhs_m, b)
        return factor_solve_entries(Dm, Lm, rhs_m, b)

    def solve1(Dm, Lm, rhs, cr=False):
        """One right-hand side; ``cr``: cyclic reduction may take it (the
        l1/l2 step, as in JAX)."""
        if linsolve == "pallas":
            return block_tridiag_solve_entries(Dm, Lm, rhs, b)
        if cr and linsolve == "cr":
            return cr_solve_entries(Dm, Lm, rhs, b)
        return factor_solve_entries(Dm, Lm, rhs, b)

    def capacitance(Um, Ru):
        C = torch.eye(N, dtype=dt, device=dev).expand(B, N, N)
        for i in range(b):
            if _is0(Um[i]):
                continue
            C = C + Um[i].transpose(-1, -2) @ Ru[i]
        return C

    def UT(Um_i, x):
        """Um_i^T x for (B, S, N) Um_i and (B, S) x -> (B, N)."""
        return (Um_i.transpose(-1, -2) @ x[:, :, None])[..., 0]

    def woodbury_basis(u_e, lam, mu, rho):
        """Frozen Woodbury basis (Um, Ru = Hb^{-1} U, chol of
        C = I + U^T Hb^{-1} U) for the NN tube rows."""
        grad_e, D_e, L_e, U_e = _assemble_e(sp, u_e, p, lam, mu, rho)
        fm, Dm, Lm, _ = masked_system(u_e, grad_e, D_e, L_e, rho)
        Um = [0.0 if _is0(U_e[i]) else U_e[i] * fm[i][:, :, None]
              for i in range(b)]
        rhs_m = [torch.zeros(B, S, N, dtype=dt, device=dev) if _is0(Um[i])
                 else Um[i] for i in range(b)]
        Ru = msolve(Dm, Lm, rhs_m)
        return Um, Ru, cap_factor(capacitance(Um, Ru))

    alphas = torch.pow(
        torch.tensor(cfg.ls_backtrack, dtype=dt, device=dev),
        torch.arange(cfg.ls_iters, dtype=dt, device=dev))[:, None, None]

    def inner_step(u_e, merit, lam, mu, rho, wb=None):
        # ``merit`` is carried: it equals _merit_e(u_e) (the accepted
        # candidate's value, or unchanged on a failed search).
        grad_e, D_e, L_e, U_e = _assemble_e(sp, u_e, p, lam, mu, rho,
                                            nn_need_U=wb is None)
        fm, Dm, Lm, gf = masked_system(u_e, grad_e, D_e, L_e, rho)

        if wb is not None:
            # Frozen basis: fresh banded solve of the gradient column only,
            # corrected through the basis built at the chunk's start.
            Um, Ru, cholC = wb
            Rg = solve1(Dm, Lm, [-g for g in gf])
            crhs = torch.zeros(B, N, dtype=dt, device=dev)
            for i in range(b):
                if _is0(Um[i]):
                    continue
                crhs = crhs - UT(Um[i], Rg[i])
            y_c = cap_solve(cholC, crhs)
            d_e = [Rg[i] + (Ru[i] @ y_c[:, :, None])[..., 0]
                   for i in range(b)]
        elif U_e is not None:
            # Exact rank-N Woodbury on the banded factorization:
            #   d = -(Rg - Ru (I + U^T Ru)^{-1} U^T Rg),  R* = Hb^{-1}[gf, U]
            Um = [0.0 if _is0(U_e[i]) else U_e[i] * fm[i][:, :, None]
                  for i in range(b)]
            rhs_m = [torch.cat(
                [gf[i][:, :, None],
                 torch.zeros(B, S, N, dtype=dt, device=dev) if _is0(Um[i])
                 else Um[i]], dim=2) for i in range(b)]
            sol_m = msolve(Dm, Lm, rhs_m)
            Rg = [s[:, :, 0] for s in sol_m]
            Ru = [s[:, :, 1:] for s in sol_m]
            C = capacitance(Um, Ru)
            crhs = torch.zeros(B, N, dtype=dt, device=dev)
            for i in range(b):
                if _is0(Um[i]):
                    continue
                crhs = crhs + UT(Um[i], Rg[i])
            y_c = cap_solve(cap_factor(C), crhs)
            d_e = [-(Rg[i] - (Ru[i] @ y_c[:, :, None])[..., 0])
                   for i in range(b)]
        else:
            d_e = solve1(Dm, Lm, [-g for g in gf], cr=True)
        d_e = [torch.where(fm[i] > 0.0, d_e[i], 0.0) for i in range(b)]

        dir_deriv = 0.0
        for i in range(b):
            dir_deriv = dir_deriv + _sum(grad_e[i] * d_e[i])

        # parallel Armijo backtracking over all candidate steps at once
        u_try = tuple(clip(u_e[i][None] + alphas * d_e[i][None], i)
                      for i in range(b))                  # (ls, B, S)
        m_trys = _merit_e(sp, u_try, p, lam, mu, rho)      # (ls, B, 1)
        ok = m_trys <= merit + cfg.armijo * alphas * dir_deriv
        idx = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
        any_ok = torch.any(ok, dim=0)                     # (B, 1)
        u_new = tuple(
            torch.where(any_ok,
                        torch.gather(u_try[i], 0, idx.expand(1, B, S))[0],
                        u_e[i]) for i in range(b))
        merit_new = torch.where(any_ok, torch.gather(m_trys, 0, idx)[0],
                                merit)
        return u_new, merit_new, pg_norm(u_e, grad_e)

    def inner_loop(u_e, merit, frozen, lam, mu, rho, steps, wb):
        for _ in range(steps):
            u3, m3, gnorm = inner_step(u_e, merit, lam, mu, rho, wb=wb)
            frozen2 = frozen | (gnorm < cfg.tol_grad * 0.1)
            u_e = tuple(torch.where(frozen, u_e[i], u3[i]) for i in range(b))
            merit = torch.where(frozen, merit, m3)
            frozen = frozen2
        return u_e, merit, frozen

    u_e = tuple(clip(u0_e[i], i) for i in range(b))
    prev_viol = torch.full((B, 1), float("inf"), dtype=dt, device=dev)
    converged = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    outer_used = torch.zeros(B, 1, dtype=torch.int32, device=dev)

    for _ in range(cfg.outer_iters):
        # One merit evaluation per outer seeds the carried value.
        merit = _merit_e(sp, u_e, p, lam, mu, rho)
        frozen = torch.zeros(B, 1, dtype=torch.bool, device=dev)
        u2 = u_e
        if nn_frozen_basis:
            done = 0
            while done < cfg.inner_iters:
                step = min(nn_chunk, cfg.inner_iters - done)
                wb = woodbury_basis(u2, lam, mu, rho)
                u2, merit, frozen = inner_loop(u2, merit, frozen, lam, mu,
                                               rho, step, wb)
                done += step
        else:
            u2, merit, frozen = inner_loop(u2, merit, frozen, lam, mu, rho,
                                           cfg.inner_iters, None)
        u_new = tuple(torch.where(converged, u_e[i], u2[i])
                      for i in range(b))

        z_e, w, v_e, h_dyn, h_ic, h_tube, g_list = residuals_of(u_new)
        h = flat_h(h_dyn, h_ic, h_tube)
        g = flat_g(g_list)
        viol = torch.maximum(
            torch.amax(torch.abs(h), dim=-1, keepdim=True),
            torch.amax(torch.clamp_min(-g, 0.0), dim=-1, keepdim=True))
        if cfg.penalty_only:
            lam_new, mu_new = lam, mu
        else:
            lam_new = torch.where(converged, lam, lam + rho * h)
            mu_new = torch.where(converged, mu,
                                 torch.clamp_min(mu - rho * g, 0.0))
        grow = viol > cfg.viol_reduction * prev_viol
        rho_new = torch.where(
            converged | ~grow, rho,
            torch.clamp_max(rho * cfg.rho_growth, cfg.rho_max))
        grad_e, _, _, _ = _assemble_e(sp, u_new, p, lam_new, mu_new, rho,
                                      grad_rho=0.0, nn_need_U=False)
        gnorm = pg_norm(u_new, grad_e)
        r2 = _objective_r2(sp, z_e, w, v_e, p)
        obj_scale = 1.0 + torch.sqrt(r2)
        now_conv = (viol < cfg.tol_feas) & (gnorm < cfg.tol_grad * obj_scale)
        outer_used = torch.where(converged, outer_used, outer_used + 1)
        converged = converged | now_conv
        u_e, lam, mu, rho, prev_viol = u_new, lam_new, mu_new, rho_new, viol

    z_e, w, v_e, h_dyn, h_ic, h_tube, g_list = residuals_of(u_e)
    grad_e, _, _, _ = _assemble_e(sp, u_e, p, lam, mu, rho, grad_rho=0.0,
                                  nn_need_U=False)
    r2 = _objective_r2(sp, z_e, w, v_e, p)
    x = torch.stack(u_e, dim=-1).reshape(B, -1)
    return ALSolution(
        x=x, lam=lam, mu=mu, viol=prev_viol[:, 0],
        grad_norm=pg_norm(u_e, grad_e)[:, 0], obj=0.5 * r2[:, 0],
        rho=rho[:, 0], converged=converged[:, 0],
        outer_used=outer_used[:, 0],
    )
