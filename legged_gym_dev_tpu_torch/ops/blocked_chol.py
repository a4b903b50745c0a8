"""Blocked batched Cholesky for the (B, N, N) Woodbury capacitance systems.

Counterpart of ``legged_gym_dev_tpu/ops/blocked_chol.py``, which is plain
jnp there (no Pallas kernel): the same panel-by-panel factorization with
an unrolled scalar-entry panel Cholesky (pivots floored at 1e-30), an
unrolled right-triangular panel solve and one batched product per panel.
"""
from __future__ import annotations

import torch


def _chol_panel(P):
    """Unrolled Cholesky of a (..., p, p) SPD block via scalar entries."""
    p = P.shape[-1]
    c = [[None] * p for _ in range(p)]
    for j in range(p):
        acc = P[..., j, j]
        for k in range(j):
            acc = acc - c[j][k] * c[j][k]
        d = torch.sqrt(torch.clamp_min(acc, 1e-30))
        c[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, p):
            a = P[..., i, j]
            for k in range(j):
                a = a - c[i][k] * c[j][k]
            c[i][j] = a * inv
    zero = torch.zeros_like(c[0][0])
    rows = [torch.stack([c[i][j] if j <= i else zero for j in range(p)],
                        dim=-1) for i in range(p)]
    return torch.stack(rows, dim=-2)


def _solve_right_lowerT(T, Lp):
    """X = T @ Lp^{-T} for (..., r, p) T and (..., p, p) lower Lp."""
    p = Lp.shape[-1]
    cols = []
    for j in range(p):
        acc = T[..., :, j]
        for k in range(j):
            acc = acc - cols[k] * Lp[..., j, k][..., None]
        cols.append(acc / Lp[..., j, j][..., None])
    return torch.stack(cols, dim=-1)


def blocked_cholesky(C, p: int = 10):
    """Lower Cholesky factor of (..., n, n) SPD C with panel size p
    (n must be a multiple of p)."""
    n = C.shape[-1]
    if n % p:
        raise ValueError(f"panel size {p} does not divide n={n}")
    lead = C.shape[:-2]
    done = C.new_zeros(lead + (n, 0))
    for k0 in range(0, n, p):
        k1 = k0 + p
        Lrow_prev = done[..., k0:k1, :]
        P = C[..., k0:k1, k0:k1] - Lrow_prev @ Lrow_prev.transpose(-1, -2)
        Lp = _chol_panel(P)
        if k1 < n:
            Ltr_prev = done[..., k1:, :]
            T = C[..., k1:, k0:k1] - Ltr_prev @ Lrow_prev.transpose(-1, -2)
            X = _solve_right_lowerT(T, Lp)
        else:
            X = C.new_zeros(lead + (0, p))
        col = torch.cat([C.new_zeros(lead + (k0, p)), Lp, X], dim=-2)
        done = torch.cat([done, col], dim=-1)
    return done


def blocked_cho_solve(L, rhs, p: int = 10):
    """Solve L L^T x = rhs for (..., n, n) lower L and rhs (..., n) or
    (..., n, k)."""
    n = L.shape[-1]
    vec = rhs.ndim == L.ndim - 1
    b = rhs[..., None] if vec else rhs
    ys = []
    for k0 in range(0, n, p):
        k1 = k0 + p
        acc = b[..., k0:k1, :]
        if k0:
            acc = acc - L[..., k0:k1, :k0] @ torch.cat(ys, dim=-2)
        Lp = L[..., k0:k1, k0:k1]
        rows = []
        for i in range(p):
            a = acc[..., i, :]
            for j in range(i):
                a = a - rows[j] * Lp[..., i, j][..., None]
            rows.append(a / Lp[..., i, i][..., None])
        ys.append(torch.stack(rows, dim=-2))
    y = torch.cat(ys, dim=-2)
    xs_rev = []
    for bi in range(n // p - 1, -1, -1):
        k0, k1 = bi * p, bi * p + p
        acc = y[..., k0:k1, :]
        if k1 < n:
            x_below = torch.cat(list(reversed(xs_rev)), dim=-2)
            acc = acc - L[..., k1:, k0:k1].transpose(-1, -2) @ x_below
        Lp = L[..., k0:k1, k0:k1]
        rows = [None] * p
        for i in reversed(range(p)):
            a = acc[..., i, :]
            for j in range(i + 1, p):
                a = a - rows[j] * Lp[..., j, i][..., None]
            rows[i] = a / Lp[..., i, i][..., None]
        xs_rev.append(torch.stack(rows, dim=-2))
    x = torch.cat(list(reversed(xs_rev)), dim=-2)
    return x[..., 0] if vec else x
