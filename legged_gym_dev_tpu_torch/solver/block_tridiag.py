"""Batched block-tridiagonal SPD factorization and solves: the plain
block-Thomas reference form.

Counterpart of ``legged_gym_dev_tpu/solver/block_tridiag.py``. The system
matrix is

    T[k, k] = D[k];  T[k+1, k] = L[k];  T[k, k+1] = L[k]^T,

with D (..., S, b, b) and L (..., S-1, b, b); any leading axes are batch
axes. The stage recursion is a Python loop over S on batched tensors (the
JAX module's ``lax.scan``); the small Cholesky and triangular solves are
unrolled over the static block size in the JAX module's order of
operations, so the rounding follows it. This is the array-form staged
solver's linear algebra and ``sim.dynamics.solve_qdd``'s Cholesky; the
entry-form solver's kernels (``ops/block_tridiag_kernels.py``) are held
against the same arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BTFactorization(NamedTuple):
    chol: torch.Tensor   # (..., S, b, b) Cholesky factors of Schur blocks
    L: torch.Tensor      # (..., S-1, b, b) original sub-diagonal blocks


def small_cholesky(M: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky of (..., b, b) for a small static b, pivots
    floored at 1e-12."""
    b = M.shape[-1]
    cols = []
    for j in range(b):
        acc = M[..., :, j]
        for k in range(j):
            acc = acc - cols[k] * cols[k][..., j:j + 1]
        d = torch.sqrt(torch.clamp(acc[..., j], min=1e-12))
        col = acc / d[..., None]
        # zero the strictly-upper part of this column
        mask = (torch.arange(b, device=M.device) >= j).to(M.dtype)
        cols.append(col * mask)
    return torch.stack(cols, dim=-1)


def _tri_solve_lower(Lm: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve L y = rhs with lower-triangular L (..., b, b), rhs
    (..., b[, k]); unrolled over b."""
    b = Lm.shape[-1]
    vec = rhs.ndim == Lm.ndim - 1
    if vec:
        rhs = rhs[..., None]
    ys = []
    for i in range(b):
        acc = rhs[..., i, :]
        for k in range(i):
            acc = acc - Lm[..., i, k][..., None] * ys[k]
        ys.append(acc / Lm[..., i, i][..., None])
    y = torch.stack(ys, dim=-2)
    return y[..., 0] if vec else y


def _tri_solve_upper_t(Lm: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = rhs (L lower-triangular), unrolled."""
    b = Lm.shape[-1]
    vec = rhs.ndim == Lm.ndim - 1
    if vec:
        rhs = rhs[..., None]
    xs = [None] * b
    for i in reversed(range(b)):
        acc = rhs[..., i, :]
        for k in range(i + 1, b):
            acc = acc - Lm[..., k, i][..., None] * xs[k]
        xs[i] = acc / Lm[..., i, i][..., None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def _chol_solve(c: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with a precomputed lower-triangular Cholesky factor."""
    return _tri_solve_upper_t(c, _tri_solve_lower(c, rhs))


def block_tridiag_factor(D: torch.Tensor, L: torch.Tensor) -> BTFactorization:
    """Block-Cholesky (Thomas) forward sweep,
    S_0 = D_0;  S_k = D_k - L_{k-1} S_{k-1}^{-1} L_{k-1}^T,
    returning the Cholesky factor of every Schur block."""
    S = D.shape[-3]
    chol = [small_cholesky(D[..., 0, :, :])]
    for k in range(1, S):
        Lk_1 = L[..., k - 1, :, :]
        # W = S_{k-1}^{-1} L_{k-1}^T via two triangular solves
        W = _chol_solve(chol[-1], Lk_1.transpose(-1, -2))
        chol.append(small_cholesky(D[..., k, :, :] - Lk_1 @ W))
    return BTFactorization(chol=torch.stack(chol, dim=-3), L=L)


def _substitute(fac: BTFactorization, R: torch.Tensor) -> torch.Tensor:
    """Forward then backward substitution for right-hand-side columns R
    (..., S, b, k)."""
    chol, L = fac
    S = chol.shape[-3]
    y = [_chol_solve(chol[..., 0, :, :], R[..., 0, :, :])]
    for k in range(1, S):
        y.append(_chol_solve(chol[..., k, :, :],
                             R[..., k, :, :] - L[..., k - 1, :, :] @ y[-1]))
    x = [None] * S
    x[-1] = y[-1]
    for k in reversed(range(S - 1)):
        x[k] = y[k] - _chol_solve(
            chol[..., k, :, :], L[..., k, :, :].transpose(-1, -2) @ x[k + 1])
    return torch.stack(x, dim=-3)


def block_tridiag_solve(fac: BTFactorization,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Forward then backward substitution with the factored system; rhs
    (..., S, b)."""
    return _substitute(fac, rhs[..., None])[..., 0]


def block_tridiag_matvec(D, L, x):
    """T x, for tests and refinement."""
    out = torch.einsum("...sij,...sj->...si", D, x)
    lower = torch.einsum("...sij,...sj->...si", L, x[..., :-1, :])
    upper = torch.einsum("...sji,...sj->...si", L, x[..., 1:, :])
    zero = torch.zeros_like(x[..., :1, :])
    return (out + torch.cat([zero, lower], dim=-2)
            + torch.cat([upper, zero], dim=-2))


def woodbury_solve(fac: BTFactorization, U: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """Solve (T + U U^T) x = rhs with T banded-factored and U
    (..., S, b, r):

        x = T^-1 rhs - T^-1 U (I + U^T T^-1 U)^-1 U^T T^-1 rhs,

    the one-shot NN tube rows (rank r = N), whose Jacobian couples every
    stage."""
    r = U.shape[-1]
    Tinv_rhs = block_tridiag_solve(fac, rhs)
    Tinv_U = _substitute(fac, U)       # the columns of U as extra rhs
    G = (torch.eye(r, dtype=U.dtype, device=U.device)
         + torch.einsum("...sbr,...sbq->...rq", U, Tinv_U))
    w = torch.einsum("...sbr,...sb->...r", U, Tinv_rhs)
    y = torch.linalg.solve(G, w[..., None])[..., 0]
    return Tinv_rhs - torch.einsum("...sbr,...r->...sb", Tinv_U, y)
