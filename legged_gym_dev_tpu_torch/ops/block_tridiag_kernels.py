"""Batched SPD block-tridiagonal solves: CUDA kernels and plain versions.

Counterpart of ``legged_gym_dev_tpu/ops/pallas_block_tridiag.py``. The
system per scenario has diagonal blocks ``D_k`` (b x b, symmetric) and
sub-diagonal blocks ``L_k`` coupling stage k+1 (rows) to stage k (columns);
it is solved by the block-Thomas recursion: Cholesky factors of the Schur
complements ``S_k = D_k - L_k S_{k-1}^{-1} L_k^T`` (pivots floored at
1e-12), then forward and backward substitution.

Wrappers keep the JAX package's public layouts:

- ``block_tridiag_solve_entries``: entry lists of (B, S) tensors, one
  right-hand side (kernel ``bt_solve``; the TPU's ``_bt_kernel``).
- ``block_tridiag_solve``: array form (B, S, b, b); a second wrapper over
  the same ``bt_solve`` kernel.
- ``block_tridiag_multirhs_entries``: entry lists with (B, S, R) right-hand
  sides; factor once (kernel ``bt_factor``), then substitute R columns
  (kernel ``bt_msolve``).

On CUDA tensors a wrapper launches its kernel (``csrc/block_tridiag.cu``,
built at first use) or raises; on CPU tensors, and only there, it runs the
plain PyTorch version beside it. Each kernel counts its launches.
"""
from __future__ import annotations

import torch

from . import _build

SUPPORTED_B = (3, 4, 5, 6, 7, 8)   # block sizes the CUDA source instantiates


SOURCE = "block_tridiag.cu"
BT_SOLVE = _build.Kernel(SOURCE, "bt_solve", n_ptr=5, n_int=3)
BT_FACTOR = _build.Kernel(SOURCE, "bt_factor", n_ptr=3, n_int=3)
BT_MSOLVE = _build.Kernel(SOURCE, "bt_msolve", n_ptr=4, n_int=4)
KERNELS = {"bt_solve": BT_SOLVE, "bt_factor": BT_FACTOR,
           "bt_msolve": BT_MSOLVE}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# plain PyTorch versions: block-Thomas over (B, b, b) blocks
# ---------------------------------------------------------------------------

def _bmm(A, Bm):
    """Exact-fp32 small-block product (no TF32 whatever the global flags)."""
    return (A.unsqueeze(-1) * Bm.unsqueeze(-3)).sum(-2)


def _chol_plain(M):
    """Lower Cholesky of (B, b, b) blocks (lower triangle read), column by
    column with pivots floored at 1e-12, as the kernels do."""
    b = M.shape[-1]
    c = torch.zeros_like(M)
    for j in range(b):
        acc = M[:, j:, j]
        for k in range(j):
            acc = acc - c[:, j:, k] * c[:, j:j + 1, k]
        d = torch.sqrt(torch.clamp_min(acc[:, :1], 1e-12))
        c[:, j:, j] = acc * (1.0 / d)
    return c


def _cho_solve_plain(c, r):
    """Solves (c c^T) x = r for (B, b, b) lower c and (B, b, R) r."""
    b = c.shape[-1]
    y = [None] * b
    for i in range(b):
        acc = r[:, i]
        for k in range(i):
            acc = acc - c[:, i, k, None] * y[k]
        y[i] = acc / c[:, i, i, None]
    x = [None] * b
    for i in reversed(range(b)):
        acc = y[i]
        for k in range(i + 1, b):
            acc = acc - c[:, k, i, None] * x[k]
        x[i] = acc / c[:, i, i, None]
    return torch.stack(x, dim=1)


def _factor_plain(D, L):
    """Per-stage factors of D (B, S, b, b), L (B, S-1, b, b): list of S."""
    c = _chol_plain(D[:, 0])
    chol = [c]
    for k in range(1, D.shape[1]):
        Lk = L[:, k - 1]
        W = _cho_solve_plain(c, Lk.transpose(-1, -2))
        c = _chol_plain(D[:, k] - _bmm(Lk, W))
        chol.append(c)
    return chol


def _substitute_plain(chol, L, rhs):
    """Forward + backward substitution of rhs (B, S, b, R)."""
    S = rhs.shape[1]
    y = [_cho_solve_plain(chol[0], rhs[:, 0])]
    for k in range(1, S):
        y.append(_cho_solve_plain(chol[k],
                                  rhs[:, k] - _bmm(L[:, k - 1], y[k - 1])))
    x = [None] * S
    x[S - 1] = y[S - 1]
    for k in range(S - 2, -1, -1):
        r = _bmm(L[:, k].transpose(-1, -2), x[k + 1])
        x[k] = y[k] - _cho_solve_plain(chol[k], r)
    return torch.stack(x, dim=1)


def _blocks(E):
    """b x b nested list of (B, T) -> (B, T, b, b)."""
    return torch.stack([torch.stack(row, dim=-1) for row in E], dim=-2)


def block_tridiag_solve_entries_plain(D_full, L_full, rhs, b: int):
    x = _substitute_plain(_factor_plain(_blocks(D_full), _blocks(L_full)),
                          _blocks(L_full),
                          torch.stack(rhs, dim=-1)[..., None])
    return list(x[..., 0].unbind(-1))


def block_tridiag_solve_plain(D, L, rhs):
    return _substitute_plain(_factor_plain(D, L), L, rhs[..., None])[..., 0]


def block_tridiag_multirhs_entries_plain(D_full, L_full, rhs_cols, b: int):
    Lb = _blocks(L_full)
    x = _substitute_plain(_factor_plain(_blocks(D_full), Lb), Lb,
                          torch.stack(rhs_cols, dim=2))
    return list(x.unbind(2))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor, b: int) -> bool:
    """True for CUDA tensors (kernel), False for CPU ones (plain version);
    raises for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    if b not in SUPPORTED_B:
        raise ValueError(f"block size {b} is not one of {SUPPORTED_B}")
    return True


def _check(x: torch.Tensor, shape, device):
    if x.dtype != torch.float32 or x.device != device:
        raise TypeError(f"expected float32 on {device}, got {x.dtype} on "
                        f"{x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _stage_major(entries, B, T, device):
    """List of (B, T) entries -> contiguous (T, len, B)."""
    for e in entries:
        _check(e, (B, T), device)
    return torch.stack([e.t() for e in entries], dim=1)


def _lower(D_full, b):
    return [D_full[i][j] for i in range(b) for j in range(i + 1)]


def _flat(L_full, b):
    return [L_full[i][j] for i in range(b) for j in range(b)]


def _ptr(t: torch.Tensor):
    return t.data_ptr() or None


def _launch_solve(Dt, Lt, rt, S, B, b):
    """bt_solve on stage-major tensors: Dt (S, NL, B), Lt (S-1, b*b, B),
    rt (S, b, B) -> x (S, b, B)."""
    x = torch.empty_like(rt)
    chol = torch.empty((S, b * (b + 1) // 2, B), dtype=torch.float32,
                       device=rt.device)
    BT_SOLVE([_ptr(Dt), _ptr(Lt), _ptr(rt), _ptr(x), _ptr(chol)],
             [S, B, b], rt.device)
    return x


def block_tridiag_solve_entries(D_full, L_full, rhs, b: int):
    """Batched solve from entry form (the staged solver's layout).

    D_full: b x b nested list of (B, S) (full symmetric blocks; the kernel
    reads the lower triangle); L_full: b x b nested list of (B, S-1);
    rhs: list b of (B, S). Returns list b of (B, S).
    """
    if not _on_cuda(rhs[0], b):
        return block_tridiag_solve_entries_plain(D_full, L_full, rhs, b)
    B, S = rhs[0].shape
    dev = rhs[0].device
    x = _launch_solve(_stage_major(_lower(D_full, b), B, S, dev),
                      _stage_major(_flat(L_full, b), B, S - 1, dev),
                      _stage_major(list(rhs), B, S, dev), S, B, b)
    return list(x.permute(1, 2, 0).contiguous().unbind(0))


def block_tridiag_solve(D, L, rhs):
    """Batched solve from array form: D (B, S, b, b), L (B, S-1, b, b),
    rhs (B, S, b) -> x (B, S, b)."""
    B, S, b, _ = D.shape
    if not _on_cuda(rhs, b):
        return block_tridiag_solve_plain(D, L, rhs)
    _check(D, (B, S, b, b), rhs.device)
    _check(L, (B, S - 1, b, b), rhs.device)
    _check(rhs, (B, S, b), rhs.device)
    il, jl = torch.tril_indices(b, b, device=D.device)
    Dt = D[:, :, il, jl].permute(1, 2, 0).contiguous()
    Lt = L.reshape(B, S - 1, b * b).permute(1, 2, 0).contiguous()
    rt = rhs.permute(1, 2, 0).contiguous()
    return _launch_solve(Dt, Lt, rt, S, B, b).permute(2, 0, 1)


def block_tridiag_multirhs_entries(D_full, L_full, rhs_cols, b: int):
    """Batched multi-RHS solve from entry form: factor once, then
    substitute every column.

    D_full/L_full as in ``block_tridiag_solve_entries``; rhs_cols: list b
    of (B, S, R). Returns list b of (B, S, R).
    """
    if not _on_cuda(rhs_cols[0], b):
        return block_tridiag_multirhs_entries_plain(D_full, L_full,
                                                    rhs_cols, b)
    B, S, R = rhs_cols[0].shape
    dev = rhs_cols[0].device
    Dt = _stage_major(_lower(D_full, b), B, S, dev)
    Lt = _stage_major(_flat(L_full, b), B, S - 1, dev)
    for r in rhs_cols:
        _check(r, (B, S, R), dev)
    rt = torch.stack(list(rhs_cols), dim=0)              # (b, B, S, R)
    chol = torch.empty((S, b * (b + 1) // 2, B), dtype=torch.float32,
                       device=dev)
    BT_FACTOR([_ptr(Dt), _ptr(Lt), _ptr(chol)], [S, B, b], dev)
    x = torch.empty_like(rt)
    BT_MSOLVE([_ptr(chol), _ptr(Lt), _ptr(rt), _ptr(x)], [S, B, R, b], dev)
    return list(x.unbind(0))
