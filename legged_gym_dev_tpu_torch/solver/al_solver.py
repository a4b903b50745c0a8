"""Solver configuration and result of the augmented-Lagrangian solver.

Counterpart of ``legged_gym_dev_tpu/solver/al_solver.py``: ``ALConfig``
(every field and default unchanged) and ``ALSolution``. The generic dense
``solve_al`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


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
    # "auto" = "thomas" below 128 stages, "cr" from there;
    # "cr" = block cyclic reduction, not ported yet (raises).
    linsolve: str = "auto"
    # NN-oneshot Woodbury basis refresh: "inner" (exact, every inner step),
    # "outer" (once per outer), or an int k >= 1 (every k inner steps).
    nn_basis_refresh: object = "inner"


class ALSolution(NamedTuple):
    """Batch-leading solver result: one row per scenario."""

    x: torch.Tensor            # (B, S*b) staged iterate, stage-major
    lam: torch.Tensor          # (B, E) equality multipliers
    mu: torch.Tensor           # (B, I) inequality multipliers (>= 0)
    viol: torch.Tensor         # (B,) max constraint violation
    grad_norm: torch.Tensor    # (B,) projected-gradient inf-norm at x
    obj: torch.Tensor          # (B,) objective value
    rho: torch.Tensor          # (B,) final penalty
    converged: torch.Tensor    # (B,) bool
    outer_used: torch.Tensor   # (B,) outer iterations until convergence
