"""Two-phase batched solve with convergence compaction ("bucketing").

Counterpart of ``legged_gym_dev_tpu/solver/bucketed.py``. The staged
solver freezes converged scenarios but still runs the full outer schedule
for them. This module splits the schedule:

- phase 1: the first ``phase1_outers`` outer iterations on the whole batch;
- compaction: the scenarios not yet converged are gathered into the
  smallest power-of-two bucket of at least 128 (a host round trip on the
  converged mask, by design, as in the JAX package);
- phase 2: the remaining outer iterations on the bucket only, resumed from
  phase 1's iterate, multipliers and penalty, then scattered back.

Only the penalty-growth hysteresis (``prev_viol``) restarts at the phase
boundary, so iterates can differ from the single-phase solve within solver
tolerance: parity is on feasibility statistics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.runtime import resolve_device
from .al_solver import ALConfig
from .fast_tube import (
    _staged_problem,
    solve_tube_fast,
    solve_tube_fast_single,
    staged_bounds,
    unpack_staged,
)
from .trajopt import TrajOptParams, TrajOptSolution


def _next_bucket(n: int, minimum: int = 128) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _take(p: TrajOptParams, rows: torch.Tensor) -> TrajOptParams:
    """The scenarios ``rows`` of a batch, a per-scenario ROM's and tube
    net's among them (shared ones serve every scenario)."""
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, torch.Tensor):
            v = v[rows]
        elif f.name == "rom" or getattr(v, "per_scenario", False):
            v = v.select(rows)
        kw[f.name] = v
    return TrajOptParams(**kw)


def solve_tube_fast_bucketed(
    p_batch: TrajOptParams,
    N: int,
    H_rev: int,
    tube_kind: str = "l1",
    scaling: float = 0.5,
    cfg: ALConfig = ALConfig(),
    phase1_outers: int = 16,
    warm_start: str = "interpolate",
    tube_ws="evaluate",
    device=None,
):
    """Bucketed twin of ``solve_tube_fast_batched`` on ``device`` (None =
    the CUDA card). Returns (TrajOptSolution, stats dict)."""
    assert 0 < phase1_outers < cfg.outer_iters
    p_batch = p_batch.to(resolve_device(device))
    cfg1 = dataclasses.replace(cfg, outer_iters=phase1_outers)
    cfg2 = dataclasses.replace(cfg,
                               outer_iters=cfg.outer_iters - phase1_outers)
    out1 = solve_tube_fast(p_batch, N, H_rev, tube_kind=tube_kind,
                           scaling=scaling, cfg=cfg1, warm_start=warm_start,
                           tube_ws=tube_ws)

    conv = out1.sol.converged.cpu().numpy()
    B = conv.shape[0]
    idx = np.nonzero(~conv)[0]
    stats = {"B": B, "unconverged_after_phase1": int(idx.size)}
    if idx.size == 0:
        return out1, stats

    bucket = min(_next_bucket(idx.size), B)
    stats["bucket"] = bucket
    dev = p_batch.device
    pad = torch.as_tensor(
        np.concatenate([idx, np.zeros(bucket - idx.size, np.int64)]),
        device=dev)
    sp = _staged_problem(p_batch, N, tube_kind, scaling, False)
    b = sp.n + 1 + sp.m
    p_sub = _take(p_batch, pad)
    # phase 2 clips to scenario 0's bounds, as the JAX package's does
    # (shared bounds; they differ only for a per-scenario ROM or w_max)
    lb_u, ub_u = staged_bounds(_take(p_batch, pad[:1] * 0), sp.n, sp.m, N)
    s1 = out1.sol
    sol2 = solve_tube_fast_single(
        sp, p_sub, s1.x.reshape(B, N + 1, b)[pad], lb_u, ub_u, cfg2,
        lam0=s1.lam[pad], mu0=s1.mu[pad], rho_init=s1.rho[pad])

    take = torch.as_tensor(idx, device=dev)
    n_take = idx.size

    def scatter(full, part):
        out = full.clone()
        out[take] = part[:n_take]
        return out

    sol = s1._replace(
        x=scatter(s1.x, sol2.x), lam=scatter(s1.lam, sol2.lam),
        mu=scatter(s1.mu, sol2.mu), viol=scatter(s1.viol, sol2.viol),
        grad_norm=scatter(s1.grad_norm, sol2.grad_norm),
        obj=scatter(s1.obj, sol2.obj), rho=scatter(s1.rho, sol2.rho),
        converged=scatter(s1.converged, sol2.converged),
        outer_used=scatter(s1.outer_used,
                           sol2.outer_used + s1.outer_used[pad]))
    z, w, v = unpack_staged(sol.x.reshape(B, N + 1, b), sp.n, sp.m, N)
    return TrajOptSolution(z=z, v=v, w=w, sol=sol), stats
