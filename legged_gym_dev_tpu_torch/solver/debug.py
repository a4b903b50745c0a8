"""Solver observability: named columns, violation segmentation, iteration
CSV.

Counterpart of ``legged_gym_dev_tpu/solver/debug.py``: named decision and
constraint columns for post-mortems, per-constraint-family segmentation of
a solution's violations, and a per-iteration CSV of the solver trace
(``solve_al(..., return_trace=True)``). The port's violations are
batch-leading: one row per scenario, the columns last.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from .trajopt import TrajOptParams, build_nlp_fns, pack_x


def generate_col_names(n: int, m: int, N: int, n_obs: int,
                       with_tube: bool, H_rev: int = 0):
    """Named columns for the decision vector, the equality and inequality
    residuals and the scenario parameters: ``z_{k}_{i}`` / ``v_{k}_{i}`` /
    ``w_{k}``; h = [dyn, ic, tube], g = [obs].

    Returns (x_cols, h_cols, g_cols, p_cols).
    """
    x_cols = [f"z_{k}_{i}" for k in range(N + 1) for i in range(n)]
    x_cols += [f"v_{k}_{i}" for k in range(N) for i in range(m)]
    if with_tube:
        x_cols += [f"w_{k}" for k in range(N + 1)]

    h_cols = [f"dyn_{i}_{k}" for k in range(N) for i in range(n)]
    h_cols += [f"ic_{i}" for i in range(2)]
    if with_tube:
        h_cols += [f"tube_{k}" for k in range(N)]

    g_cols = [f"obs_{i}_{k}" for k in range(N + 1) for i in range(n_obs)]

    p_cols = [f"z_ic_{i}" for i in range(n)]
    p_cols += [f"z_g_{i}" for i in range(n)]
    p_cols += [f"obs_{i}_x" for i in range(n_obs)]
    p_cols += [f"obs_{i}_y" for i in range(n_obs)]
    p_cols += [f"obs_{i}_r" for i in range(n_obs)]
    if H_rev:
        p_cols += [f"e_{i}" for i in range(H_rev)]
        p_cols += [f"v_prev_{r}_{c}" for r in range(H_rev) for c in range(m)]
    return x_cols, h_cols, g_cols, p_cols


def compute_constraint_violation(p: TrajOptParams, z, v, w, N: int,
                                 tube_fn=None):
    """Per-constraint violations of candidate solutions z (B, N+1, n),
    v (B, N, m), w (B, N+1) or None: |h| for equalities, max(-g, 0) for
    inequalities. Returns (viol_h (B, E), viol_g (B, I)) numpy arrays
    aligned with ``generate_col_names``' h_cols / g_cols."""
    n, m = p.rom.n, p.rom.m
    with_tube = w is not None
    _, h_fn, g_fn = build_nlp_fns(n, m, N, with_tube, tube_fn=tube_fn)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=p.device)

    x = pack_x(t(z), t(v), t(w) if with_tube else None)
    with torch.no_grad():
        viol_h = np.abs(h_fn(x, p).cpu().numpy())
        viol_g = np.maximum(-g_fn(x, p).cpu().numpy(), 0.0)
    return viol_h, viol_g


def segment_constraint_violation(viol_h, viol_g, h_cols,
                                 g_cols) -> Dict[str, np.ndarray]:
    """Split violations (columns last) by constraint family: Dynamics,
    each obstacle, Initial Condition, Tube Dynamics."""
    viol_h = np.asarray(viol_h)
    viol_g = np.asarray(viol_g)
    seg = {
        "Dynamics": viol_h[..., [j for j, s in enumerate(h_cols)
                                 if s.startswith("dyn")]],
    }
    i = 0
    while True:
        idx = [j for j, s in enumerate(g_cols) if s.startswith(f"obs_{i}_")]
        if not idx:
            break
        seg[f"Obstacle {i}"] = viol_g[..., idx]
        i += 1
    seg["Initial Condition"] = viol_h[
        ..., [j for j, s in enumerate(h_cols) if s.startswith("ic")]]
    tube_idx = [j for j, s in enumerate(h_cols) if s.startswith("tube")]
    if tube_idx:
        seg["Tube Dynamics"] = viol_h[..., tube_idx]
    return seg


def trace_to_csv(trace: dict, path: str,
                 scenario: Optional[int] = None) -> str:
    """Write a solver iteration trace to CSV, one row per outer iteration.
    ``trace`` is the dict ``solve_al(..., return_trace=True)`` returns:
    each value (outer_iters,) for one scenario or (B, outer_iters) for a
    batch, of which ``scenario`` selects a row."""
    cols = sorted(trace.keys())
    arrs = {}
    for k in cols:
        a = trace[k]
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.ndim == 2:
            if scenario is None:
                raise ValueError(
                    "batched trace: pass scenario= to select one row")
            a = a[scenario]
        arrs[k] = a
    n_iter = len(next(iter(arrs.values())))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["iter"] + cols)
        for i in range(n_iter):
            writer.writerow([i] + [float(arrs[k][i]) for k in cols])
    return path
