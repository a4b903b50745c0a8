#!/usr/bin/env python3
"""How far rounding alone moves the plans of chip_smoke.py's reference check.

Solves chip_smoke.py's reference batch (bench.py's gap problem, B=8, N=50,
an 8x6 AL schedule, numpy seed 2; l1 and NN_oneshot) twice on the CPU
through the port's plain block-tridiagonal versions: once as they are
(each substitution divides by the pivot) and once with each substitution
multiplying by the pivot's reciprocal instead, the rounding of a kernel
that uses uncorrected reciprocal pivots. Prints each scenario's max |dz|
and the batch's max |dw| between the two. CPU only; a few minutes.

Usage: ``python3 scripts/torch_ref_rounding.py``
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk  # noqa: E402
from legged_gym_dev_tpu_torch.solver import (  # noqa: E402
    ALConfig,
    solve_tube_fast_batched,
)

DIVIDE = btk._cho_solve_plain


def reciprocal_cho_solve(c, r):
    """_cho_solve_plain with a * (1 / c_ii) in place of a / c_ii."""
    b = c.shape[-1]
    rp = 1.0 / torch.diagonal(c, dim1=-2, dim2=-1)[..., None]
    y = [None] * b
    for i in range(b):
        acc = r[:, i]
        for k in range(i):
            acc = acc - c[:, i, k, None] * y[k]
        y[i] = acc * rp[:, i]
    x = [None] * b
    for i in reversed(range(b)):
        acc = y[i]
        for k in range(i + 1, b):
            acc = acc - c[:, k, i, None] * x[k]
        x[i] = acc * rp[:, i]
    return torch.stack(x, dim=1)


def solve(tube):
    cfg = ALConfig(outer_iters=8, inner_iters=6, linsolve="pallas",
                   nn_basis_refresh=(3 if tube == "NN_oneshot" else "inner"))
    p = cs.bench_batch(8, tube, torch.device("cpu"), seed=2)
    return solve_tube_fast_batched(p, cs.N, cs.H_REV, tube_kind=tube,
                                   scaling=0.5, cfg=cfg,
                                   warm_start="interpolate",
                                   tube_ws="evaluate", device="cpu")


def main():
    for tube in ("l1", "NN_oneshot"):
        btk._cho_solve_plain = DIVIDE
        ref = solve(tube)
        btk._cho_solve_plain = reciprocal_cho_solve
        rec = solve(tube)
        btk._cho_solve_plain = DIVIDE
        dz = (ref.z - rec.z).abs().amax(dim=(1, 2))
        dw = float((ref.w - rec.w).abs().max())
        print(f"{tube}: max|dz| per scenario "
              + " ".join(f"{v:.3e}" for v in dz.tolist())
              + f"; max|dw| {dw:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
