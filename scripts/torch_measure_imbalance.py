"""Per-shard load imbalance of the staged solve, on the PyTorch/CUDA port.

The counterpart of ``scripts/measure_imbalance.py`` on
``legged_gym_dev_tpu_torch``. The staged AL solve runs a fixed
outer x inner schedule (converged scenarios freeze their updates but
still run every iteration), so a shard's wall should not depend on how
hard its scenarios are: the same operations on the same shapes. This
splits the bench batch (B=2048, the ``gap`` problem with z0, zf and the
obstacles moved by ``default_rng(0)``) into SHARDS slices, what a mesh of
that many cards would give each, solves each slice in turn on one card
(``solve_tube_fast_batched``, l1, 20x10, ``linsolve`` from BENCH_LINSOLVE:
"pallas", the CUDA kernel ``bt_solve``, by default), and reports the
spread of their walls and of the outer iterations used. Straggler
penalty = the slowest slice's wall over the mean, less 1. One untimed
solve of the first slice, then 3 timed solves a slice, the least kept.

Run on the card:  python scripts/torch_measure_imbalance.py
On the CPU:       E2E_CPU=1 B=16 SHARDS=2 \\
                  python scripts/torch_measure_imbalance.py
Environment knobs (the JAX file's): B (2048), SHARDS (8), BENCH_LINSOLVE
(pallas). ``--reps`` cuts the timed solves. ``main`` prints the JAX
file's JSON line and returns it as a dict.
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    gap_params,
    parse,
    print_launches,
    reset_launches,
    sync,
)

from legged_gym_dev_tpu_torch.solver import ALConfig  # noqa: E402

REPS = 3


def imbalance(walls) -> tuple:
    """The JAX file's (wall spread, straggler penalty in %) of the slices'
    walls: max / mean - 1, rounded as it rounds them."""
    walls = np.asarray(walls)
    spread = float(walls.max() / walls.mean() - 1.0)
    return round(spread, 4), round(100 * spread, 2)


def measure_imbalance(B: int = 2048, shards: int = 8,
                      cfg: ALConfig = ALConfig(linsolve="pallas"),
                      N: int = N, H_rev: int = H_REV, reps: int = REPS,
                      device=None) -> dict:
    from legged_gym_dev_tpu_torch.solver.fast_tube import (
        solve_tube_fast_batched,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    Bs = B // shards
    p = gap_params(B, 0, ("z0", "zf", "obs_c", "obs_r"), dev, N=N,
                   H_rev=H_rev)

    def solve(pp):
        return solve_tube_fast_batched(pp, N, H_rev, tube_kind="l1",
                                       scaling=0.5, cfg=cfg,
                                       warm_start="interpolate", device=dev)

    def shard(i):
        """Scenarios [i Bs, (i+1) Bs): every batch-leading tensor's rows
        (the ROM and the tube are shared)."""
        rows = slice(i * Bs, (i + 1) * Bs)
        return p.replace(**{
            f.name: getattr(p, f.name)[rows]
            for f in dataclasses.fields(p)
            if isinstance(getattr(p, f.name), torch.Tensor)})

    reset_launches()
    solve(shard(0))                  # the kernels' build and first launches
    walls, outers = [], []
    for i in range(shards):
        sh = shard(i)
        ts = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = solve(sh)
            sync(dev)
            ts.append(time.perf_counter() - t0)
        walls.append(min(ts))
        ou = out.sol.outer_used.cpu().numpy()
        outers.append((float(ou.mean()), float(np.percentile(ou, 90)),
                       int(ou.max())))
    spread, penalty = imbalance(walls)
    rec = {
        "shards": shards, "per_shard_batch": Bs,
        "wall_ms": [round(w * 1e3, 2) for w in walls],
        "wall_spread": spread,
        "straggler_penalty_pct": penalty,
        "outer_used_mean_p90_max": outers,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    args = parse(argv, __doc__)
    rec = measure_imbalance(
        B=int(os.environ.get("B", "2048")),
        shards=int(os.environ.get("SHARDS", "8")),
        cfg=ALConfig(linsolve=os.environ.get("BENCH_LINSOLVE", "pallas")),
        reps=args.reps or REPS, device=args.device)
    rec["launches"] = print_launches()
    return rec


if __name__ == "__main__":
    main()
