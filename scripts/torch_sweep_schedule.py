"""Sweep the AL-GN iteration schedule at bench shapes, on the PyTorch/CUDA
port: throughput, feasibility, the outer iterations used, and the
solution's drift from the default schedule (an accuracy guard: the drift
must stay well under 1e-3).

The counterpart of ``scripts/sweep_schedule.py`` on
``legged_gym_dev_tpu_torch``. At B=1024 (the ``gap`` problem, z0, zf and
the obstacles moved by ``default_rng(0)``), ``solve_tube_fast_batched``
(l1, N=50) runs the default 20x10x10 schedule (outer x inner x line
search) and the JAX file's 15 others, on the kernel route
(``linsolve="pallas"``: the CUDA kernel ``bt_solve`` on the card, the
port's main path; the JAX file's ``ALConfig`` takes the block-Thomas
scan). Each schedule: one untimed solve, then 3 timed ones, the least
kept. The drift is measured over the scenarios feasible (violation <
1e-3) under both schedules, -1 where there are none.

Run on the card:  python scripts/torch_sweep_schedule.py
On the CPU:       python scripts/torch_sweep_schedule.py --cpu  (or E2E_CPU=1)
``--reps`` cuts the timed solves. ``main`` prints the JAX file's lines and
returns their numbers as a dict.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    best_of,
    gap_params,
    parse,
    print_launches,
    reset_launches,
)

REPS = 3
SCHEDULES = ((14, 10, 10), (12, 10, 10), (12, 8, 10), (14, 8, 8),
             (12, 8, 8), (10, 8, 8), (12, 6, 8), (10, 6, 8),
             # keep outers (feasibility needs them), trim inners/ls
             (20, 8, 10), (20, 8, 8), (20, 6, 8), (24, 6, 8),
             (20, 5, 8), (24, 5, 8), (28, 4, 8))


def drift(z, ref_z, feas, ref_feas) -> float:
    """Max |z - ref_z| over the scenarios feasible under both schedules
    (the JAX file's z-drift), -1 where there are none."""
    both = np.asarray(feas) & np.asarray(ref_feas)
    if not both.any():
        return -1
    return float(np.abs(np.asarray(z) - np.asarray(ref_z))[both].max())


def sweep_schedule(B: int = 1024, N: int = N, H_rev: int = H_REV,
                   default=(20, 10, 10), schedules=SCHEDULES,
                   reps: int = REPS, device=None) -> dict:
    from legged_gym_dev_tpu_torch.solver import ALConfig
    from legged_gym_dev_tpu_torch.solver.fast_tube import (
        solve_tube_fast_batched,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    p = gap_params(B, 0, ("z0", "zf", "obs_c", "obs_r"), dev, N=N,
                   H_rev=H_rev)

    def run(o, i, ls):
        cfg = ALConfig(outer_iters=o, inner_iters=i, ls_iters=ls,
                       linsolve="pallas")
        t, out = best_of(lambda: solve_tube_fast_batched(
            p, N, H_rev, tube_kind="l1", scaling=0.5, cfg=cfg,
            warm_start="interpolate", tube_ws="evaluate", device=dev),
            reps, dev)
        return (out.z.cpu().numpy(), out.sol.viol.cpu().numpy(),
                out.sol.outer_used.cpu().numpy(), B / t)

    reset_launches()
    ref_z, ref_viol, ou, ref_rate = run(*default)
    ref_feas = ref_viol < 1e-3
    pct = {q: float(np.percentile(ou, q)) for q in (50, 90, 99)}
    o, i, ls = default
    print(f"default {o}x{i}x{ls}: {ref_rate:7.1f} solves/s  "
          f"feas={ref_feas.mean():.4f} outer_used p50={pct[50]:.0f} "
          f"p90={pct[90]:.0f} p99={pct[99]:.0f} max={ou.max()}", flush=True)
    rows = [dict(schedule=f"{o}x{i}x{ls}", solves_per_s=ref_rate,
                 feasible_frac=float(ref_feas.mean()),
                 outer_used_p50_p90_p99_max=[pct[50], pct[90], pct[99],
                                             int(ou.max())])]
    for o, i, ls in schedules:
        z, viol, _, rate = run(o, i, ls)
        feas = viol < 1e-3
        dz = drift(z, ref_z, feas, ref_feas)
        print(f"{o:2d}x{i:2d}x{ls:2d}        : {rate:7.1f} solves/s  "
              f"feas={feas.mean():.4f}  z-drift(feas∩feas)={dz:.2e}",
              flush=True)
        rows.append(dict(schedule=f"{o}x{i}x{ls}", solves_per_s=rate,
                         feasible_frac=float(feas.mean()), z_drift=dz))
    return dict(batch=B, schedules=rows)


def main(argv=None):
    args = parse(argv, __doc__)
    out = sweep_schedule(reps=args.reps or REPS, device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
