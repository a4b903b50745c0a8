"""Closed-loop re-solve schedule tuner, on the PyTorch/CUDA port: can
B=1024 fit in the 0.1 s ROM tick?

The counterpart of ``scripts/tune_loop_schedule.py`` on
``legged_gym_dev_tpu_torch``. The receding-horizon loop re-solves the
whole scenario batch between ROM ticks with a short warm schedule
(``cfg_loop``). This sweeps (outer, inner, Woodbury basis chunk) on the
real closed loop (``closed_loop_tube_mpc_fast``: B scenarios x H ticks,
the NN tube, the nominal warm start, ``linsolve`` from LINSOLVE:
"pallas", the CUDA kernels ``bt_solve``, ``bt_factor`` and ``bt_msolve``,
by default) and reports the wall a tick against the 0.1 s budget
together with the quality gates: the adopted fraction, the tube's
coverage of the executed trajectories (``evaluate_tube_on_mpc_trace``)
and the goal reach. A faster schedule counts only if the loop still
adopts its plans.

The gap batch moves z0, zf and the obstacle radii by ``default_rng(0)``
draws; the tube net is the JAX file's (2x128, softplus head, the last
layer's weights x0.1 and biases -2.5) drawn from a seeded
``torch.Generator``. Each combination makes one untimed loop of one tick
(the kernels' build and first launches; the port compiles nothing else),
then times 3 loops of H ticks and keeps the least.

Run on the card:  python scripts/torch_tune_loop_schedule.py
On the CPU:       E2E_CPU=1 B=8 H=2 python scripts/torch_tune_loop_schedule.py
Environment knobs (the JAX file's): B (1024), H (75), LINSOLVE (pallas).
``--reps`` cuts the timed loops. ``main`` prints the JAX file's JSON line
for each combination and returns them as a dict.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    flat_trace,
    gap_params,
    parse,
    print_launches,
    reset_launches,
    surrogate_robot,
    tube_mlp,
)
from torch_profile_tick import make_run, timed_loop  # noqa: E402

REPS = 3
COMBOS = ((5, 6, 3), (5, 6, 6), (4, 6, 3), (3, 6, 3), (4, 4, 4))


def fits_budget(per_tick: float, budget: float) -> bool:
    """The JAX file's gate: a tick's re-solve within the ROM tick."""
    return bool(per_tick < budget)


def tune_loop_schedule(B: int = 1024, H: int = 75, linsolve: str = "pallas",
                       combos=COMBOS, N: int = N, H_rev: int = H_REV,
                       first=(20, 10), reps: int = REPS,
                       device=None) -> list:
    """One record a combination; ``first`` is the first solve's outer x
    inner schedule."""
    from legged_gym_dev_tpu_torch.evaluation import evaluate_tube_on_mpc_trace
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT, ALConfig
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    prob = PROBLEM_DICT["gap"]
    p = gap_params(B, 0, ("z0", "zf", "obs_r"), dev, N=N, H_rev=H_rev,
                   Qw=0.1, tube=tube_mlp(dev, N=N, H_rev=H_rev))
    robot = surrogate_robot(prob["dt"], 0.3, 0.5, dev)
    cfg_first = ALConfig(outer_iters=first[0], inner_iters=first[1],
                         nn_basis_refresh=3, linsolve=linsolve)
    reset_launches()
    recs = []
    for outer, inner, chunk in combos:
        cfg_loop = ALConfig(outer_iters=outer, inner_iters=inner,
                            nn_basis_refresh=chunk, linsolve=linsolve)
        run = make_run(p, robot, cfg_first, cfg_loop, "nominal", "evaluate",
                       H, N, H_rev, dev)
        per_tick, out = timed_loop(run, H, reps, dev)
        z_t, v_t, w_t, pzx_t, viols, adopts = [o.cpu().numpy() for o in out]
        goal = np.linalg.norm(z_t[:, -1] - np.asarray(prob["goal"]), axis=-1)
        cov = evaluate_tube_on_mpc_trace(flat_trace(z_t, w_t, pzx_t, viols))
        rec = {
            "sched": f"{outer}x{inner}c{chunk}", "B": B,
            "per_tick_ms": round(per_tick * 1e3, 1),
            "fits_budget": fits_budget(per_tick, prob["dt"]),
            "adopted_frac": round(float(adopts.mean()), 4),
            "coverage": round(cov["coverage"], 4),
            "goal_reach_10cm": round(float((goal < 0.1).mean()), 4),
            "resolves_per_s": round(B / per_tick, 1),
        }
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None):
    args = parse(argv, __doc__)
    recs = tune_loop_schedule(
        B=int(os.environ.get("B", "1024")), H=int(os.environ.get("H", "75")),
        linsolve=os.environ.get("LINSOLVE", "pallas"),
        reps=args.reps or REPS, device=args.device)
    return {"combos": recs, "launches": print_launches()}


if __name__ == "__main__":
    main()
