"""Closed-loop tick structure at B=2048, on the PyTorch/CUDA port.

The counterpart of ``scripts/profile_tick.py`` on
``legged_gym_dev_tpu_torch``. It localizes what a tick of the batched
NN_oneshot closed loop (``fast_tube.closed_loop_tube_mpc_fast``, H=25
ticks, the first solve 20x10, the Woodbury basis refreshed every 3 inner
steps, ``linsolve="pallas"``: the kernels ``bt_solve``, ``bt_factor`` and
``bt_msolve`` on the card) costs by scaling the loop schedule: 4x6 (the
production schedule), 2x6, 4x3, 1x2 and 4x6 with the tube's warm start at
0. If the tick scales about linearly with the inner count it is
solve-bound; the rest at zero inner steps is the fixed cost a tick (the
tube warm start's evaluation, the plan shift, the surrogate's PD
tracking, the adoption gate).

The gap batch moves z0 and zf by ``default_rng(1)`` draws; the tube net is
the JAX file's (2x128, softplus head, the last layer's weights x0.1 and
biases -2.5) drawn from a seeded ``torch.Generator``. Each schedule makes
one untimed loop of one tick (the kernels' build and first launches; the
port compiles nothing else), then times 3 loops of H ticks and keeps the
least.

Run on the card:  python scripts/torch_profile_tick.py
On the CPU:       E2E_CPU=1 B=8 python scripts/torch_profile_tick.py
Environment knob (the JAX file's): B (2048). ``--reps`` cuts the timed
loops. ``main`` prints the JAX file's lines and returns their numbers as a
dict.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    gap_params,
    parse,
    print_launches,
    reset_launches,
    surrogate_robot,
    sync,
    tube_mlp,
)

from legged_gym_dev_tpu_torch.solver import ALConfig  # noqa: E402

H = 25
REPS = 3
CFG_FIRST = ALConfig(nn_basis_refresh=3, linsolve="pallas")
SCHEDULES = ((4, 6, "evaluate", ""), (2, 6, "evaluate", ""),
             (4, 3, "evaluate", ""), (1, 2, "evaluate", "1x2 floor"),
             (4, 6, 0.0, ""))


def tick_split(t_44: float, t_12: float):
    """The JAX file's attribution (seconds a tick at 4x6 and at 1x2):
    (cost an inner step, fixed cost a tick)."""
    per_inner = (t_44 - t_12) / (4 * 6 - 1 * 2)
    return per_inner, t_12 - per_inner * 2


def make_run(p, robot, cfg_first, cfg_loop, warm_start, tube_ws, H, N,
             H_rev, dev):
    """The NN_oneshot closed loop of the batch ``p`` in full fp32, as a
    function of its tick count (default H)."""
    from legged_gym_dev_tpu_torch.solver.fast_tube import (
        closed_loop_tube_mpc_fast,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    def run(ticks=H):
        with fp32_matmul():
            return closed_loop_tube_mpc_fast(
                p, robot, tube_kind="NN_oneshot", scaling=0.5, H=ticks,
                N=N, H_rev=H_rev, cfg_first=cfg_first, cfg_loop=cfg_loop,
                warm_start=warm_start, tube_ws=tube_ws, device=dev)
    return run


def timed_loop(run, H, reps, dev):
    """One untimed loop of one tick, then ``reps`` loops of H ticks:
    (least seconds a tick, the last loop's output)."""
    run(1)
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = run(H)
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts) / (H + 1), out


def profile_tick(B: int = 2048, H: int = H, N: int = N, H_rev: int = H_REV,
                 reps: int = REPS, schedules=SCHEDULES,
                 cfg_first: ALConfig = CFG_FIRST, device=None) -> dict:
    """ms a tick and the adoption of each schedule at batch B, then the
    split (``schedules`` must hold 4x6 and 1x2 for it); ``cfg_first`` is
    the first solve's schedule."""
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    p = gap_params(B, 1, ("z0", "zf"), dev, N=N, H_rev=H_rev, Qw=0.1,
                   tube=tube_mlp(dev, N=N, H_rev=H_rev))
    robot = surrogate_robot(PROBLEM_DICT["gap"]["dt"], 0.3, 0.5, dev)
    reset_launches()
    rows, t = [], {}
    for outers, inners, tube_ws, label in schedules:
        cfg_loop = ALConfig(outer_iters=outers, inner_iters=inners,
                            nn_basis_refresh=3, linsolve="pallas")
        run = make_run(p, robot, cfg_first, cfg_loop, "interpolate", tube_ws,
                       H, N, H_rev, dev)
        w, out = timed_loop(run, H, reps, dev)
        ad = float(out[5].float().mean())
        label = label or f"{outers}x{inners}"
        print(f"{label} tube_ws={tube_ws}: {w * 1e3:.1f} ms/tick, adoption "
              f"{ad:.4f}", flush=True)
        rows.append(dict(schedule=f"{outers}x{inners}", tube_ws=tube_ws,
                         ms_per_tick=w * 1e3, adoption=ad))
        if tube_ws == "evaluate":
            t[outers, inners] = w
    per_inner, fixed = tick_split(t[4, 6], t[1, 2])
    print(f"approx per-inner cost {per_inner * 1e3:.2f} ms; fixed per-tick "
          f"~{fixed * 1e3:.1f} ms", flush=True)
    return dict(batch=B, H=H, schedules=rows, per_inner_ms=per_inner * 1e3,
                fixed_per_tick_ms=fixed * 1e3)


def main(argv=None):
    args = parse(argv, __doc__)
    B = int(os.environ.get("B", "2048"))
    out = profile_tick(B=B, reps=args.reps or REPS, device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
