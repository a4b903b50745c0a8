"""Flagship end-to-end pipeline of the PyTorch/CUDA port: collect ->
tube-train -> batched NN-tube closed-loop MPC, with a real-time verdict.

The counterpart of ``scripts/flagship_e2e.py`` on ``legged_gym_dev_tpu_torch``:

  1. collect ROM-tracking rollouts from the physics-free ROM sim with a PD
     tracker (``make_rom_tracking_env``, ``DoubleSingleTracking``,
     ``collect_epochs``: 2 epochs of 10 s);
  2. train the one-shot horizon tube net on them (2x128, softplus head,
     vector tube loss at alpha 0.9, batch 1024);
  3. run the receding-horizon tube MPC with the learned tube inside the
     solver for B scenarios at once (``closed_loop_tube_mpc_fast``,
     batch-leading; the first solve 20x10 and the loop's 4x6, Woodbury
     basis refreshed every 3 inner steps); on the card every banded solve
     is a CUDA kernel (``bt_solve``, ``bt_factor``, ``bt_msolve``);
  4. report the per-re-solve latency against the ROM tick (0.1 s) and the
     tube's coverage along the executed trajectories.

Run on the card:  python scripts/torch_flagship_e2e.py
On the CPU:       E2E_CPU=1 python scripts/torch_flagship_e2e.py  (or --cpu)

Environment knobs (the JAX script's names and defaults):
  B (1024) scenarios; H (75) closed-loop ticks; EPOCHS (40) tube-net
  epochs; COLLECT_ENVS (1024) ROM-tracking envs; LINSOLVE ("pallas", the
  CUDA kernels, on the card; "auto" on the CPU).
  REPS (3): the timed closed-loop calls, after one warm-up call whose time
  is ``compile_plus_first_s``. The JAX script's warm-up burst of two calls
  served a remote backend's one-time finalization; the port compiles
  nothing, so one warm-up call does.

The last line of standard output is the JSON report, with the JAX
script's keys and ``launches``: each kernel's launch count in this
process, read from the counters where the kernels launch.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legged_gym_dev_tpu_torch.solver import ALConfig  # noqa: E402

N, H_REV = 50, 10
# the JAX script's schedules: the first solve 20x10 and the loop's 4x6,
# both with the Woodbury basis refreshed every 3 inner steps
CFG_FIRST = ALConfig(nn_basis_refresh=3)
CFG_LOOP = ALConfig(outer_iters=4, inner_iters=6, nn_basis_refresh=3)
SCENARIO_SEED = 0


def reset_launches():
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    btk.reset_launches()
    sk.reset_launches()


def launch_counts() -> dict:
    """Each kernel's launches in this process since ``reset_launches``
    (the wrappers count them where they launch): bt_solve, bt_factor,
    bt_msolve and the substep kernel by joint count."""
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    return {**btk.launches(),
            "substep": {str(nj): n for nj, n in sk.launches_by_nj().items()}}


def scenario_batch(prob: dict, B: int, seed: int = SCENARIO_SEED):
    """The JAX scripts' perturbed scenario batch, float32: z0 and zf moved
    by U(-0.15, 0.15) and the obstacle radii scaled by U(0.85, 1.0), drawn
    from ``np.random.default_rng(seed)`` in that order; the obstacle
    centres unchanged. Returns (z0, zf, obs_c, obs_r), batch-leading."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    z0 = (np.asarray(prob["start"], f32)
          + rng.uniform(-0.15, 0.15, (B, 2)).astype(f32))
    zf = (np.asarray(prob["goal"], f32)
          + rng.uniform(-0.15, 0.15, (B, 2)).astype(f32))
    obs_r = (np.asarray(prob["obs"]["r"], f32)
             * rng.uniform(0.85, 1.0, (B, 2)).astype(f32))
    obs_c = np.broadcast_to(np.asarray(prob["obs"]["c"], f32),
                            (B,) + np.shape(prob["obs"]["c"]))
    return z0, zf, obs_c, obs_r


def nn_tube_batch(pm, prob: dict, B: int, N: int, H_rev: int, tube_model,
                  seed: int, device):
    """``TrajOptParams`` of the scenario batch with the NN tube shared by
    every scenario (Q = R = 10 I, Qw 0.1, w_max 1)."""
    from legged_gym_dev_tpu_torch.solver import TrajOptParams

    z0, zf, obs_c, obs_r = scenario_batch(prob, B, seed)
    return TrajOptParams.create(
        pm, N, H_rev, 10 * np.eye(2), 10 * np.eye(2), z0, zf, obs_c, obs_r,
        Qw=0.1, w_max=1.0, tube_params=tube_model, batch=B, device=device)


def surrogate_robot(dt: float, vel: float, acc: float, device):
    """The closed loop's plant: a double integrator with |velocity| <=
    ``vel`` and |acceleration| <= ``acc``, positions unbounded."""
    from legged_gym_dev_tpu_torch.core import DoubleInt2D

    return DoubleInt2D.create(dt, [-np.inf, -np.inf, -vel, -vel],
                              [np.inf, np.inf, vel, vel], [-acc, -acc],
                              [acc, acc], device=device)


def with_out_scale(model, scale: float):
    """The tube net with ``out_scale`` set to ``scale`` (the weights are
    shared, not copied)."""
    return model.replace(out_scale=scale)


def make_loop(robot, H: int, N: int, H_rev: int, cfg_first: ALConfig,
              cfg_loop: ALConfig, device):
    """The batched NN-tube closed loop of a params batch: the JAX scripts'
    ``closed_loop_tube_mpc_fast`` call (nominal warm start, the tube warm
    start evaluated), in full fp32."""
    from legged_gym_dev_tpu_torch.solver.fast_tube import (
        closed_loop_tube_mpc_fast,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    def run(p):
        with fp32_matmul():
            return closed_loop_tube_mpc_fast(
                p, robot, tube_kind="NN_oneshot", scaling=0.5, H=H, N=N,
                H_rev=H_rev, cfg_first=cfg_first, cfg_loop=cfg_loop,
                warm_start="nominal", tube_ws="evaluate", device=device)

    return run


def timed_loop(run, p, reps: int):
    """One warm-up call, then ``reps`` timed ones; each call ends when its
    executed states reach the host. Returns (host traces (z, v, w, pz_x,
    viol, adopted), warm-up seconds, least timed seconds)."""
    t0 = time.perf_counter()
    out = run(p)
    out[0].cpu()
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run(p)
        out[0].cpu()
        ts.append(time.perf_counter() - t0)
    return [o.cpu().numpy() for o in out], t_first, min(ts)


def max_adopted_viol(viols: np.ndarray, adopts: np.ndarray) -> float:
    """The largest violation of a plan that was executed: ``viols[:, k]``
    is the re-solve computed at tick k, and ``adopts[:, k + 1]`` says
    whether it was executed at the next tick."""
    return float(np.where(adopts[:, 1:], viols[:, :-1], 0.0).max(
        initial=0.0))


def goal_stats(z_t: np.ndarray, goal) -> dict:
    """Distance of each scenario's last executed ROM state to the goal:
    its median and the fraction within 10 cm."""
    goal_dist = np.linalg.norm(z_t[:, -1] - np.asarray(goal), axis=-1)
    return {"median_goal_dist": float(np.median(goal_dist)),
            "goal_reach_frac_10cm": float(np.mean(goal_dist < 0.1))}


def flat_trace(z_t, w_t, pzx_t, viols=None) -> types.SimpleNamespace:
    """The executed traces with the batch flattened into time, as the JAX
    scripts hand them to ``evaluate_tube_on_mpc_trace`` (whose first-step
    skip then drops only the first scenario's first step)."""
    trace = types.SimpleNamespace(
        z=z_t.reshape(-1, z_t.shape[-1]), w=w_t.reshape(-1),
        pz_x=pzx_t.reshape(-1, pzx_t.shape[-1]))
    if viols is not None:
        trace.viol, trace.converged = viols, viols < 1e-3
    return trace


def loop_timing(B: int, H: int, t_mpc: float, t_first: float,
                budget: float) -> dict:
    """The timing keys of a closed-loop record: one full solve and H
    warm-started re-solves per call."""
    per_resolve = t_mpc / (H + 1)
    return {
        "wall_s": round(t_mpc, 3),
        "compile_plus_first_s": round(t_first, 1),
        "per_resolve_batched_s": round(per_resolve, 4),
        "rom_tick_budget_s": budget,
        "realtime_batched": bool(per_resolve < budget),
        "resolves_per_s": round(B * (H + 1) / t_mpc, 1),
    }


def with_linsolve(cfg_first, cfg_loop, linsolve):
    """Both schedules with their banded solves on ``linsolve``."""
    return (dataclasses.replace(cfg_first, linsolve=linsolve),
            dataclasses.replace(cfg_loop, linsolve=linsolve))


def run_flagship(B: int = 1024, H: int = 75, epochs: int = 40,
                 collect_envs: int = 1024, linsolve: str = None,
                 reps: int = 3, N: int = N, H_rev: int = H_REV,
                 cfg_first: ALConfig = CFG_FIRST,
                 cfg_loop: ALConfig = CFG_LOOP, device=None) -> dict:
    """The pipeline; returns the report. ``device=None`` is the CUDA card
    (raises without one); ``linsolve=None`` is "pallas" on the card and
    "auto" on the CPU, and applies to both schedules."""
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    if linsolve is None:
        linsolve = "pallas" if dev.type == "cuda" else "auto"
    cfg_first, cfg_loop = with_linsolve(cfg_first, cfg_loop, linsolve)
    reset_launches()
    report = {}

    # 1. collect (the reference's data collection on its CustomSim analog)
    from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
    from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env
    from legged_gym_dev_tpu_torch.tube.collect import collect_epochs

    t0 = time.perf_counter()
    sim = make_rom_tracking_env(num_envs=collect_envs, device=dev).sim
    policy = DoubleSingleTracking.create(4.0, 4.0, sim.model.clip_v_z)
    data = collect_epochs(sim, policy,
                          torch.Generator(device=dev).manual_seed(0),
                          episode_length_s=10.0, epochs=2)
    t_collect = time.perf_counter() - t0
    n_steps = data.z.shape[0] * data.v.shape[1]
    report["collect"] = {"episodes": int(data.z.shape[0]),
                         "rom_steps": int(n_steps),
                         "wall_s": round(t_collect, 2)}
    print(f"[1/4] collected {data.z.shape[0]} episodes ({n_steps} ROM "
          f"steps) in {t_collect:.1f}s", flush=True)

    # 2. the one-shot horizon tube net (the reference's train_tube.py)
    res, t_train = train_oneshot(data, N, H_rev, epochs, dev)
    last_eval = next(r for r in reversed(res.history) if "coverage" in r)
    report["tube_train"] = {
        "epochs": epochs,
        "one_step_coverage": round(last_eval["coverage"], 4),
        "final_loss": round(last_eval["loss"], 5),
        "wall_s": round(t_train, 2)}
    print(f"[2/4] tube net trained: coverage={last_eval['coverage']:.3f} "
          f"loss={last_eval['loss']:.4f} in {t_train:.1f}s", flush=True)

    # 3. the batched NN-tube closed loop (the reference's
    #    tube_planning_closed_loop.py)
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT

    prob = PROBLEM_DICT["gap"]
    pm = make_rom("SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
                  [prob["pos_max"]] * 2, [-prob["vel_max"]] * 2,
                  [prob["vel_max"]] * 2, device=dev)
    p_batch = nn_tube_batch(pm, prob, B, N, H_rev, res.best_model,
                            SCENARIO_SEED, dev)
    run = make_loop(surrogate_robot(prob["dt"], 0.3, 0.5, dev), H, N,
                    H_rev, cfg_first, cfg_loop, dev)
    (z_t, v_t, w_t, pzx_t, viols, adopts), t_first, t_mpc = timed_loop(
        run, p_batch, reps)
    budget = prob["dt"]
    timing = loop_timing(B, H, t_mpc, t_first, budget)
    report["mpc"] = {"scenarios": B, "H": H, **timing,
                     "adopted_frac": float(adopts.mean()),
                     "max_adopted_viol": max_adopted_viol(viols, adopts),
                     **goal_stats(z_t, prob["goal"])}
    per = timing["per_resolve_batched_s"]
    print(f"[3/4] closed-loop MPC: {B} scenarios x {H} steps in "
          f"{t_mpc:.2f}s -> {per * 1000:.1f} ms/re-solve (budget "
          f"{budget * 1000:.0f} ms, "
          f"{'REAL-TIME' if timing['realtime_batched'] else 'OVER BUDGET'})",
          flush=True)

    # 4. tube coverage along the executed trajectories
    from legged_gym_dev_tpu_torch.evaluation import evaluate_tube_on_mpc_trace

    cov = evaluate_tube_on_mpc_trace(flat_trace(z_t, w_t, pzx_t, viols))
    report["tube_on_trace"] = {k: round(v, 4) for k, v in cov.items()}
    print(f"[4/4] executed-trajectory tube coverage={cov['coverage']:.3f} "
          f"mean_width={cov['mean_width']:.3f} "
          f"mean_error={cov['mean_error']:.3f}", flush=True)
    report["launches"] = launch_counts()
    return report


def train_oneshot(data, N: int, H_rev: int, epochs: int, dev):
    """The one-shot horizon tube net of the JAX scripts on ``data``: 2x128
    softplus_b5 with a softplus head, the vector tube loss at alpha 0.9,
    batch 1024, evaluated every 10 epochs. Returns (TrainResult, wall s)."""
    from legged_gym_dev_tpu_torch.tube.datasets import (
        scalar_horizon_tube_dataset,
    )
    from legged_gym_dev_tpu_torch.tube.losses import vector_tube_loss
    from legged_gym_dev_tpu_torch.tube.models import MLP
    from legged_gym_dev_tpu_torch.tube.train import TrainConfig, train_tube

    t0 = time.perf_counter()
    ds = scalar_horizon_tube_dataset(data, H_fwd=N, H_rev=H_rev)
    model = MLP.create(torch.Generator(device=dev).manual_seed(1),
                       ds.input_dim, ds.output_dim, num_units=128,
                       num_layers=2, final_activation="softplus")
    res = train_tube(
        ds, model, lambda fw, w, x: vector_tube_loss(fw, w, alpha=0.9),
        TrainConfig(epochs=epochs, batch_size=1024, eval_every=10),
        device=dev)
    return res, time.perf_counter() - t0


def cpu_requested(argv=None, doc: str = __doc__) -> bool:
    """``--cpu`` on the command line or ``E2E_CPU`` in the environment
    (``doc``: the script's docstring, for ``--help``)."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as E2E_CPU=1 does)")
    return ap.parse_args(argv).cpu or bool(os.environ.get("E2E_CPU"))


def main(argv=None):
    cpu = cpu_requested(argv)
    env = os.environ
    report = run_flagship(
        B=int(env.get("B", "1024")), H=int(env.get("H", "75")),
        epochs=int(env.get("EPOCHS", "40")),
        collect_envs=int(env.get("COLLECT_ENVS", "1024")),
        linsolve=env.get("LINSOLVE") or None,
        reps=int(env.get("REPS", "3")), device="cpu" if cpu else None)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
