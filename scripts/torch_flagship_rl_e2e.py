"""Flagship RL pipeline of the PyTorch/CUDA port: the reference's workflow
end to end on the card.

The counterpart of ``scripts/flagship_rl_e2e.py`` on
``legged_gym_dev_tpu_torch``: train an RL policy -> select the
``best{stage}`` checkpoint by fixture tracking error -> collect tube data
from that policy -> one-shot tube training with a split-conformal width
scale -> batched NN-tube closed-loop MPC, uncalibrated, calibrated and
after a trace-conformal step. On the card the rigid-body substeps of
training, fixture evaluation and collection run the CUDA kernel
``substep``, and every banded solve of the closed loops ``bt_solve``,
``bt_factor`` and ``bt_msolve``.

Checkpoint selection follows the reference's stage-gated ``best{stage}``
aliases: the runner keeps the best-reward checkpoint of each curriculum
stage, and every candidate (``latest`` and each ``best{stage}``) is rolled
on the zero, square and circle fixtures; the lowest mean error wins.

Run on the card:  URDF=hopper.urdf python scripts/torch_flagship_rl_e2e.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs (the JAX script's names and defaults):
  TASK (hopper_trajectory), TRAIN_ITERS (2000), TRAIN_ENVS (4096),
  CURRICULUM (single_int for the hopper, else none; none disables),
  WEIGHT_SAMPLER (e.g. UniformWeightSamplerTurnBiased), COLLECT_EPOCHS (2),
  COLLECT_ENVS (1024), B (1024), H (75), EPOCHS (40), LINSOLVE (pallas),
  PROBLEM (gap), REPORT (flagship_rl_report.json in the temporary
  directory), SAVE_INTERVAL (200), FIXTURE_ENVS (256), FIXTURE_STEPS (400),
  STOP_AFTER (2: stop after the checkpoint selection), ROBOT_VEL_SCALE
  (1.5), ROBOT_ACC_SCALE (2.5).
The port's own:
  URDF: the robot, a URDF file path or the URDF text, passed as
    ``urdf_path=`` to the training, fixture and collection envs. Without
    it the presets' default file is used, which lies outside this
    repository: they raise FileNotFoundError where it is absent. Nothing
    stands in for it.
  EPISODE_S (10.0): the collection episode in seconds (the JAX script's
    fixed 10 s). An episode must hold at least N + 2 ROM ticks
    (EPISODE_S / the ROM's dt >= N + 2; the H_rev history is padded), or
    no horizon window fits and the tube dataset is empty.
  REPS (3): the timed calls of each closed loop, after one warm-up call
    (the JAX script's burst of two served a remote backend's one-time
    finalization; the port compiles nothing).

The report (the JAX script's keys and ``launches``, each kernel's launch
count in this process) is written to REPORT and printed as the last line.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_flagship_e2e as rom_flagship  # noqa: E402
from legged_gym_dev_tpu_torch.solver import ALConfig  # noqa: E402

FIXTURE_NAMES = ("zero", "square", "circle")
CAL_SEED = 101   # the trace-conformal calibration's scenario batch


def calibration_split(data, frac: int = 10):
    """Episode-level split: the last 1/``frac`` of the episodes (at least
    one) are never seen by training or best-model selection; they are the
    split-conformal calibration set. Returns (train, calibration)."""
    from legged_gym_dev_tpu_torch.tube.datasets import RolloutData

    n_cal = max(data.z.shape[0] // frac, 1)
    train = RolloutData(z=data.z[:-n_cal], v=data.v[:-n_cal],
                        pz_x=data.pz_x[:-n_cal], done=data.done[:-n_cal])
    cal = RolloutData(z=data.z[-n_cal:], v=data.v[-n_cal:],
                      pz_x=data.pz_x[-n_cal:], done=data.done[-n_cal:])
    return train, cal


def mpc_env(vel_max: float, v_max_data: float, vel_scale: float,
            acc_scale: float) -> dict:
    """The planning ROM's speed bound and the surrogate robot's authority.
    The tube net was trained on inputs |v| <= v_max_data, so the plan is
    bounded by it too (a larger bound asks the net for widths outside its
    data); the robot's velocity and acceleration bounds scale with it
    (1.5x / 2.5x give the hopper's surrogate, 0.3 and 0.5 at 0.2)."""
    return {"v_max_data": v_max_data, "v_plan": min(float(vel_max),
                                                    v_max_data),
            "robot_vel": vel_scale * v_max_data,
            "robot_acc": acc_scale * v_max_data}


def select_checkpoint(runner, eval_fixtures):
    """Rolls ``latest`` and every ``best{stage}`` checkpoint on the
    fixtures (``eval_fixtures(policy)`` -> {fixture: metrics}) and loads
    the one with the lowest mean ``mean_tracking_error``. Returns (its
    name, {candidate: errors}, its fixture metrics)."""
    candidates = ["latest"] + [f"best{s}" for s in runner.ckpt.best_stages()]
    selection = {}
    best_name, best_err, best_fixtures = None, np.inf, None
    for name in candidates:
        runner.load(name)
        fx = eval_fixtures(runner.get_inference_policy())
        mean_err = float(np.mean([fx[f]["mean_tracking_error"]
                                  for f in FIXTURE_NAMES]))
        selection[name] = {"fixture_mean_err": round(mean_err, 4),
                           **{f: fx[f]["mean_tracking_error"]
                              for f in FIXTURE_NAMES}}
        print(f"   candidate {name}: mean fixture err {mean_err:.4f} "
              f"({selection[name]})", flush=True)
        if mean_err < best_err:
            best_name, best_err, best_fixtures = name, mean_err, fx
    runner.load(best_name)
    print(f"   SELECTED {best_name} (mean fixture err {best_err:.4f})",
          flush=True)
    return best_name, selection, best_fixtures


def _host_model(model, x: np.ndarray) -> np.ndarray:
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    with torch.no_grad(), fp32_matmul():
        return model(torch.as_tensor(
            x, device=model.weights[0].device)).cpu().numpy()


def _write(report, path):
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def run_rl_flagship(task: str = "hopper_trajectory", train_iters: int = 2000,
                    train_envs: int = 4096, curriculum: str = None,
                    weight_sampler: str = "", collect_epochs: int = 2,
                    collect_envs: int = 1024, B: int = 1024, H: int = 75,
                    epochs: int = 40, linsolve: str = "pallas",
                    problem: str = "gap", report_path: str = None,
                    save_interval: int = 200, fixture_envs: int = 256,
                    fixture_steps: int = 400, stop_after=None,
                    robot_vel_scale: float = 1.5,
                    robot_acc_scale: float = 2.5, urdf: str = None,
                    episode_s: float = 10.0, reps: int = 3,
                    N: int = rom_flagship.N, H_rev: int = rom_flagship.H_REV,
                    cfg_first: ALConfig = rom_flagship.CFG_FIRST,
                    cfg_loop: ALConfig = rom_flagship.CFG_LOOP,
                    device=None, log_root: str = None) -> dict:
    """The pipeline; returns the report and writes it to ``report_path``.
    ``device=None`` is the CUDA card (raises without one); ``curriculum``
    None is "single_int" for the hopper, else "none"; ``linsolve`` applies
    to both schedules; ``stop_after=2`` stops after the checkpoint
    selection; the runner logs under ``log_root``."""
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    tmp = tempfile.gettempdir()
    report_path = report_path or os.path.join(tmp, "flagship_rl_report.json")
    log_root = log_root or os.path.join(tmp, "flagship_rl_logs")
    if curriculum is None:
        curriculum = "single_int" if task == "hopper_trajectory" else "none"
    cfg_first, cfg_loop = rom_flagship.with_linsolve(cfg_first, cfg_loop,
                                                linsolve)
    rom_flagship.reset_launches()
    report = {"task": task, "curriculum": curriculum,
              "weight_sampler": weight_sampler or "default"}
    common = {"device": dev}
    if urdf:
        common["urdf_path"] = urdf

    # 1. train the trajectory-tracking policy (the reference's train_rl.py)
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.rl.runner import make_curriculum_stage_fn

    env_kw = {"num_envs": train_envs, **common}
    if task == "hopper_trajectory":
        if curriculum != "none":
            env_kw["curriculum"] = curriculum
        if weight_sampler:
            env_kw["weight_sampler"] = weight_sampler
    t0 = time.perf_counter()
    env = task_registry.make_env(task, **env_kw)
    runner = task_registry.make_alg_runner(env, task, log_root=log_root,
                                           run_name="flagship", seed=0)
    stage_fn = None
    if getattr(env, "curriculum", None) is not None and env.curriculum.enabled:
        stage_fn = make_curriculum_stage_fn(env.curriculum,
                                            runner.cfg.num_steps)
    hist = runner.learn(train_iters, save_interval=save_interval,
                        log_interval=50, curriculum_stage_fn=stage_fn)
    t_train_rl = time.perf_counter() - t0
    rewards = [h["mean_reward"] for h in hist]
    report["rl_train"] = {
        "iters": train_iters, "envs": train_envs,
        "wall_s": round(t_train_rl, 1),
        "reward_first": round(float(rewards[0]), 4),
        "reward_last": round(float(np.mean(rewards[-5:])), 4),
        "env_steps_per_s": round(
            train_iters * train_envs * runner.cfg.num_steps / t_train_rl)}
    print(f"[1/5] RL train {task}: {train_iters} iters in {t_train_rl:.0f}s,"
          f" reward {rewards[0]:.3f} -> {np.mean(rewards[-5:]):.3f}",
          flush=True)

    # 2. best{stage} selection and fixture tracking (the reference's
    #    evaluate_rl_policy.py and its wandb aliases)
    from legged_gym_dev_tpu_torch.evaluation import evaluate_tracking_policy
    from legged_gym_dev_tpu_torch.trajgen.generator import (
        CircleTrajectoryGenerator,
        SquareTrajectoryGenerator,
        ZeroTrajectoryGenerator,
    )

    fixtures_cls = dict(zip(FIXTURE_NAMES, (ZeroTrajectoryGenerator,
                                            SquareTrajectoryGenerator,
                                            CircleTrajectoryGenerator)))
    t0 = time.perf_counter()
    eval_env = task_registry.make_env(task, num_envs=fixture_envs,
                                      add_noise=False, **common)

    def eval_fixtures(policy):
        out = {}
        for name in FIXTURE_NAMES:
            if hasattr(policy, "reset"):
                policy.reset()
            m = evaluate_tracking_policy(eval_env, policy,
                                         fixtures_cls[name],
                                         steps=fixture_steps)
            out[name] = {k: round(float(v), 4) for k, v in m.items()}
        return out

    best_name, selection, best_fixtures = select_checkpoint(runner,
                                                            eval_fixtures)
    policy = runner.get_inference_policy()
    fixtures = dict(best_fixtures)
    # the Raibert heuristic on the same fixtures (the hopper's expert
    # controller, which the reference's data pipeline can run instead)
    if hasattr(eval_env, "raibert"):
        for name in FIXTURE_NAMES:
            m = evaluate_tracking_policy(eval_env, eval_env.raibert,
                                         fixtures_cls[name],
                                         steps=fixture_steps)
            fixtures[f"raibert_{name}"] = {k: round(float(v), 4)
                                           for k, v in m.items()}
    report["checkpoint_selection"] = {"candidates": selection,
                                      "selected": best_name}
    report["fixture_tracking"] = fixtures
    report["fixture_tracking"]["wall_s"] = round(time.perf_counter() - t0, 1)
    print(f"[2/5] best-stage selection + fixture eval done "
          f"({len(selection)} candidates)", flush=True)
    if str(stop_after) == "2":
        report["launches"] = rom_flagship.launch_counts()
        _write(report, report_path)
        return report

    # 3. collect tube data from the selected policy (the reference's
    #    data_collection_trajectory.py)
    from legged_gym_dev_tpu_torch.tube.collect import collect_tracking
    from legged_gym_dev_tpu_torch.tube.datasets import RolloutData

    t0 = time.perf_counter()
    col_env = task_registry.make_env(task, num_envs=collect_envs,
                                     add_noise=False, **common)
    gen = torch.Generator(device=dev).manual_seed(3)
    data = RolloutData.concatenate([
        collect_tracking(col_env, policy, gen, episode_length_s=episode_s)
        for _ in range(collect_epochs)])
    t_collect = time.perf_counter() - t0
    err = np.linalg.norm(np.asarray(data.pz_x) - np.asarray(data.z),
                         axis=-1)
    report["collect"] = {
        "episodes": int(data.z.shape[0]),
        "rom_steps": int(data.z.shape[0] * data.v.shape[1]),
        "wall_s": round(t_collect, 1),
        "mean_tracking_err": round(float(err.mean()), 4),
        "p95_tracking_err": round(float(np.percentile(err, 95)), 4)}
    print(f"[3/5] collected {data.z.shape[0]} episodes from the selected "
          f"policy in {t_collect:.0f}s (mean err {err.mean():.3f})",
          flush=True)

    # 4. one-shot tube training on the policy's rollouts and the
    #    split-conformal scale (the reference's train_tube.py with
    #    tube_learning_oneshot.yaml)
    from legged_gym_dev_tpu_torch.tube.datasets import (
        scalar_horizon_tube_dataset,
    )
    from legged_gym_dev_tpu_torch.tube.train import conformal_width_scale

    t0 = time.perf_counter()
    data_train, data_cal = calibration_split(data)
    ds_cal = scalar_horizon_tube_dataset(data_cal, H_fwd=N, H_rev=H_rev)
    res, _ = rom_flagship.train_oneshot(data_train, N, H_rev, epochs, dev)
    # out_scale 1.0 on the uncalibrated net, so all three loops run the
    # same module structure
    base_model = rom_flagship.with_out_scale(res.best_model, 1.0)
    s = conformal_width_scale(base_model, ds_cal, alpha=0.9, per_step=True,
                              rng=np.random.default_rng(11))
    cal_model = rom_flagship.with_out_scale(res.best_model, s)
    xb, yb = ds_cal.sample_batch(np.random.default_rng(12), 8192)
    cov_pre = float(np.mean(_host_model(base_model, xb) >= yb))
    cov_post = float(np.mean(_host_model(cal_model, xb) >= yb))
    t_tube = time.perf_counter() - t0
    last_eval = next(r for r in reversed(res.history) if "coverage" in r)
    report["tube_train"] = {
        "epochs": epochs,
        "one_step_coverage": round(last_eval["coverage"], 4),
        "conformal_scale": round(s, 4),
        "cal_step_coverage_pre": round(cov_pre, 4),
        "cal_step_coverage_post": round(cov_post, 4),
        "wall_s": round(t_tube, 1)}
    print(f"[4/5] tube net: window coverage={last_eval['coverage']:.3f}, "
          f"conformal scale={s:.3f} (cal per-step coverage {cov_pre:.3f} "
          f"-> {cov_post:.3f}) in {t_tube:.0f}s", flush=True)

    # 5. the batched NN-tube closed loops with the policy-data tube (the
    #    reference's tube_planning_closed_loop.py)
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.evaluation import (
        evaluate_tube_on_mpc_trace,
        trace_conformal_scale,
    )
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT

    prob = PROBLEM_DICT[problem]
    menv = mpc_env(prob["vel_max"], float(col_env.rom.v_max.max()),
                   robot_vel_scale, robot_acc_scale)
    report["mpc_env"] = {k: round(v, 4) for k, v in menv.items()}
    v_plan = menv["v_plan"]
    pm = make_rom("SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
                  [prob["pos_max"]] * 2, [-v_plan] * 2, [v_plan] * 2,
                  device=dev)
    robot = rom_flagship.surrogate_robot(prob["dt"], menv["robot_vel"],
                                         menv["robot_acc"], dev)
    run = rom_flagship.make_loop(robot, H, N, H_rev, cfg_first, cfg_loop,
                                 dev)

    def build_batch(tube_model, seed=rom_flagship.SCENARIO_SEED):
        return rom_flagship.nn_tube_batch(pm, prob, B, N, H_rev, tube_model,
                                          seed, dev)

    def run_loop(tube_model, label):
        (z_t, v_t, w_t, pzx_t, viols, adopts), t_first, t_mpc = \
            rom_flagship.timed_loop(run, build_batch(tube_model), reps)
        cov = evaluate_tube_on_mpc_trace(
            rom_flagship.flat_trace(z_t, w_t, pzx_t, viols))
        timing = rom_flagship.loop_timing(B, H, t_mpc, t_first, prob["dt"])
        rec = {"problem": problem, "scenarios": B, "H": H, **timing,
               "adopted_frac": float(adopts.mean()),
               "median_goal_dist": rom_flagship.goal_stats(
                   z_t, prob["goal"])["median_goal_dist"],
               "tube_coverage_on_trace": round(cov["coverage"], 4),
               "tube_mean_width": round(cov["mean_width"], 4),
               "tube_mean_error": round(cov["mean_error"], 4)}
        per = timing["per_resolve_batched_s"]
        verdict = "REAL-TIME" if timing["realtime_batched"] else "OVER BUDGET"
        print(f"   {label}: {per * 1000:.1f} ms/re-solve ({verdict}), "
              f"adoption {rec['adopted_frac']:.3f}, coverage "
              f"{cov['coverage']:.3f}", flush=True)
        return rec

    report["mpc_uncalibrated"] = run_loop(base_model, "uncalibrated tube")
    report["mpc"] = run_loop(cal_model, "calibrated tube ")

    # 5b. trace-conformal calibration: the surrogate closed loop shifts
    # the error distribution away from the held-out robot rollouts', so
    # the loop runs once on a disjoint scenario batch, the finite-sample
    # alpha-quantile of error / width on its trace is compounded into
    # out_scale, and the original scenarios run again
    zc, _, wc, pzc = [o.cpu().numpy() for o in
                      run(build_batch(cal_model, seed=CAL_SEED))[:4]]
    q_tr = trace_conformal_scale(rom_flagship.flat_trace(zc, wc, pzc),
                                 alpha=0.9)
    tc_model = rom_flagship.with_out_scale(res.best_model, s * q_tr)
    report["trace_conformal"] = {"scale_q": round(q_tr, 4),
                                 "out_scale": round(s * q_tr, 4)}
    report["mpc_trace_cal"] = run_loop(tc_model, "trace-calibrated")
    print(f"[5/5] NN-tube MPC done (calibrated adoption "
          f"{report['mpc']['adopted_frac']:.3f}, coverage "
          f"{report['mpc']['tube_coverage_on_trace']:.3f}; trace-cal "
          f"q={q_tr:.3f} -> coverage "
          f"{report['mpc_trace_cal']['tube_coverage_on_trace']:.3f} at "
          f"adoption {report['mpc_trace_cal']['adopted_frac']:.3f})",
          flush=True)
    report["launches"] = rom_flagship.launch_counts()
    _write(report, report_path)
    return report


def main(argv=None):
    cpu = rom_flagship.cpu_requested(argv, __doc__)
    env = os.environ
    task = env.get("TASK", "hopper_trajectory")
    report = run_rl_flagship(
        task=task, train_iters=int(env.get("TRAIN_ITERS", "2000")),
        train_envs=int(env.get("TRAIN_ENVS", "4096")),
        curriculum=env.get("CURRICULUM") or None,
        weight_sampler=env.get("WEIGHT_SAMPLER", ""),
        collect_epochs=int(env.get("COLLECT_EPOCHS", "2")),
        collect_envs=int(env.get("COLLECT_ENVS", "1024")),
        B=int(env.get("B", "1024")), H=int(env.get("H", "75")),
        epochs=int(env.get("EPOCHS", "40")),
        linsolve=env.get("LINSOLVE", "pallas"),
        problem=env.get("PROBLEM", "gap"),
        report_path=env.get("REPORT") or None,
        save_interval=int(env.get("SAVE_INTERVAL", "200")),
        fixture_envs=int(env.get("FIXTURE_ENVS", "256")),
        fixture_steps=int(env.get("FIXTURE_STEPS", "400")),
        stop_after=env.get("STOP_AFTER"),
        robot_vel_scale=float(env.get("ROBOT_VEL_SCALE", "1.5")),
        robot_acc_scale=float(env.get("ROBOT_ACC_SCALE", "2.5")),
        urdf=env.get("URDF") or None,
        episode_s=float(env.get("EPISODE_S", "10.0")),
        reps=int(env.get("REPS", "3")), device="cpu" if cpu else None)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
