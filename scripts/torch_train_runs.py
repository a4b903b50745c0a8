"""The port's RL training drivers (``scripts/torch_train_*.py``) on the
test robots of ``tests/torch_robot_cases.py``, with what a long run can
go wrong in counted.

Each run is one driver's ``main()`` in a process of its own, with its
robot's URDF written under ``build/train_runs/<run>/`` and passed through
``OVERRIDES``, the driver's environment knobs set as below, and its logs
under that directory. Around the driver this script:

- builds the ``substep`` kernel for the robot's joint count first, so the
  learn wall holds no ``nvcc``;
- counts the kernel's launches where it launches and holds them to
  iterations x steps x decimation, plus the evaluation's steps x
  decimation (0 on rough terrain, which takes the plain substep);
- counts, per learn iteration, the envs that ``guard_finite_state`` flags
  and the envs that reset;
- times the evaluation and keeps the reward curve, the terrain levels and
  the checkpoints the runner wrote.

Each run's record is printed as ``[train run] {json}`` and written to
``<out>/<run>.json``; the driver's own output goes to ``<out>/<run>.log``.

    python3 scripts/torch_train_runs.py anymal_c_velocity cassie
    python3 scripts/torch_train_runs.py all --iters 2 --eval-steps 20

Runs (the driver, the robot, the knobs): see ``RUNS``. ``--iters`` and
``--eval-steps`` cut every run named (the drivers' defaults otherwise:
the evaluation's 500 steps after 50 to settle). Needs the card.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# run -> (driver script, test robot constant, joint count, knobs)
RUNS = {
    "anymal_c_velocity": ("torch_train_velocity_task", "QUADRUPED_URDF", 12,
                          {"TASK": "anymal_c_velocity", "ITERS": "300",
                           "ENVS": "4096"}),
    "a1_velocity": ("torch_train_velocity_task", "A1_URDF", 12,
                    {"TASK": "a1_velocity", "ITERS": "300", "ENVS": "4096"}),
    "adam_velocity": ("torch_train_velocity_task", "BIPED10_URDF", 10,
                      {"TASK": "adam_velocity", "ITERS": "300",
                       "ENVS": "4096"}),
    "cassie": ("torch_train_cassie", "CASSIE_URDF", 12,
               {"ITERS": "300", "ENVS": "4096"}),
    "anymal_c_lstm": ("torch_train_anymal_lstm", "QUADRUPED_URDF", 12,
                      {"ITERS": "150", "ENVS": "4096", "SKIP_PD": "1"}),
    "anymal_c_rough": ("torch_train_rough_sanity", "QUADRUPED_URDF", 12,
                       {"ITERS": "50", "ENVS": "2048", "CHUNK": "10"}),
}
CURVE_POINTS = 12      # reward-curve samples kept per run


def load_by_path(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Counters:
    """Device-side counts per env step (no host sync while training):
    the envs ``guard_finite_state`` flags and the envs that reset."""

    def __init__(self):
        self.guard, self.resets = [], []

    def install(self):
        from legged_gym_dev_tpu_torch.envs import legged_robot_velocity as lv

        guard, do_reset = lv.guard_finite_state, lv.LeggedRobotVelocityEnv._do_reset

        def counted_guard(robot, safe_state, *a, **kw):
            robot, nonfinite = guard(robot, safe_state, *a, **kw)
            self.guard.append(nonfinite.sum())
            return robot, nonfinite

        def counted_reset(env, state, mask):
            self.resets.append(mask.sum())
            return do_reset(env, state, mask)

        lv.guard_finite_state = counted_guard
        lv.LeggedRobotVelocityEnv._do_reset = counted_reset

    def per_step(self, lo, hi):
        import torch

        out = {}
        for name in ("guard", "resets"):
            xs = getattr(self, name)[lo:hi]
            out[name] = (torch.stack(xs).cpu().numpy().astype(np.int64)
                         if xs else np.zeros(0, np.int64))
        return out


def curve(values, points=CURVE_POINTS):
    """(iteration, value) at ``points`` evenly spaced iterations and the
    last."""
    n = len(values)
    idx = sorted({int(i) for i in np.linspace(0, n - 1, min(points, n))})
    return [(i, float(values[i])) for i in idx]


def child(run, out_dir, iters, eval_steps):
    """One run in this process; returns its record."""
    import torch

    from legged_gym_dev_tpu_torch.envs import presets, task_registry
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    script, const, nj, knobs = RUNS[run]
    work = ROOT / "build" / "train_runs" / run
    (work / "tmp").mkdir(parents=True, exist_ok=True)
    tempfile.tempdir = str(work / "tmp")       # the runners' log roots
    rc = load_by_path("torch_robot_cases",
                      ROOT / "tests" / "torch_robot_cases.py")
    urdf = work / f"{const.lower()}.urdf"
    urdf.write_text(getattr(rc, const))
    os.environ.update(knobs, OVERRIDES=json.dumps({"urdf_path": str(urdf)}))
    if iters:
        os.environ["ITERS"] = str(iters)
    if script == "torch_train_anymal_lstm":
        presets.ACTUATOR_NET_PATH = str(rc.write_actuator_net(
            work / "actuator_net.pt", seed=0))
    t0 = time.perf_counter()
    sk.build([nj])
    build_s = time.perf_counter() - t0

    driver = load_by_path(script, ROOT / "scripts" / f"{script}.py")
    envs, runners = [], []
    make_env, make_runner = task_registry.make_env, task_registry.make_alg_runner

    def capture_env(*a, **kw):
        envs.append(make_env(*a, **kw))
        return envs[-1]

    def capture_runner(*a, **kw):
        runners.append(make_runner(*a, **kw))
        return runners[-1]

    task_registry.make_env = capture_env
    task_registry.make_alg_runner = capture_runner
    counters = Counters()
    counters.install()
    evals = []
    if hasattr(driver, "evaluate_velocity_tracking"):
        evaluate = driver.evaluate_velocity_tracking
        steps = eval_steps or inspect.signature(evaluate).parameters[
            "steps"].default
        cut = dict(steps=steps, settle=min(50, steps // 5)) if eval_steps \
            else {}

        def timed_evaluate(env, policy, gen):
            torch.cuda.synchronize()
            before = sum(sk.launches_by_nj().values())
            mark = len(counters.guard)
            t = time.perf_counter()
            stats = evaluate(env, policy, gen, **cut)
            torch.cuda.synchronize()
            evals.append(dict(steps=steps, wall_s=time.perf_counter() - t,
                              k3_launches=sum(sk.launches_by_nj().values())
                              - before, counter_mark=mark, stats=stats))
            return stats

        driver.evaluate_velocity_tracking = timed_evaluate

    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    out = driver.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_nj = sk.launches_by_nj()

    env, runner = envs[0], runners[0]
    T = runner.cfg.num_steps
    dec = env.sim.decimation if sk.supports_kernel(env.sim) else 0
    n_it = runner.it
    ev = evals[0] if evals else None
    want_learn = n_it * T * dec
    want_eval = ev["steps"] * dec if ev else 0
    got = sum(by_nj.values())
    learn_end = ev["counter_mark"] if ev else len(counters.guard)
    counts = counters.per_step(0, learn_end)
    per_iter = {k: v[:n_it * T].reshape(n_it, T).sum(1)
                for k, v in counts.items()}
    history = runner.history
    rewards = [h["mean_reward"] for h in history]
    tenth = max(n_it // 10, 1)
    rec = dict(
        run=run, script=f"scripts/{script}.py", robot=const, nj=nj,
        knobs={k: os.environ[k] for k in knobs}, card=card(),
        device=torch.cuda.get_device_name(0), build_s=build_s,
        process_wall_s=wall, driver=out,
        iterations=n_it, steps_per_iteration=T, batch=env.num_envs,
        substeps_per_step=env.sim.decimation,
        k3_launches=dict(by_nj=by_nj, total=got, want_learn=want_learn,
                         want_eval=want_eval,
                         eval=ev["k3_launches"] if ev else 0,
                         exact=got == want_learn + want_eval
                         and (ev is None or ev["k3_launches"] == want_eval)),
        guard_per_iteration=dict(
            total=int(per_iter["guard"].sum()),
            first_tenth_mean=float(per_iter["guard"][:tenth].mean()),
            last_tenth_mean=float(per_iter["guard"][-tenth:].mean()),
            max=int(per_iter["guard"].max())),
        resets_per_iteration=dict(
            first_tenth_mean=float(per_iter["resets"][:tenth].mean()),
            last_tenth_mean=float(per_iter["resets"][-tenth:].mean())),
        reward_curve=curve(rewards),
        final_metrics={k: history[-1][k] for k in
                       ("loss", "policy_loss", "value_loss", "kl")
                       if k in history[-1]},
        all_metrics_finite=bool(all(
            np.isfinite(v) for h in history for v in h.values()
            if isinstance(v, float))),
        checkpoints=sorted(os.listdir(runner.log_dir))
        if runner.log_dir else [])
    if ev:
        ev_counts = counters.per_step(ev["counter_mark"], None)
        rec["eval"] = dict(steps=ev["steps"], wall_s=ev["wall_s"],
                           guard_total=int(ev_counts["guard"].sum()),
                           **ev["stats"])
    if hasattr(runner.env_state, "terrain_levels"):
        levels = runner.env_state.terrain_levels.cpu().numpy()
        rec["terrain_levels"] = dict(mean=float(levels.mean()),
                                     max=int(levels.max()))
    (out_dir / f"{run}.json").write_text(json.dumps(rec, indent=1))
    print("[train run] " + json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+", help=f"{sorted(RUNS)} or all")
    ap.add_argument("--iters", type=int, default=0,
                    help="learn iterations of every run (0: the run's)")
    ap.add_argument("--eval-steps", type=int, default=0,
                    help="evaluation steps (0: the driver's)")
    ap.add_argument("--out", default=str(ROOT / "build" / "train_runs"),
                    help="directory of the records and logs")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    runs = sorted(RUNS) if args.runs == ["all"] else args.runs
    unknown = sorted(set(runs) - set(RUNS))
    if unknown:
        ap.error(f"unknown runs {unknown}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.child:
        child(runs[0], out_dir, args.iters, args.eval_steps)
        return 0
    print(card(), flush=True)
    failed = []
    for run in runs:
        t0 = time.perf_counter()
        with open(out_dir / f"{run}.log", "w") as log:
            rc = subprocess.run(
                [sys.executable, __file__, run, "--child", "--iters",
                 str(args.iters), "--eval-steps", str(args.eval_steps),
                 "--out", str(out_dir)], stdout=log, stderr=subprocess.STDOUT,
                cwd=ROOT).returncode
        text = (out_dir / f"{run}.log").read_text().splitlines()
        rec = next((json.loads(line[len("[train run] "):]) for line in text
                    if line.startswith("[train run] ")), None)
        ok = rc == 0 and rec is not None and rec["k3_launches"]["exact"]
        print(f"[{run}] rc {rc} in {time.perf_counter() - t0:.1f} s; "
              + ("\n".join(text[-8:]) if rec is None else
                 json.dumps({k: rec[k] for k in (
                     "driver", "k3_launches", "guard_per_iteration",
                     "resets_per_iteration", "reward_curve",
                     "terrain_levels", "eval") if k in rec})), flush=True)
        if not ok:
            failed.append(run)
    print(json.dumps({"ok": not failed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
