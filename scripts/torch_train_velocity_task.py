"""Generic velocity-task PPO driver of the PyTorch/CUDA port: train any
registered velocity task, then run the package's tracking evaluation
(``evaluation.evaluate_velocity_tracking``).

The counterpart of ``scripts/train_velocity_task.py`` on
``legged_gym_dev_tpu_torch``. On the card every flat-terrain substep of
training and evaluation runs the CUDA kernel ``substep``.

Run on the card:  TASK=a1_velocity ITERS=500 ENVS=4096 \\
                  OVERRIDES='{"urdf_path": "a1.urdf"}' \\
                  python scripts/torch_train_velocity_task.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs (the JAX script's names and defaults): TASK
(a1_velocity), ITERS (500), ENVS (4096), OVERRIDES (JSON keywords for the
task's env factory, e.g. '{"only_positive_rewards": false, "sim_dt":
0.0025, "sim_decimation": 8}'). The robots' default URDF files lie outside
this repository; ``OVERRIDES='{"urdf_path": ...}'`` names another (a file
path or the URDF text).

The runner logs under ``<temporary directory>/<TASK>_logs``. ``main``
prints the JAX script's lines and returns their numbers as a dict.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legged_gym_dev_tpu_torch.evaluation import (  # noqa: E402
    evaluate_velocity_tracking,
)

EVAL_SEED = 7     # the JAX script's jax.random.PRNGKey(7)


def cpu_requested(argv=None, doc: str = __doc__) -> bool:
    """``--cpu`` on the command line or ``E2E_CPU`` in the environment
    (``doc``: the script's docstring, for ``--help``)."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as E2E_CPU=1 does)")
    return ap.parse_args(argv).cpu or bool(os.environ.get("E2E_CPU"))


def device_for(argv=None, doc: str = __doc__) -> torch.device:
    """The CPU where asked for, else the card; raises without one."""
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    return resolve_device("cpu" if cpu_requested(argv, doc) else None)


def env_overrides() -> dict:
    """``OVERRIDES``: JSON keywords for the env factory."""
    return json.loads(os.environ.get("OVERRIDES", "{}"))


def generator(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def train(task: str, iters: int, n_envs: int, dev, overrides: dict,
          log_root: str, save_interval: int, log_interval: int,
          reward_max: bool = True, seed: int = 0):
    """``task``'s env and runner, ``iters`` learn iterations timed; prints
    the JAX scripts' line. Returns (env, runner, its numbers)."""
    from legged_gym_dev_tpu_torch.envs import task_registry

    env = task_registry.make_env(task, num_envs=n_envs, device=dev,
                                 **overrides)
    runner = task_registry.make_alg_runner(env, task, log_root=log_root,
                                           seed=seed)
    t0 = time.perf_counter()
    hist = runner.learn(iters, save_interval=save_interval,
                        log_interval=log_interval)
    wall = time.perf_counter() - t0
    return env, runner, report(task, iters, n_envs, runner.cfg.num_steps,
                               wall, [h["mean_reward"] for h in hist],
                               reward_max)


def report(task, iters, n_envs, num_steps, wall, r, reward_max=True,
           extra=""):
    """Prints the JAX scripts' training line; returns its numbers."""
    out = dict(task=task, iterations=iters, envs=n_envs, wall_s=wall,
               steps_per_s=iters * n_envs * num_steps / wall,
               reward_first5=float(np.mean(r[:5])),
               reward_last5=float(np.mean(r[-5:])))
    if reward_max:
        out["reward_max"] = float(np.max(r))
    out["finite"] = bool(np.all(np.isfinite(r)))
    best = f"max={out['reward_max']:.4f} " if reward_max else ""
    print(f"{task}: {iters} iters x {n_envs} envs in {wall:.0f}s "
          f"({out['steps_per_s']:.0f} steps/s); {extra}"
          f"reward first5={out['reward_first5']:.4f} "
          f"last5={out['reward_last5']:.4f} {best}"
          f"finite={out['finite']}", flush=True)
    return out


def main(argv=None):
    dev = device_for(argv)
    task = os.environ.get("TASK", "a1_velocity")
    iters = int(os.environ.get("ITERS", "500"))
    n_envs = int(os.environ.get("ENVS", "4096"))
    env, runner, out = train(
        task, iters, n_envs, dev, env_overrides(),
        log_root=os.path.join(tempfile.gettempdir(), f"{task}_logs"),
        save_interval=max(iters // 2, 1), log_interval=100)
    policy = runner.get_inference_policy()
    stats = evaluate_velocity_tracking(env, policy,
                                       generator(env.device, EVAL_SEED))
    print(f"{task} eval: {stats}", flush=True)
    out["eval"] = stats
    return out


if __name__ == "__main__":
    main()
