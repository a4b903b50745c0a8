"""Rough-terrain perceptive training on the PyTorch/CUDA port: PPO on
``anymal_c_rough`` (235 observations with the 187-point height scan, the
procedural terrain grid and the terrain-level curriculum), with the level
curve recorded per chunk of learn iterations.

The counterpart of ``scripts/train_rough_sanity.py`` on
``legged_gym_dev_tpu_torch``. Non-flat terrain takes the plain substep,
as the reference's ``RobotSim.substep`` does, so no ``substep`` kernel
launches here.

Run on the card:  OVERRIDES='{"urdf_path": "anymal_c.urdf"}' \\
                  python scripts/torch_train_rough_sanity.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs: ITERS (1500), ENVS (2048) and CHUNK (100), the JAX
script's, and OVERRIDES (JSON keywords for the env factory). The runner
logs under ``<temporary directory>/rough_logs``. ``main`` prints the JAX
script's lines and returns their numbers as a dict; ``level_curve`` holds
(iterations done, mean terrain level, max level) after each chunk.
"""
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_train_velocity_task import (  # noqa: E402
    device_for,
    env_overrides,
    report,
)

TASK = "anymal_c_rough"
NUM_OBS = 235


def main(argv=None):
    from legged_gym_dev_tpu_torch.envs import task_registry

    dev = device_for(argv, __doc__)
    iters = int(os.environ.get("ITERS", "1500"))
    n_envs = int(os.environ.get("ENVS", "2048"))
    chunk = int(os.environ.get("CHUNK", "100"))
    env = task_registry.make_env(TASK, num_envs=n_envs, device=dev,
                                 **env_overrides())
    if env.num_obs != NUM_OBS:
        raise RuntimeError(f"{TASK}: {env.num_obs} observations, not "
                           f"{NUM_OBS}")
    runner = task_registry.make_alg_runner(
        env, TASK, log_root=os.path.join(tempfile.gettempdir(),
                                         "rough_logs"), seed=0)
    t0 = time.perf_counter()
    rewards, level_curve = [], []
    done = 0
    while done < iters:
        n = min(chunk, iters - done)
        # learn returns the whole history; this chunk's are its last n
        hist = runner.learn(n, save_interval=iters, log_interval=chunk)
        done += n
        rewards += [h["mean_reward"] for h in hist[-n:]]
        levels = runner.env_state.terrain_levels.cpu().numpy()
        lvl, mx = float(levels.mean()), int(levels.max())
        level_curve.append((done, round(lvl, 3), mx))
        print(f"  iter {done}: mean_terrain_level={lvl:.3f} max={mx} "
              f"reward={np.mean(rewards[-5:]):.4f}", flush=True)
    wall = time.perf_counter() - t0
    out = report(TASK, iters, n_envs, runner.cfg.num_steps, wall, rewards,
                 reward_max=False, extra=f"obs={env.num_obs}; ")
    out["obs"] = env.num_obs
    print(f"terrain level curve [(iter, mean, max)]: {level_curve}",
          flush=True)
    out["level_curve"] = level_curve
    return out


if __name__ == "__main__":
    main()
