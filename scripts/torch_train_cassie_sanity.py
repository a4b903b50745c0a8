"""Cassie biped training sanity on the PyTorch/CUDA port: a short PPO run
on ``cassie_velocity`` that records the biped reward set's training
signal (reward movement and throughput).

The counterpart of ``scripts/train_cassie_sanity.py`` on
``legged_gym_dev_tpu_torch``. On the card every substep runs the CUDA
kernel ``substep``.

Run on the card:  OVERRIDES='{"urdf_path": "cassie.urdf"}' \\
                  python scripts/torch_train_cassie_sanity.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs: ITERS (500) and ENVS (4096), the JAX script's, and
OVERRIDES (JSON keywords for the env factory; the reference's Cassie URDF
lies outside this repository, so ``urdf_path`` names another). The runner
logs under ``<temporary directory>/cassie_logs``. ``main`` prints the JAX
script's line and returns its numbers as a dict.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_train_velocity_task import (  # noqa: E402
    device_for,
    env_overrides,
    train,
)


def main(argv=None):
    dev = device_for(argv, __doc__)
    iters = int(os.environ.get("ITERS", "500"))
    n_envs = int(os.environ.get("ENVS", "4096"))
    _, _, out = train(
        "cassie_velocity", iters, n_envs, dev, env_overrides(),
        log_root=os.path.join(tempfile.gettempdir(), "cassie_logs"),
        save_interval=iters, log_interval=50, reward_max=False)
    return out


if __name__ == "__main__":
    main()
