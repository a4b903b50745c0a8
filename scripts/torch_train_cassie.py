"""Cassie biped: velocity-command training and the tracking evaluation, on
the PyTorch/CUDA port.

The counterpart of ``scripts/train_cassie.py`` on
``legged_gym_dev_tpu_torch``: ``cassie_velocity`` trained for ITERS
iterations, then ``evaluation.evaluate_velocity_tracking`` of the trained
deterministic policy (command-tracking error, single-stance fraction and
termination rate over a 500-step rollout). On the card every substep runs
the CUDA kernel ``substep``.

Run on the card:  OVERRIDES='{"urdf_path": "cassie.urdf"}' \\
                  python scripts/torch_train_cassie.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs: ITERS (2000) and ENVS (4096), the JAX script's, and
OVERRIDES (JSON keywords for the env factory; the reference's Cassie URDF
lies outside this repository, so ``urdf_path`` names another). The runner
logs under ``<temporary directory>/cassie_logs``. ``main`` prints the JAX
script's lines and returns their numbers as a dict.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_train_velocity_task import (  # noqa: E402
    device_for,
    env_overrides,
    evaluate_velocity_tracking,
    generator,
    train,
)

TASK = "cassie_velocity"
EVAL_SEED = 123   # the JAX script's jax.random.PRNGKey(123)


def main(argv=None):
    dev = device_for(argv, __doc__)
    iters = int(os.environ.get("ITERS", "2000"))
    n_envs = int(os.environ.get("ENVS", "4096"))
    env, runner, out = train(
        TASK, iters, n_envs, dev, env_overrides(),
        log_root=os.path.join(tempfile.gettempdir(), "cassie_logs"),
        save_interval=max(iters // 4, 1), log_interval=100)
    policy = runner.get_inference_policy()
    stats = evaluate_velocity_tracking(env, policy,
                                       generator(env.device, EVAL_SEED))
    print(f"cassie eval: {stats}", flush=True)
    out["eval"] = stats
    return out


if __name__ == "__main__":
    main()
