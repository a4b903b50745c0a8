"""ANYmal-C PPO through the LSTM actuator network, on the PyTorch/CUDA
port.

The counterpart of ``scripts/train_anymal_lstm.py`` on
``legged_gym_dev_tpu_torch``: ``anymal_c_lstm`` advances the actuator
net's hidden state every substep inside the env step (zeroed per reset
env), trained for ITERS iterations, then evaluated with
``evaluation.evaluate_velocity_tracking``; then, unless ``SKIP_PD=1``, a
same-process run of the PD-actuated ``anymal_c_velocity`` for
min(ITERS, 200) iterations as the throughput reference. PPO does not
differentiate through the actuator. On the card every substep runs the
CUDA kernel ``substep``.

The actuator net is the TorchScript file ``envs.presets.ACTUATOR_NET_PATH``
names (the reference's ANYdrive net, outside this repository); a caller
sets that attribute before ``main()`` to use another file.

Run on the card:  OVERRIDES='{"urdf_path": "anymal_c.urdf"}' \\
                  python scripts/torch_train_anymal_lstm.py
On the CPU:       E2E_CPU=1 ... (or --cpu)

Environment knobs: ITERS (1500), ENVS (4096) and SKIP_PD, the JAX
script's, and OVERRIDES (JSON keywords for both env factories). The
runners log under ``<temporary directory>/<task>_logs``. ``main`` prints
the JAX script's lines and returns their numbers as a dict (the PD run's
under ``pd``).
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

EVAL_SEED = 7     # the JAX script's jax.random.PRNGKey(7)


def train_task(task, iters, n_envs, dev, overrides):
    """``task`` at the JAX script's learn settings (seed 0)."""
    return train(task, iters, n_envs, dev, overrides,
                 log_root=os.path.join(tempfile.gettempdir(),
                                       f"{task}_logs"),
                 save_interval=max(iters // 2, 1), log_interval=100)


def main(argv=None):
    dev = device_for(argv, __doc__)
    iters = int(os.environ.get("ITERS", "1500"))
    n_envs = int(os.environ.get("ENVS", "4096"))
    overrides = env_overrides()
    env, runner, out = train_task("anymal_c_lstm", iters, n_envs, dev,
                                  overrides)
    policy = runner.get_inference_policy()
    stats = evaluate_velocity_tracking(env, policy,
                                       generator(env.device, EVAL_SEED))
    print(f"anymal_c_lstm eval: {stats}", flush=True)
    out["eval"] = stats
    # the same-process PD-path throughput reference (a short run; the
    # number of interest is steps/s, not convergence)
    if os.environ.get("SKIP_PD", "") != "1":
        out["pd"] = train_task("anymal_c_velocity", min(iters, 200), n_envs,
                               dev, overrides)[2]
    return out


if __name__ == "__main__":
    main()
