"""Component-level timing of the rigid-body sim hot path, on the
PyTorch/CUDA port.

The counterpart of ``scripts/profile_sim.py`` on
``legged_gym_dev_tpu_torch``. Times each piece of the hopper's substep at
training batch size: the contact kinematics, the mass matrix, the bias
forces and the forward dynamics of ``sim/dynamics.py`` (plain PyTorch),
the substep (the CUDA kernel ``substep`` at nj=4 on the card), and the
whole env step (decimation x substeps, observations and rewards). Each
piece: one untimed call, then 20 calls (the env step 10) back to back and
one synchronize, as the JAX file's throughput timer.

Run on the card:  OVERRIDES='{"urdf_path": "hopper.urdf"}' \\
                  python scripts/torch_profile_sim.py [batch]
On the CPU:       ... --cpu  (or E2E_CPU=1)

Arguments (the JAX file's): batch (4096). ``OVERRIDES``: JSON keywords for
``make_hopper_trajectory_env`` (the reference's hopper URDF lies outside
this repository; ``urdf_path`` names another, a file or the URDF text).
``--reps`` cuts the timed calls. ``main`` prints the JAX file's lines and
returns their numbers (ms) as a dict.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    device_name,
    env_overrides,
    mean_of,
    parse,
    print_launches,
    reset_launches,
)

REPS, ENV_REPS = 20, 10


def profile_sim(B: int = 4096, reps: int = REPS, env_reps: int = ENV_REPS,
                overrides=None, device=None) -> dict:
    """ms a call of each piece at batch B; prints each as the JAX file
    does."""
    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
    )
    from legged_gym_dev_tpu_torch.sim import dynamics as dyn
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    print(f"platform={device_name(dev)} B={B}", flush=True)
    env = make_hopper_trajectory_env(num_envs=B, device=dev,
                                     **(overrides or {}))
    sim = env.sim
    model = sim.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, _ = env.reset(gen)
    robot = st.robot
    tau = torch.zeros(B, model.nj, device=dev)
    f_ext = torch.zeros(B, 6 + model.nj, device=dev)

    out = {}
    reset_launches()
    for name, fn, n in [
            ("mass_matrix", lambda: dyn.mass_matrix(model, robot), reps),
            ("bias_forces", lambda: dyn.bias_forces(model, robot), reps),
            ("contact_kin", lambda: dyn.contact_kinematics(model, robot),
             reps),
            ("forward_dyn", lambda: dyn.forward_dynamics(model, robot, tau,
                                                         f_ext), reps),
            ("substep", lambda: sim.substep(robot, tau), reps)]:
        dt = mean_of(fn, n, dev)
        print(f"{name:14s} {dt * 1e3:8.3f} ms  ({B / dt / 1e6:8.2f} M/s)",
              flush=True)
        out[name] = dt * 1e3

    # Full env step (policy-rate): decimation x substeps + obs/rew.
    act = torch.zeros(B, 4, device=dev)
    act[:, 0] = 1.0
    dt = mean_of(lambda: env.step(st, act), env_reps, dev)
    print(f"{'env.step':14s} {dt * 1e3:8.3f} ms  ({B / dt:10.0f} "
          f"env-steps/s)", flush=True)
    out["env.step"] = dt * 1e3
    out["env_steps_per_s"] = B / dt
    out["decimation"] = sim.decimation
    return out


def main(argv=None):
    args = parse(argv, __doc__, positional=(("batch", int, 4096, "envs"),))
    reps = args.reps or REPS
    out = profile_sim(B=args.batch, reps=reps, env_reps=args.reps or ENV_REPS,
                      overrides=env_overrides(), device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
