"""Component-level timing of the ANYmal trajectory task, on the
PyTorch/CUDA port.

The counterpart of ``scripts/profile_quadruped.py`` on
``legged_gym_dev_tpu_torch``. Times each piece of ``env.step``: the bare
substep (the CUDA kernel ``substep`` at the robot's joint count on the
card), the decimated sim step, the trajectory generator's tick and
window, the contact forces, the rewards, the observations, the reset path
with no env reset, the whole env step; then one PPO learn iteration
(``rl.ppo.make_learn_iteration``: a 24-step rollout, GAE and the update)
with the default 512-256-128 actor-critic, from which the update's share
is the iteration less 24 env steps. Each piece: one untimed call, then 10
calls (the learn iteration 5) back to back and one synchronize, as the
JAX file's throughput timer.

Run on the card:  OVERRIDES='{"urdf_path": "anymal_c.urdf"}' \\
                  python scripts/torch_profile_quadruped.py [batch] [task]
On the CPU:       ... --cpu  (or E2E_CPU=1)

Arguments (the JAX file's): batch (4096), task (anymal_c_trajectory).
``OVERRIDES``: JSON keywords for the task's env factory (the robots' URDFs
lie outside this repository; ``urdf_path`` names another). ``--reps``
cuts the timed calls. ``main`` prints the JAX file's lines and returns
their numbers (ms) as a dict.
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

REPS, LEARN_REPS = 10, 5


def profile_quadruped(B: int = 4096, task: str = "anymal_c_trajectory",
                      reps: int = REPS, learn_reps: int = LEARN_REPS,
                      overrides=None, device=None) -> dict:
    """ms a call of each piece at batch B; prints each as the JAX file
    does."""
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.rl import ActorCritic, PPOConfig
    from legged_gym_dev_tpu_torch.rl.ppo import (
        init_train_state,
        make_learn_iteration,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    print(f"platform={device_name(dev)} B={B} task={task}", flush=True)
    env = task_registry.make_env(task, num_envs=B, device=dev,
                                 **(overrides or {}))
    sim = env.sim
    nj = sim.model.nj
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, _ = env.reset(gen)
    robot = st.robot
    tau = torch.zeros(B, nj, device=dev)
    act = torch.zeros(B, nj, device=dev)

    tgen = env._traj_gen_cur(st)
    f_contact = env._contact_forces(robot, sim)
    feet = list(env.feet_spheres)
    contact = f_contact[:, feet, 2] > 1.0
    first_contact = (st.feet_air_time > 0.0) & contact
    air = st.feet_air_time + env.dt
    term = list(env.termination_spheres)
    term_contact = (torch.any(torch.linalg.vector_norm(
        f_contact[:, term, :], dim=-1) > 1.0, dim=-1) if term
        else torch.zeros(B, dtype=torch.bool, device=dev))
    no_reset = torch.zeros(B, dtype=torch.bool, device=dev)

    out = {}
    reset_launches()
    for name, fn, per in [
            ("substep", lambda: sim.substep(robot, tau), "substeps"),
            (f"sim.step(x{sim.decimation})",
             lambda: sim.step_with_carry(robot, tau,
                                         lambda c, rs: (tau, tau))[0],
             "steps"),
            ("trajgen.step", lambda: tgen.step(st.traj_gen), "steps"),
            ("trajgen.window", lambda: tgen.get_trajectory(st.traj_gen),
             "steps"),
            ("contact_forces", lambda: env._contact_forces(robot, sim),
             "steps"),
            ("rewards", lambda: env._rewards(st, robot, f_contact,
                                             term_contact,
                                             first_contact.float(), air),
             "steps"),
            ("obs", lambda: env._obs(st), "steps"),
            ("do_reset(none)", lambda: env._do_reset(st, no_reset), "steps"),
            ("env.step", lambda: env.step(st, act), "steps")]:
        dt = mean_of(fn, reps, dev)
        print(f"{name:16s} {dt * 1e3:8.3f} ms  ({B / dt / 1e3:9.1f} "
              f"k{per}/s)", flush=True)
        out[name] = dt * 1e3

    # The fused learn iteration (rollout + GAE + update); env.step above
    # lets the update's share be inferred as iteration - 24 x step.
    cfg = PPOConfig()
    # the weights drawn on the CPU, as the runner draws them
    ac = ActorCritic(env.num_obs, env.num_actions,
                     generator=torch.Generator().manual_seed(1)).to(dev)
    train_gen = torch.Generator(device=dev)
    train_gen.manual_seed(1)
    ts = init_train_state(ac, cfg, train_gen)
    learn = make_learn_iteration(env, ac, cfg)
    dt = mean_of(lambda: learn(ts, st)[2]["mean_reward"], learn_reps, dev)
    steps = B * cfg.num_steps
    print(f"{'learn_iteration':16s} {dt * 1e3:8.3f} ms  "
          f"({steps / dt / 1e3:9.1f} kenv-steps/s)", flush=True)
    out["learn_iteration"] = dt * 1e3
    out["learn_env_steps_per_s"] = steps / dt
    out["decimation"] = sim.decimation
    out["num_steps"] = cfg.num_steps
    return out


def main(argv=None):
    args = parse(argv, __doc__, positional=(
        ("batch", int, 4096, "envs"),
        ("task", str, "anymal_c_trajectory", "registered task")))
    out = profile_quadruped(B=args.batch, task=args.task,
                            reps=args.reps or REPS,
                            learn_reps=args.reps or LEARN_REPS,
                            overrides=env_overrides(), device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
