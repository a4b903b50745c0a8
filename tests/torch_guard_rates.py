"""How often ``guard_finite_state`` flags an env (non-finite state, or a
base velocity above 50) in the port's velocity task and in the JAX
package's, on a test robot of tests/torch_robot_cases.py.

Both envs are built by ``tests/torch_robot_steps.build`` (the same preset
on the same URDF, observation noise off), reset with their own random
draws, and stepped ``steps`` times with the same numpy-drawn actions
(normal, std 1 by default: a fresh policy's spread; a larger ``std``
drives the contacts harder). Beside the flags: the resets and the mean
and largest planar base speed over the envs and steps. The draws are not matched
between the packages, so the two counts are compared as rates, not env
by env. Not a test (no bar): it says whether a flag rate seen in a long
run on the card is the port's or the robot's.

    JAX_PLATFORMS=cpu python -m tests.torch_guard_rates ROBOT B STEPS \
        [STD] [COMPILED]
    JAX_PLATFORMS=cpu python -m tests.torch_guard_rates cassie 512 30 1 0

The JAX step is compiled once (a minute or two on the CPU for A1), or
with COMPILED=0 run op by op (``jax.disable_jit``; Cassie's compile takes
longer than its 30 steps op by op, about 15 s each at B=512); its flags
leave it through ``jax.debug.callback``.
"""
import contextlib
import json
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

import legged_gym_dev_tpu.envs.legged_robot_velocity as jax_velocity
import legged_gym_dev_tpu_torch.envs.legged_robot_velocity as port_velocity
from tests import torch_robot_cases as rc
from tests.torch_robot_steps import build

URDFS = {"cassie": "CASSIE_URDF", "a1": "A1_URDF",
         "anymal_c": "QUADRUPED_URDF"}


def counting(module, counts, traced=False):
    """Wraps ``module.guard_finite_state`` to append each call's count of
    flagged envs (``traced``: through ``jax.debug.callback``, so that the
    count leaves a compiled step). Returns the original."""
    guard = module.guard_finite_state

    def counted(robot, safe_state, *a, **kw):
        robot, bad = guard(robot, safe_state, *a, **kw)
        if traced:
            jax.debug.callback(lambda n: counts.append(int(n)), bad.sum())
        else:
            counts.append(int(bad.sum()))
        return robot, bad

    module.guard_finite_state = counted
    return guard


def planar_speed(v):
    """Each env's planar base speed (m/s)."""
    return np.linalg.norm(v[:, :2], axis=-1)


def main(robot="cassie", B=512, steps=30, std=1.0, compiled=1):
    jenv, tenv = build(robot, getattr(rc, URDFS[robot]), num_envs=B)
    actions = np.random.default_rng(0).normal(
        0.0, std, (steps, B, tenv.nj)).astype(np.float32)
    out = {"robot": robot, "batch": B, "steps": steps, "action_std": std}
    counts = {"port": [], "jax": []}
    saved = (counting(port_velocity, counts["port"]),
             counting(jax_velocity, counts["jax"], traced=True))
    try:
        ts, _ = tenv.reset(torch.Generator().manual_seed(0))
        done, speed = 0, []
        for a in actions:
            ts, tr = tenv.step(ts, torch.as_tensor(a))
            done += int(tr.done.sum())
            speed.append(planar_speed(ts.robot.v.numpy()))
        out["port"] = dict(flags=sum(counts["port"]), done=done,
                           mean_base_speed=float(np.mean(speed)),
                           max_base_speed=float(np.max(speed)))
        with contextlib.ExitStack() as ctx:
            if not compiled:
                ctx.enter_context(jax.disable_jit())
            js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
            step = jax.jit(jenv.step)
            done, speed = 0, []
            for a in actions:
                js, jtr = step(js, jnp.asarray(a))
                done += int(np.asarray(jtr.done).sum())
                speed.append(planar_speed(np.asarray(js.robot.v)))
        out["jax"] = dict(flags=sum(counts["jax"]), done=done,
                          mean_base_speed=float(np.mean(speed)),
                          max_base_speed=float(np.max(speed)))
    finally:
        port_velocity.guard_finite_state, jax_velocity.guard_finite_state = \
            saved
    for k in ("port", "jax"):
        out[k]["flags_per_env_step"] = out[k]["flags"] / (B * steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*args[:1], *(int(a) for a in args[1:3]),
         *(float(a) for a in args[3:4]), *(int(a) for a in args[4:5]))
