"""Functional RL environment protocol.

Counterpart of ``legged_gym_dev_tpu/envs/base.py``: an env is a config
object whose methods transform an explicit state,

    state, obs         = env.reset(generator)
    state, transition  = env.step(state, actions)

and ``Transition`` carries the rsl_rl VecEnv quintuple (obs, privileged
obs, reward, done, extras).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch


class Transition(NamedTuple):
    obs: torch.Tensor          # (B, num_obs)
    privileged_obs: Any        # (B, num_privileged_obs) or None
    reward: torch.Tensor       # (B,)
    done: torch.Tensor         # (B,) bool: env was reset after this step
    info: Dict[str, Any]       # {'episode': {...}, 'time_outs': (B,), ...}


def guard_finite_state(robot, safe_state, explosion_vel: float = 50.0):
    """Detect and neutralize envs whose physics state went non-finite or
    whose base velocity exceeds ``explosion_vel`` (no legged robot moves at
    tens of m/s; a contact resonance can ring at the velocity cap without
    going inf). Flagged envs take ``safe_state``'s values and are reported
    so the caller force-terminates them.

    Returns ``(sanitized_robot, bad_mask)``.
    """
    bad = ~(torch.isfinite(robot.base_pos).all(-1)
            & torch.isfinite(robot.base_quat).all(-1)
            & torch.isfinite(robot.q).all(-1)
            & torch.isfinite(robot.v).all(-1))
    # torch.amax propagates NaN as jnp.max does; NaN > x is False, and the
    # isfinite test above has flagged the env already.
    bad = bad | (torch.amax(torch.abs(robot.v[..., :6]), dim=-1)
                 > explosion_vel)

    def fix(x, s):
        m = bad.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(m, s, x)

    fields = {f.name: fix(getattr(robot, f.name), getattr(safe_state, f.name))
              for f in dataclasses.fields(robot)}
    return type(robot)(**fields), bad
