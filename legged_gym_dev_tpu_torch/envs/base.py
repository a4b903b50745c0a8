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
from typing import Any, Callable, Dict, NamedTuple

import torch


class Transition(NamedTuple):
    obs: torch.Tensor          # (B, num_obs)
    privileged_obs: Any        # (B, num_privileged_obs) or None
    reward: torch.Tensor       # (B,)
    done: torch.Tensor         # (B,) bool: env was reset after this step
    info: Dict[str, Any]       # {'episode': {...}, 'time_outs': (B,), ...}


def scaled_reward_terms(term_table: Dict[str, Callable],
                        reward_scales: Dict[str, float], dt: float):
    """The active (name, fn, scale) list: each scale times the policy
    ``dt``, as the reference multiplies them; zero-scale terms and
    'termination' (added unscaled by dt after the clip) are left out."""
    active = []
    for name, scale in reward_scales.items():
        if scale == 0 or name == "termination":
            continue
        if name not in term_table:
            raise ValueError(
                f"Reward term '{name}' not in table {sorted(term_table)}")
        active.append((name, term_table[name], float(scale) * dt))
    return active


def compute_total_reward(active_terms, env, state, only_positive=False,
                         termination_fn=None, termination_scale=0.0):
    """(total, {name: term}): the scaled terms summed, the total clipped
    at 0 when ``only_positive``, then the termination term added after
    the clip."""
    total = 0.0
    episode = {}
    for name, fn, scale in active_terms:
        r = fn(env, state) * scale
        total = total + r
        episode[name] = r
    if only_positive:
        total = torch.clamp_min(torch.as_tensor(total), 0.0)
    if termination_fn is not None and termination_scale != 0.0:
        r = termination_fn(env, state) * termination_scale
        total = total + r
        episode["termination"] = r
    return total, episode


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


# ---------------------------------------------------------------------------
# Data-parallel replicas over a device mesh
# ---------------------------------------------------------------------------

def shard_env(env, mesh, axis="dp", per_env=()) -> list:
    """One replica of ``env`` per shard of ``mesh``: ``num_envs`` / shards
    envs each, its sim's shard (``sim.shard``), rows [i b, (i+1) b) of the
    fields named in ``per_env`` and every other tensor on the shard's
    device."""
    from ..parallel.mesh import place

    k = mesh.extent(axis)
    B = env.num_envs
    if B % k:
        raise ValueError(f"{B} envs do not divide over {k} shards")
    b = B // k
    sims = env.sim.shard(mesh, axis)
    names = {f.name for f in dataclasses.fields(env) if f.init}
    out = []
    for i, dev in enumerate(mesh.devices.flat):
        kw = {"sim": sims[i]}
        for name in names - {"sim"}:
            v = getattr(env, name)
            if name == "num_envs":
                kw[name] = b
            elif name in per_env and v is not None:
                kw[name] = v[i * b:(i + 1) * b].to(dev, copy=True)
            else:
                nv = place(v, dev)
                if nv is not v:
                    kw[name] = nv
        out.append(dataclasses.replace(env, **kw))
    return out


def shard_env_state(state, mesh, batch_size: int, generators, axis="dp"):
    """An env state cut into shards (``shard_batch`` with ``batch_size``),
    every generator replaced by the shard's own."""
    from ..parallel.mesh import Sharded, shard_batch, tree_map

    sh = shard_batch(state, mesh, axis, batch_size=batch_size)
    return Sharded([tree_map(lambda x, g=g: g if isinstance(
        x, torch.Generator) else x, s) for s, g in zip(sh, generators)],
        mesh, batch_size, sh.split)


class ShardedEnv:
    """An env's replicas over a device mesh (``env.shard``), stepped shard
    by shard: the port's counterpart of a JAX env stepped on a state
    sharded over the mesh. A step that reduces over the whole batch
    (``env.reduces_batch``, the velocity task's command curriculum) runs
    ``step_begin`` on every shard, sums the shards' ``batch_stats`` on the
    first device and finishes every shard with ``step_end`` on that sum,
    so the replicated state it updates stays equal on every shard."""

    def __init__(self, env, mesh, axis="dp"):
        self.env, self.mesh, self.axis = env, mesh, axis
        self.envs = env.shard(mesh, axis)

    @property
    def num_envs(self) -> int:
        return self.env.num_envs

    def reset(self, generators):
        """Each shard reset with its own generator: (states, obs), both
        ``Sharded``."""
        from ..parallel.mesh import Sharded

        out = [e.reset(g) for e, g in zip(self.envs, generators)]
        return (Sharded([s for s, _ in out], self.mesh, self.num_envs),
                Sharded([o for _, o in out], self.mesh, self.num_envs))

    def shard_state(self, state, generators):
        """A whole-batch state of ``env`` cut into the shards' states."""
        if hasattr(self.env, "shard_state"):
            return self.env.shard_state(state, self.mesh, generators,
                                        self.axis)
        return shard_env_state(state, self.mesh, self.num_envs, generators,
                               self.axis)

    def step(self, states, actions):
        """(states, transitions): ``Sharded`` states, one transition per
        shard."""
        from ..parallel.mesh import Sharded

        if getattr(self.env, "reduces_batch", False):
            ctxs = [e.step_begin(s, a)
                    for e, s, a in zip(self.envs, states, actions)]
            stats = [e.batch_stats(c) for e, c in zip(self.envs, ctxs)]
            total = stats[0]
            for x in stats[1:]:
                total = total + x.to(total.device)
            out = [e.step_end(c, total.to(e.device))
                   for e, c in zip(self.envs, ctxs)]
        else:
            out = [e.step(s, a)
                   for e, s, a in zip(self.envs, states, actions)]
        return (Sharded([s for s, _ in out], self.mesh, self.num_envs),
                [t for _, t in out])
