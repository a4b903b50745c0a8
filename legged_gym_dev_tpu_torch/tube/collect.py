"""ROM-tracking data collection: the rollout recorder.

Counterpart of ``legged_gym_dev_tpu/tube/collect.py``: rolls a policy in a
tracking env and records, at every ROM tick, the planned ROM state ``z``,
the achieved projection ``pz_x``, the applied ROM input ``v`` and the
termination flags.

With the env's uniform clock the ROM tick cadence is fixed, so the inner
loop is a fixed ``round(rom.dt / dt_loop)`` env steps. The loops hold no
host sync: records stay on the device, time-major, and move to the host
once at the end. Envs that terminated within a tick get their planned
state snapped to the projection, so the recorded tracking error is zero.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..sim.rom_sim import RomSim, RomSimState
from .datasets import RolloutData


def _ticks(episode_length_s, rom_dt, dt_loop) -> Tuple[int, int]:
    """(T ROM ticks, env steps a tick)."""
    T = int(round(float(episode_length_s) / float(rom_dt)))
    return T, max(1, int(round(float(rom_dt) / float(dt_loop))))


def _to_host(z0, pz0, zs, pzs, vs, dones) -> RolloutData:
    """Device records (a list of (B, .) per tick for each field) -> host
    ``RolloutData``, episode-major with the t=0 row first: one transfer
    per field."""
    z = torch.cat([z0[:, None], torch.stack(zs, dim=1)], dim=1)
    pz_x = torch.cat([pz0[:, None], torch.stack(pzs, dim=1)], dim=1)
    v = torch.stack(vs, dim=1)
    done = torch.stack(dones, dim=1)
    return RolloutData(z=z.cpu().numpy(), v=v.cpu().numpy(),
                       pz_x=pz_x.cpu().numpy(), done=done.cpu().numpy())


def rom_tick(sim: RomSim, policy: Callable, state: RomSimState,
             steps: int):
    """One ROM tick of ``collect_rom_tracking``: ``steps`` sim steps, then
    the records (z_t, pz_x, v_t, done_t). RomSim never terminates."""
    for _ in range(steps):
        state = sim.step(state, policy(sim.get_observations(state)))
    proj = sim.rom.proj_z(state.root_states)
    z_t = sim.traj_gen.get_trajectory(state.traj_gen)[:, 0, :]
    done_t = torch.zeros(sim.num_envs, dtype=torch.bool, device=sim.device)
    return state, (torch.where(done_t[:, None], proj, z_t), proj,
                   state.traj_gen.v, done_t)


def _record(T, tick, carry):
    """Run ``tick`` T times from ``carry``: the final carry and the
    records, one list per field."""
    recs = []
    for _ in range(T):
        *carry, rec = tick(*carry)
        recs.append(rec)
    return carry, [list(field) for field in zip(*recs)]


def collect_rom_tracking(sim: RomSim, policy: Callable,
                         gen: torch.Generator, episode_length_s: float
                         ) -> Tuple[RolloutData, RomSimState]:
    """One epoch of ROM-tracking data from every env of ``sim``, reset from
    ``gen``: host ``RolloutData`` of shapes (B, T+1, n) / (B, T, m) /
    (B, T) with T = episode_length_s / rom.dt, and the final state."""
    T, steps = _ticks(episode_length_s, sim.rom.dt, sim.traj_gen.dt_loop)
    state = sim.reset(gen)
    z0 = sim.traj_gen.get_trajectory(state.traj_gen)[:, 0, :]
    pz0 = sim.rom.proj_z(state.root_states)
    (state,), recs = _record(
        T, lambda s: rom_tick(sim, policy, s, steps), [state])
    return _to_host(z0, pz0, *recs), state


def collect_epochs(sim: RomSim, policy: Callable, gen: torch.Generator,
                   episode_length_s: float, epochs: int) -> RolloutData:
    """Several epochs, each from a fresh reset, concatenated along the
    episode axis."""
    return RolloutData.concatenate([
        collect_rom_tracking(sim, policy, gen, episode_length_s)[0]
        for _ in range(epochs)])


def velocity_tick(env, policy: Callable, traj_gen, state, tg, steps: int,
                  Kp: float = 1.0):
    """One ROM tick of ``collect_velocity_tracking``: (state, tg,
    records)."""
    from ..core.maths import quat_to_yaw, yaw2rot

    rom = traj_gen.rom
    done_t = torch.zeros(env.num_envs, dtype=torch.bool, device=env.device)
    for _ in range(steps):
        pz_x = rom.proj_z(state.robot.root_states)
        z_des = traj_gen.get_trajectory(tg)[:, 0, :2]
        cmd_world = Kp * (z_des - pz_x[:, :2]) + tg.v[:, :2]
        yaw = quat_to_yaw(state.robot.base_quat)
        cmd_body = torch.clamp(
            torch.einsum("bij,bj->bi", yaw2rot(yaw), cmd_world), -1.0, 1.0)
        commands = state.commands.clone()
        commands[:, :2] = cmd_body
        commands[:, 2] = 0.0
        state = state.replace(commands=commands)
        # the policy acts on the freshly written command
        state, tr = env.step(state, policy(env._obs(state)))
        tg = traj_gen.step(tg)
        done_t = done_t | tr.done
    pz_x = rom.proj_z(state.robot.root_states)
    z_t = traj_gen.get_trajectory(tg)[:, 0, :]
    return state, tg, (torch.where(done_t[:, None], pz_x, z_t), pz_x, tg.v,
                       done_t)


def collect_velocity_tracking(env, policy: Callable, traj_gen,
                              gen: torch.Generator, episode_length_s: float,
                              Kp: float = 1.0) -> RolloutData:
    """ROM tracking through a velocity-command policy: an external ROM
    trajectory generator makes the plan, and a P law on the projection
    error writes [vx, vy] commands (rotated into the base yaw frame and
    clipped to [-1, 1]; yaw rate 0) into the env's command slots before
    the observation the policy acts on is built. Records (z, pz_x, v,
    done) at ROM ticks as ``collect_tracking`` does."""
    rom = traj_gen.rom
    T, steps = _ticks(episode_length_s, rom.dt, env.dt)
    B = env.num_envs
    state, _ = env.reset(gen)
    tg = traj_gen.init_state(gen, B)
    tg = traj_gen.reset(tg, torch.ones(B, dtype=torch.bool,
                                       device=env.device),
                        rom.proj_z(state.robot.root_states))
    pz0 = rom.proj_z(state.robot.root_states)
    z0 = traj_gen.get_trajectory(tg)[:, 0, :]
    _, recs = _record(T, lambda s, g: velocity_tick(
        env, policy, traj_gen, s, g, steps, Kp), [state, tg])
    return _to_host(z0, pz0, *recs)


def build_raibert_obs(env, state) -> torch.Tensor:
    """The Raibert heuristic's observation [pos_err (2), vel (2),
    des_vel (2), quat_xyzw (4)] from the env's internals."""
    pz_x = env.rom.proj_z(state.robot.root_states)
    des_pos = state.trajectory[:, -1, :]
    des_vel = env.traj_gen.get_v_trajectory(state.traj_gen)[:, -1, :2]
    return torch.cat([des_pos - pz_x, state.robot.v[:, :2], des_vel,
                      state.robot.base_quat], dim=-1)


def tracking_tick(env, policy: Callable, state, obs, steps: int,
                  raibert_obs: bool = False):
    """One ROM tick of ``collect_tracking``: (state, obs, records)."""
    done_t = torch.zeros(env.num_envs, dtype=torch.bool, device=env.device)
    for _ in range(steps):
        a_in = build_raibert_obs(env, state) if raibert_obs else obs
        state, tr = env.step(state, policy(a_in))
        obs = tr.obs
        done_t = done_t | tr.done
    pz_x = env.rom.proj_z(state.robot.root_states)
    z_t = torch.where(done_t[:, None], pz_x, state.trajectory[:, 0, :])
    return state, obs, (z_t, pz_x, state.traj_gen.v, done_t)


def collect_tracking(env, policy: Callable, gen: torch.Generator,
                     episode_length_s: float,
                     raibert_obs: bool = False) -> RolloutData:
    """ROM-tracking data from a rigid-body trajectory env (the hopper, the
    quadruped trajectory task: anything with ``rom``, ``traj_gen``, a
    ``trajectory`` window and ``robot.root_states``). ``raibert_obs=True``
    feeds the policy the Raibert observation (``build_raibert_obs``)
    instead of the policy observation."""
    T, steps = _ticks(episode_length_s, env.rom.dt, env.dt)
    state, obs = env.reset(gen)
    pz0 = env.rom.proj_z(state.robot.root_states)
    z0 = state.trajectory[:, 0, :]
    _, recs = _record(T, lambda s, o: tracking_tick(
        env, policy, s, o, steps, raibert_obs), [state, obs])
    return _to_host(z0, pz0, *recs)


# The collector's first name: it was written for the hopper.
collect_hopper_tracking = collect_tracking
