"""Trajectory-tracking locomotion environment (generic legged robot).

Counterpart of ``legged_gym_dev_tpu/envs/legged_robot_trajectory.py``: the
velocity commands are replaced by a rolling ROM-trajectory window the
robot must track.

- Observations: [base lin vel, base ang vel, projected gravity,
  (trajectory window - rom.proj_z(root_states)) flattened, dof pos rel
  default, dof vel, actions] (65 dims for 12 joints, SingleInt2D, N=10),
  then on a heightfield the height scan (252 dims with its 187 points).
- One trajectory-generator tick per env step.
- Rewards ``tracking_rom`` (weighted exp of the squared projection error)
  and ``differential_error`` (asymmetric slopes on the error increment),
  the command-gate-free ``feet_air_time``; every other term delegates to
  the velocity env's table.
- Random-interval pushes: a per-env countdown; on expiry the base's xy
  velocity is set to a random value and the countdown is resampled.
- ROM-distance randomization on trajectory reset: with probability
  1 - zero_rom_dist_llh the window is rebuilt around proj_z(x) + U(-d, d).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.maths import masked_update as _mwhere
from ..core.maths import quat_to_rotmat
from ..trajgen.generator import TrajectoryGenerator, TrajGenState
from .base import Transition
from .legged_robot_velocity import (
    LeggedRobotVelocityEnv,
    VelocityEnvState,
    _uniform,
)


@dataclasses.dataclass
class TrajectoryEnvState(VelocityEnvState):
    """Velocity-env state + trajectory tracking extras. ``commands`` holds
    the ROM's desired velocity, so shared reward gates see it."""

    traj_gen: TrajGenState = None
    trajectory: torch.Tensor = None          # (B, N, rom.n)
    prev_error: torch.Tensor = None          # (B, rom.n) squared error
    time_until_next_push: torch.Tensor = None  # (B,) seconds


@dataclasses.dataclass
class LeggedRobotTrajectoryEnv(LeggedRobotVelocityEnv):
    """ROM-trajectory tracking task on the batched rigid-body sim."""

    traj_gen: Optional[TrajectoryGenerator] = None
    reward_weighting: Optional[torch.Tensor] = None   # (rom.n,)
    max_rom_distance: Optional[torch.Tensor] = None   # (rom.n,)
    zero_rom_dist_llh: float = 0.25
    diff_err_slopes: tuple = (4.0, 1.0)    # (pos_slope, neg_slope)
    time_between_pushes: tuple = (0.5, 10.0)
    randomize_rom_distance: bool = True

    @property
    def rom(self):
        return self.traj_gen.rom

    @property
    def reduces_batch(self) -> bool:
        return False        # the trajectory task has no command curriculum

    @property
    def n_traj(self) -> int:
        return self.traj_gen.N

    @property
    def num_obs(self) -> int:
        return (3 + 3 + 3 + self.rom.n * self.n_traj + 3 * self.nj
                + self.num_height_points)

    # ---- observations -----------------------------------------------------
    def _obs(self, state: TrajectoryEnvState) -> torch.Tensor:
        robot = state.robot
        B = self.num_envs
        R = quat_to_rotmat(robot.base_quat)
        lin_vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        gravity_body = -R[:, 2, :]
        mod_traj = state.trajectory - self.rom.proj_z(
            robot.root_states)[:, None, :]
        obs = self._with_heights([
            lin_vel_body * 2.0,
            robot.v[:, 3:6] * 0.25,
            gravity_body,
            mod_traj.reshape(B, -1),
            (robot.q - self.default_dof_pos) * 1.0,
            robot.v[:, 6:] * 0.05,
            state.actions,
        ], robot)
        return self._noisy(state, obs)

    # ---- resets -------------------------------------------------------------
    def reset(self, gen: torch.Generator):
        B, dev = self.num_envs, self.device
        state = TrajectoryEnvState(**self._initial_state(
            gen,
            traj_gen=self.traj_gen.init_state(gen, B),
            trajectory=torch.zeros((B, self.n_traj, self.rom.n),
                                   device=dev),
            prev_error=torch.zeros((B, self.rom.n), device=dev),
            time_until_next_push=torch.zeros(B, device=dev)))
        state = self._do_reset(state, torch.ones(B, dtype=torch.bool,
                                                 device=dev))
        return state, self._obs(state)

    def _do_reset(self, state: TrajectoryEnvState, mask):
        # Robot/DR resets are the velocity task's; its command resample is
        # overwritten below with the ROM's desired velocity.
        state = super()._do_reset(state, mask)
        B, dev, gen = self.num_envs, self.device, state.gen
        p_zx = self.rom.proj_z(state.robot.root_states)
        if self.randomize_rom_distance and self.max_rom_distance is not None:
            offset_on = (torch.rand(B, generator=gen, device=dev)
                         > self.zero_rom_dist_llh)
            offset = _uniform(gen, p_zx.shape, -self.max_rom_distance,
                              self.max_rom_distance, dev)
            p_zx = p_zx + torch.where(offset_on[:, None], offset, 0.0)
        tgen = self._traj_gen_cur(state)
        tg = tgen.reset(state.traj_gen, mask, p_zx)
        trajectory = tgen.get_trajectory(tg)
        push_t = _uniform(gen, (B,), self.time_between_pushes[0],
                          self.time_between_pushes[1], dev)
        return state.replace(
            traj_gen=tg,
            trajectory=trajectory,
            commands=self._rom_commands(state.commands, tg),
            prev_error=_mwhere(mask, torch.zeros((B, self.rom.n),
                                                 device=dev),
                               state.prev_error),
            time_until_next_push=torch.where(mask, push_t,
                                             state.time_until_next_push),
        )

    def _rom_commands(self, commands, tg: TrajGenState):
        """The ROM's desired planar velocity in the commands buffer."""
        v = tg.v[:, :2]
        if v.shape[-1] < 2:
            v = torch.nn.functional.pad(v, (0, 2 - v.shape[-1]))
        return torch.cat([v, torch.zeros_like(commands[:, 2:])], dim=-1)

    def _traj_gen_cur(self, state) -> TrajectoryGenerator:
        """Trajectory generator under the current curriculum stage (the
        base env has no curriculum tables)."""
        return self.traj_gen

    # ---- rewards ------------------------------------------------------------
    def _rewards(self, state, robot, f_contact, term_contact, first_contact,
                 air_time, names=None) -> Dict[str, torch.Tensor]:
        desired = state.trajectory[:, 0, :]
        pz_x = self.rom.proj_z(robot.root_states)
        sq_err = torch.square(pz_x - desired)

        own = {}
        rest = []
        for name in (names if names is not None
                     else [n for n, _ in self.reward_scales]):
            if name == "tracking_rom":
                err = sq_err @ self.reward_weighting
                own[name] = torch.exp(-err / self.tracking_sigma)
            elif name == "differential_error":
                err = torch.linalg.vector_norm(sq_err, dim=-1)
                diff = err - torch.linalg.vector_norm(state.prev_error,
                                                      dim=-1)
                pos_s, neg_s = self.diff_err_slopes
                own[name] = torch.where(diff < 0, neg_s, pos_s) * diff
            elif name == "feet_air_time":
                own[name] = torch.sum((air_time - 0.5) * first_contact,
                                      dim=-1)
            else:
                rest.append(name)
        own.update(super()._rewards(state, robot, f_contact, term_contact,
                                    first_contact, air_time, names=rest))
        return own

    # ---- step ---------------------------------------------------------------
    def step(self, state: TrajectoryEnvState,
             actions) -> Tuple[TrajectoryEnvState, Transition]:
        B, dev = self.num_envs, self.device
        actions = torch.clamp(actions, -100.0, 100.0)
        state = state.replace(actions=actions)
        state, robot, nonfinite = self._physics(state)

        # trajectory-generator tick at the policy rate
        tgen = self._traj_gen_cur(state)
        tg = tgen.step(state.traj_gen)
        trajectory = tgen.get_trajectory(tg)
        state = state.replace(robot=robot, traj_gen=tg, trajectory=trajectory,
                              commands=self._rom_commands(state.commands, tg))

        c = self._contacts_and_done(state, robot, nonfinite)
        done = c["done"]
        rews = self._rewards(state, robot, c["f_contact"], c["term_contact"],
                             c["first_contact"].float(), c["air_time"])
        total, episode_sums, episode_info = self._total_reward(state, rews,
                                                               done)

        # random-interval pushes: xy base velocity set on countdown expiry
        gen = state.gen
        countdown = state.time_until_next_push - self.dt
        need_push = countdown <= 0.0
        push_vel = _uniform(gen, (B, 2), -self.max_push_vel,
                            self.max_push_vel, dev)
        robot = robot.replace(v=torch.cat([
            torch.where(need_push[:, None], push_vel, robot.v[:, :2]),
            robot.v[:, 2:]], dim=-1))
        next_push = _uniform(gen, (B,), self.time_between_pushes[0],
                             self.time_between_pushes[1], dev)
        countdown = torch.where(need_push, next_push, countdown)

        desired = trajectory[:, 0, :]
        pz_x = self.rom.proj_z(robot.root_states)
        new_state = state.replace(
            robot=robot, last_actions=actions, last_dof_vel=robot.v[:, 6:],
            feet_air_time=torch.where(c["contact_filt"], 0.0, c["air_time"]),
            last_contacts=c["contact"],
            prev_error=torch.square(pz_x - desired),
            episode_step=c["episode_step"], episode_sums=episode_sums,
            time_until_next_push=countdown)
        new_state = self._do_reset(new_state, done)
        obs = self._obs(new_state)
        info = {"episode": episode_info, "time_outs": c["time_out"],
                "n_resets": done.sum()}
        return new_state, Transition(obs=obs, privileged_obs=None,
                                     reward=total, done=done, info=info)
