"""Hopper velocity-command RL environment.

Counterpart of ``legged_gym_dev_tpu/envs/hopper_velocity.py``: the hopper
of the trajectory task (same controller, DR, resets and penalty terms,
``HopperCommon``) driven by resampled (vx, vy, wz) velocity commands
instead of a rolling ROM window.

- Observations (21): [z, quat, body lin vel, body ang vel, wheel vels,
  commands, normalized action quat]; the commands get no noise, and the
  observations are not clipped.
- Commands resampled every ``resampling_time_s`` within the ranges; planar
  commands below 0.05 m/s snapped to zero.
- 6-dim pushes on per-env timers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..core.maths import masked_update as _mwhere
from ..core.maths import quat_to_rotmat
from ..sim.dynamics import RobotState
from ..sim.robot_sim import RobotSim
from .base import Transition
from .hopper_trajectory import HopperCommon, HopperDR
from .legged_robot_velocity import _uniform

HOPPER_VELOCITY_REWARD_SCALES = (
    ("termination", -5.0),
    ("tracking_lin_vel", 1.0),
    ("tracking_ang_vel", 0.5),
    ("orientation", -1.0),
    ("action_rate", -0.1),
    ("torques", -0.00001),
    ("dof_acc", -2.5e-7),
    ("unit_quat", -0.1),
)


@dataclasses.dataclass
class HopperVelEnvState:
    gen: torch.Generator
    robot: RobotState
    commands: torch.Tensor            # (B, 3) [vx, vy, wz]
    actions: torch.Tensor             # (B, 4) raw policy actions (quat wxyz)
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor        # (B, 4)
    torques: torch.Tensor             # (B, 4)
    time_until_next_push: torch.Tensor  # (B,) seconds
    episode_step: torch.Tensor        # (B,) int32
    episode_sums: Dict[str, torch.Tensor]
    dr: HopperDR
    common_step: int = 0

    def replace(self, **kw) -> "HopperVelEnvState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class HopperVelocityEnv(HopperCommon):
    sim: RobotSim
    p_gains: torch.Tensor
    d_gains: torch.Tensor
    kd_spindown: torch.Tensor
    spring_stiffness: float
    spring_damping: float
    spring_setpoint: float
    foot_pos_des: float
    rot_actuator: torch.Tensor
    torque_limits: torch.Tensor
    wheel_speed_limit: float
    ts_ratio: float
    obs_scales: torch.Tensor        # (21,)
    noise_vec: torch.Tensor         # (21,)
    command_ranges: torch.Tensor    # (3, 2) [[vx lo hi], [vy], [wz]]
    tracking_sigma: float
    max_push_vel: torch.Tensor      # (6,)
    reward_scales: tuple = HOPPER_VELOCITY_REWARD_SCALES
    control_type: str = "orientation_spindown"
    add_noise: bool = True
    domain_rand: bool = True
    episode_length_s: float = 20.0
    resampling_time_s: float = 10.0
    push_robots: bool = True
    time_between_pushes: tuple = (0.5, 10.0)
    foot_sphere: int = 1
    termination_spheres: tuple = (0, 2, 3, 4)
    num_envs: int = 4096

    def replace(self, **kw) -> "HopperVelocityEnv":
        return dataclasses.replace(self, **kw)

    @property
    def num_obs(self) -> int:
        return 1 + 4 + 3 + 3 + 3 + 3 + 4

    def _sample_commands(self, gen) -> torch.Tensor:
        lo, hi = self.command_ranges[:, 0], self.command_ranges[:, 1]
        cmd = _uniform(gen, (self.num_envs, 3), lo, hi, self.device)
        keep = torch.linalg.vector_norm(cmd[:, :2], dim=-1) > 0.05
        return torch.cat([cmd[:, :2] * keep[:, None].float(), cmd[:, 2:]],
                         dim=-1)

    def _obs(self, state: HopperVelEnvState) -> torch.Tensor:
        return self._scaled_obs(state, [state.commands])

    def reset(self, gen: torch.Generator
              ) -> Tuple[HopperVelEnvState, torch.Tensor]:
        B, dev = self.num_envs, self.device
        state = HopperVelEnvState(**self._base_state(
            gen, commands=torch.zeros((B, 3), device=dev)))
        state = self._do_reset(state, torch.ones(B, dtype=torch.bool,
                                                 device=dev))
        return state, self._obs(state)

    def _do_reset(self, state: HopperVelEnvState,
                  mask) -> HopperVelEnvState:
        B, dev, gen = self.num_envs, self.device, state.gen
        robot = self._reset_robot(state, mask, gen)
        dr = self._resample_dr(state.dr, mask, gen)
        ident = self._identity_actions()
        first_push = _uniform(gen, (B,), self.time_between_pushes[0],
                              self.time_between_pushes[1], dev)
        return state.replace(
            robot=robot,
            commands=_mwhere(mask, self._sample_commands(gen),
                             state.commands),
            actions=_mwhere(mask, ident, state.actions),
            last_actions=_mwhere(mask, ident, state.last_actions),
            last_dof_vel=_mwhere(mask, torch.zeros((B, 4), device=dev),
                                 state.last_dof_vel),
            time_until_next_push=torch.where(mask, first_push,
                                             state.time_until_next_push),
            episode_step=torch.where(mask, 0, state.episode_step),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()},
            dr=dr)

    def _rewards(self, state: HopperVelEnvState, robot: RobotState, actions,
                 torques, term_contact) -> Dict[str, torch.Tensor]:
        R = quat_to_rotmat(robot.base_quat)
        lin_vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        out, rest = {}, []
        for name, _ in self.reward_scales:
            if name == "tracking_lin_vel":
                err = torch.sum(torch.square(
                    state.commands[:, :2] - lin_vel_body[:, :2]), dim=-1)
                out[name] = torch.exp(-err / self.tracking_sigma)
            elif name == "tracking_ang_vel":
                err = torch.square(state.commands[:, 2] - robot.v[:, 5])
                out[name] = torch.exp(-err / self.tracking_sigma)
            else:
                rest.append(name)
        out.update(self._common_rewards(state, robot, actions, torques,
                                        term_contact, rest))
        return out

    def step(self, state: HopperVelEnvState,
             actions) -> Tuple[HopperVelEnvState, Transition]:
        actions = torch.clamp(actions, -100.0, 100.0)
        state = state.replace(actions=actions)
        robot, torques = self._physics(state)

        term_contact = self._term_contact(robot)
        episode_step = state.episode_step + 1
        time_out = episode_step >= self.max_episode_length
        done = term_contact | time_out

        rews = self._rewards(state, robot, actions, torques, term_contact)
        total, episode_sums, episode_info = self._total_reward(
            state, rews, term_contact, done)

        # commands resampled on a fixed clock, then pushes
        resample_every = max(int(round(self.resampling_time_s / self.dt)), 1)
        commands = _mwhere((episode_step % resample_every) == 0,
                           self._sample_commands(state.gen), state.commands)
        robot, timer = self._push(state, robot, self.max_push_vel, 1.0)

        new_state = state.replace(
            robot=robot, commands=commands,
            common_step=state.common_step + 1, last_actions=actions,
            last_dof_vel=robot.v[:, 6:], torques=torques,
            time_until_next_push=timer, episode_step=episode_step,
            episode_sums=episode_sums)
        new_state = self._do_reset(new_state, done)
        obs = self._obs(new_state)
        info = {"episode": episode_info, "time_outs": time_out,
                "n_resets": done.sum()}
        return new_state, Transition(obs=obs, privileged_obs=None,
                                     reward=total, done=done, info=info)
