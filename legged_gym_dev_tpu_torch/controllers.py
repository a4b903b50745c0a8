"""Hand-designed tracking controllers.

Counterpart of ``legged_gym_dev_tpu/controllers.py``: ``omega_to_quat``,
the Raibert-heuristic hopper policy (which the hopper trajectory task's
``raibert`` reward term compares the policy's action with, and which
drives the hopper's tube-data collection) and the PD law by which a
double integrator tracks a single-integrator plan (the ROM-tracking
collection's policy).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .core.maths import quat_to_yaw
from .trajgen.samplers import f32


def omega_to_quat(omega_pitch, omega_roll, omega_yaw):
    """Euler (pitch, roll, yaw) -> (w,x,y,z) quaternion as the reference
    builds it."""
    cy, sy = torch.cos(omega_yaw * 0.5), torch.sin(omega_yaw * 0.5)
    cp, sp = torch.cos(omega_pitch * 0.5), torch.sin(omega_pitch * 0.5)
    cr, sr = torch.cos(omega_roll * 0.5), torch.sin(omega_roll * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack((w, x, y, z), dim=-1)


@dataclasses.dataclass(frozen=True)
class RaibertHeuristic:
    """Raibert-style hopper orientation policy: [pos_err(2), vel(2),
    des_vel(2), quat_xyzw(4)] observations -> a desired orientation
    quaternion (w,x,y,z). Gains are held at their float32 values."""

    Kp: float
    Kv: float
    Kff: float
    clip_pos: float
    clip_vel: float
    clip_ang: float

    def replace(self, **kw) -> "RaibertHeuristic":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, Kp, Kv, Kff, clip_pos, clip_vel, clip_ang):
        return cls(*(f32(v) for v in (Kp, Kv, Kff, clip_pos, clip_vel,
                                      clip_ang)))

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        """Sign conventions as the reference's."""
        pos_error_x = obs[:, 0]
        pos_error_y = -obs[:, 1]
        cur_err_vel_x = -obs[:, 2]
        cur_err_vel_y = obs[:, 3]
        des_vel_x = obs[:, 4]
        des_vel_y = -obs[:, 5]

        def clip(x, c):
            return torch.clamp(x, -c, c)

        pitch_pos = clip(-self.Kp * pos_error_x, self.clip_pos)
        roll_pos = clip(-self.Kp * pos_error_y, self.clip_pos)
        vel_x = clip(-self.Kv * cur_err_vel_x + self.Kff * des_vel_x,
                     self.clip_vel)
        vel_y = clip(-self.Kv * cur_err_vel_y + self.Kff * des_vel_y,
                     self.clip_vel)
        omega_pitch = clip(pitch_pos + vel_x, self.clip_ang)
        omega_roll = clip(roll_pos + vel_y, self.clip_ang)
        yaw = quat_to_yaw(obs[:, 6:10])
        return omega_to_quat(omega_pitch, omega_roll, yaw)


@dataclasses.dataclass(frozen=True)
class DoubleSingleTracking:
    """PD law for a double integrator tracking a single-integrator plan,
    projected onto the state-dependent input bounds ``clip_v_z``.

    Observation layout: [x (4), z_des (2), v_des (2)]."""

    Kp: float
    Kd: float
    clip_v_z: Callable

    def replace(self, **kw) -> "DoubleSingleTracking":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, Kp, Kd, clip_v_z):
        return cls(Kp=f32(Kp), Kd=f32(Kd), clip_v_z=clip_v_z)

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs[:, :4]
        z_des = obs[:, 4:6]
        v_des = obs[:, 6:8]
        u = self.Kp * (z_des - x[:, :2]) + self.Kd * (v_des - x[:, 2:])
        return self.clip_v_z(x, u)
