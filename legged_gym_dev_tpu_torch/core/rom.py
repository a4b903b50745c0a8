"""Reduced-order-model (ROM) dynamics as batched PyTorch functions.

Counterpart of ``legged_gym_dev_tpu/core/rom.py``: the base class and all
six ROMs of the zoo (``SingleInt2D``, the tube-MPC plan ROM;
``DoubleInt2D``, the closed-loop plant; the unicycle family), each with
the array form (``f``, ``proj_z``, ``des_pose_vel``, ``clip_v_z``) and the
entry form (``f_entries``, ``f_jac_entries``) the staged solver uses.

One ROM is shared by a whole scenario batch: ``dt`` is a Python float (held
exactly at its float32 value, as the JAX leaf is float32) and the bounds are
``(n,)`` / ``(m,)`` tensors. Methods take any leading batch axes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import ClassVar

import numpy as np
import torch

from ..utils.runtime import resolve_device
from .maths import quat_to_euler_xyz, yaw2rot


@dataclass(frozen=True)
class RomDynamics:
    """Base ROM: discrete dynamics, projection and input clipping."""

    n: ClassVar[int]
    m: ClassVar[int]

    dt: float
    z_min: torch.Tensor  # (n,)
    z_max: torch.Tensor  # (n,)
    v_min: torch.Tensor  # (m,)
    v_max: torch.Tensor  # (m,)

    @classmethod
    def create(cls, dt, z_min, z_max, v_min, v_max,
               device=None) -> "RomDynamics":
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(dt=float(np.float32(dt)), z_min=t(z_min), z_max=t(z_max),
                   v_min=t(v_min), v_max=t(v_max))

    def to(self, device) -> "RomDynamics":
        return replace(self, z_min=self.z_min.to(device),
                       z_max=self.z_max.to(device),
                       v_min=self.v_min.to(device),
                       v_max=self.v_max.to(device))

    def f(self, z, v):
        raise NotImplementedError

    def proj_z(self, x):
        raise NotImplementedError

    def des_pose_vel(self, z, v):
        """Desired (x, y, yaw) pose and (vx, vy, yawdot) velocity, (..., 3)
        each."""
        raise NotImplementedError

    def _mask(self, *flags) -> torch.Tensor:
        return torch.tensor(flags, dtype=torch.bool, device=self.z_min.device)

    def _weights(self, *values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32,
                            device=self.z_min.device)

    @property
    def vel_inds(self) -> torch.Tensor:
        """Boolean mask over z marking velocity-like states."""
        return torch.zeros(self.n, dtype=torch.bool, device=self.z_min.device)

    def weighting_vector(self, w) -> torch.Tensor:
        """Per-dim reward weights from a ``RewardWeighting`` config."""
        raise NotImplementedError

    def compute_state_dependent_input_bounds(self, z):
        shape = z.shape[:-1] + (self.m,)
        return self.v_min.expand(shape), self.v_max.expand(shape)

    def clip_v_z(self, z, v):
        v_min_z, v_max_z = self.compute_state_dependent_input_bounds(z)
        return torch.minimum(torch.maximum(v, v_min_z), v_max_z)

    def f_entries(self, z_e, v_e):
        """Entry-form dynamics: lists of coordinate tensors -> list of n."""
        raise NotImplementedError

    def f_jac_entries(self, z_e, v_e):
        """Exact Jacobians (A, B) as nested lists: A[i][j] = df_i/dz_j,
        B[i][j] = df_i/dv_j; entries are tensors or Python floats (0.0 is
        a symbolic zero the staged solver skips)."""
        raise NotImplementedError


@dataclass(frozen=True)
class SingleInt2D(RomDynamics):
    """2D single integrator: z=[x,y], v=[vx,vy]."""

    n: ClassVar[int] = 2
    m: ClassVar[int] = 2

    def f(self, z, v):
        return z + self.dt * v

    def proj_z(self, x):
        return x[..., :2]

    def des_pose_vel(self, z, v):
        yaw = torch.atan2(v[..., 1], v[..., 0])
        pose = torch.cat([z, yaw[..., None]], dim=-1)
        vel = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        return pose, vel

    def weighting_vector(self, w):
        return self._weights(w.position, w.position)

    def f_entries(self, z_e, v_e):
        return [z_e[0] + self.dt * v_e[0], z_e[1] + self.dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        return ([[1.0, 0.0], [0.0, 1.0]], [[dt, 0.0], [0.0, dt]])


@dataclass(frozen=True)
class DoubleInt2D(RomDynamics):
    """2D double integrator: z=[x,y,vx,vy], v=[ax,ay]."""

    n: ClassVar[int] = 4
    m: ClassVar[int] = 2

    def f(self, z, v):
        pos = z[..., :2] + self.dt * z[..., 2:]
        vel = z[..., 2:] + self.dt * v
        return torch.cat([pos, vel], dim=-1)

    def proj_z(self, x):
        return torch.cat([x[..., :2], x[..., 7:9]], dim=-1)

    def des_pose_vel(self, z, v):
        yaw = torch.atan2(z[..., 3], z[..., 2])
        pose = torch.cat([z[..., :2], yaw[..., None]], dim=-1)
        vel = torch.cat([z[..., 2:], torch.zeros_like(z[..., :1])], dim=-1)
        return pose, vel

    @property
    def vel_inds(self):
        return self._mask(False, False, True, True)

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.velocity, w.velocity)

    def compute_state_dependent_input_bounds(self, z):
        """Shrink the accel bounds so velocities stay inside [z_min, z_max]."""
        v_max_z = torch.minimum(self.v_max,
                                (self.z_max[2:] - z[..., 2:]) / self.dt)
        v_min_z = torch.maximum(self.v_min,
                                (self.z_min[2:] - z[..., 2:]) / self.dt)
        return v_min_z, v_max_z

    def f_entries(self, z_e, v_e):
        dt = self.dt
        return [z_e[0] + dt * z_e[2], z_e[1] + dt * z_e[3],
                z_e[2] + dt * v_e[0], z_e[3] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        A = [[1.0, 0.0, dt, 0.0], [0.0, 1.0, 0.0, dt],
             [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
        B = [[0.0, 0.0], [0.0, 0.0], [dt, 0.0], [0.0, dt]]
        return A, B


@dataclass(frozen=True)
class Unicycle(RomDynamics):
    """Unicycle: z=[x,y,th], v=[v,om]."""

    n: ClassVar[int] = 3
    m: ClassVar[int] = 2

    def f(self, z, v):
        dx = v[..., 0] * torch.cos(z[..., 2])
        dy = v[..., 0] * torch.sin(z[..., 2])
        dth = v[..., 1]
        return z + self.dt * torch.stack([dx, dy, dth], dim=-1)

    def proj_z(self, x):
        yaw = quat_to_euler_xyz(x[..., 3:7])[..., 2]
        return torch.cat([x[..., :2], yaw[..., None]], dim=-1)

    def des_pose_vel(self, z, v):
        vx = v[..., 0] * torch.cos(z[..., 2])
        vy = v[..., 0] * torch.sin(z[..., 2])
        return z[..., :3], torch.stack([vx, vy, v[..., 1]], dim=-1)

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.orientation)

    def f_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * v_e[0] * c, z_e[1] + dt * v_e[0] * s,
                z_e[2] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        A = [[1.0, 0.0, -dt * v_e[0] * s],
             [0.0, 1.0, dt * v_e[0] * c],
             [0.0, 0.0, 1.0]]
        B = [[dt * c, 0.0], [dt * s, 0.0], [0.0, dt]]
        return A, B


@dataclass(frozen=True)
class LateralUnicycle(Unicycle):
    """Unicycle with a lateral slip input: v=[v, v_perp, om]."""

    n: ClassVar[int] = 3
    m: ClassVar[int] = 3

    def f(self, z, v):
        c, s = torch.cos(z[..., 2]), torch.sin(z[..., 2])
        dx = v[..., 0] * c - v[..., 1] * s
        dy = v[..., 0] * s + v[..., 1] * c
        return z + self.dt * torch.stack([dx, dy, v[..., 2]], dim=-1)

    def des_pose_vel(self, z, v):
        c, s = torch.cos(z[..., 2]), torch.sin(z[..., 2])
        vx = v[..., 0] * c - v[..., 1] * s
        vy = v[..., 0] * s + v[..., 1] * c
        # yawdot from v[..., 1], as the JAX package and the reference
        return z[..., :3], torch.stack([vx, vy, v[..., 1]], dim=-1)

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.orientation,
                             w.velocity, w.velocity, w.angular_velocity)

    def f_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * (v_e[0] * c - v_e[1] * s),
                z_e[1] + dt * (v_e[0] * s + v_e[1] * c),
                z_e[2] + dt * v_e[2]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        A = [[1.0, 0.0, dt * (-v_e[0] * s - v_e[1] * c)],
             [0.0, 1.0, dt * (v_e[0] * c - v_e[1] * s)],
             [0.0, 0.0, 1.0]]
        B = [[dt * c, -dt * s, 0.0], [dt * s, dt * c, 0.0], [0.0, 0.0, dt]]
        return A, B


def _local_planar_velocity(x):
    """Yaw of the 13-dim state's quaternion, and its world x-y velocity in
    the yaw frame."""
    yaw = quat_to_euler_xyz(x[..., 3:7])[..., 2]
    v_local = torch.einsum("...ij,...j->...i", yaw2rot(yaw), x[..., 7:9])
    return yaw, v_local


@dataclass(frozen=True)
class ExtendedUnicycle(Unicycle):
    """Unicycle with velocity states: z=[x,y,th,v,om], v=[a,al]."""

    n: ClassVar[int] = 5
    m: ClassVar[int] = 2

    def f(self, z, v):
        dx = z[..., 3] * torch.cos(z[..., 2])
        dy = z[..., 3] * torch.sin(z[..., 2])
        return z + self.dt * torch.stack(
            [dx, dy, z[..., 4], v[..., 0], v[..., 1]], dim=-1)

    def proj_z(self, x):
        yaw, v_local = _local_planar_velocity(x)
        return torch.cat([x[..., :2], yaw[..., None], v_local[..., :1],
                          x[..., 12:13]], dim=-1)

    def des_pose_vel(self, z, v):
        vx = z[..., 3] * torch.cos(z[..., 2])
        vy = z[..., 3] * torch.sin(z[..., 2])
        return z[..., :3], torch.stack([vx, vy, z[..., 4]], dim=-1)

    @property
    def vel_inds(self):
        return self._mask(False, False, False, True, True)

    def compute_state_dependent_input_bounds(self, z):
        """Shrink the input bounds so the velocity states stay inside
        [z_min, z_max]."""
        v_max_z = torch.minimum(self.v_max,
                                (self.z_max[3:] - z[..., 3:]) / self.dt)
        v_min_z = torch.maximum(self.v_min,
                                (self.z_min[3:] - z[..., 3:]) / self.dt)
        return v_min_z, v_max_z

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.orientation,
                             w.velocity, w.angular_velocity)

    def f_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * z_e[3] * c, z_e[1] + dt * z_e[3] * s,
                z_e[2] + dt * z_e[4], z_e[3] + dt * v_e[0],
                z_e[4] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        A = [[1.0, 0.0, -dt * z_e[3] * s, dt * c, 0.0],
             [0.0, 1.0, dt * z_e[3] * c, dt * s, 0.0],
             [0.0, 0.0, 1.0, 0.0, dt],
             [0.0, 0.0, 0.0, 1.0, 0.0],
             [0.0, 0.0, 0.0, 0.0, 1.0]]
        B = [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [dt, 0.0], [0.0, dt]]
        return A, B


@dataclass(frozen=True)
class ExtendedLateralUnicycle(ExtendedUnicycle):
    """z=[x,y,th,v,v_perp,om], v=[a,a_perp,al]."""

    n: ClassVar[int] = 6
    m: ClassVar[int] = 3

    def f(self, z, v):
        c, s = torch.cos(z[..., 2]), torch.sin(z[..., 2])
        dx = z[..., 3] * c - z[..., 4] * s
        dy = z[..., 3] * s + z[..., 4] * c
        return z + self.dt * torch.cat(
            [torch.stack([dx, dy, z[..., 5]], dim=-1), v], dim=-1)

    def proj_z(self, x):
        yaw, v_local = _local_planar_velocity(x)
        return torch.cat([x[..., :2], yaw[..., None], v_local,
                          x[..., 12:13]], dim=-1)

    def des_pose_vel(self, z, v):
        c, s = torch.cos(z[..., 2]), torch.sin(z[..., 2])
        vx = z[..., 3] * c - z[..., 4] * s
        vy = z[..., 3] * s + z[..., 4] * c
        return z[..., :3], torch.stack([vx, vy, z[..., 5]], dim=-1)

    @property
    def vel_inds(self):
        return self._mask(False, False, False, True, True, True)

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.orientation,
                             w.velocity, w.velocity, w.angular_velocity)

    def f_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * (z_e[3] * c - z_e[4] * s),
                z_e[1] + dt * (z_e[3] * s + z_e[4] * c),
                z_e[2] + dt * z_e[5], z_e[3] + dt * v_e[0],
                z_e[4] + dt * v_e[1], z_e[5] + dt * v_e[2]]

    def f_jac_entries(self, z_e, v_e):
        dt = self.dt
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        A = [[1.0, 0.0, dt * (-z_e[3] * s - z_e[4] * c), dt * c, -dt * s,
              0.0],
             [0.0, 1.0, dt * (z_e[3] * c - z_e[4] * s), dt * s, dt * c, 0.0],
             [0.0, 0.0, 1.0, 0.0, 0.0, dt],
             [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
             [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
             [0.0, 0.0, 0.0, 0.0, 0.0, 1.0]]
        B = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
             [dt, 0.0, 0.0], [0.0, dt, 0.0], [0.0, 0.0, dt]]
        return A, B


ROM_REGISTRY = {
    "SingleInt2D": SingleInt2D,
    "DoubleInt2D": DoubleInt2D,
    "Unicycle": Unicycle,
    "LateralUnicycle": LateralUnicycle,
    "ExtendedUnicycle": ExtendedUnicycle,
    "ExtendedLateralUnicycle": ExtendedLateralUnicycle,
}


def make_rom(name: str, dt, z_min, z_max, v_min, v_max,
             device=None) -> RomDynamics:
    """Registry lookup, as ``legged_gym_dev_tpu.core.rom.make_rom``."""
    try:
        cls = ROM_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown ROM '{name}'. Known: {sorted(ROM_REGISTRY)}") from None
    return cls.create(dt, z_min, z_max, v_min, v_max, device=device)
