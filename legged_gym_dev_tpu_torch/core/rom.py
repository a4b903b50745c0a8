"""Reduced-order-model (ROM) dynamics as batched PyTorch functions.

Counterpart of ``legged_gym_dev_tpu/core/rom.py``: the base class and all
six ROMs of the zoo (``SingleInt2D``, the tube-MPC plan ROM;
``DoubleInt2D``, the closed-loop plant; the unicycle family), each with
the array form (``f``, ``proj_z``, ``des_pose_vel``, ``clip_v``,
``clip_v_z``) and the entry form (``f_entries``, ``f_jac_entries``) the
staged solver uses.

A ROM comes in two forms. The shared form serves a whole scenario batch:
``dt`` is a Python float (held exactly at its float32 value, as the JAX leaf
is float32) and the bounds are ``(n,)`` / ``(m,)`` tensors. The per-scenario
form is the JAX package's vmapped ROM pytree: ``dt`` is a ``(B,)`` float32
tensor and/or the bounds are ``(B, n)`` / ``(B, m)`` (``create`` with
arrays, ``stack``). Array-form methods take inputs whose leading axis is the
scenario axis, ``(B, ..., n)``; entry-form methods take entries ``(..., B,
T)`` (the scenario axis second to last, a candidate axis may lead), where a
per-scenario ``dt`` acts as a ``(B, 1)`` column. Products with a float32
``dt`` tensor round as those with the float it replaces: one rounding of the
exact product either way.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import ClassVar, Sequence, Union

import numpy as np
import torch

from ..utils.runtime import resolve_device
from .maths import quat_to_euler_xyz, yaw2rot


@dataclass(frozen=True)
class RomDynamics:
    """Base ROM: discrete dynamics, projection and input clipping."""

    n: ClassVar[int]
    m: ClassVar[int]

    dt: Union[float, torch.Tensor]  # float, or (B,) per scenario
    z_min: torch.Tensor  # (n,) or (B, n)
    z_max: torch.Tensor  # (n,) or (B, n)
    v_min: torch.Tensor  # (m,) or (B, m)
    v_max: torch.Tensor  # (m,) or (B, m)

    @classmethod
    def create(cls, dt, z_min, z_max, v_min, v_max,
               device=None) -> "RomDynamics":
        """The shared form from a scalar ``dt`` and ``(n,)`` / ``(m,)``
        bounds; the per-scenario form where ``dt`` is ``(B,)`` or a bound
        carries a leading ``B`` axis."""
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(dt=float(np.float32(dt)) if np.ndim(dt) == 0 else t(dt),
                   z_min=t(z_min), z_max=t(z_max), v_min=t(v_min),
                   v_max=t(v_max))

    @classmethod
    def stack(cls, roms: Sequence["RomDynamics"],
              device=None) -> "RomDynamics":
        """The per-scenario form of ``roms`` (one ROM of this class a
        scenario, each shared-form) on ``device`` (None = the CUDA card)."""
        if any(type(r) is not cls for r in roms):
            raise ValueError(f"stack needs {cls.__name__} ROMs")
        return cls.create(
            [float(r.dt) for r in roms],
            *(np.stack([getattr(r, k).cpu().numpy() for r in roms])
              for k in ("z_min", "z_max", "v_min", "v_max")), device=device)

    def replace(self, **kw) -> "RomDynamics":
        return replace(self, **kw)

    @property
    def per_scenario(self) -> bool:
        """True for the per-scenario form (a leading ``B`` axis on ``dt``
        or on the bounds)."""
        return isinstance(self.dt, torch.Tensor) or self.z_min.ndim == 2

    @property
    def batch_size(self):
        """The scenario count of the per-scenario form, else None."""
        if isinstance(self.dt, torch.Tensor):
            return self.dt.shape[0]
        return self.z_min.shape[0] if self.z_min.ndim == 2 else None

    def select(self, rows) -> "RomDynamics":
        """The per-scenario ROM of scenarios ``rows`` (a slice or an index
        tensor); the shared form is every scenario's, and is returned."""
        def take(t):
            return t[rows] if isinstance(t, torch.Tensor) and (
                t.ndim == 2 or t is self.dt) else t

        return replace(self, dt=take(self.dt), z_min=take(self.z_min),
                       z_max=take(self.z_max), v_min=take(self.v_min),
                       v_max=take(self.v_max))

    def to(self, device) -> "RomDynamics":
        dt = self.dt
        return replace(self, dt=dt.to(device) if isinstance(
                           dt, torch.Tensor) else dt,
                       z_min=self.z_min.to(device),
                       z_max=self.z_max.to(device),
                       v_min=self.v_min.to(device),
                       v_max=self.v_max.to(device))

    def _dt(self, x):
        """``dt`` against an array-form input ``x (B, ..., k)``."""
        dt = self.dt
        if isinstance(dt, torch.Tensor):
            return dt.reshape(dt.shape + (1,) * (x.ndim - 1))
        return dt

    @property
    def _dt_e(self):
        """``dt`` against entries ``(..., B, T)``: a float or ``(B, 1)``."""
        dt = self.dt
        return dt[:, None] if isinstance(dt, torch.Tensor) else dt

    @staticmethod
    def _bound(t, x):
        """A bound ``(k,)`` or ``(B, k)`` against ``x (B, ..., k)``."""
        if t.ndim == 2:
            return t.reshape(t.shape[:1] + (1,) * (x.ndim - 2) + t.shape[1:])
        return t

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
        return (self._bound(self.v_min, z).expand(shape),
                self._bound(self.v_max, z).expand(shape))

    def _state_input_bounds(self, z, k):
        """Input bounds shrunk so the velocity states ``z[..., k:]`` stay
        inside [z_min, z_max] after one step."""
        dt = self._dt(z)
        z_min, z_max = self._bound(self.z_min, z), self._bound(self.z_max, z)
        v_max_z = torch.minimum(self._bound(self.v_max, z),
                                (z_max[..., k:] - z[..., k:]) / dt)
        v_min_z = torch.maximum(self._bound(self.v_min, z),
                                (z_min[..., k:] - z[..., k:]) / dt)
        return v_min_z, v_max_z

    def clip_v(self, v):
        """``v (B, ..., m)`` clipped to [v_min, v_max], shared or per
        scenario."""
        return torch.clamp(v, self._bound(self.v_min, v),
                           self._bound(self.v_max, v))

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
        return z + self._dt(z) * v

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
        dt = self._dt_e
        return [z_e[0] + dt * v_e[0], z_e[1] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
        return ([[1.0, 0.0], [0.0, 1.0]], [[dt, 0.0], [0.0, dt]])


@dataclass(frozen=True)
class DoubleInt2D(RomDynamics):
    """2D double integrator: z=[x,y,vx,vy], v=[ax,ay]."""

    n: ClassVar[int] = 4
    m: ClassVar[int] = 2

    def f(self, z, v):
        dt = self._dt(z)
        pos = z[..., :2] + dt * z[..., 2:]
        vel = z[..., 2:] + dt * v
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
        return self._state_input_bounds(z, 2)

    def f_entries(self, z_e, v_e):
        dt = self._dt_e
        return [z_e[0] + dt * z_e[2], z_e[1] + dt * z_e[3],
                z_e[2] + dt * v_e[0], z_e[3] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
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
        return z + self._dt(z) * torch.stack([dx, dy, dth], dim=-1)

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
        dt = self._dt_e
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * v_e[0] * c, z_e[1] + dt * v_e[0] * s,
                z_e[2] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
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
        return z + self._dt(z) * torch.stack([dx, dy, v[..., 2]], dim=-1)

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
        dt = self._dt_e
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * (v_e[0] * c - v_e[1] * s),
                z_e[1] + dt * (v_e[0] * s + v_e[1] * c),
                z_e[2] + dt * v_e[2]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
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
        return z + self._dt(z) * torch.stack(
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
        return self._state_input_bounds(z, 3)

    def weighting_vector(self, w):
        return self._weights(w.position, w.position, w.orientation,
                             w.velocity, w.angular_velocity)

    def f_entries(self, z_e, v_e):
        dt = self._dt_e
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * z_e[3] * c, z_e[1] + dt * z_e[3] * s,
                z_e[2] + dt * z_e[4], z_e[3] + dt * v_e[0],
                z_e[4] + dt * v_e[1]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
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
        return z + self._dt(z) * torch.cat(
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
        dt = self._dt_e
        c, s = torch.cos(z_e[2]), torch.sin(z_e[2])
        return [z_e[0] + dt * (z_e[3] * c - z_e[4] * s),
                z_e[1] + dt * (z_e[3] * s + z_e[4] * c),
                z_e[2] + dt * z_e[5], z_e[3] + dt * v_e[0],
                z_e[4] + dt * v_e[1], z_e[5] + dt * v_e[2]]

    def f_jac_entries(self, z_e, v_e):
        dt = self._dt_e
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
