"""Reduced-order-model (ROM) dynamics as batched PyTorch functions.

Counterpart of ``legged_gym_dev_tpu/core/rom.py``. Ported: the base class,
``SingleInt2D`` (the tube-MPC plan ROM) and ``DoubleInt2D`` (the closed-loop
plant), with the array form (``f``, ``proj_z``, ``clip_v_z``) and the entry
form (``f_entries``, ``f_jac_entries``) the staged solver uses. The other
four ROMs of the JAX package are not ported yet: ``make_rom`` raises
``NotImplementedError`` for them.

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

    def weighting_vector(self, w):
        return torch.tensor([w.position, w.position], dtype=torch.float32,
                            device=self.z_min.device)

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

    @property
    def vel_inds(self):
        return torch.tensor([False, False, True, True],
                            device=self.z_min.device)

    def weighting_vector(self, w):
        return torch.tensor([w.position, w.position, w.velocity, w.velocity],
                            dtype=torch.float32, device=self.z_min.device)

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


ROM_REGISTRY = {"SingleInt2D": SingleInt2D, "DoubleInt2D": DoubleInt2D}
_NOT_PORTED = ("Unicycle", "LateralUnicycle", "ExtendedUnicycle",
               "ExtendedLateralUnicycle")


def make_rom(name: str, dt, z_min, z_max, v_min, v_max,
             device=None) -> RomDynamics:
    """Registry lookup, as ``legged_gym_dev_tpu.core.rom.make_rom``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"ROM '{name}' is not ported yet")
    try:
        cls = ROM_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown ROM '{name}'. Known: "
            f"{sorted(ROM_REGISTRY) + sorted(_NOT_PORTED)}") from None
    return cls.create(dt, z_min, z_max, v_min, v_max, device=device)
