"""Assembled batched robot simulator: dynamics + contact + actuation.

Counterpart of ``legged_gym_dev_tpu/sim/robot_sim.py``. A ``RobotSim``
holds the model and the contact, spring and limit parameters:

    state' = sim.substep(state, tau)                   # one physics step
    state' = sim.step(state, torque_fn)                # decimation substeps
    state', carry = sim.step_with_carry(state, carry, torque_fn)

``substep`` takes the kernel's route (``ops/substep_kernels.substep``: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors) for every
sim that ``supports_kernel`` admits (flat terrain, per-robot springs), and
the plain version for the others (a heightfield), as the JAX package
routes non-flat terrain to its XLA path. ``use_pallas_substep`` picks the
route as the JAX field does: ``None`` (the default) and ``True`` take the
kernel where ``supports_kernel`` holds, ``False`` takes the plain version
(``substep_kernels.substep_plain``) also for CUDA tensors. ``create``
sets it from ``LGDT_PALLAS_SUBSTEP=0/1`` unless the caller names it.
The route is read from the sim alone.

``shard(mesh)`` cuts a sim into per-shard sims (per-env DR fields
sliced, everything on the shard's device), each a sim of its shard's envs
whose ``substep`` takes the shard kernel (``substep_kernels.substep_shard``,
K3s: designed for a shard's batch, equal to the substep kernel bit for
bit); the envs' replicas over a mesh (``envs.ShardedEnv``) step on them.
With ``shard_mesh`` set, ``substep`` on a whole batch goes shard by shard
through ``substep_kernels.substep_sharded`` on those sims (with
``use_pallas_substep=False``, the plain version on each shard's device).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import substep_kernels
from ..utils.runtime import resolve_device
from .contact import ContactParams, flat_terrain
from .dynamics import RobotModel, RobotState


@dataclasses.dataclass
class JointSprings:
    """Passive per-joint spring/damper to a setpoint (hopper foot spring)."""

    stiffness: torch.Tensor   # (nj,)
    damping: torch.Tensor     # (nj,)
    setpoint: torch.Tensor    # (nj,)

    def replace(self, **kw) -> "JointSprings":
        return dataclasses.replace(self, **kw)

    @classmethod
    def zero(cls, nj: int, device=None):
        dev = resolve_device(device)
        return cls(*(torch.zeros(nj, device=dev) for _ in range(3)))


@dataclasses.dataclass
class RobotSim:
    model: RobotModel
    contact: ContactParams
    springs: JointSprings
    # Optional per-env payload mass on the base body (B,) (domain
    # randomization); per-env friction rides through ``contact.friction``
    # shaped (B, 1, 1).
    base_mass_delta: Optional[torch.Tensor] = None
    dt: float = 0.005
    decimation: int = 4
    terrain_fn: Callable = flat_terrain
    joint_limit_stiffness: float = 1000.0
    joint_limit_damping: float = 10.0
    # Base linear/angular velocity cap (Isaac Gym's max_linear/
    # angular_velocity = 1000): keeps a contact blow-up from overflowing to
    # inf within one decimated step.
    base_vel_limit: float = 1000.0
    # The substep's route (module docstring). JAX's kernel route also needs
    # B % 1024 == 0 above 1024; the port's kernels take any batch.
    use_pallas_substep: Optional[bool] = None
    # Optional ``(mesh, axis)``: ``substep`` takes the kernel's route
    # through ``substep_sharded`` and gathers the result (the JAX sim's
    # ``pallas_substep_sharded`` route; a heightfield keeps the plain
    # substep).
    shard_mesh: Optional[tuple] = None
    # A shard's sim (from ``shard``): ``substep`` takes the shard kernel.
    is_shard: bool = False

    def replace(self, **kw) -> "RobotSim":
        return dataclasses.replace(self, **kw)

    def shard(self, mesh, axis="dp") -> list:
        """The per-shard sims over ``mesh``: shard i holds rows
        [i b, (i+1) b) of every per-env field (``base_mass_delta`` (B,);
        contact parameters of two or more dims, (B, 1), (B, 1, 1) or
        (B, nc)), and the model's, springs' and contact's tensors on its
        device; no mesh of their own, and ``is_shard`` set. Cut once per
        mesh and kept on the sim."""
        from ..parallel.mesh import place

        cache = self.__dict__.setdefault("_shards", {})
        key = (id(mesh), axis if isinstance(axis, str) else tuple(axis))
        hit = cache.get(key)
        if hit is not None and hit[0] is mesh:
            return hit[1]
        k = mesh.extent(axis)

        def rows(x, i, dev, per_env):
            if not per_env:
                return place(x, dev)
            if x.shape[0] % k:
                raise ValueError(f"a per-env field of {x.shape[0]} rows "
                                 f"does not divide over {k} shards")
            b = x.shape[0] // k
            return x[i * b:(i + 1) * b].to(dev, copy=True)

        bmd, c = self.base_mass_delta, self.contact
        out = []
        for i, dev in enumerate(mesh.devices.flat):
            contact = c.replace(**{
                f: rows(getattr(c, f), i, dev, getattr(c, f).ndim >= 2)
                for f in ("stiffness", "damping", "friction")},
                slip_vel=place(c.slip_vel, dev))
            out.append(self.replace(
                contact=contact, springs=place(self.springs, dev),
                base_mass_delta=(None if bmd is None else rows(
                    torch.as_tensor(bmd), i, dev,
                    torch.as_tensor(bmd).ndim >= 1)),
                terrain_fn=place(self.terrain_fn, dev),
                shard_mesh=None, is_shard=True))
        cache[key] = (mesh, out)
        return out

    @property
    def device(self) -> torch.device:
        return self.springs.stiffness.device

    @classmethod
    def create(cls, model, contact=None, springs=None, dt=0.005,
               decimation=4, terrain_fn=flat_terrain, device=None, **kw):
        """A sim of ``model``; ``LGDT_PALLAS_SUBSTEP=0/1`` in the
        environment sets ``use_pallas_substep`` unless ``kw`` names it."""
        dev = resolve_device(device)
        env_flag = os.environ.get("LGDT_PALLAS_SUBSTEP", "")
        if env_flag in ("0", "1"):
            kw.setdefault("use_pallas_substep", env_flag == "1")
        return cls(
            model=model,
            contact=contact or ContactParams.create(device=dev),
            springs=springs or JointSprings.zero(model.nj, device=dev),
            dt=float(dt), decimation=int(decimation), terrain_fn=terrain_fn,
            **kw)

    def default_state(self, batch: int, base_pos=(0.0, 0.0, 1.0),
                      q: Optional[torch.Tensor] = None) -> RobotState:
        nj, dev = self.model.nj, self.device
        return RobotState(
            base_pos=torch.as_tensor(np.asarray(base_pos, np.float32),
                                     device=dev).expand(batch, 3).clone(),
            base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0],
                                   device=dev).expand(batch, 4).clone(),
            q=(torch.zeros((batch, nj), device=dev) if q is None
               else torch.as_tensor(q, dtype=torch.float32, device=dev)
               .expand(batch, nj).clone()),
            v=torch.zeros((batch, 6 + nj), device=dev),
        )

    def substep(self, state: RobotState, tau: torch.Tensor) -> RobotState:
        """One physics step at self.dt with applied joint torques tau."""
        plain = self.use_pallas_substep is False
        kernel = not plain and substep_kernels.supports_kernel(self)
        if self.shard_mesh is not None and (plain or kernel):
            from ..parallel.mesh import gather

            return gather(substep_kernels.substep_sharded(
                self, state, tau, *self.shard_mesh,
                step=substep_kernels.substep_plain if plain else None))
        if not kernel:
            return substep_kernels.substep_plain(self, state, tau)
        if self.is_shard:
            return substep_kernels.substep_shard(self, state, tau)
        return substep_kernels.substep(self, state, tau)

    def step(self, state: RobotState,
             torque_fn: Callable[[RobotState], torch.Tensor]) -> RobotState:
        """Decimated control step: torques recomputed every substep."""
        for _ in range(self.decimation):
            state = self.substep(state, torque_fn(state))
        return state

    def step_with_carry(self, state: RobotState, carry,
                        torque_fn: Callable) -> tuple:
        """Decimated step with a stateful torque controller:
        ``torque_fn(carry, robot) -> (carry, tau)``, e.g. the LSTM actuator
        net, whose hidden state advances every substep."""
        for _ in range(self.decimation):
            carry, tau = torque_fn(carry, state)
            state = self.substep(state, tau)
        return state, carry
