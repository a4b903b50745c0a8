"""ROM-only environment: a physics-free tracking sim for tube data.

Counterpart of ``legged_gym_dev_tpu/sim/rom_sim.py``: a simple model (a
double integrator "robot") tracks a single-integrator ROM trajectory with
no rigid-body physics, the data-collection path that needs no URDF.

``reset(gen) -> state`` and ``step(state, action) -> state``; random draws
come from the state's ``torch.Generator`` (the one its trajectory-generator
state holds), so the numbers differ from the JAX package's while the
deterministic parts match it given the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.maths import masked_update as _mwhere
from ..core.rom import RomDynamics
from ..trajgen.generator import TrajectoryGenerator, TrajGenState
from ..trajgen.samplers import f32


@dataclasses.dataclass
class RomSimState:
    gen: torch.Generator
    root_states: torch.Tensor     # (B, model.n)
    traj_gen: TrajGenState
    trajectory: torch.Tensor      # (B, N, rom.n) current interpolated window

    def replace(self, **kw) -> "RomSimState":
        return dataclasses.replace(self, **kw)


def _merge_traj_gen(mask, new: TrajGenState, old: TrajGenState,
                    batch: int) -> TrajGenState:
    """``new`` where ``mask`` and ``old`` elsewhere, field by field (fields
    without a leading batch axis take ``new``)."""
    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if (isinstance(a, torch.Tensor) and a.ndim >= 1
                and a.shape[0] == batch):
            out[f.name] = _mwhere(mask, a, b)
        else:
            out[f.name] = a
    return TrajGenState(**out)


@dataclasses.dataclass(frozen=True)
class RomSim:
    """ROM-tracking sim: ``model`` is the "robot", ``traj_gen.rom`` the
    reference. Reset draws the root state inside the init-noise bounds and
    offsets the ROM start from the robot's projection by up to
    ``max_rom_distance`` (no offset with probability
    ``zero_rom_dist_llh``)."""

    model: RomDynamics
    traj_gen: TrajectoryGenerator
    init_noise_lower: torch.Tensor   # (model.n,)
    init_noise_upper: torch.Tensor   # (model.n,)
    max_rom_distance: torch.Tensor   # (rom.n,)
    zero_rom_dist_llh: float = f32(0.05)
    randomize_rom_distance: bool = True
    num_envs: int = 1

    def replace(self, **kw) -> "RomSim":
        return dataclasses.replace(self, **kw)

    def shard(self, mesh, axis="dp") -> list:
        """One sim per shard of ``mesh``: ``num_envs`` / shards envs each,
        its tensors on the shard's device."""
        from ..parallel.mesh import place

        k = mesh.extent(axis)
        if self.num_envs % k:
            raise ValueError(f"{self.num_envs} envs do not divide over {k} "
                             f"shards")
        return [place(self, dev).replace(num_envs=self.num_envs // k)
                for dev in mesh.devices.flat]

    @property
    def rom(self) -> RomDynamics:
        return self.traj_gen.rom

    @property
    def device(self) -> torch.device:
        return self.init_noise_lower.device

    @classmethod
    def create(cls, model, traj_gen, num_envs, init_noise_lower,
               init_noise_upper, max_rom_distance, zero_rom_dist_llh=0.05,
               randomize_rom_distance=True):
        dev = model.z_min.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(model=model, traj_gen=traj_gen,
                   init_noise_lower=t(init_noise_lower),
                   init_noise_upper=t(init_noise_upper),
                   max_rom_distance=t(max_rom_distance),
                   zero_rom_dist_llh=f32(zero_rom_dist_llh),
                   randomize_rom_distance=bool(randomize_rom_distance),
                   num_envs=int(num_envs))

    # ------------------------------------------------------------------
    def reset(self, gen: torch.Generator) -> RomSimState:
        B, dev = self.num_envs, self.device
        state = RomSimState(
            gen=gen,
            root_states=torch.zeros((B, self.model.n), device=dev),
            traj_gen=self.traj_gen.init_state(gen, B),
            trajectory=torch.zeros((B, self.traj_gen.N, self.rom.n),
                                   device=dev))
        return self.reset_idx(state, torch.ones(B, dtype=torch.bool,
                                                device=dev))

    def _uniform(self, gen, shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=self.device)
        return lo + u * (hi - lo)

    def reset_idx(self, state: RomSimState,
                  mask: torch.Tensor) -> RomSimState:
        """Randomize root states and rebuild trajectories where ``mask``."""
        B, gen = self.num_envs, state.gen
        roots = self._uniform(gen, (B, self.model.n), self.init_noise_lower,
                              self.init_noise_upper)
        root_states = _mwhere(mask, roots, state.root_states)

        # the ROM starts at the robot's projection, optionally offset
        p_zx = self.rom.proj_z(root_states)
        if self.randomize_rom_distance:
            offset_on = (torch.rand(B, generator=gen, device=self.device)
                         > self.zero_rom_dist_llh)
            offset = self._uniform(gen, p_zx.shape, -self.max_rom_distance,
                                   self.max_rom_distance)
            p_zx = torch.where((mask & offset_on)[:, None], p_zx + offset,
                               p_zx)

        tg = self.traj_gen.reset(state.traj_gen, mask, p_zx)
        state = state.replace(root_states=root_states, traj_gen=tg)
        # The reset ends with a zero-action step, for the reset envs only:
        # this runs inside the per-step masked auto-reset, and an unmasked
        # step would advance every other env's clock twice a policy step.
        stepped = self.step(state, torch.zeros((B, self.model.m),
                                               device=self.device))
        return state.replace(
            root_states=_mwhere(mask, stepped.root_states,
                                state.root_states),
            traj_gen=_merge_traj_gen(mask, stepped.traj_gen, state.traj_gen,
                                     B),
            trajectory=_mwhere(mask, stepped.trajectory, state.trajectory))

    # ------------------------------------------------------------------
    def step(self, state: RomSimState, action: torch.Tensor) -> RomSimState:
        """model.f, one trajectory-generator tick and the window refresh."""
        tg = self.traj_gen.step(state.traj_gen)
        return state.replace(root_states=self.model.f(state.root_states,
                                                      action),
                             traj_gen=tg,
                             trajectory=self.traj_gen.get_trajectory(tg))

    def get_observations(self, state: RomSimState) -> torch.Tensor:
        """[root_state, next planned z, next planned v]."""
        return torch.cat([state.root_states, state.trajectory[:, 0, :],
                          state.traj_gen.v_trajectory[:, 1, :]], dim=1)

    def get_state(self, state: RomSimState) -> torch.Tensor:
        return state.root_states
