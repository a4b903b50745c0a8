"""ROM trajectory-tracking RL environment (physics-free robot model).

Counterpart of ``legged_gym_dev_tpu/envs/rom_tracking.py``: the
trajectory-tracking task on the ROM-only simulator, where a simple model
(a double integrator) tracks a rolling ROM trajectory window.

- Observations: the root state, the trajectory window relative to the
  robot's projected position, and the previous action.
- Rewards (each times ``scale * dt``): ``tracking_rom``, the exp of the
  weighted squared projection error; ``differential_error``, the change of
  the error's norm; ``action_rate``.
- Termination is the time limit only (``time_outs`` in the info); the
  per-term episode sums of the envs that reset are reported over episode
  seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..sim.rom_sim import RomSim, RomSimState
from .base import Transition, shard_env


@dataclasses.dataclass
class RomTrackingEnvState:
    gen: torch.Generator
    sim: RomSimState
    prev_action: torch.Tensor      # (B, act_dim)
    prev_error: torch.Tensor       # (B, rom.n) squared error, previous
    episode_step: torch.Tensor     # (B,) int32
    episode_sums: Dict[str, torch.Tensor]  # per-term reward sums (B,)

    def replace(self, **kw) -> "RomTrackingEnvState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RomTrackingEnv:
    sim: RomSim
    reward_weighting: torch.Tensor   # (rom.n,)
    tracking_sigma: float
    reward_scales: tuple = (("tracking_rom", 1.0),
                            ("differential_error", 0.0),
                            ("action_rate", -0.01))
    episode_length_s: float = 20.0
    only_positive_rewards: bool = False

    def replace(self, **kw) -> "RomTrackingEnv":
        return dataclasses.replace(self, **kw)

    def shard(self, mesh, axis="dp") -> list:
        """One env per shard of ``mesh`` (``envs.base.shard_env``)."""
        return shard_env(self, mesh, axis)

    # ---- sizes -----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.sim.device

    @property
    def num_envs(self) -> int:
        return self.sim.num_envs

    @property
    def num_actions(self) -> int:
        return self.sim.model.m

    @property
    def num_obs(self) -> int:
        return (self.sim.model.n + self.sim.traj_gen.N * self.sim.rom.n
                + self.num_actions)

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.dt))

    @property
    def dt(self) -> float:
        return float(self.sim.traj_gen.dt_loop)

    # ---- reward terms ----------------------------------------------------
    def _sq_error(self, sim: RomSimState) -> torch.Tensor:
        pz_x = self.sim.rom.proj_z(sim.root_states)
        return torch.square(pz_x - sim.trajectory[:, 0, :])

    def _reward_tracking_rom(self, state: RomTrackingEnvState):
        err = self._sq_error(state.sim) @ self.reward_weighting
        return torch.exp(-err / self.tracking_sigma)

    def _reward_differential_error(self, state: RomTrackingEnvState):
        """The error norm's change (the scale sets the sign)."""
        err = torch.linalg.vector_norm(self._sq_error(state.sim), dim=-1)
        return err - torch.linalg.vector_norm(state.prev_error, dim=-1)

    def _reward_action_rate(self, state: RomTrackingEnvState, action):
        return torch.sum(torch.square(action - state.prev_action), dim=-1)

    # ---- API -------------------------------------------------------------
    def _obs(self, state: RomTrackingEnvState) -> torch.Tensor:
        pz_x = self.sim.rom.proj_z(state.sim.root_states)
        rel_traj = state.sim.trajectory - pz_x[:, None, :]
        return torch.cat([state.sim.root_states,
                          rel_traj.reshape(self.num_envs, -1),
                          state.prev_action], dim=-1)

    def reset(self, gen: torch.Generator
              ) -> Tuple[RomTrackingEnvState, torch.Tensor]:
        B, dev = self.num_envs, self.device

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        state = RomTrackingEnvState(
            gen=gen, sim=self.sim.reset(gen),
            prev_action=zeros(B, self.num_actions),
            prev_error=zeros(B, self.sim.rom.n),
            episode_step=torch.zeros(B, dtype=torch.int32, device=dev),
            episode_sums={name: zeros(B) for name, _ in self.reward_scales})
        return state, self._obs(state)

    def step(self, state: RomTrackingEnvState, actions: torch.Tensor
             ) -> Tuple[RomTrackingEnvState, Transition]:
        actions = self.sim.model.clip_v_z(state.sim.root_states, actions)
        sim_state = self.sim.step(state.sim, actions)
        mid = state.replace(sim=sim_state)

        rews = {}
        for name, scale in self.reward_scales:
            if scale == 0.0:
                continue
            if name == "tracking_rom":
                r = self._reward_tracking_rom(mid)
            elif name == "differential_error":
                r = self._reward_differential_error(mid)
            elif name == "action_rate":
                r = self._reward_action_rate(mid, actions)
            else:
                raise ValueError(f"unknown reward term {name}")
            rews[name] = r * (scale * self.dt)
        total = sum(rews.values())
        if self.only_positive_rewards:
            total = torch.clamp(total, min=0.0)
        episode_sums = {k: v + rews[k] if k in rews else v
                        for k, v in state.episode_sums.items()}

        # termination: the time limit only
        episode_step = state.episode_step + 1
        done = episode_step >= self.max_episode_length
        # per-term sums of the envs that reset this step over episode
        # seconds; the consumer divides by the reset count
        episode_info = {
            "rew_" + k: torch.sum(torch.where(done, v, 0.0))
            / self.episode_length_s for k, v in episode_sums.items()}

        sim_state = self.sim.reset_idx(sim_state, done)
        new_state = RomTrackingEnvState(
            gen=state.gen, sim=sim_state,
            prev_action=torch.where(done[:, None], 0.0, actions),
            prev_error=self._sq_error(sim_state),
            episode_step=torch.where(done, 0, episode_step),
            episode_sums={k: torch.where(done, 0.0, v)
                          for k, v in episode_sums.items()})
        info = {"episode": episode_info, "time_outs": done,
                "n_resets": done.sum()}
        return new_state, Transition(obs=self._obs(new_state),
                                     privileged_obs=None, reward=total,
                                     done=done, info=info)
