"""Batched ROM trajectory generation with explicit state.

Counterpart of ``legged_gym_dev_tpu/trajgen/generator.py``
(``TrajectoryGenerator`` and the scripted zero/square/circle fixtures of
the deterministic evaluation, with ``TRAJ_GEN_REGISTRY``). All per-env
state lives in a ``TrajGenState`` and every update is a masked batch
update:

- 4 input modes (sample-hold / ramp / extreme bang-bang / sinusoid) mixed
  by sampled simplex weights;
- an asynchronous two-rate clock: the env loop ticks at ``dt_loop``, the
  ROM advances only where ``t >= k * rom.dt``;
- a rolling window of ``N * dN`` ROM states, interpolated to the env clock
  and strided by ``dN``;
- stationary envs, whose inputs and velocity states are zeroed;
- reset rebuilds the window by stepping ``N * dN`` ROM ticks.

Random draws come from the state's ``torch.Generator`` (``gen``), so the
numbers differ from the JAX package's; the deterministic parts
(``step_rom``, ``step``, ``get_trajectory``) match it given the same state.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.maths import masked_update as _mwhere
from ..core.rom import DoubleInt2D, RomDynamics, SingleInt2D
from .samplers import UniformSampleHoldDT, UniformWeightSampler, f32


@dataclasses.dataclass
class TrajGenState:
    """All per-env trajectory-generator state (leading batch axis B)."""

    gen: torch.Generator
    t: torch.Tensor                 # (B,) env-loop time
    k: torch.Tensor                 # (B,) ROM tick counter (float)
    t_final: torch.Tensor           # (B,) current mode expiry time
    weights: torch.Tensor           # (B, 4) input-mode mixture
    sample_hold_input: torch.Tensor  # (B, m)
    extreme_input: torch.Tensor     # (B, m)
    ramp_t_start: torch.Tensor      # (B,)
    ramp_v_start: torch.Tensor      # (B, m)
    ramp_v_end: torch.Tensor        # (B, m)
    sin_mag: torch.Tensor           # (B, m)
    sin_freq: torch.Tensor          # (B, m)
    sin_off: torch.Tensor           # (B, m)
    sin_mean: torch.Tensor          # (B, m)
    trajectory: torch.Tensor        # (B, N*dN+1, n)
    v_trajectory: torch.Tensor      # (B, N*dN, m)
    v: torch.Tensor                 # (B, m) last applied ROM input
    stationary: torch.Tensor        # (B,) bool
    center: torch.Tensor            # (B, 2) scripted-circle center

    def replace(self, **kw) -> "TrajGenState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrajectoryGenerator:
    """Random-input trajectory generator over a ROM."""

    rom: RomDynamics
    t_sampler: UniformSampleHoldDT
    weight_sampler: UniformWeightSampler
    dt_loop: float
    freq_low: float
    freq_high: float
    prob_stationary: float
    N: int = 4
    dN: int = 1

    def replace(self, **kw) -> "TrajectoryGenerator":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, rom, t_sampler, weight_sampler, dt_loop=0.02, N=4, dN=1,
               freq_low=0.01, freq_high=10.0, prob_stationary=0.01):
        return cls(rom=rom, t_sampler=t_sampler,
                   weight_sampler=weight_sampler, dt_loop=f32(dt_loop),
                   freq_low=f32(freq_low), freq_high=f32(freq_high),
                   prob_stationary=f32(prob_stationary), N=int(N),
                   dN=int(dN))

    @property
    def device(self) -> torch.device:
        return self.rom.z_min.device

    # ---- state construction ---------------------------------------------
    def init_state(self, gen: torch.Generator, batch: int) -> TrajGenState:
        n, m, dev = self.rom.n, self.rom.m, self.device
        W = self.N * self.dN

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return TrajGenState(
            gen=gen, t=z(batch), k=z(batch), t_final=z(batch),
            weights=z(batch, 4), sample_hold_input=z(batch, m),
            extreme_input=z(batch, m), ramp_t_start=z(batch),
            ramp_v_start=z(batch, m),
            ramp_v_end=self.rom.v_min.expand(batch, m).clone(),
            sin_mag=z(batch, m), sin_freq=z(batch, m), sin_off=z(batch, m),
            sin_mean=z(batch, m), trajectory=z(batch, W + 1, n),
            v_trajectory=z(batch, W, m), v=z(batch, m),
            stationary=torch.zeros(batch, dtype=torch.bool, device=dev),
            center=z(batch, 2))

    # ---- resampling (masked) --------------------------------------------
    def resample(self, state: TrajGenState, mask: torch.Tensor,
                 z: torch.Tensor) -> TrajGenState:
        """Resample all input-mode params where ``mask``."""
        B, m = z.shape[0], self.rom.m
        v_min, v_max = self.rom.compute_state_dependent_input_bounds(z)
        U = torch.rand((B, 7 * m + 2), generator=state.gen, device=z.device)

        def u(i):
            return U[:, i * m:(i + 1) * m]

        sample_hold = v_min + u(0) * (v_max - v_min)
        ramp_v_start = self.rom.clip_v_z(z, state.ramp_v_end)
        ramp_v_end = v_min + u(1) * (v_max - v_min)
        ramp_t_start = state.t_final
        choice = torch.floor(u(2) * 3.0).to(torch.int32)
        extreme = torch.where(choice == 0, v_min,
                              torch.where(choice == 1,
                                          torch.zeros_like(v_min), v_max))
        sin_mag = u(3) * (v_max - v_min) / 2.0
        sin_mean = (v_min + sin_mag) + u(4) * (v_max - v_min - 2.0 * sin_mag)
        sin_freq = self.freq_low + u(5) * f32(
            f32(self.freq_high) - f32(self.freq_low))
        sin_off = -math.pi + u(6) * 2.0 * math.pi
        t_final = state.t_final + self.t_sampler.sample_from_unit(
            U[:, 7 * m])
        weights = self.weight_sampler.sample(state.gen, B, z.device)
        stationary = U[:, 7 * m + 1] < self.prob_stationary

        return state.replace(
            t_final=torch.where(mask, t_final, state.t_final),
            weights=_mwhere(mask, weights, state.weights),
            sample_hold_input=_mwhere(mask, sample_hold,
                                      state.sample_hold_input),
            extreme_input=_mwhere(mask, extreme, state.extreme_input),
            ramp_t_start=torch.where(mask, ramp_t_start, state.ramp_t_start),
            ramp_v_start=_mwhere(mask, ramp_v_start, state.ramp_v_start),
            ramp_v_end=_mwhere(mask, ramp_v_end, state.ramp_v_end),
            sin_mag=_mwhere(mask, sin_mag, state.sin_mag),
            sin_freq=_mwhere(mask, sin_freq, state.sin_freq),
            sin_off=_mwhere(mask, sin_off, state.sin_off),
            sin_mean=_mwhere(mask, sin_mean, state.sin_mean),
            stationary=torch.where(mask, stationary, state.stationary),
        )

    # ---- input synthesis -------------------------------------------------
    def _mode_inputs(self, state: TrajGenState, t: torch.Tensor):
        const = state.sample_hold_input
        span = state.t_final - state.ramp_t_start
        denom = torch.where(torch.abs(span) < 1e-8, 1.0, span)
        frac = ((t - state.ramp_t_start) / denom)[:, None]
        ramp = state.ramp_v_start + (state.ramp_v_end
                                     - state.ramp_v_start) * frac
        extreme = state.extreme_input
        sinus = (state.sin_mag * torch.sin(state.sin_freq * t[:, None]
                                           + state.sin_off)
                 + state.sin_mean)
        return const, ramp, extreme, sinus

    def get_input_t(self, state: TrajGenState, z: torch.Tensor,
                    allow_mask=None) -> tuple:
        """Resample expired modes, then mix the 4 modes."""
        expired = state.t > state.t_final
        if allow_mask is not None:
            expired = expired & allow_mask
        state = self.resample(state, expired, z)
        const, ramp, extreme, sinus = self._mode_inputs(state, state.t)
        w = state.weights
        v = (w[:, 0:1] * self.rom.clip_v_z(z, const)
             + w[:, 1:2] * self.rom.clip_v_z(z, ramp)
             + w[:, 2:3] * self.rom.clip_v_z(z, extreme)
             + w[:, 3:4] * self.rom.clip_v_z(z, sinus))
        return state, v

    # ---- stepping --------------------------------------------------------
    def step_rom(self, state: TrajGenState, mask: torch.Tensor,
                 increment_rom_time: bool = False,
                 allow_resample_mask=None) -> TrajGenState:
        """Advance the ROM one tick for envs in ``mask``."""
        z_last = state.trajectory[:, -1, :]
        state, v = self.get_input_t(state, z_last,
                                    allow_mask=allow_resample_mask)
        v = torch.where(state.stationary[:, None], 0.0, v)
        z_next = self.rom.f(z_last, v)
        still = state.stationary[:, None] & self.rom.vel_inds[None, :]
        z_next = torch.where(still, 0.0, z_next)

        new_traj = torch.cat([state.trajectory[:, 1:, :],
                              z_next[:, None, :]], dim=1)
        new_vtraj = torch.cat([state.v_trajectory[:, 1:, :],
                               v[:, None, :]], dim=1)
        t = state.t
        if increment_rom_time:
            t = torch.where(mask, state.t + self.rom.dt, state.t)
        return state.replace(
            trajectory=_mwhere(mask, new_traj, state.trajectory),
            v_trajectory=_mwhere(mask, new_vtraj, state.v_trajectory),
            v=_mwhere(mask, v, state.v),
            k=torch.where(mask, state.k + 1.0, state.k),
            t=t,
        )

    def step(self, state: TrajGenState) -> TrajGenState:
        """One env-loop tick: advance the ROM where due, then
        t += dt_loop."""
        due = state.t >= state.k * self.rom.dt - 1e-5
        state = self.step_rom(state, due)
        return state.replace(t=state.t + self.dt_loop)

    # ---- reset -----------------------------------------------------------
    def reset(self, state: TrajGenState, mask: torch.Tensor,
              z: torch.Tensor) -> TrajGenState:
        """Rebuild the rolling window for envs in ``mask``."""
        W = self.N * self.dN
        n, m = self.rom.n, self.rom.m
        B = z.shape[0]
        traj = torch.zeros((B, W + 1, n), dtype=torch.float32,
                           device=z.device)
        traj[:, -1, :] = z
        k0 = torch.full((B,), -float(W), dtype=torch.float32,
                        device=z.device)
        t0 = k0 * self.rom.dt
        state = state.replace(
            trajectory=_mwhere(mask, traj, state.trajectory),
            v_trajectory=_mwhere(mask, torch.zeros((B, W, m),
                                                   device=z.device),
                                 state.v_trajectory),
            k=torch.where(mask, k0, state.k),
            t=torch.where(mask, t0, state.t),
            t_final=torch.where(mask, t0, state.t_final),
        )
        state = self.resample(state, mask, z)
        for _ in range(W):
            state = self.step_rom(state, mask, increment_rom_time=True,
                                  allow_resample_mask=mask)
        return state

    # ---- outputs ---------------------------------------------------------
    def get_trajectory(self, state: TrajGenState) -> torch.Tensor:
        """Window interpolated to the env clock, strided by dN."""
        traj0 = state.trajectory[:, :-1, :]
        traj1 = state.trajectory[:, 1:, :]
        alpha = (state.t - (state.k - 1.0) * self.rom.dt) / self.rom.dt
        interp = traj0 + (traj1 - traj0) * alpha[:, None, None]
        return interp[:, ::self.dN, :]

    def get_v_trajectory(self, state: TrajGenState) -> torch.Tensor:
        """The window's inputs, strided by dN."""
        return state.v_trajectory[:, ::self.dN, :]


class ZeroTrajectoryGenerator(TrajectoryGenerator):
    """Always-stationary fixture: zero inputs, the window held still."""

    def resample(self, state, mask, z):
        return state.replace(stationary=torch.where(mask, True,
                                                    state.stationary))

    def get_input_t(self, state, z, allow_mask=None):
        return state, torch.zeros((z.shape[0], self.rom.m),
                                  dtype=torch.float32, device=z.device)


def _window(t, lo, hi, value):
    """``value`` where lo <= t < hi, else 0."""
    return torch.where((lo <= t) & (t < hi), value, 0.0)


class SquareTrajectoryGenerator(TrajectoryGenerator):
    """Open-loop piecewise square path for SingleInt2D / DoubleInt2D. The
    breakpoints come from the ROM's float32 bounds, as 0-d tensors on its
    device."""

    def resample(self, state, mask, z):
        return state

    def get_input_t(self, state, z, allow_mask=None):
        t = state.t
        vmax, vmin = self.rom.v_max, self.rom.v_min
        if isinstance(self.rom, DoubleInt2D):
            zmax, zmin = self.rom.z_max, self.rom.z_min
            c0 = zmax[3] / 2 / vmax[1]
            c1 = c0 + (1 - 2 * (0.5 * vmax[1] * c0 ** 2)) / (zmax[3] / 2)
            c2 = c1 + zmin[3] / 2 / vmin[1]
            c3 = c2
            c4 = c3 + zmax[2] / vmax[0]
            c5 = c4 + (1 - 2 * (0.5 * vmax[0] * (c4 - c3) ** 2)) / (
                zmax[2] / 2)
            c6 = c5 + zmin[2] / vmin[0]
            c7 = c6
            c8 = c7 + zmin[3] / 2 / vmin[1]
            c9 = c8 + (1 - 2 * (0.5 * torch.abs(vmin[1]) * (c8 - c7) ** 2)
                       ) / (torch.abs(zmin[3]) / 2)
            c10 = c9 + zmax[3] / 2 / vmax[1]
            c11 = c10
            c12 = c11 + zmin[2] / vmin[0]
            c13 = c12 + (1 - 2 * (0.5 * torch.abs(vmin[0])
                                  * (c12 - c11) ** 2)) / (
                torch.abs(zmin[2]) / 2)
            c14 = c13 + zmax[2] / vmax[0]
            vy = (_window(t, 0, c0, vmax[1]) + _window(t, c1, c2, vmin[1])
                  + _window(t, c7, c8, vmin[1])
                  + _window(t, c9, c10, vmax[1]))
            vx = (_window(t, c3, c4, vmax[0]) + _window(t, c5, c6, vmin[0])
                  + _window(t, c11, c12, vmin[0])
                  + _window(t, c13, c14, vmax[0]))
        elif isinstance(self.rom, SingleInt2D):
            c1 = 2 / vmax[1]
            c2 = c1 + 1 / vmax[0]
            c3 = c2 + 2 / torch.abs(vmin[1])
            c4 = c3 + 1 / torch.abs(vmin[0])
            vy = (_window(t, 0, c1, vmax[1] / 2)
                  + _window(t, c2, c3, vmin[1] / 2))
            # the reference's own choice: vmin[1] on the last leg
            vx = _window(t, c1, c2, vmax[0]) + _window(t, c3, c4, vmin[1])
        else:
            raise ValueError(
                "Square fixture supports SingleInt2D/DoubleInt2D")
        return state, torch.stack([vx, vy], dim=-1)

    def reset(self, state, mask, z):
        z = torch.where(self.rom.vel_inds[None, :], 0.0, z)
        return super().reset(state, mask, z)


def _norm(x):
    """Euclidean norm over the last axis, kept: sqrt of the sum of
    squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


class CircleTrajectoryGenerator(TrajectoryGenerator):
    """Feedback circle tracker for SingleInt2D / DoubleInt2D: a circle of
    radius 0.5 around a center set on reset, at the ROM's slowest input
    bound."""

    def resample(self, state, mask, z):
        center = z[:, :2] - torch.tensor([0.5, 0.0], device=z.device)
        return state.replace(center=_mwhere(mask, center, state.center))

    def get_input_t(self, state, z, allow_mask=None):
        t = state.t
        vmax, vmin = self.rom.v_max, self.rom.v_min
        speed = torch.min(torch.minimum(vmax, torch.abs(vmin)))
        if isinstance(self.rom, DoubleInt2D):
            ph = t / speed
            z_des = state.center + 0.5 * torch.stack(
                [torch.cos(ph), torch.sin(ph)], dim=-1)
            v_des = 0.5 * torch.stack([-torch.sin(ph), torch.cos(ph)],
                                      dim=-1) / speed
            v = self.rom.clip_v_z(
                z, -4.0 * (z[:, :2] - z_des) - 4.0 * (z[:, 2:] - v_des))
        elif isinstance(self.rom, SingleInt2D):
            e = z - state.center
            v = torch.stack([-e[:, 1], e[:, 0]], dim=-1)
            vn = torch.clamp(_norm(v), min=1e-8)
            v = v + -(e - 0.5 * e / vn)
            vn2 = torch.clamp(_norm(v), min=1e-8)
            v = v / vn2 * speed
        else:
            raise ValueError(
                "Circle fixture supports SingleInt2D/DoubleInt2D")
        return state, v


TRAJ_GEN_REGISTRY = {
    "TrajectoryGenerator": TrajectoryGenerator,
    "ZeroTrajectoryGenerator": ZeroTrajectoryGenerator,
    "SquareTrajectoryGenerator": SquareTrajectoryGenerator,
    "CircleTrajectoryGenerator": CircleTrajectoryGenerator,
}
