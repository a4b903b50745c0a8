"""Hold-time and mode-weight samplers for the trajectory generator.

Counterpart of ``legged_gym_dev_tpu/trajgen/samplers.py``. Stateless: a
sampler draws from the ``torch.Generator`` it is handed. Scalars are held
at their float32 values (the JAX leaves are float32), and differences of
them are taken in float32, so the arithmetic matches the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def f32(x) -> float:
    """A Python float holding x's float32 value."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class UniformSampleHoldDT:
    """Uniform hold-time sampler."""

    t_low: float
    t_high: float

    def replace(self, **kw) -> "UniformSampleHoldDT":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, t_low: float, t_high: float) -> "UniformSampleHoldDT":
        return cls(t_low=f32(t_low), t_high=f32(t_high))

    def sample(self, gen: torch.Generator, batch: int,
               device) -> torch.Tensor:
        """``batch`` hold times drawn uniformly in [t_low, t_high)."""
        return self.sample_from_unit(
            torch.rand((batch,), generator=gen, device=device))

    def sample_from_unit(self, u: torch.Tensor) -> torch.Tensor:
        """Transform pre-drawn unit uniforms."""
        return self.t_low + u * f32(np.float32(self.t_high)
                                    - np.float32(self.t_low))


def _dirichlet_like(gen: torch.Generator, batch: int, mask,
                    device) -> torch.Tensor:
    """Weights on the simplex over the 4 input modes: U(0,1)^4 times
    ``mask`` (zeroing masked modes, or scaling a mode's share), then
    normalized."""
    w = torch.rand((batch, 4), generator=gen, device=device)
    w = w * torch.tensor(mask, dtype=torch.float32, device=device)[None, :]
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)


@dataclasses.dataclass(frozen=True)
class UniformWeightSampler:
    """Weights over (sample-hold, ramp, extreme, sinusoid): U(0,1)^4 times
    a per-mode mask, normalized onto the simplex."""

    mask: tuple = (1.0, 1.0, 1.0, 1.0)

    def replace(self, **kw) -> "UniformWeightSampler":
        return dataclasses.replace(self, **kw)

    def sample(self, gen: torch.Generator, batch: int,
               device) -> torch.Tensor:
        return _dirichlet_like(gen, batch, self.mask, device)


def UniformWeightSamplerNoExtreme() -> UniformWeightSampler:
    """Mode weights without the extreme (bang-bang) mode."""
    return UniformWeightSampler(mask=(1.0, 1.0, 0.0, 1.0))


def UniformWeightSamplerNoRamp() -> UniformWeightSampler:
    """The hopper trajectory task's mode weights (no ramp mode)."""
    return UniformWeightSampler(mask=(1.0, 0.0, 1.0, 1.0))


def UniformWeightSamplerOnlySampleHold() -> UniformWeightSampler:
    """Sample-and-hold weights only (the ``WeightSamplerSampleAndHold``
    name of the registry)."""
    return UniformWeightSampler(mask=(1.0, 0.0, 0.0, 0.0))


def UniformWeightSamplerTurnBiased(
        sin_weight: float = 3.0) -> UniformWeightSampler:
    """Sinusoid-heavy weights: no ramp, the extreme mode halved and the
    sinusoid's U(0,1) draw scaled by ``sin_weight`` before normalization,
    so sustained turning carries most of the expected mass (about 2/3 at
    the default 3) without excluding the other modes."""
    return UniformWeightSampler(mask=(1.0, 0.0, 0.5, f32(sin_weight)))


SAMPLER_REGISTRY = {
    "UniformSampleHoldDT": UniformSampleHoldDT,
    "UniformWeightSampler": UniformWeightSampler,
    "UniformWeightSamplerNoExtreme": UniformWeightSamplerNoExtreme,
    "UniformWeightSamplerNoRamp": UniformWeightSamplerNoRamp,
    "WeightSamplerSampleAndHold": UniformWeightSamplerOnlySampleHold,
    "UniformWeightSamplerTurnBiased": UniformWeightSamplerTurnBiased,
}
