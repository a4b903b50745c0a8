from .generator import (
    TRAJ_GEN_REGISTRY,
    CircleTrajectoryGenerator,
    SquareTrajectoryGenerator,
    TrajectoryGenerator,
    TrajGenState,
    ZeroTrajectoryGenerator,
)
from .samplers import (
    SAMPLER_REGISTRY,
    UniformSampleHoldDT,
    UniformWeightSampler,
    UniformWeightSamplerNoExtreme,
    UniformWeightSamplerNoRamp,
)

__all__ = [
    "TRAJ_GEN_REGISTRY",
    "SAMPLER_REGISTRY",
    "TrajectoryGenerator",
    "TrajGenState",
    "ZeroTrajectoryGenerator",
    "SquareTrajectoryGenerator",
    "CircleTrajectoryGenerator",
    "UniformSampleHoldDT",
    "UniformWeightSampler",
    "UniformWeightSamplerNoExtreme",
    "UniformWeightSamplerNoRamp",
]
