from .generator import TrajectoryGenerator, TrajGenState
from .samplers import UniformSampleHoldDT, UniformWeightSampler

__all__ = [
    "TrajectoryGenerator",
    "TrajGenState",
    "UniformSampleHoldDT",
    "UniformWeightSampler",
]
