"""Batched rigid-body simulator: URDF model, scalar-graph dynamics,
compliant contact and the substep (kernel on the card); the physics-free
ROM sim of the tube-learning data."""
from .rom_sim import RomSim, RomSimState

__all__ = ["RomSim", "RomSimState"]
