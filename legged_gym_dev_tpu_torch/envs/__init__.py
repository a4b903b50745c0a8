from .base import ShardedEnv, Transition, guard_finite_state
from .registry import TaskRegistry, task_registry
from .rom_tracking import RomTrackingEnv, RomTrackingEnvState
from . import presets  # noqa: F401  (registers preset tasks)
from .hopper_trajectory import HopperTrajectoryEnv
from .legged_robot_trajectory import (
    LeggedRobotTrajectoryEnv,
    TrajectoryEnvState,
)
from .legged_robot_velocity import LeggedRobotVelocityEnv, VelocityEnvState

__all__ = [
    "ShardedEnv",
    "Transition",
    "guard_finite_state",
    "TaskRegistry",
    "task_registry",
    "RomTrackingEnv",
    "RomTrackingEnvState",
    "HopperTrajectoryEnv",
    "LeggedRobotTrajectoryEnv",
    "TrajectoryEnvState",
    "LeggedRobotVelocityEnv",
    "VelocityEnvState",
]
