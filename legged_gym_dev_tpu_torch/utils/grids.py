"""Grid-generation helpers for evaluation sweeps (numpy only).

Counterpart of ``legged_gym_dev_tpu/utils/grids.py``: 2D grid-search
configurations, per-robot jittered grids for spatial evaluation sweeps,
and the forward direction of a quaternion, rotated in float32 as the
package's ``quat_apply`` rotates it.
"""
from __future__ import annotations

import numpy as np


def generate_grid_search_configs_2d(start: float, end: float,
                                    density: int) -> np.ndarray:
    """All (x, y) pairs of a density x density grid -> (density^2, 2)."""
    x = np.linspace(start, end, density)
    g = np.stack(np.meshgrid(x, x, indexing="ij"), axis=-1)
    return g.reshape(-1, 2)


def generate_robot_grids(start: float, end: float, density: int,
                         num_robots: int, deviation: float,
                         rng=None) -> np.ndarray:
    """Per-robot Gaussian-jittered copies of the base grid
    -> (num_robots, density^2, 2)."""
    rng = rng or np.random.default_rng()
    base = generate_grid_search_configs_2d(start, end, density)
    noise = rng.normal(0.0, deviation, (num_robots,) + base.shape)
    return base[None] + noise


def add_zero_z_coordinate(robot_grids: np.ndarray) -> np.ndarray:
    """(..., 2) -> (..., 3) with z = 0."""
    return np.concatenate(
        [robot_grids, np.zeros(robot_grids.shape[:-1] + (1,))], axis=-1
    )


def quaternion_to_direction_vector(quat_xyzw) -> np.ndarray:
    """Forward (+x) direction of an (x, y, z, w) quaternion, in float32:
    v + w t + u x t with t = 2 u x v."""
    q = np.asarray(quat_xyzw, np.float32)
    v = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32),
                        q.shape[:-1] + (3,))
    u, w = q[..., :3], q[..., 3:4]
    t = np.float32(2.0) * np.cross(u, v)
    return v + w * t + np.cross(u, t)
