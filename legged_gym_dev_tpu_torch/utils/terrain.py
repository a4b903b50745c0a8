"""Procedural terrain generation and the heightfield sampler.

Counterpart of ``legged_gym_dev_tpu/utils/terrain.py``: a grid of
procedural sub-terrains (pyramid slopes, rough slopes, pyramid stairs up
and down, discrete obstacles, stepping stones, gaps, pits) with curriculum
rows (difficulty grows along the rows), randomized or selected modes and
per-cell env origins.

Generation is numpy on the host, a copy of the JAX package's generators:
the same seed gives the same ``height_field_raw`` and ``env_origins``, bit
for bit. The product is a bilinear height function on the device
(``make_terrain_fn``: one gather of a pre-quadded 4-corner table, with an
analytic gradient as its ``value_and_grad``) that plugs into the contact
model's ``terrain_fn``, and ``height_scan`` for perceptive observations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.maths import quat_to_yaw
from .runtime import resolve_device


@dataclasses.dataclass
class TerrainCfg:
    """The terrain config block."""

    mesh_type: str = "trimesh"    # 'none' | 'plane' | 'heightfield' | 'trimesh'
    horizontal_scale: float = 0.1  # [m]
    vertical_scale: float = 0.005  # [m]
    border_size: float = 25.0      # [m]
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10             # difficulty levels
    num_cols: int = 20             # terrain types
    # [smooth slope, rough slope, stairs up, stairs down, discrete,
    #  stepping stones, gap, pit]
    terrain_proportions: Sequence[float] = (0.1, 0.1, 0.35, 0.25, 0.2)
    curriculum: bool = False
    selected: bool = False
    terrain_kwargs: Optional[dict] = None
    slope_treshold: float = 0.75


# ---------------------------------------------------------------------------
# Sub-terrain generators (heights in integer units of vertical_scale)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SubTerrain:
    width: int
    length: int
    vertical_scale: float
    horizontal_scale: float

    def __post_init__(self):
        self.height_field_raw = np.zeros((self.length, self.width), np.int16)


def pyramid_sloped_terrain(t: SubTerrain, slope: float,
                           platform_size: float = 1.0) -> None:
    """Pyramid rising (or sinking) toward the center with a flat platform."""
    x = np.arange(t.length)
    y = np.arange(t.width)
    cx, cy = (t.length - 1) / 2, (t.width - 1) / 2
    # distance-to-edge fraction in [0, 1] (1 at the center)
    fx = 1.0 - np.abs(x - cx) / cx
    fy = 1.0 - np.abs(y - cy) / cy
    frac = np.minimum(fx[:, None], fy[None, :])
    max_height = slope * (t.horizontal_scale / t.vertical_scale) * cx
    hf = (frac * max_height).astype(np.int16)
    # flat platform in the middle at the pyramid's height there
    ps = int(platform_size / t.horizontal_scale / 2)
    x1, x2 = int(cx) - ps, int(cx) + ps
    y1, y2 = int(cy) - ps, int(cy) + ps
    platform_frac = min(1.0 - (cx - x1) / cx, 1.0)
    hf[x1:x2, y1:y2] = int(platform_frac * max_height)
    t.height_field_raw += hf


def random_uniform_terrain(t: SubTerrain, min_height: float,
                           max_height: float, step: float = 0.005,
                           downsampled_scale: float = 0.2,
                           rng: Optional[np.random.Generator] = None) -> None:
    """Uniform noise sampled on a coarse grid, upsampled bilinearly."""
    rng = rng or np.random.default_rng()
    lo = int(min_height / t.vertical_scale)
    hi = int(max_height / t.vertical_scale)
    n_step = max(int((max_height - min_height) / step), 1)
    ds = max(int(downsampled_scale / t.horizontal_scale), 1)
    coarse = rng.integers(0, n_step + 1,
                          (t.length // ds + 2, t.width // ds + 2))
    coarse = lo + coarse * (hi - lo) // max(n_step, 1)
    xi = np.linspace(0, coarse.shape[0] - 1, t.length)
    yi = np.linspace(0, coarse.shape[1] - 1, t.width)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[0] - 1)
    y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
    wx = (xi - x0)[:, None]
    wy = (yi - y0)[None, :]
    up = ((1 - wx) * (1 - wy) * coarse[x0][:, y0]
          + wx * (1 - wy) * coarse[x1][:, y0]
          + (1 - wx) * wy * coarse[x0][:, y1]
          + wx * wy * coarse[x1][:, y1])
    t.height_field_raw += up.astype(np.int16)


def pyramid_stairs_terrain(t: SubTerrain, step_width: float,
                           step_height: float,
                           platform_size: float = 1.0) -> None:
    """Concentric square steps toward the center."""
    sw = max(int(step_width / t.horizontal_scale), 1)
    sh = int(step_height / t.vertical_scale)
    ps = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.length // 2, t.width // 2
    x = np.arange(t.length)
    y = np.arange(t.width)
    dist = np.maximum(np.abs(x - cx)[:, None], np.abs(y - cy)[None, :])
    ring = np.maximum((dist - ps) // sw + 1, 0)
    n_max = ring.max()
    t.height_field_raw += ((n_max - ring) * sh).astype(np.int16)


def discrete_obstacles_terrain(t: SubTerrain, max_height: float,
                               min_size: float, max_size: float,
                               num_rects: int, platform_size: float = 1.0,
                               rng=None) -> None:
    rng = rng or np.random.default_rng()
    hmax = int(max_height / t.vertical_scale)
    heights = [-hmax, -hmax // 2, hmax // 2, hmax]
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / t.horizontal_scale)
        l = int(rng.uniform(min_size, max_size) / t.horizontal_scale)
        x = rng.integers(0, max(t.length - l, 1))
        y = rng.integers(0, max(t.width - w, 1))
        t.height_field_raw[x:x + l, y:y + w] = int(rng.choice(heights))
    ps = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.length // 2, t.width // 2
    t.height_field_raw[cx - ps:cx + ps, cy - ps:cy + ps] = 0


def stepping_stones_terrain(t: SubTerrain, stone_size: float,
                            stone_distance: float, max_height: float,
                            platform_size: float = 1.0,
                            depth: float = -10.0, rng=None) -> None:
    rng = rng or np.random.default_rng()
    ss = max(int(stone_size / t.horizontal_scale), 1)
    sd = int(stone_distance / t.horizontal_scale)
    hmax = int(max_height / t.vertical_scale)
    t.height_field_raw[:] = int(depth / t.vertical_scale)
    y = 0
    while y < t.width:
        x = int(rng.integers(0, ss + sd + 1))
        # leading partial stone on the row
        t.height_field_raw[: max(x - sd, 0), y:y + ss] = int(
            rng.integers(-hmax, hmax + 1))
        while x < t.length:
            t.height_field_raw[x:x + ss, y:y + ss] = int(
                rng.integers(-hmax, hmax + 1))
            x += ss + sd
        y += ss + sd
    ps = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.length // 2, t.width // 2
    t.height_field_raw[cx - ps:cx + ps, cy - ps:cy + ps] = 0


def gap_terrain(t: SubTerrain, gap_size: float,
                platform_size: float = 1.0) -> None:
    gs = int(gap_size / t.horizontal_scale)
    ps = int(platform_size / t.horizontal_scale)
    cx, cy = t.length // 2, t.width // 2
    x1 = (t.length - ps) // 2
    x2 = x1 + gs
    y1 = (t.width - ps) // 2
    y2 = y1 + gs
    t.height_field_raw[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    t.height_field_raw[cx - x1:cx + x1, cy - y1:cy + y1] = 0


def pit_terrain(t: SubTerrain, depth: float,
                platform_size: float = 1.0) -> None:
    d = int(depth / t.vertical_scale)
    ps = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.length // 2, t.width // 2
    t.height_field_raw[cx - ps:cx + ps, cy - ps:cy + ps] = -d


SUBTERRAIN_REGISTRY = {
    "pyramid_sloped_terrain": pyramid_sloped_terrain,
    "random_uniform_terrain": random_uniform_terrain,
    "pyramid_stairs_terrain": pyramid_stairs_terrain,
    "discrete_obstacles_terrain": discrete_obstacles_terrain,
    "stepping_stones_terrain": stepping_stones_terrain,
    "gap_terrain": gap_terrain,
    "pit_terrain": pit_terrain,
}


# ---------------------------------------------------------------------------
# Terrain grid
# ---------------------------------------------------------------------------

class Terrain:
    def __init__(self, cfg: TerrainCfg, num_robots: int, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.type = cfg.mesh_type
        if self.type in ("none", "plane"):
            self.height_field_raw = np.zeros((1, 1), np.int16)
            self.env_origins = np.zeros((1, 1, 3))
            return
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        props = list(cfg.terrain_proportions)
        # extended to the 8 families (gap and pit 0 by default)
        while len(props) < 8:
            props.append(0.0)
        self.proportions = [sum(props[: i + 1]) for i in range(len(props))]

        self.width_px = int(self.env_width / cfg.horizontal_scale)
        self.length_px = int(self.env_length / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_cols = cfg.num_cols * self.width_px + 2 * self.border
        self.tot_rows = cfg.num_rows * self.length_px + 2 * self.border
        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols),
                                         np.int16)
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

        if cfg.curriculum:
            self._curriculum()
        elif cfg.selected:
            self._selected()
        else:
            self._randomized()

    @classmethod
    def from_arrays(cls, cfg: TerrainCfg, height_field_raw: np.ndarray,
                    env_origins: np.ndarray) -> "Terrain":
        """A terrain of given heightfield and origins (nothing generated)."""
        t = cls.__new__(cls)
        t.cfg, t.type, t.rng = cfg, cfg.mesh_type, None
        t.height_field_raw = np.asarray(height_field_raw, np.int16)
        t.env_origins = np.asarray(env_origins, np.float64)
        return t

    # ---- modes ----------------------------------------------------------
    def _randomized(self):
        for k in range(self.cfg.num_rows * self.cfg.num_cols):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            choice = self.rng.uniform(0, 1)
            difficulty = self.rng.choice([0.5, 0.75, 0.9])
            self._add(self.make_terrain(choice, difficulty), i, j)

    def _curriculum(self):
        for j in range(self.cfg.num_cols):
            for i in range(self.cfg.num_rows):
                difficulty = i / self.cfg.num_rows
                choice = j / self.cfg.num_cols + 0.001
                self._add(self.make_terrain(choice, difficulty), i, j)

    def _selected(self):
        kwargs = dict(self.cfg.terrain_kwargs)
        name = kwargs.pop("type")
        fn = SUBTERRAIN_REGISTRY[name]
        for k in range(self.cfg.num_rows * self.cfg.num_cols):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            t = self._new_sub()
            fn(t, **kwargs)
            self._add(t, i, j)

    def _new_sub(self) -> SubTerrain:
        return SubTerrain(width=self.width_px, length=self.length_px,
                          vertical_scale=self.cfg.vertical_scale,
                          horizontal_scale=self.cfg.horizontal_scale)

    def make_terrain(self, choice: float, difficulty: float) -> SubTerrain:
        """Difficulty-scaled terrain selection."""
        t = self._new_sub()
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        obstacle_height = 0.05 + difficulty * 0.2
        stone_size = 1.5 * (1.05 - difficulty)
        stone_dist = 0.05 if difficulty == 0 else 0.1
        gap_size = 1.0 * difficulty
        pit_depth = 1.0 * difficulty
        p = self.proportions
        if choice < p[0]:
            if choice < p[0] / 2:
                slope *= -1
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
        elif choice < p[1]:
            pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
            random_uniform_terrain(t, -0.05, 0.05, 0.005, 0.2, rng=self.rng)
        elif choice < p[3]:
            if choice < p[2]:
                step_height *= -1
            pyramid_stairs_terrain(t, step_width=0.31,
                                   step_height=step_height, platform_size=3.0)
        elif choice < p[4]:
            discrete_obstacles_terrain(t, obstacle_height, 1.0, 2.0, 20,
                                       platform_size=3.0, rng=self.rng)
        elif choice < p[5]:
            stepping_stones_terrain(t, stone_size, stone_dist, 0.0,
                                    platform_size=4.0, rng=self.rng)
        elif choice < p[6]:
            gap_terrain(t, gap_size=gap_size, platform_size=3.0)
        else:
            pit_terrain(t, depth=pit_depth, platform_size=4.0)
        return t

    def _add(self, t: SubTerrain, i: int, j: int):
        sx = self.border + i * self.length_px
        sy = self.border + j * self.width_px
        self.height_field_raw[sx:sx + self.length_px,
                              sy:sy + self.width_px] = t.height_field_raw
        ox = (i + 0.5) * self.env_length
        oy = (j + 0.5) * self.env_width
        hs = self.cfg.horizontal_scale
        x1 = int((self.env_length / 2.0 - 1) / hs)
        x2 = int((self.env_length / 2.0 + 1) / hs)
        y1 = int((self.env_width / 2.0 - 1) / hs)
        y2 = int((self.env_width / 2.0 + 1) / hs)
        oz = np.max(t.height_field_raw[x1:x2, y1:y2]) * self.cfg.vertical_scale
        self.env_origins[i, j] = [ox, oy, oz]

    # ---- sampling on the device --------------------------------------------
    def make_terrain_fn(self, device=None) -> Callable:
        """Bilinear heightfield sampler for the contact model, on ``device``
        (``None``: the CUDA card). World (x, y) in meters maps to
        heightfield pixels with the border offset: cell (0, 0) starts at
        -border_size. The function carries ``value_and_grad``: height and
        analytic surface gradient from one gather."""
        dev = resolve_device(device)
        if self.type in ("none", "plane"):
            def plane(xy):
                return xy.new_zeros(xy.shape[:-1])

            plane.value_and_grad = lambda xy: (xy.new_zeros(xy.shape[:-1]),
                                               torch.zeros_like(xy))
            return plane
        # Pre-quadded corner table: hf4[x * (W - 1) + y] holds the cell's
        # [h00, h01, h10, h11], so a bilinear sample is one gather of
        # contiguous 4-float rows (4x the table's memory, built once).
        hf_np = (self.height_field_raw.astype(np.float32)
                 * self.cfg.vertical_scale)
        hf4 = torch.as_tensor(np.stack(
            [hf_np[:-1, :-1], hf_np[:-1, 1:], hf_np[1:, :-1], hf_np[1:, 1:]],
            axis=-1).reshape(-1, 4), device=dev)
        hs = self.cfg.horizontal_scale
        border = self.cfg.border_size
        H, W = self.height_field_raw.shape
        Wc = W - 1  # quad-table column count

        def _corners(xy):
            px = (xy[..., 0] + border) / hs
            py = (xy[..., 1] + border) / hs
            x0 = torch.clamp(torch.floor(px).to(torch.int32), 0, H - 2)
            y0 = torch.clamp(torch.floor(py).to(torch.int32), 0, W - 2)
            wx = torch.clamp(px - x0, 0.0, 1.0)
            wy = torch.clamp(py - y0, 0.0, 1.0)
            flat = (x0 * Wc + y0).reshape(-1)
            hq = hf4[flat].reshape(x0.shape + (4,))
            return hq.unbind(-1), wx, wy

        def _height(h00, h01, h10, h11, wx, wy):
            return ((1 - wx) * (1 - wy) * h00 + wx * (1 - wy) * h10
                    + (1 - wx) * wy * h01 + wx * wy * h11)

        def terrain_fn(xy):
            (h00, h01, h10, h11), wx, wy = _corners(xy)
            return _height(h00, h01, h10, h11, wx, wy)

        def value_and_grad(xy):
            """Height and analytic surface gradient from the same 4-corner
            gather."""
            (h00, h01, h10, h11), wx, wy = _corners(xy)
            h = _height(h00, h01, h10, h11, wx, wy)
            gx = ((1 - wy) * (h10 - h00) + wy * (h11 - h01)) / hs
            gy = ((1 - wx) * (h01 - h00) + wx * (h11 - h10)) / hs
            return h, torch.stack([gx, gy], dim=-1)

        terrain_fn.value_and_grad = value_and_grad
        # the heightfield lives on ``dev``; ``to`` rebuilds it on another
        # device (``parallel.mesh.place``: a mesh's shards on other cards)
        terrain_fn.device = dev
        terrain_fn.to = self.make_terrain_fn
        return terrain_fn


def height_scan(terrain_fn: Callable, base_pos: torch.Tensor,
                base_quat: torch.Tensor, points_x: Sequence[float],
                points_y: Sequence[float]) -> torch.Tensor:
    """Yaw-rotated grid of height measurements around each robot, points
    in ij order (x major). Returns (B, len(x) * len(y))."""
    dev = base_pos.device
    px, py = torch.meshgrid(
        torch.tensor(np.asarray(points_x, np.float32), device=dev),
        torch.tensor(np.asarray(points_y, np.float32), device=dev),
        indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)                     # (P,)
    yaw = quat_to_yaw(base_quat)
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    world = torch.stack([c * px - s * py + base_pos[:, None, 0],
                         s * px + c * py + base_pos[:, None, 1]], dim=-1)
    return terrain_fn(world)
