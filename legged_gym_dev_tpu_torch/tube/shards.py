"""Binary rollout shards and the native streaming data loader.

Counterpart of ``legged_gym_dev_tpu/tube/shards.py`` (numpy and ctypes, the
port's own copy). Python defines the frame semantics (the per-step
features and targets, as ``tube.datasets`` builds them) and the window
source-index map (the stride-aligned ``get_slice``); the native library
(``native``, ``csrc/tube_dataloader.cc``) owns the runtime: mmap'd
out-of-core shards, epoch shuffling, the sliding-window gather, and
worker-thread batch prefetch that overlaps the training step.
"""
from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from ..native import load_dataloader
from .datasets import RolloutData, TubeDataset, sliding_window

_MAGIC = 0x314C4454  # 'TDL1'


# ---------------------------------------------------------------------------
# frame construction (the one place for the semantics; tube.datasets')
# ---------------------------------------------------------------------------

def frames_for_variant(r: RolloutData, variant: str):
    """RolloutData -> (static (E,T,Fs), windowed (E,T,Fw), target (E,T,G),
    done (E,T), n_zero_tail).

    Variants follow the dataset constructors of tube.datasets: 'scalar'
    (w = ||pz_x - z||, window over [z_rest, v]), 'scalar_recursive',
    'vector', 'error'.
    """
    z, pz_x = r.z[:, :-1], r.pz_x[:, :-1]
    err = pz_x - z
    err_p1 = r.pz_x[:, 1:] - r.z[:, 1:]
    m = r.v.shape[-1]
    E, T = r.done.shape
    f32 = np.float32
    if variant == "scalar":
        w = np.linalg.norm(err, axis=-1)[..., None]
        w_p1 = np.linalg.norm(err_p1, axis=-1)[..., None]
        static = w.astype(f32)
        windowed = np.concatenate((z[:, :, 2:], r.v), axis=-1).astype(f32)
        target = w_p1.astype(f32)
    elif variant == "scalar_recursive":
        w = np.linalg.norm(err, axis=-1)[..., None]
        w_p1 = np.linalg.norm(err_p1, axis=-1)[..., None]
        static = np.zeros((E, T, 0), f32)
        windowed = np.concatenate((w, z[:, :, 2:], r.v), axis=-1).astype(f32)
        target = w_p1.astype(f32)
    elif variant == "vector":
        static = np.zeros((E, T, 0), f32)
        windowed = np.concatenate((np.abs(err), z, r.v), axis=-1).astype(f32)
        target = np.abs(err_p1).astype(f32)
    elif variant == "error":
        static = np.zeros((E, T, 0), f32)
        windowed = np.concatenate((err, z, r.v), axis=-1).astype(f32)
        target = err_p1.astype(f32)
    else:
        raise ValueError(f"unknown variant '{variant}'")
    return static, windowed, target, np.asarray(r.done, bool), m


def write_shard(path: str, static, windowed, target, done,
                n_zero_tail: int = 0) -> None:
    """Write one binary shard (see tube_dataloader.cc for the layout)."""
    E, T = done.shape
    Fs, Fw, G = static.shape[-1], windowed.shape[-1], target.shape[-1]
    header = np.array([_MAGIC, 1, E, T, Fs, Fw, G, n_zero_tail], np.int32)
    with open(path, "wb") as f:
        header.tofile(f)
        np.ascontiguousarray(static, np.float32).tofile(f)
        np.ascontiguousarray(windowed, np.float32).tofile(f)
        np.ascontiguousarray(target, np.float32).tofile(f)
        np.ascontiguousarray(done, np.uint8).tofile(f)


def write_rollout_shards(out_dir: str, rollouts: List[RolloutData],
                         variant: str = "scalar") -> List[str]:
    """One shard per collected rollout epoch; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, r in enumerate(rollouts):
        static, windowed, target, done, m = frames_for_variant(r, variant)
        path = os.path.join(out_dir, f"epoch_{i}.tdl")
        write_shard(path, static, windowed, target, done, n_zero_tail=m)
        paths.append(path)
    return paths


def window_srcmap(T: int, N: int, dN: int) -> np.ndarray:
    """(N, T) int32 source index per (shift, time); -1 = pad with the
    episode's first frame (trailing input dims zeroed). Exactly
    ``tube.datasets.get_slice``'s indexing."""
    out = np.full((N, T), -1, np.int32)
    for i in range(N):
        slc = np.flip(np.arange(T - i * dN - 1, -1, step=-dN))
        pad = T - len(slc)
        out[i, pad:] = slc
    return out


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

class NativeTubeLoader:
    """Streaming batches from shards via the C++ loader (ctypes)."""

    def __init__(self, paths: List[str], N: int = 1, dN: int = 1,
                 n_zero_tail: int = -1):
        lib = load_dataloader()
        if lib is None:
            raise RuntimeError("native dataloader unavailable (no g++?)")
        self._lib = lib
        with open(paths[0], "rb") as f:
            hdr = np.fromfile(f, np.int32, 8)
        T = int(hdr[3])
        if n_zero_tail < 0:
            n_zero_tail = int(hdr[7])
        self._srcmap = np.ascontiguousarray(window_srcmap(T, N, dN))
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._h = lib.tdl_open(
            arr, len(paths), N, dN, n_zero_tail,
            self._srcmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T)
        if not self._h:
            raise RuntimeError(
                f"tdl_open failed: {lib.tdl_error().decode()}")
        self.num_rows = int(lib.tdl_rows(self._h))
        self.input_dim = int(lib.tdl_row_dim(self._h))
        self.target_dim = int(lib.tdl_target_dim(self._h))

    def epoch(self, seed: int, batch: int, n_threads: int = 2,
              shuffle: bool = True):
        """Yield (x, y) float32 batches for one pass over the data."""
        lib = self._lib
        lib.tdl_start_epoch(self._h, seed, batch, n_threads, int(shuffle))
        x = np.empty((batch, self.input_dim), np.float32)
        y = np.empty((batch, self.target_dim), np.float32)
        xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        yp = y.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while True:
            n = lib.tdl_next_batch(self._h, xp, yp)
            if n <= 0:
                break
            yield x[:n].copy(), y[:n].copy()

    def load_all(self) -> TubeDataset:
        """Materialize the whole dataset (for the in-memory trainer)."""
        xs, ys = [], []
        for x, y in self.epoch(seed=0, batch=65536, shuffle=False):
            xs.append(x)
            ys.append(y)
        return TubeDataset(np.concatenate(xs), np.concatenate(ys))

    def close(self):
        if self._h:
            self._lib.tdl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NumpyTubeLoader:
    """The numpy loader with the same API (in memory, one thread)."""

    def __init__(self, paths: List[str], N: int = 1, dN: int = 1,
                 n_zero_tail: int = -1):
        stats, wins, tgts, dones = [], [], [], []
        for p in paths:
            with open(p, "rb") as f:
                hdr = np.fromfile(f, np.int32, 8)
                if hdr[0] != _MAGIC or hdr[1] != 1:
                    raise ValueError(f"bad magic/version in {p}")
                E, T, Fs, Fw, G = (int(v) for v in hdr[2:7])
                if n_zero_tail < 0:
                    n_zero_tail = int(hdr[7])
                stats.append(np.fromfile(f, np.float32, E * T * Fs)
                             .reshape(E, T, Fs))
                wins.append(np.fromfile(f, np.float32, E * T * Fw)
                            .reshape(E, T, Fw))
                tgts.append(np.fromfile(f, np.float32, E * T * G)
                            .reshape(E, T, G))
                dones.append(np.fromfile(f, np.uint8, E * T)
                             .reshape(E, T).astype(bool))
        static = np.concatenate(stats)
        windowed = np.concatenate(wins)
        target = np.concatenate(tgts)
        done = np.concatenate(dones)
        win = sliding_window(windowed, N, dN, n_zero_tail)
        data = np.concatenate((static, win), axis=-1)
        keep = ~done.reshape(-1)
        self._x = data.reshape(keep.shape[0], -1)[keep].astype(np.float32)
        self._y = target.reshape(keep.shape[0], -1)[keep].astype(np.float32)
        self.num_rows = self._x.shape[0]
        self.input_dim = self._x.shape[1]
        self.target_dim = self._y.shape[1]

    def epoch(self, seed: int, batch: int, n_threads: int = 2,
              shuffle: bool = True):
        idx = np.arange(self.num_rows)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for s in range(0, self.num_rows, batch):
            sel = idx[s: s + batch]
            yield self._x[sel], self._y[sel]

    def load_all(self) -> TubeDataset:
        return TubeDataset(self._x.copy(), self._y.copy())

    def close(self):
        pass


def make_loader(paths: List[str], N: int = 1, dN: int = 1,
                n_zero_tail: int = -1):
    """Native loader when the toolchain is available, numpy otherwise."""
    try:
        return NativeTubeLoader(paths, N, dN, n_zero_tail)
    except RuntimeError:
        return NumpyTubeLoader(paths, N, dN, n_zero_tail)
