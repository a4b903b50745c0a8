"""Tube-width dataset constructors (numpy).

Counterpart of ``legged_gym_dev_tpu/tube/datasets.py``, kept as the port's
own copy (the port imports nothing of the JAX package). Rollouts arrive as
host arrays from ``tube.collect``; building a dataset is one-time host
preprocessing, and the fixed-shape arrays feed the training step.

- ``sliding_window`` stacks history slices with stride dN, padding the
  start with the first row whose input dims are zeroed.
- Scalar (w = ||pz_x - z||), vector (per-dim |err|), alpha-conditioned
  (the quantile level appended to the inputs, redrawn each epoch), signed
  error-dynamics and one-shot horizon (H_rev past widths, z0's rest and
  H_rev + H_fwd inputs -> H_fwd future widths) variants.
- Rows marked ``done`` are dropped; the split is a contiguous random one.

``HorizonTubeDataset.sample_batch`` and the window filter of
``scalar_horizon_tube_dataset`` are vectorised; they draw the same integers
and give the same arrays as the JAX package's loops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RolloutData:
    """Raw tracking rollouts: leading axis episodes, second time.
    ``z`` / ``pz_x`` have T+1 steps, ``v`` / ``done`` have T."""

    z: np.ndarray      # (E, T+1, n) planned ROM states
    v: np.ndarray      # (E, T, m) ROM inputs
    pz_x: np.ndarray   # (E, T+1, n) achieved robot projections
    done: np.ndarray   # (E, T) termination flags

    def __post_init__(self):
        # The last step of every episode is marked done, so concatenating
        # episodes cannot create spurious transitions.
        self.done = np.asarray(self.done, bool).copy()
        self.done[:, -1] = True

    @classmethod
    def concatenate(cls, parts) -> "RolloutData":
        return cls(
            z=np.concatenate([p.z for p in parts], axis=0),
            v=np.concatenate([p.v for p in parts], axis=0),
            pz_x=np.concatenate([p.pz_x for p in parts], axis=0),
            done=np.concatenate([p.done for p in parts], axis=0),
        )


def get_slice(data: np.ndarray, i: int, dN: int, m: int) -> np.ndarray:
    """Shift history back by i*dN steps, padding with the initial row whose
    input dims are zeroed."""
    T = data.shape[-2]
    slc = np.flip(np.arange(T - i * dN - 1, -1, step=-dN))
    start = data[:, :1, :].copy()
    start[:, :, -m:] = 0.0
    pad = np.repeat(start, T - len(slc), axis=-2)
    return np.concatenate((pad, data[:, slc, :]), axis=-2)


def sliding_window(data: np.ndarray, N: int, dN: int, m: int) -> np.ndarray:
    """Stack N history slices along the feature axis."""
    return np.concatenate([get_slice(data, i, dN, m) for i in range(N)],
                          axis=-1)


@dataclasses.dataclass
class TubeDataset:
    """Flat (input, target) arrays and an epoch-level ``update`` hook."""

    data: np.ndarray
    target: np.ndarray

    @property
    def input_dim(self) -> int:
        return self.data.shape[1]

    @property
    def output_dim(self) -> int:
        return self.target.shape[1]

    def __len__(self) -> int:
        return self.data.shape[0]

    def update(self, rng: Optional[np.random.Generator] = None) -> None:
        """Per-epoch refresh (a no-op except for the alpha datasets)."""

    def random_split(self, split_proportion: float,
                     rng: Optional[np.random.Generator] = None):
        """Contiguous random split."""
        rng = rng or np.random.default_rng()
        split_len = int(len(self) * split_proportion)
        idx = int(rng.integers(len(self) - split_len))
        a = dataclasses.replace(
            self, data=self.data[idx: idx + split_len],
            target=self.target[idx: idx + split_len])
        b = dataclasses.replace(
            self,
            data=np.vstack((self.data[:idx], self.data[idx + split_len:])),
            target=np.vstack((self.target[:idx],
                              self.target[idx + split_len:])))
        return a, b


def _flatten_drop_done(data, target, done):
    E, T = data.shape[:2]
    data = data.reshape(E * T, -1)
    target = target.reshape(E * T, -1)
    keep = ~done.reshape(E * T)
    return data[keep], target[keep]


def scalar_tube_dataset(r: RolloutData, N: int = 1, dN: int = 1,
                        recursive: bool = False) -> TubeDataset:
    """w = ||pz_x - z||; input = [w, sliding(z_rest, v)] (``recursive``:
    the sliding window of [w, z_rest, v])."""
    z, pz_x = r.z[:, :-1], r.pz_x[:, :-1]
    w = np.linalg.norm(pz_x - z, axis=-1)
    w_p1 = np.linalg.norm(r.pz_x[:, 1:] - r.z[:, 1:], axis=-1)
    z_rest = z[:, :, 2:]
    m = r.v.shape[-1]
    if recursive:
        feats = np.concatenate((w[..., None], z_rest, r.v), axis=-1)
        data = sliding_window(feats, N, dN, m)
    else:
        zv = sliding_window(np.concatenate((z_rest, r.v), axis=-1), N, dN, m)
        data = np.concatenate((w[..., None], zv), axis=-1)
    data, target = _flatten_drop_done(data, w_p1[..., None], r.done)
    return TubeDataset(data.astype(np.float32), target.astype(np.float32))


def vector_tube_dataset(r: RolloutData, N: int = 1,
                        dN: int = 1) -> TubeDataset:
    """Per-dim |err| targets."""
    z, pz_x = r.z[:, :-1], r.pz_x[:, :-1]
    w = np.abs(pz_x - z)
    w_p1 = np.abs(r.pz_x[:, 1:] - r.z[:, 1:])
    feats = np.concatenate((w, z, r.v), axis=-1)
    data = sliding_window(feats, N, dN, r.v.shape[-1])
    data, target = _flatten_drop_done(data, w_p1, r.done)
    return TubeDataset(data.astype(np.float32), target.astype(np.float32))


@dataclasses.dataclass
class AlphaTubeDataset(TubeDataset):
    """The quantile level appended to the inputs, redrawn each epoch."""

    def update(self, rng: Optional[np.random.Generator] = None) -> None:
        rng = rng or np.random.default_rng()
        self.data[:, -1] = rng.uniform(size=len(self)).astype(np.float32)


def _alpha_dataset(w, w_p1, r: RolloutData, N, dN, rng) -> AlphaTubeDataset:
    feats = np.concatenate((w, r.z[:, :-1], r.v), axis=-1)
    data = sliding_window(feats, N, dN, r.v.shape[-1])
    data, target = _flatten_drop_done(data, w_p1, r.done)
    rng = rng or np.random.default_rng()
    alpha = rng.uniform(size=(data.shape[0], 1))
    data = np.hstack((data, alpha))
    return AlphaTubeDataset(data.astype(np.float32),
                            target.astype(np.float32))


def alpha_scalar_tube_dataset(r: RolloutData, N: int = 1, dN: int = 1,
                              rng=None) -> AlphaTubeDataset:
    w = np.linalg.norm(r.pz_x[:, :-1] - r.z[:, :-1], axis=-1)
    w_p1 = np.linalg.norm(r.pz_x[:, 1:] - r.z[:, 1:], axis=-1)
    return _alpha_dataset(w[..., None], w_p1[..., None], r, N, dN, rng)


def alpha_vector_tube_dataset(r: RolloutData, N: int = 1, dN: int = 1,
                              rng=None) -> AlphaTubeDataset:
    return _alpha_dataset(np.abs(r.pz_x[:, :-1] - r.z[:, :-1]),
                          np.abs(r.pz_x[:, 1:] - r.z[:, 1:]), r, N, dN, rng)


def error_dynamics_dataset(r: RolloutData, N: int = 1,
                           dN: int = 1) -> TubeDataset:
    """Signed error targets."""
    z, pz_x = r.z[:, :-1], r.pz_x[:, :-1]
    w = pz_x - z
    w_p1 = r.pz_x[:, 1:] - r.z[:, 1:]
    feats = np.concatenate((w, z, r.v), axis=-1)
    data = sliding_window(feats, N, dN, r.v.shape[-1])
    data, target = _flatten_drop_done(data, w_p1, r.done)
    return TubeDataset(data.astype(np.float32), target.astype(np.float32))


@dataclasses.dataclass
class HorizonTubeDataset:
    """One-shot horizon dataset with random (episode, time) sampling.

    Input per sample: [w_{t-H_rev:t}, z_t[2:], v_{t-H_rev:t+H_fwd}
    flattened column by column] -> target w_{t+1:t+H_fwd+1}: the layout the
    solver's NN_oneshot tube reads (``solver/tube_dynamics.py``).

    ``valid`` lists the (episode, t) window starts whose whole horizon holds
    no environment reset: a window across a reset stitches two episodes
    together, and its error spike would poison the learned quantile.
    """

    w: np.ndarray       # (E, H_rev + T) padded width series
    z_rest: np.ndarray  # (E, H_rev + T, n-2)
    v: np.ndarray       # (E, H_rev + T, m)
    H_fwd: int
    H_rev: int
    valid: Optional[np.ndarray] = None   # (n_valid, 2) [episode, t] pairs

    @property
    def input_dim(self) -> int:
        return (self.H_rev + self.z_rest.shape[-1]
                + (self.H_rev + self.H_fwd) * self.v.shape[-1])

    @property
    def output_dim(self) -> int:
        return self.H_fwd

    def __len__(self) -> int:
        return self.w.shape[0]

    def sample_batch(self, rng: np.random.Generator, batch: int):
        """Random (episode, time) samples -> (input, target) float32
        arrays."""
        Hf, Hr = self.H_fwd, self.H_rev
        if self.valid is not None and len(self.valid) > 0:
            pick = rng.integers(0, len(self.valid), size=batch)
            eps, ts = self.valid[pick, 0], self.valid[pick, 1]
        else:
            eps = rng.integers(0, len(self), size=batch)
            ts = rng.integers(Hr, self.w.shape[1] - Hf - 1, size=batch)
        e = eps[:, None]
        w_hist = self.w[e, ts[:, None] + np.arange(-Hr, 0)]
        z0 = self.z_rest[eps, ts]
        v_win = self.v[e, ts[:, None] + np.arange(-Hr, Hf)]
        # column by column, as the solver's NN input
        v_flat = v_win.transpose(0, 2, 1).reshape(batch, -1)
        x = np.concatenate([w_hist, z0, v_flat], axis=1)
        y = self.w[e, ts[:, None] + np.arange(1, Hf + 1)]
        return x.astype(np.float32), y.astype(np.float32)

    def random_split(self, split_proportion: float, rng=None):
        rng = rng or np.random.default_rng()
        split_len = int(len(self) * split_proportion)
        idx = int(rng.integers(len(self) - split_len))
        sel = np.arange(idx, idx + split_len)
        rest = np.r_[0:idx, idx + split_len:len(self)]

        def sub(ep_idx):
            valid = None
            if self.valid is not None:
                remap = -np.ones(len(self), np.int64)
                remap[ep_idx] = np.arange(len(ep_idx))
                mask = np.isin(self.valid[:, 0], ep_idx)
                valid = self.valid[mask].copy()
                valid[:, 0] = remap[valid[:, 0]]
            return dataclasses.replace(
                self, w=self.w[ep_idx], z_rest=self.z_rest[ep_idx],
                v=self.v[ep_idx], valid=valid)

        return sub(sel), sub(rest)

    def update(self, rng=None):
        pass


def _clean_window_starts(done: np.ndarray, H_fwd: int,
                         H_rev: int) -> Optional[np.ndarray]:
    """(episode, t) pairs, t on the padded series, of the windows whose
    span holds no reset: start s = t - H_rev in [0, T - H_fwd - 1) is
    clean when no done of steps 0..T-2 lies in [s - H_rev, s + H_fwd + 1].
    Row-major order, int64; None when there is none."""
    E, T = done.shape
    n_start = T - H_fwd - 1
    if n_start <= 0:
        return None
    counts = np.zeros((E, T), np.int64)
    np.cumsum(done[:, :-1], axis=1, out=counts[:, 1:])
    s = np.arange(n_start)
    lo = np.maximum(s - H_rev, 0)
    hi = np.minimum(s + H_fwd + 1, T - 2)          # inclusive
    hits = np.where(hi >= lo, counts[:, np.maximum(hi + 1, 0)]
                    - counts[:, lo], 0)
    pairs = np.argwhere(hits == 0)
    if len(pairs) == 0:
        return None
    pairs[:, 1] += H_rev
    return pairs.astype(np.int64)


def scalar_horizon_tube_dataset(r: RolloutData, H_fwd: int = 50,
                                H_rev: int = 10,
                                drop_done_episodes: bool = True
                                ) -> HorizonTubeDataset:
    """Pad the series back H_rev steps with the initial state and zero
    inputs. ``drop_done_episodes`` restricts sampling to windows whose
    [t-H_rev, t+H_fwd] span holds no environment reset."""
    valid = None
    if drop_done_episodes:
        valid = _clean_window_starts(np.asarray(r.done, bool), H_fwd, H_rev)
    z, pz_x, v = r.z[:, :-1], r.pz_x[:, :-1], r.v
    v = np.concatenate((np.zeros((v.shape[0], H_rev, v.shape[2])), v),
                       axis=1)
    z = np.concatenate((np.repeat(z[:, :1], H_rev, axis=1), z), axis=1)
    pz_x = np.concatenate((np.repeat(pz_x[:, :1], H_rev, axis=1), pz_x),
                          axis=1)
    w = np.linalg.norm(pz_x - z, axis=-1)
    return HorizonTubeDataset(
        w=w.astype(np.float32), z_rest=z[:, :, 2:].astype(np.float32),
        v=v.astype(np.float32), H_fwd=H_fwd, H_rev=H_rev, valid=valid)


DATASET_REGISTRY = {
    "ScalarTubeDataset": scalar_tube_dataset,
    "VectorTubeDataset": vector_tube_dataset,
    "AlphaScalarTubeDataset": alpha_scalar_tube_dataset,
    "AlphaVectorTubeDataset": alpha_vector_tube_dataset,
    "ErrorDynamicsDataset": error_dynamics_dataset,
    "ScalarHorizonTubeDataset": scalar_horizon_tube_dataset,
}
