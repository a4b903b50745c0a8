"""Tube-width network training.

Counterpart of ``legged_gym_dev_tpu/tube/train.py``: datasets from
``tube.datasets``, the ``MLP`` of ``tube.models``, losses from
``tube.losses``, and Adam in optax's arithmetic. The loop tracks the
gradient norm, calls the dataset's per-epoch ``update`` (alpha resampling),
evaluates coverage (the fraction with fw >= w) every ``eval_every`` epochs
and keeps the best model by loss.

The data pipeline is numpy on the host, and it draws from one
``np.random.default_rng(cfg.seed)`` in the JAX package's order: the split,
then per epoch ``update``, the batches, and the evaluation batch. One seed
gives both packages the same batches. Losses stay on the device within an
epoch (one host transfer an epoch).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from ..utils.runtime import fp32_matmul, resolve_device
from .datasets import HorizonTubeDataset
from .models import MLP


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 1024
    learning_rate: float = 1e-3
    eval_every: int = 10
    test_split: float = 0.2
    seed: int = 0
    grad_clip: float = 0.0  # 0 disables


@dataclasses.dataclass
class TrainResult:
    model: MLP
    best_model: MLP
    history: List[Dict]


def coverage(fw: np.ndarray, w: np.ndarray) -> float:
    """The fraction of targets the predicted tube covers."""
    return float(np.mean(np.all(fw >= w, axis=-1)))


class AdamState(NamedTuple):
    count: torch.Tensor          # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)``, after ``optax.clip_by_global_norm(grad_clip)``
    when ``grad_clip > 0``. Its b1, b2, eps and lr are Python floats, so
    ``1 - b1`` and ``1 - b2`` are formed in float64 and rounded to float32
    where they meet a tensor, as optax's weakly typed constants are:

        g     <- g if |g| < clip else g / |g| * clip     (no epsilon)
        mu    <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
        count <- count + 1
        p     <- p + (-lr) (mu / (1 - b1^count))
                             / (sqrt(nu / (1 - b2^count)) + eps)

    (``rl.ppo.Adam`` holds its constants as float32, as optax's
    ``inject_hyperparams`` does.)"""

    learning_rate: float
    grad_clip: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=params[0].device),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params, grads, state: AdamState) -> AdamState:
        """One step on ``params`` in place; returns the new state."""
        if self.grad_clip > 0:
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        for p, m, v in zip(params, mu, nu):
            p.add_((-self.learning_rate)
                   * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
        return AdamState(count=count, mu=mu, nu=nu)


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``: sqrt of the sum of each tensor's sum of
    squares, in order."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _trainable(model: MLP, device) -> MLP:
    """A copy of ``model`` on ``device`` whose weights take gradients."""
    out = _frozen(model, device)
    for p in _leaves(out):
        p.requires_grad_(True)
    return out


def _frozen(model: MLP, device=None) -> MLP:
    """A detached copy of ``model`` (on ``device``, default its own)."""
    def c(t):
        return t.detach().to(device or t.device).clone()

    return MLP([c(w) for w in model.weights], [c(b) for b in model.biases],
               activation=model.activation,
               final_activation=model.final_activation,
               out_scale=None if model.out_scale is None
               else c(model.out_scale))


def _leaves(model: MLP) -> List[torch.Tensor]:
    """The trained tensors in the JAX pytree's leaf order: weights,
    biases and ``out_scale`` where the model has one."""
    scale = [] if model.out_scale is None else [model.out_scale]
    return list(model.weights) + list(model.biases) + scale


class _Trainer:
    """The optimizer step, prediction and the history of one training run
    (shared by ``train_tube`` and ``train_tube_streaming``)."""

    def __init__(self, model: MLP, loss_fn: Callable, cfg: TrainConfig,
                 device):
        self.dev = resolve_device(device)
        self.model = _trainable(model, self.dev)
        self.params = _leaves(self.model)
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.opt = Adam(cfg.learning_rate, cfg.grad_clip)
        self.opt_state = self.opt.init(self.params)
        self.best_model, self.best_loss = _frozen(self.model), float("inf")

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.dev)

    def step(self, xb, yb):
        """One optimizer step: (loss, gradient norm) as device scalars."""
        xb, yb = self.tensor(xb), self.tensor(yb)
        with fp32_matmul(), torch.enable_grad():
            loss = self.loss_fn(self.model(xb), yb, xb)
            grads = torch.autograd.grad(loss, self.params)
            gnorm = global_norm(grads)
            self.opt_state = self.opt.update_(self.params, grads,
                                              self.opt_state)
        return loss.detach(), gnorm.detach()

    @torch.no_grad()
    def predict(self, xb) -> np.ndarray:
        with fp32_matmul():
            return self.model(self.tensor(xb)).cpu().numpy()

    def evaluate(self, xb, yb) -> Dict:
        fw = self.predict(xb)
        return {"coverage": coverage(fw, yb),
                "eval_mean_err": float(np.mean(np.abs(fw - yb)))}

    def record(self, epoch, losses, gnorms, batch_s, t0, evaluate):
        """The epoch's history entry (one host transfer of its losses),
        with the evaluation at eval epochs and the best model by loss."""
        cfg = self.cfg
        if losses:
            both = torch.stack([torch.stack(losses), torch.stack(gnorms)])
            lo, gn = both.cpu().numpy().astype(np.float64)
            rec = {"epoch": epoch, "loss": float(np.mean(lo)),
                   "grad_norm": float(np.mean(gn))}
        else:
            rec = {"epoch": epoch, "loss": float("nan"), "grad_norm": 0.0}
        rec.update(steps=len(losses), batch_s=batch_s,
                   wall_s=time.perf_counter() - t0)
        if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
            rec.update(evaluate())
            # best by lowest loss: coverage grows with over-prediction, so
            # the widest tube would win on coverage
            if rec["loss"] <= self.best_loss:
                self.best_loss = rec["loss"]
                self.best_model = _frozen(self.model)
        return rec

    def result(self, history) -> TrainResult:
        return TrainResult(model=_frozen(self.model),
                           best_model=self.best_model, history=history)


def train_tube(dataset, model: MLP, loss_fn: Callable,
               cfg: TrainConfig = TrainConfig(),
               device=None) -> TrainResult:
    """Train a tube network on a ``TubeDataset`` or
    ``HorizonTubeDataset`` on ``device`` (``None``: the CUDA card). Each
    history entry also holds the epoch's optimizer steps, its host seconds
    assembling batches (``batch_s``) and its wall seconds (``wall_s``)."""
    rng = np.random.default_rng(cfg.seed)
    horizon = isinstance(dataset, HorizonTubeDataset)
    train_ds, test_ds = dataset.random_split(1.0 - cfg.test_split, rng=rng)
    tr = _Trainer(model, loss_fn, cfg, device)

    def sample(ds, batch):
        if horizon:
            return ds.sample_batch(rng, batch)
        idx = rng.integers(0, len(ds), size=batch)
        return ds.data[idx], ds.target[idx]

    def evaluate():
        n = min(4096, max(len(test_ds), 1) * (8 if horizon else 1))
        return tr.evaluate(*sample(test_ds, n))

    history: List[Dict] = []
    steps_per_epoch = max(
        1, (len(train_ds) * (8 if horizon else 1)) // cfg.batch_size)
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        train_ds.update(rng)
        losses, gnorms, batch_s = [], [], 0.0
        for _ in range(steps_per_epoch):
            tb = time.perf_counter()
            xb, yb = sample(train_ds, cfg.batch_size)
            batch_s += time.perf_counter() - tb
            loss, gnorm = tr.step(xb, yb)
            losses.append(loss)
            gnorms.append(gnorm)
        history.append(tr.record(epoch, losses, gnorms, batch_s, t0,
                                 evaluate))
    return tr.result(history)


def train_tube_streaming(loader, model: MLP, loss_fn: Callable,
                         cfg: TrainConfig = TrainConfig(),
                         n_threads: int = 2, device=None) -> TrainResult:
    """Train from a streaming shard loader (``tube.shards``) instead of an
    in-memory dataset. The native loader's worker threads assemble the
    next shuffled batches while the step runs. Evaluation takes the first
    batch of an epoch with a held-out seed; ragged tail batches are
    dropped."""
    tr = _Trainer(model, loss_fn, cfg, device)

    def evaluate():
        it = loader.epoch(seed=cfg.seed + 10_000, batch=4096,
                          n_threads=n_threads, shuffle=True)
        return tr.evaluate(*next(iter(it)))

    history: List[Dict] = []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses, gnorms, batch_s = [], [], 0.0
        batches = iter(loader.epoch(seed=cfg.seed + epoch,
                                    batch=cfg.batch_size,
                                    n_threads=n_threads, shuffle=True))
        while True:
            tb = time.perf_counter()
            xb, yb = next(batches, (None, None))
            batch_s += time.perf_counter() - tb
            if xb is None:
                break
            if xb.shape[0] < cfg.batch_size:
                continue
            loss, gnorm = tr.step(xb, yb)
            losses.append(loss)
            gnorms.append(gnorm)
        history.append(tr.record(epoch, losses, gnorms, batch_s, t0,
                                 evaluate))
    return tr.result(history)


def conformal_width_scale(model: MLP, ds_val, alpha: float = 0.9,
                          batch: int = 8192, per_step: bool = True,
                          rng=None) -> float:
    """Split-conformal tube-width multiplier on held-out data: the
    smallest ``s`` such that ``s * model(x)`` covers the held-out targets
    at level ``alpha``, the alpha-quantile of the required scale w / fw.
    ``per_step=False`` targets whole-window coverage (every step of the
    horizon covered). Apply as the model's ``out_scale`` (it compounds with
    an existing one, which ``model(x)`` already includes)."""
    rng = rng or np.random.default_rng(0)
    if hasattr(ds_val, "sample_batch"):                 # HorizonTubeDataset
        xb, yb = ds_val.sample_batch(rng, batch)
    else:
        idx = rng.integers(0, len(ds_val), size=min(batch, len(ds_val)))
        xb, yb = ds_val.data[idx], ds_val.target[idx]
    dev = model.weights[0].device
    with torch.no_grad(), fp32_matmul():
        fw = model(torch.as_tensor(np.asarray(xb, np.float32),
                                   device=dev)).cpu().numpy()
    ratio = np.asarray(yb) / np.maximum(fw, 1e-6)
    if not per_step:
        ratio = np.max(ratio, axis=-1)
    return float(np.quantile(ratio.reshape(-1), alpha, method="higher"))


@torch.no_grad()
def evaluate_rollout_recursive(model: MLP, w0, z_rest, v,
                               H_rev: int = 0) -> torch.Tensor:
    """Roll a one-step tube model along one trajectory, feeding its own
    prediction back as the width input: w0 scalar, z_rest (T, n-2),
    v (T, m) -> predicted widths (T,). (``H_rev`` is unused, as in the JAX
    package.)"""
    dev = model.weights[0].device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    z_rest, v = t(z_rest), t(v)
    w = t(w0).reshape(1)
    out = []
    with fp32_matmul():
        for k in range(v.shape[0]):
            w = model(torch.cat([w, z_rest[k], v[k]]))[:1]
            out.append(w)
    return torch.cat(out)
