"""On-policy training runner: iteration loop, metrics, checkpoints.

Counterpart of ``legged_gym_dev_tpu/rl/runner.py``: drives the PPO learn
iteration, logs JSON-line metrics, and keeps checkpoints with ``latest`` /
``best{stage}`` aliases (best resets when the curriculum stage changes).
A checkpoint is the model's ``state_dict`` written by ``torch.save`` to
``<log_dir>/<name>.pt`` (orbax directories in the JAX package).

With a device mesh (``mesh=``, ``parallel.mesh.make_mesh``) the runner
trains data-parallel: the env is cut into one replica per shard
(``envs.base.ShardedEnv``), each reset with its own generator
(``parallel.mesh.shard_generators``: shard 0 as the unsharded run's, so a
1-device mesh reproduces it bit for bit), the model is replicated, each
shard rolls out with its replica and the update runs on the whole batch
gathered onto the first device (``ppo.make_learn_iteration_sharded``).
Checkpoints hold one copy of the parameters, so a sharded run resumes
unsharded and the other way round.
"""
from __future__ import annotations

import copy
import json
import os
import re
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.runtime import fp32_matmul
from .networks import ActorCritic
from .ppo import (
    PPOConfig,
    init_train_state,
    make_learn_iteration,
    make_learn_iteration_sharded,
    sync_replicas,
)

_ARCH_FIELDS = ("num_obs", "num_actions", "actor_hidden_dims",
                "critic_hidden_dims", "activation", "init_noise_std",
                "rnn_hidden_size")


def save_model_arch(model, log_dir: str) -> None:
    """Record the network architecture beside the checkpoints, so a resume
    or play can rebuild the exact module."""
    arch = {"cls": type(model).__name__}
    for f in _ARCH_FIELDS:
        if hasattr(model, f):
            v = getattr(model, f)
            arch[f] = list(v) if isinstance(v, (tuple, list)) else v
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "arch.json"), "w") as f:
        json.dump(arch, f)


def load_model_arch(log_dir: str):
    """Rebuild the network recorded by ``save_model_arch`` (None if the run
    has no record)."""
    path = os.path.join(log_dir, "arch.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        arch = json.load(f)
    from . import networks

    cls = getattr(networks, arch.pop("cls"))
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in arch.items()})


def make_curriculum_stage_fn(curriculum, steps_per_iter: int):
    """Map a learn-iteration index to the env's curriculum stage: the env
    advances a stage when its step counter (``steps_per_iter`` =
    ``PPOConfig.num_steps`` a learn iteration) crosses
    ``curriculum.steps``, so ``best{stage}`` checkpoints carry the stage
    the env is in."""
    thresholds = np.asarray(curriculum.steps, np.int64)

    def fn(it: int) -> int:
        return int(np.sum((it + 1) * steps_per_iter >= thresholds))

    return fn


class CheckpointManager:
    """latest / best-per-stage checkpoint aliases."""

    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.best_metric = -np.inf
        self.best_stage = -1

    def _path(self, name: str) -> str:
        return os.path.join(self.log_dir, f"{name}.pt")

    def _save(self, name: str, state_dict) -> None:
        tmp = self._path(name) + ".tmp"
        torch.save(state_dict, tmp)
        os.replace(tmp, self._path(name))

    def save(self, state_dict, it: int, metric: float, stage: int = 0):
        self._save(f"model_{it}", state_dict)
        self._save("latest", state_dict)
        if stage != self.best_stage:
            # best resets on a curriculum-stage change
            self.best_metric, self.best_stage = -np.inf, stage
        if metric >= self.best_metric:
            self.best_metric = metric
            self._save(f"best{stage}", state_dict)

    def load(self, name: str, device=None):
        return torch.load(self._path(name), map_location=device,
                          weights_only=True)

    def best_stages(self):
        """Curriculum stages that have a ``best{stage}`` checkpoint."""
        out = []
        for f in os.listdir(self.log_dir):
            m = re.fullmatch(r"best(\d+)\.pt", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def wait_until_finished(self) -> None:
        """Returns at once: ``save`` writes each checkpoint before it
        returns (the JAX package waits here for its asynchronous
        commits)."""


def _leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested metrics dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(paths, values) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = float(v)
    return out


class OnPolicyRunner:
    """Iterate PPO learn steps over a vectorized env on its device."""

    def __init__(self, env, model=None, cfg: PPOConfig = PPOConfig(),
                 log_dir: Optional[str] = None, seed: int = 0,
                 metrics_callback: Optional[Callable[[Dict], None]] = None,
                 mesh=None):
        self.env, self.cfg, self.mesh = env, cfg, mesh
        dev = env.device if mesh is None else mesh.devices.flat[0]
        if model is None:
            model = ActorCritic(env.num_obs, env.num_actions,
                                generator=torch.Generator().manual_seed(seed))
        self.model = model.to(dev)
        self.recurrent = hasattr(self.model, "initial_carry")
        if mesh is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            self.env_state, _ = env.reset(gen)
            self.models = [self.model]
        else:
            from ..envs.base import ShardedEnv
            from ..parallel.mesh import (
                replicate,
                shard_batch,
                shard_generators,
            )

            senv = ShardedEnv(env, mesh)
            gens = shard_generators(mesh, seed)
            gen = gens[0]
            self.env_state, _ = senv.reset(gens)
            self.models = replicate(self.model, mesh)
        self.train_state = init_train_state(self.model, cfg, gen)
        if self.recurrent:
            from .ppo_recurrent import (
                make_learn_iteration_recurrent,
                make_learn_iteration_recurrent_sharded,
            )

            self.carry = self.model.initial_carry(env.num_envs)
            if mesh is None:
                rec_learn = make_learn_iteration_recurrent(env, self.model,
                                                           cfg)
            else:
                self.carry = shard_batch(self.carry, mesh,
                                         batch_size=env.num_envs)
                rec_learn = make_learn_iteration_recurrent_sharded(
                    senv, self.models, cfg, gens)

            def _learn(train_state, env_state):
                train_state, env_state, self.carry, metrics = rec_learn(
                    train_state, env_state, self.carry)
                return train_state, env_state, metrics

            self._learn = _learn
        else:
            self.carry = None
            self._learn = (
                make_learn_iteration(env, self.model, cfg) if mesh is None
                else make_learn_iteration_sharded(senv, self.models, cfg,
                                                  gens))
        self.log_dir = log_dir
        self.ckpt = CheckpointManager(log_dir) if log_dir else None
        if log_dir:
            save_model_arch(self.model, log_dir)
        self.metrics_callback = metrics_callback
        self.history = []
        self.it = 0

    def learn(self, num_iterations: int, save_interval: int = 50,
              curriculum_stage_fn: Optional[Callable[[int], int]] = None,
              log_interval: int = 1):
        """Run learn iterations; convert metrics every ``log_interval``.

        Metrics stay on the device and each window goes to the host in one
        transfer, so iterations queue without waiting on the card except
        at a flush or a checkpoint."""
        metrics_path = (os.path.join(self.log_dir, "metrics.jsonl")
                        if self.log_dir else None)
        pending = []           # (it, device metrics) awaiting conversion
        t_window = time.perf_counter()

        def flush():
            nonlocal t_window
            if not pending:
                return
            paths = [p for p, _ in _leaves(pending[0][1])]
            host = torch.stack([
                torch.stack([v.float().reshape(()) for _, v in _leaves(m)])
                for _, m in pending]).cpu().numpy()
            dt = (time.perf_counter() - t_window) / len(pending)
            steps = self.cfg.num_steps * self.env.num_envs
            for row, (it, _) in zip(host, pending):
                m = _unflatten(paths, row)
                m.update(it=it, iter_time_s=dt, steps_per_s=steps / dt)
                self.history.append(m)
                if self.metrics_callback:
                    self.metrics_callback(m)
                if metrics_path:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(m) + "\n")
            pending.clear()
            t_window = time.perf_counter()

        for _ in range(num_iterations):
            self.train_state, self.env_state, metrics = self._learn(
                self.train_state, self.env_state)
            pending.append((self.it, metrics))
            last = self.it == num_iterations - 1
            if len(pending) >= log_interval or last:
                flush()
            if self.ckpt and (self.it % save_interval == 0 or last):
                stage = (curriculum_stage_fn(self.it)
                         if curriculum_stage_fn else 0)
                self.ckpt.save(
                    self.model.state_dict(), self.it,
                    self.history[-1].get("mean_reward", 0.0)
                    if self.history else 0.0, stage)
            self.it += 1
        flush()
        return self.history

    def get_inference_policy(self):
        """Deterministic policy (the Gaussian's mean) of a snapshot of the
        current parameters. A recurrent policy carries its LSTM state
        across calls; call ``policy.reset()`` at episode boundaries."""
        model = copy.deepcopy(self.model).eval()

        if self.recurrent:
            state = {"carry": None}

            @torch.no_grad()
            def policy(obs):
                carry = state["carry"]
                if carry is None:
                    carry = model.initial_carry(obs.shape[0])
                with fp32_matmul():
                    mean, _, _, state["carry"] = model(obs, carry)
                return mean

            policy.reset = lambda: state.update(carry=None)
            return policy

        @torch.no_grad()
        def policy(obs):
            with fp32_matmul():
                return model(obs)[0]

        return policy

    def load_state_dict(self, state_dict) -> None:
        """Loads a checkpoint's parameters into the model and every
        replica."""
        self.model.load_state_dict(state_dict)
        sync_replicas(self.models)

    def load(self, name: str = "latest"):
        if self.ckpt is None:
            raise ValueError("the runner has no log_dir to load from")
        self.load_state_dict(self.ckpt.load(name, self.env.device))
