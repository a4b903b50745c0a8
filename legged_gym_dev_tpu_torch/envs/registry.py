"""Task registry: explicit name -> (env factory, PPO config) mapping.

Counterpart of ``legged_gym_dev_tpu/envs/registry.py``: ``make_env`` builds
a task's env, ``make_alg_runner`` its PPO runner with the log-dir layout
``<log_root>/<task>/<date>_<run>`` and ``resume`` / ``load_run``.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import datetime
from typing import Any, Callable, Dict, Optional

from ..rl.ppo import PPOConfig


@dataclasses.dataclass
class TaskEntry:
    env_factory: Callable[..., Any]       # (**overrides) -> env
    train_cfg: PPOConfig
    runner_kwargs: Dict[str, Any]


class TaskRegistry:
    def __init__(self):
        self._tasks: Dict[str, TaskEntry] = {}

    def register(self, name: str, env_factory: Callable[..., Any],
                 train_cfg: PPOConfig = PPOConfig(), **runner_kwargs) -> None:
        self._tasks[name] = TaskEntry(env_factory, train_cfg, runner_kwargs)

    def list_tasks(self):
        return sorted(self._tasks)

    def get(self, name: str) -> TaskEntry:
        try:
            return self._tasks[name]
        except KeyError:
            raise ValueError(f"Task '{name}' not registered. Known: "
                             f"{self.list_tasks()}") from None

    def make_env(self, name: str, **overrides):
        """Construct the task's env with the given overrides."""
        return self.get(name).env_factory(**overrides)

    def make_alg_runner(self, env, name: str, log_root: str = "logs",
                        run_name: str = "", seed: int = 0,
                        resume: bool = False, load_run: str = "latest",
                        load_dir: str = "", model=None,
                        metrics_callback=None,
                        train_cfg: Optional[PPOConfig] = None, mesh=None):
        """The task's PPO runner logging to
        ``<log_root>/<name>/<date>_<run_name>``. ``resume`` loads
        ``load_run`` from ``load_dir``, by default the most recent earlier
        run under ``<log_root>/<name>`` (by modification time), and
        rebuilds the network it recorded. ``train_cfg`` overrides the
        task's registered PPO config; ``mesh`` trains data-parallel over a
        device mesh (``OnPolicyRunner``)."""
        from ..rl.runner import (
            CheckpointManager,
            OnPolicyRunner,
            load_model_arch,
        )

        entry = self.get(name)
        stamp = datetime.now().strftime("%b%d_%H-%M-%S")
        log_dir = os.path.join(log_root, name, f"{stamp}_{run_name}")
        if resume:
            if not load_dir:
                task_root = os.path.join(log_root, name)
                runs = sorted(
                    (d for d in os.listdir(task_root)
                     if os.path.isdir(os.path.join(task_root, d))
                     and d != os.path.basename(log_dir)),
                    key=lambda d: os.path.getmtime(
                        os.path.join(task_root, d)))
                if not runs:
                    raise FileNotFoundError(
                        f"no previous runs to resume under {task_root}")
                load_dir = os.path.join(task_root, runs[-1])
            if model is None:
                model = load_model_arch(load_dir)
        runner = OnPolicyRunner(
            env, model=model, cfg=train_cfg or entry.train_cfg,
            log_dir=log_dir, seed=seed, metrics_callback=metrics_callback,
            mesh=mesh, **entry.runner_kwargs)
        if resume:
            runner.load_state_dict(
                CheckpointManager(load_dir).load(load_run, env.device))
        return runner


task_registry = TaskRegistry()


def register(name: str, env_factory, train_cfg: PPOConfig = PPOConfig(),
             **runner_kwargs) -> None:
    task_registry.register(name, env_factory, train_cfg, **runner_kwargs)


def get(name: str) -> TaskEntry:
    return task_registry.get(name)


def make_env(name: str, **overrides):
    return task_registry.make_env(name, **overrides)
