"""Task registry: explicit name -> (env factory, PPO config) mapping.

Counterpart of ``legged_gym_dev_tpu/envs/registry.py`` without the runner
(``make_alg_runner`` comes with the PPO update in a later slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

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


task_registry = TaskRegistry()


def register(name: str, env_factory, train_cfg: PPOConfig = PPOConfig(),
             **runner_kwargs) -> None:
    task_registry.register(name, env_factory, train_cfg, **runner_kwargs)


def get(name: str) -> TaskEntry:
    return task_registry.get(name)


def make_env(name: str, **overrides):
    return task_registry.make_env(name, **overrides)
