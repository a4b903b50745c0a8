"""YAML config tree: composition, interpolation and the sections' readers.

Counterpart of ``legged_gym_dev_tpu/utils/config.py``; it reads the same
``configs/`` files:

- ``defaults:`` composition (sibling files merged in order, the current
  file at its ``_self_`` position) and ``${var}`` interpolation against
  top-level scalar keys;
- CLI flags override YAML (``cli.py``).

Recognized sections: ``task`` / ``experiment_name`` / ``seed`` (scalars),
``env`` (preset-factory kwargs incl. a ``rewards.scales`` mapping and a
``curriculum`` name), ``policy`` (architecture incl. ``recurrent: true``),
``train`` (PPOConfig overrides), ``run`` (iterations, seed), ``tube``
(``tube_spec``: the tube net's dataset, loss, model and training) and
``collect`` (the ``collect`` subcommand's settings). Any other top-level
scalar key is an interpolation variable.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional

import yaml

from ..rl.ppo import PPOConfig

SECTIONS = ("env", "policy", "train", "run", "tube", "collect")
SCALAR_KEYS = ("task", "experiment_name", "seed")

_INTERP = re.compile(r"^\$\{([A-Za-z_][A-Za-z0-9_]*)\}$")


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _interpolate(obj: Any, variables: Dict[str, Any]) -> Any:
    if isinstance(obj, str):
        m = _INTERP.match(obj.strip())
        if m:
            name = m.group(1)
            if name not in variables:
                raise ValueError(f"undefined interpolation variable "
                                 f"'${{{name}}}'")
            return variables[name]
        return obj
    if isinstance(obj, dict):
        return {k: _interpolate(v, variables) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v, variables) for v in obj]
    return obj


TUBE_DATASETS = ("scalar", "vector", "alpha_scalar", "alpha_vector",
                 "error", "oneshot")
TUBE_LOSSES = ("scalar", "vector", "alpha_scalar", "alpha_vector", "error")


def tube_spec(tube_cfg: Optional[Dict]) -> Dict[str, Any]:
    """Normalize a ``tube:`` section (configs/tube_learning/*.yaml): the
    dataset, loss and model choices as explicit names, with defaults."""
    cfg = dict(tube_cfg or {})
    spec = {
        "dataset": cfg.pop("dataset", "scalar"),
        "loss": cfg.pop("loss", "scalar"),
        "alpha": float(cfg.pop("alpha", 0.9)),
        "num_units": int(cfg.pop("num_units", 128)),
        "num_layers": int(cfg.pop("num_layers", 2)),
        "activation": cfg.pop("activation", "softplus_b5"),
        "epochs": int(cfg.pop("epochs", 100)),
        "batch_size": int(cfg.pop("batch_size", 1024)),
        "lr": float(cfg.pop("lr", 1e-3)),
        "window": int(cfg.pop("window", 3)),
        "H_fwd": int(cfg.pop("H_fwd", 50)),
        "H_rev": int(cfg.pop("H_rev", 10)),
    }
    if cfg:
        raise ValueError(f"unknown tube config keys: {sorted(cfg)}")
    if spec["dataset"] not in TUBE_DATASETS:
        raise ValueError(f"unknown tube dataset '{spec['dataset']}' "
                         f"(expected one of {TUBE_DATASETS})")
    if spec["loss"] not in TUBE_LOSSES:
        raise ValueError(f"unknown tube loss '{spec['loss']}'")
    return spec


def _load_raw(path: str, _stack=()) -> Dict:
    if path in _stack:
        raise ValueError(f"circular defaults: {' -> '.join(_stack + (path,))}")
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    defaults = cfg.pop("defaults", None)
    if not defaults:
        return cfg
    base_dir = os.path.dirname(os.path.abspath(path))
    merged: Dict = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, cfg)
            self_seen = True
            continue
        sub = os.path.join(base_dir, str(entry))
        if not sub.endswith((".yaml", ".yml")):
            sub += ".yaml"
        merged = _deep_merge(merged, _load_raw(sub, _stack + (path,)))
    if not self_seen:
        merged = _deep_merge(merged, cfg)
    return merged


def load_config(path: str) -> Dict[str, Any]:
    """Load + compose + interpolate one YAML config file."""
    cfg = _load_raw(path)
    variables = {k: v for k, v in cfg.items()
                 if not isinstance(v, (dict, list))}
    cfg = _interpolate(cfg, variables)
    for key, val in cfg.items():
        if key in SECTIONS or key in SCALAR_KEYS:
            continue
        if isinstance(val, dict):
            raise ValueError(
                f"unknown config section '{key}' (expected one of "
                f"{SECTIONS + SCALAR_KEYS}; scalar keys are interpolation "
                "variables)")
    return cfg


# ---------------------------------------------------------------------------
# Sections -> preset, policy and PPO arguments
# ---------------------------------------------------------------------------

def apply_train_overrides(base: PPOConfig, overrides: Dict) -> PPOConfig:
    valid = {f.name for f in dataclasses.fields(PPOConfig)}
    bad = set(overrides) - valid
    if bad:
        raise ValueError(f"unknown PPOConfig fields: {sorted(bad)}")
    return dataclasses.replace(base, **overrides)


def build_policy(policy_cfg: Optional[Dict], num_actions: int,
                 num_obs: int, generator=None):
    """Policy network from a config ``policy:`` section (hidden dims,
    activation, init noise; ``recurrent: true`` builds the LSTM
    actor-critic with ``rnn_hidden_size``). ``generator`` (CPU) draws the
    initial weights."""
    from ..rl import ActorCritic, ActorCriticRecurrent

    cfg = dict(policy_cfg or {})
    recurrent = bool(cfg.pop("recurrent", False))
    kw: Dict[str, Any] = {"num_obs": num_obs, "num_actions": num_actions,
                          "generator": generator}
    for key in ("actor_hidden_dims", "critic_hidden_dims"):
        if key in cfg:
            kw[key] = tuple(cfg.pop(key))
    for key in ("activation", "init_noise_std"):
        if key in cfg:
            kw[key] = cfg.pop(key)
    if recurrent and "rnn_hidden_size" in cfg:
        kw["rnn_hidden_size"] = cfg.pop("rnn_hidden_size")
    cfg.pop("rnn_hidden_size", None)
    if cfg:
        raise ValueError(f"unknown policy config keys: {sorted(cfg)}")
    if recurrent:
        return ActorCriticRecurrent(**kw)
    return ActorCritic(**kw)


def env_kwargs(env_cfg: Optional[Dict]) -> Dict[str, Any]:
    """Map a config ``env:`` section onto preset-factory kwargs.

    ``rewards.scales`` (the reference YAML spelling,
    ref configs/rl/hopper_single_int.yaml:12-26) becomes the factory's
    ``reward_scales`` tuple; everything else passes through (the factory
    rejects unknown kwargs, so typos fail loudly at build time).
    """
    cfg = dict(env_cfg or {})
    rewards = cfg.pop("rewards", None)
    if rewards:
        rewards = dict(rewards)
        scales = rewards.pop("scales", None)
        if rewards:
            raise ValueError(
                f"unsupported env.rewards keys: {sorted(rewards)} "
                "(only 'scales' maps onto the factories)")
        if scales:
            cfg["reward_scales"] = tuple(
                (name, float(v)) for name, v in scales.items())
    return cfg
