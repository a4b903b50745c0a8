"""Recurrent PPO: BPTT over the rollout window for LSTM policies.

Counterpart of ``legged_gym_dev_tpu/rl/ppo_recurrent.py``:

- The rollout keeps the window-start LSTM carry (``carry0``) and the
  per-step done flags; the update replays the whole ``num_steps`` window
  under the current parameters with the carry re-masked at episode
  boundaries (exact truncated BPTT over the window).
- Minibatches slice the env axis (sequences stay whole); each epoch
  permutes the envs.
"""
from __future__ import annotations

import torch

from ..utils.runtime import fp32_matmul
from .networks import ActorCriticRecurrent
from .ppo import (
    PPOConfig,
    TrainState,
    collect_steps,
    compute_gae,
    normalized,
    ppo_losses,
    rollout_metrics,
    run_epochs,
    sync_replicas,
)


def _recurrent_batch(st, last_value, carry0, cfg: PPOConfig):
    batch = dict(st)
    rewards = batch.pop("rewards")
    batch["advantages"], batch["returns"] = compute_gae(
        rewards, batch["values"], batch["dones"], last_value, cfg.gamma,
        cfg.lam)
    batch["carry0"] = carry0
    return batch


def rollout_recurrent(env, model, env_state, carry, cfg: PPOConfig,
                      generator: torch.Generator, obs=None):
    """Collect ``cfg.num_steps`` transitions, threading the LSTM carry.
    Returns ``(env_state, carry, batch, metrics)``; ``batch`` is a dict
    of (T, B, ...) tensors with ``carry0`` (the window's first carry)."""
    if obs is None:
        obs = env._obs(env_state)

    def step(states, actions):
        state, tr = env.step(states[0], actions[0])
        return [state], [tr]

    states, carries, st, last_value, ep_infos, n_resets = collect_steps(
        step, [model], [env_state], [obs], cfg, [generator],
        carries=[carry])
    return (states[0], carries[0],
            _recurrent_batch(st, last_value, carry, cfg),
            rollout_metrics(st, ep_infos, n_resets))


def rollout_recurrent_sharded(senv, models, states, carries,
                              cfg: PPOConfig, generators):
    """``rollout_recurrent`` over a device mesh, as ``ppo.rollout_sharded``:
    ``carries`` holds each shard's carry (``shard_batch`` of the whole
    batch's by its batch size). Returns ``(states, carries, batch,
    metrics)``; the batch's ``carry0`` is the shards' first carries
    concatenated on the first device."""
    from ..parallel.mesh import Sharded, gather

    obs = [e._obs(s) for e, s in zip(senv.envs, states)]
    states, new, st, last_value, ep_infos, n_resets = collect_steps(
        senv.step, list(models), states, obs, cfg, generators,
        carries=list(carries))
    return (states, Sharded(new, carries.mesh, carries.batch_size,
                            carries.split),
            _recurrent_batch(st, last_value, gather(carries), cfg),
            rollout_metrics(st, ep_infos, n_resets))


def ppo_update_recurrent(model, train_state: TrainState, batch,
                         cfg: PPOConfig, indices=None):
    """Epochs x env-axis minibatches of clipped PPO with window replay.
    ``indices`` (epochs, minibatches, envs) replaces the generator's
    permutations. Returns ``(train_state, metrics)``."""
    B = batch["log_probs"].shape[1]
    batch = dict(batch, advantages=normalized(batch["advantages"]))

    def minibatch(idx):
        mb = {k: v[:, idx] for k, v in batch.items()
              if k not in ("log_stds", "carry0")}
        carry = tuple(x[idx] for x in batch["carry0"])
        means, log_stds, values = [], [], []
        for t in range(mb["obs"].shape[0]):
            mean, log_std, value, carry = model(mb["obs"][t], carry)
            carry = ActorCriticRecurrent.mask_carry(carry, mb["dones"][t])
            means.append(mean)
            log_stds.append(log_std)
            values.append(value)
        log_std = torch.stack(log_stds)[:, None, :]   # (T, 1, A)
        return ppo_losses(cfg, torch.stack(means), log_std,
                          torch.stack(values), mb, batch["log_stds"][0])

    with fp32_matmul():
        return run_epochs(cfg, train_state, B, minibatch, indices)


def make_learn_iteration_recurrent(env, model, cfg: PPOConfig):
    """One recurrent rollout -> GAE -> BPTT update iteration:
    ``learn_iteration(train_state, env_state, carry) -> (train_state,
    env_state, carry, metrics)``."""

    def learn_iteration(train_state: TrainState, env_state, carry):
        env_state, carry, batch, roll_metrics = rollout_recurrent(
            env, model, env_state, carry, cfg, train_state.gen)
        train_state, up_metrics = ppo_update_recurrent(model, train_state,
                                                       batch, cfg)
        return train_state, env_state, carry, {**roll_metrics, **up_metrics}

    return learn_iteration


def make_learn_iteration_recurrent_sharded(senv, models, cfg: PPOConfig,
                                           generators):
    """The recurrent learn iteration over a device mesh (as
    ``ppo.make_learn_iteration_sharded``): ``learn_iteration(train_state,
    env_states, carries) -> (train_state, env_states, carries,
    metrics)``, the carries ``Sharded``."""

    def learn_iteration(train_state: TrainState, env_states, carries):
        env_states, carries, batch, roll_metrics = rollout_recurrent_sharded(
            senv, models, env_states, carries, cfg, generators)
        train_state, up_metrics = ppo_update_recurrent(models[0],
                                                       train_state, batch,
                                                       cfg)
        sync_replicas(models)
        return train_state, env_states, carries, {**roll_metrics,
                                                  **up_metrics}

    return learn_iteration
