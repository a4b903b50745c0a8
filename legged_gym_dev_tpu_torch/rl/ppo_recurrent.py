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
from .networks import ActorCriticRecurrent, gaussian_sample
from .ppo import (
    PPOConfig,
    TrainState,
    compute_gae,
    normalized,
    ppo_losses,
    run_epochs,
)


@torch.no_grad()
def rollout_recurrent(env, model, env_state, carry, cfg: PPOConfig,
                      generator: torch.Generator, obs=None):
    """Collect ``cfg.num_steps`` transitions, threading the LSTM carry.
    Returns ``(env_state, carry, batch, metrics)``; ``batch`` is a dict
    of (T, B, ...) tensors with ``carry0`` (the window's first carry)."""
    if obs is None:
        obs = env._obs(env_state)
    carry0 = carry
    keys = ("obs", "actions", "log_probs", "values", "rewards", "dones",
            "means", "log_stds")
    out = {k: [] for k in keys}
    ep_infos, n_resets = [], []
    with fp32_matmul():
        for _ in range(cfg.num_steps):
            mean, log_std, value, carry = model(obs, carry)
            action, log_prob = gaussian_sample(generator, mean, log_std)
            env_state, tr = env.step(env_state, action)
            reward = tr.reward + cfg.gamma * value * \
                tr.info["time_outs"].float()
            carry = ActorCriticRecurrent.mask_carry(carry, tr.done)
            for k, x in zip(keys, (obs, action, log_prob, value, reward,
                                   tr.done, mean, log_std)):
                out[k].append(x)
            ep_infos.append(tr.info["episode"])
            n_resets.append(tr.info["n_resets"])
            obs = tr.obs
        _, _, last_value, _ = model(obs, carry)
    batch = {k: torch.stack(v) for k, v in out.items()}
    rewards = batch.pop("rewards")
    batch["advantages"], batch["returns"] = compute_gae(
        rewards, batch["values"], batch["dones"], last_value, cfg.gamma,
        cfg.lam)
    batch["carry0"] = carry0
    total_resets = torch.clamp(torch.stack(n_resets).sum(), min=1)
    metrics = {
        "mean_reward": rewards.mean(),
        "mean_episode_info": {
            k: torch.stack([e[k] for e in ep_infos]).sum() / total_resets
            for k in (ep_infos[0] if ep_infos else {})},
    }
    return env_state, carry, batch, metrics


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
