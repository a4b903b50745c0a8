"""PPO: configuration, GAE and the rollout of the vectorized env.

Counterpart of ``legged_gym_dev_tpu/rl/ppo.py``: ``PPOConfig`` (the
reference PPO block), ``compute_gae`` and ``rollout``. The update
(``ppo_update``) and the fused learn iteration come in a later slice.

Where the JAX rollout scans under ``jit``, this one is a Python loop over
``cfg.num_steps`` env steps; actions are drawn from an explicit
``torch.Generator``. The policy runs in full fp32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..utils.runtime import fp32_matmul
from .networks import gaussian_sample


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Defaults = the reference PPO block (legged_robot_config.py)."""

    num_steps: int = 24
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    clip_param: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    learning_rate: float = 1e-3
    schedule: str = "adaptive"
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    min_lr: float = 1e-5
    max_lr: float = 1e-2


class RolloutBatch(NamedTuple):
    obs: torch.Tensor        # (T, B, O)
    actions: torch.Tensor    # (T, B, A)
    log_probs: torch.Tensor  # (T, B)
    values: torch.Tensor     # (T, B)
    advantages: torch.Tensor
    returns: torch.Tensor
    means: torch.Tensor      # (T, B, A) old policy means (for KL)
    log_stds: torch.Tensor   # (T, A) old log-stds


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """GAE(lambda) over (T, B) tensors; episode boundaries cut the
    recursion. Returns (advantages, returns)."""
    T = rewards.shape[0]
    gae_next = torch.zeros_like(last_value)
    value_next = last_value
    adv = [None] * T
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t].float()
        delta = rewards[t] + gamma * value_next * nonterminal - values[t]
        gae_next = delta + gamma * lam * nonterminal * gae_next
        adv[t] = gae_next
        value_next = values[t]
    advantages = torch.stack(adv)
    return advantages, advantages + values


@torch.no_grad()
def rollout(env, model, env_state, cfg: PPOConfig,
            generator: torch.Generator, obs=None):
    """Collect ``cfg.num_steps`` transitions from the vectorized env.

    ``obs`` defaults to ``env._obs(env_state)``. Returns
    ``(env_state, batch, metrics)``.
    """
    if obs is None:
        obs = env._obs(env_state)
    keys = ("obs", "actions", "log_probs", "values", "rewards", "dones",
            "means", "log_stds")
    out = {k: [] for k in keys}
    ep_infos, n_resets = [], []
    with fp32_matmul():
        for _ in range(cfg.num_steps):
            mean, log_std, value = model(obs)
            action, log_prob = gaussian_sample(generator, mean, log_std)
            env_state, tr = env.step(env_state, action)
            # time-limit bootstrapping: truncation is not death
            reward = tr.reward + cfg.gamma * value * \
                tr.info["time_outs"].float()
            for k, x in zip(keys, (obs, action, log_prob, value, reward,
                                   tr.done, mean, log_std)):
                out[k].append(x)
            ep_infos.append(tr.info["episode"])
            n_resets.append(tr.info["n_resets"])
            obs = tr.obs
        _, _, last_value = model(obs)
    st = {k: torch.stack(v) for k, v in out.items()}
    advantages, returns = compute_gae(st["rewards"], st["values"],
                                      st["dones"], last_value, cfg.gamma,
                                      cfg.lam)
    batch = RolloutBatch(obs=st["obs"], actions=st["actions"],
                         log_probs=st["log_probs"], values=st["values"],
                         advantages=advantages, returns=returns,
                         means=st["means"], log_stds=st["log_stds"])
    total_resets = torch.clamp(torch.stack(n_resets).sum(), min=1)
    metrics = {
        "mean_reward": st["rewards"].mean(),
        # envs emit per-step sums over reset envs: divide the total by the
        # number of resets in the window
        "mean_episode_info": {
            k: torch.stack([e[k] for e in ep_infos]).sum() / total_resets
            for k in (ep_infos[0] if ep_infos else {})},
    }
    return env_state, batch, metrics
