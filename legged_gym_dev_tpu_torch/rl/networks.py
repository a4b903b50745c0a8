"""Actor-critic policy network and Gaussian helpers.

Counterpart of ``legged_gym_dev_tpu/rl/networks.py`` (``ActorCritic``; the
recurrent variant is not ported yet): MLP actor and critic (512-256-128
ELU by default) with a state-independent learnable log-std Gaussian head.
Layers are ``torch.nn.Linear``; flax's ``Dense`` kernel (in, out) is its
weight transposed (``interop.actor_critic_from_numpy``). Initialization
follows flax's defaults: LeCun-normal (truncated) weights, zero biases,
drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

_ACT = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh, "selu": nn.SELU}


def _lecun_normal_(w: torch.Tensor, gen) -> None:
    """flax's lecun_normal: truncated normal (+-2 std) of variance
    1/fan_in, its std corrected for the truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(
            torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0, generator=gen) * std)


def mlp(n_in: int, hidden_dims: Sequence[int], out_dim: int,
        activation: str, gen=None) -> nn.Sequential:
    layers, d = [], n_in
    for h in list(hidden_dims):
        layers += [nn.Linear(d, h), _ACT[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    for layer in layers:
        if isinstance(layer, nn.Linear):
            _lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Gaussian MLP actor + value critic (rsl_rl ActorCritic parity)."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (512, 256, 128),
                 critic_hidden_dims: Sequence[int] = (512, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_actions = num_actions
        self.actor = mlp(num_obs, actor_hidden_dims, num_actions, activation,
                         generator)
        self.critic = mlp(num_obs, critic_hidden_dims, 1, activation,
                          generator)
        self.log_std = nn.Parameter(
            torch.full((num_actions,), math.log(init_noise_std)))

    def forward(self, obs: torch.Tensor):
        """obs (B, O) -> mean (B, A), log_std (A,), value (B,)."""
        return self.actor(obs), self.log_std, self.critic(obs)[..., 0]


def gaussian_log_prob(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)


def gaussian_sample(gen: torch.Generator, mean, log_std):
    std = torch.exp(log_std)
    eps = torch.randn(mean.shape, generator=gen, device=mean.device)
    action = mean + std * eps
    return action, gaussian_log_prob(action, mean, log_std)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e),
                     dim=-1)


def gaussian_kl(mean_a, log_std_a, mean_b, log_std_b):
    """KL(a || b) for diagonal Gaussians (rsl_rl adaptive-LR form)."""
    var_a, var_b = torch.exp(2 * log_std_a), torch.exp(2 * log_std_b)
    return torch.sum(log_std_b - log_std_a
                     + (var_a + (mean_a - mean_b) ** 2) / (2.0 * var_b)
                     - 0.5, dim=-1)
