"""Actor-critic policy network and Gaussian helpers.

Counterpart of ``legged_gym_dev_tpu/rl/networks.py``: ``ActorCritic``, MLP
actor and critic (512-256-128 ELU by default) with a state-independent
learnable log-std Gaussian head, and ``ActorCriticRecurrent``, one shared
LSTM cell feeding both MLPs. Layers are ``torch.nn.Linear``; flax's
``Dense`` kernel (in, out) is its weight transposed
(``interop.actor_critic_from_numpy``). Initialization follows flax's
defaults: LeCun-normal (truncated) weights, orthogonal recurrent kernels,
zero biases, drawn from an explicit (CPU) ``torch.Generator``.
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
        self.num_obs, self.num_actions = num_obs, num_actions
        self.actor_hidden_dims = tuple(actor_hidden_dims)
        self.critic_hidden_dims = tuple(critic_hidden_dims)
        self.activation, self.init_noise_std = activation, init_noise_std
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


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: gates i, f, g, o from input kernels
    without bias and hidden kernels with bias,

        y = h @ W_h + b_h + x @ W_i      (columns [i | f | g | o])
        c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
        h' = sigmoid(o) * tanh(c')

    with the carry ``(c, h)``. ``weight_ih`` (4H, in) and ``weight_hh``
    (4H, H) stack the gates' kernels, transposed, in that order, and
    ``bias_hh`` (4H,) their biases (``interop`` maps flax's
    ``ii``/``if``/``ig``/``io`` and ``hi``/``hf``/``hg``/``ho``)."""

    def __init__(self, num_in: int, hidden: int, generator=None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, num_in))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        with torch.no_grad():
            for k in range(4):
                rows = slice(k * hidden, (k + 1) * hidden)
                _lecun_normal_(self.weight_ih[rows], generator)
                self.weight_hh[rows].copy_(nn.init.orthogonal_(
                    torch.empty(hidden, hidden), generator=generator))

    def forward(self, carry, x):
        c, h = carry
        y = h @ self.weight_hh.t() + self.bias_hh + x @ self.weight_ih.t()
        i, f, g, o = y.split(self.hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class ActorCriticRecurrent(nn.Module):
    """LSTM actor-critic (rsl_rl ``ActorCriticRecurrent`` parity): one LSTM
    over the observation stream feeds the actor and critic MLPs. The carry
    is explicit, threaded by the rollout, and zeroed where an episode ends
    (``mask_carry``)."""

    def __init__(self, num_obs: int, num_actions: int,
                 rnn_hidden_size: int = 256,
                 actor_hidden_dims: Sequence[int] = (256, 128),
                 critic_hidden_dims: Sequence[int] = (256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_obs, self.num_actions = num_obs, num_actions
        self.rnn_hidden_size = rnn_hidden_size
        self.actor_hidden_dims = tuple(actor_hidden_dims)
        self.critic_hidden_dims = tuple(critic_hidden_dims)
        self.activation, self.init_noise_std = activation, init_noise_std
        self.lstm = LSTMCell(num_obs, rnn_hidden_size, generator)
        self.actor = mlp(rnn_hidden_size, actor_hidden_dims, num_actions,
                         activation, generator)
        self.critic = mlp(rnn_hidden_size, critic_hidden_dims, 1,
                          activation, generator)
        self.log_std = nn.Parameter(
            torch.full((num_actions,), math.log(init_noise_std)))

    def forward(self, obs: torch.Tensor, carry):
        """obs (B, O), carry ((B, H), (B, H)) -> mean (B, A), log_std (A,),
        value (B,), carry."""
        carry, hidden = self.lstm(carry, obs)
        return (self.actor(hidden), self.log_std,
                self.critic(hidden)[..., 0], carry)

    def initial_carry(self, batch: int):
        h = torch.zeros((batch, self.rnn_hidden_size),
                        device=self.log_std.device)
        return (h, h)

    @staticmethod
    def mask_carry(carry, done):
        """Zero the (c, h) state of envs whose episode just ended."""
        keep = (1.0 - done.float())[:, None]
        return tuple(x * keep for x in carry)
