"""PPO: configuration, GAE, the rollout, the update and the learn
iteration.

Counterpart of ``legged_gym_dev_tpu/rl/ppo.py``: clipped-surrogate PPO with
GAE(lambda), adaptive-KL learning rate, value clipping, an entropy bonus
and time-limit bootstrapping.

Where the JAX package scans under ``jit``, the port loops in Python over
env steps, epochs and minibatches; nothing in the loop waits for the
device (no ``.item()``: the adaptive-KL schedule is ``torch.where`` on a
0-d ``lr`` tensor, and the minibatch permutations come from the
``torch.Generator`` on the device). The optimizer is optax's
``chain(clip_by_global_norm, adam)`` written out as tensor ops in optax's
order (``Adam``). The model's parameters are updated in place. Policy
products run in full fp32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch

from ..trajgen.samplers import f32
from ..utils.runtime import fp32_matmul
from .networks import (
    gaussian_entropy,
    gaussian_kl,
    gaussian_log_prob,
    gaussian_sample,
)


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

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)


class AdamState(NamedTuple):
    count: torch.Tensor          # () int32
    mu: List[torch.Tensor]       # first moments, one per parameter
    nu: List[torch.Tensor]       # second moments


class TrainState(NamedTuple):
    params: List[torch.Tensor]   # the model's parameters (updated in place)
    opt_state: AdamState
    lr: torch.Tensor             # () float32, adapted per minibatch
    gen: torch.Generator         # actions and minibatch permutations


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``:

        g      <- g if |g| < max_norm else g / |g| * max_norm   (no epsilon)
        mu     <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
        count  <- count + 1
        p      <- p + (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count))
                       + eps) * (-lr)

    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
    ``torch.optim.Adam`` orders the bias corrections otherwise.) optax's
    ``inject_hyperparams`` holds b1, b2 and eps as float32, so they are
    held at their float32 values here."""

    max_grad_norm: float
    b1: float = f32(0.9)
    b2: float = f32(0.999)
    eps: float = f32(1e-8)

    def init(self, params) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=params[0].device),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params])

    def clip(self, grads):
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.max_grad_norm
        # where(keep, g, g / norm * max_norm), with g / 1 * 1 = g exactly
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        return torch._foreach_mul(grads, torch.where(
            keep, 1.0, torch.full_like(norm, self.max_grad_norm)))

    @torch.no_grad()
    def update_(self, params, grads, state: AdamState,
                lr: torch.Tensor) -> AdamState:
        """One step on ``params`` in place; returns the new state."""
        grads = self.clip(grads)
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                torch._foreach_mul(state.mu, self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1 - self.b2),
            torch._foreach_mul(state.nu, self.b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - self.b1 ** count)
        nu_hat = torch._foreach_div(nu, 1 - self.b2 ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        step = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
        torch._foreach_add_(params, step)
        return AdamState(count=count, mu=mu, nu=nu)


def make_optimizer(cfg: PPOConfig) -> Adam:
    return Adam(max_grad_norm=cfg.max_grad_norm)


def init_train_state(model, cfg: PPOConfig,
                     generator: torch.Generator) -> TrainState:
    """Adam state for ``model``'s parameters, ``lr`` at
    ``cfg.learning_rate``; ``generator`` draws actions and
    permutations."""
    params = list(model.parameters())
    return TrainState(params=params,
                      opt_state=make_optimizer(cfg).init(params),
                      lr=torch.tensor(cfg.learning_rate,
                                      dtype=torch.float32,
                                      device=params[0].device),
                      gen=generator)


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


KEYS = ("obs", "actions", "log_probs", "values", "rewards", "dones",
        "means", "log_stds")


@torch.no_grad()
def collect_steps(step, models, states, obs, cfg: PPOConfig, generators,
                  carries=None):
    """``cfg.num_steps`` transitions of k shards, each with its policy
    replica ``models[i]`` and generator: ``step(states, actions) ->
    (states, transitions)`` steps all shards (k = 1: one env). With
    ``carries`` (one LSTM carry per shard) the policy is recurrent and its
    carry is masked where an episode ends.

    Returns ``(states, carries, st, last_value, ep_infos, n_resets)``: ``st``
    the (T, B, ...) stacks of ``KEYS`` with the shards concatenated along
    the env axis on the first shard's device (``log_stds`` (T, A) is
    shard 0's: the replicas are equal), the per-step episode sums and
    reset counts summed over the shards."""
    k = len(models)
    out = [{key: [] for key in KEYS} for _ in range(k)]
    ep_infos, n_resets = [], []
    carries = None if carries is None else list(carries)
    with fp32_matmul():
        for _ in range(cfg.num_steps):
            acts, vals = [], []
            for i in range(k):
                if carries is None:
                    mean, log_std, value = models[i](obs[i])
                else:
                    mean, log_std, value, carries[i] = models[i](
                        obs[i], carries[i])
                action, log_prob = gaussian_sample(generators[i], mean,
                                                   log_std)
                for key, x in zip(("obs", "actions", "log_probs", "values",
                                   "means", "log_stds"),
                                  (obs[i], action, log_prob, value, mean,
                                   log_std)):
                    out[i][key].append(x)
                acts.append(action)
                vals.append(value)
            states, trs = step(states, acts)
            for i, tr in enumerate(trs):
                # time-limit bootstrapping: truncation is not death
                out[i]["rewards"].append(
                    tr.reward + cfg.gamma * vals[i]
                    * tr.info["time_outs"].float())
                out[i]["dones"].append(tr.done)
                if carries is not None:
                    carries[i] = models[i].mask_carry(carries[i], tr.done)
            ep_infos.append({key: _sum([tr.info["episode"][key]
                                        for tr in trs])
                             for key in trs[0].info["episode"]})
            n_resets.append(_sum([tr.info["n_resets"] for tr in trs]))
            obs = [tr.obs for tr in trs]
        last = [models[i](obs[i]) if carries is None
                else models[i](obs[i], carries[i]) for i in range(k)]
    st = {key: _cat([torch.stack(o[key]) for o in out], dim=1)
          for key in KEYS if key != "log_stds"}
    st["log_stds"] = torch.stack(out[0]["log_stds"])
    last_value = _cat([x[2] for x in last], dim=0)
    return states, carries, st, last_value, ep_infos, n_resets


def _sum(xs):
    """Sum of per-shard tensors on the first one's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return total


def _cat(xs, dim):
    """Per-shard tensors concatenated on the first one's device (one shard:
    itself)."""
    if len(xs) == 1:
        return xs[0]
    return torch.cat([x.to(xs[0].device) for x in xs], dim=dim)


def rollout_metrics(st, ep_infos, n_resets):
    """Mean reward over all T x B rewards; the episode sums per reset (the
    envs emit per-step sums over the envs that reset)."""
    total_resets = torch.clamp(torch.stack(n_resets).sum(), min=1)
    return {
        "mean_reward": st["rewards"].mean(),
        "mean_episode_info": {
            k: torch.stack([e[k] for e in ep_infos]).sum() / total_resets
            for k in (ep_infos[0] if ep_infos else {})},
    }


def _batch(st, last_value, cfg: PPOConfig) -> RolloutBatch:
    advantages, returns = compute_gae(st["rewards"], st["values"],
                                      st["dones"], last_value, cfg.gamma,
                                      cfg.lam)
    return RolloutBatch(obs=st["obs"], actions=st["actions"],
                        log_probs=st["log_probs"], values=st["values"],
                        advantages=advantages, returns=returns,
                        means=st["means"], log_stds=st["log_stds"])


def rollout(env, model, env_state, cfg: PPOConfig,
            generator: torch.Generator, obs=None):
    """Collect ``cfg.num_steps`` transitions from the vectorized env.

    ``obs`` defaults to ``env._obs(env_state)``. Returns
    ``(env_state, batch, metrics)``.
    """
    if obs is None:
        obs = env._obs(env_state)

    def step(states, actions):
        state, tr = env.step(states[0], actions[0])
        return [state], [tr]

    states, _, st, last_value, ep_infos, n_resets = collect_steps(
        step, [model], [env_state], [obs], cfg, [generator])
    return (states[0], _batch(st, last_value, cfg),
            rollout_metrics(st, ep_infos, n_resets))


def rollout_sharded(senv, models, states, cfg: PPOConfig, generators):
    """``rollout`` over a device mesh: shard i of ``senv``
    (``envs.base.ShardedEnv``) rolls out with the policy replica
    ``models[i]`` and ``generators[i]``; the batch is gathered onto the
    first device (envs in shard order) and its metrics are over the whole
    batch. Returns ``(states, batch, metrics)``, ``states`` ``Sharded``."""
    obs = [e._obs(s) for e, s in zip(senv.envs, states)]
    states, _, st, last_value, ep_infos, n_resets = collect_steps(
        senv.step, list(models), states, obs, cfg, generators)
    return (states, _batch(st, last_value, cfg),
            rollout_metrics(st, ep_infos, n_resets))


def sync_replicas(models) -> None:
    """Copies the first model's parameters into every other replica."""
    state = models[0].state_dict()
    for m in list(models)[1:]:
        m.load_state_dict(state)


def adaptive_lr(lr: torch.Tensor, kl: torch.Tensor,
                cfg: PPOConfig) -> torch.Tensor:
    """rsl_rl's adaptive-KL schedule, on the device: shrink on overshoot,
    grow when conservative, clip to [min_lr, max_lr]."""
    if cfg.schedule != "adaptive":
        return lr
    lr = torch.where(kl > cfg.desired_kl * 2.0, lr / 1.5, lr)
    lr = torch.where(kl < cfg.desired_kl / 2.0, lr * 1.5, lr)
    return torch.clamp(lr, cfg.min_lr, cfg.max_lr)


def ppo_losses(cfg: PPOConfig, mean, log_std, value, mb, old_log_std):
    """(total, policy loss, value loss, KL) of a minibatch ``mb`` (a dict
    of the rollout's tensors) under the new policy's outputs."""
    log_prob = gaussian_log_prob(mb["actions"], mean, log_std)
    ratio = torch.exp(log_prob - mb["log_probs"])
    adv = mb["advantages"]
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                        1.0 + cfg.clip_param) * adv
    policy_loss = -torch.minimum(surr1, surr2).mean()
    if cfg.use_clipped_value_loss:
        value_clipped = mb["values"] + torch.clamp(
            value - mb["values"], -cfg.clip_param, cfg.clip_param)
        value_loss = torch.maximum(
            (value - mb["returns"]) ** 2,
            (value_clipped - mb["returns"]) ** 2).mean()
    else:
        value_loss = ((value - mb["returns"]) ** 2).mean()
    entropy = gaussian_entropy(log_std).mean()
    kl = gaussian_kl(mb["means"], old_log_std, mean, log_std).mean()
    total = (policy_loss + cfg.value_loss_coef * value_loss
             - cfg.entropy_coef * entropy)
    return total, policy_loss, value_loss, kl.detach()


def normalized(adv: torch.Tensor) -> torch.Tensor:
    """Advantages normalized by their population std (ddof 0, as
    ``jnp.std``)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def run_epochs(cfg: PPOConfig, train_state: TrainState, n: int, minibatch,
               indices=None):
    """``cfg.num_learning_epochs`` x ``cfg.num_mini_batches`` optimizer
    steps over ``n`` samples. Each epoch permutes ``arange(n)`` with the
    train state's generator and drops the remainder (or takes
    ``indices[epoch]``, (minibatches, size), as given);
    ``minibatch(idx) -> (total, policy loss, value loss, KL)``. Returns the
    new train state and the metrics averaged over all steps."""
    M = cfg.num_mini_batches
    size = n // M
    tx = make_optimizer(cfg)
    params, opt, lr = (train_state.params, train_state.opt_state,
                       train_state.lr)
    gen = train_state.gen
    stats = []
    for epoch in range(cfg.num_learning_epochs):
        if indices is None:
            perm = torch.randperm(n, generator=gen, device=lr.device)
            idxs = perm[:size * M].reshape(M, size)
        else:
            idxs = torch.as_tensor(indices[epoch], device=lr.device)
        for m in range(M):
            total, pl, vl, kl = minibatch(idxs[m])
            grads = torch.autograd.grad(total, params)
            # the rate adapted to this minibatch's KL applies to its step
            lr = adaptive_lr(lr, kl, cfg)
            opt = tx.update_(params, list(grads), opt, lr)
            stats.append(torch.stack([total.detach(), pl.detach(),
                                      vl.detach(), kl]))
    loss, pl, vl, kl = torch.stack(stats).mean(0)
    metrics = {"loss": loss, "policy_loss": pl, "value_loss": vl, "kl": kl,
               "lr": lr}
    return train_state._replace(opt_state=opt, lr=lr), metrics


def ppo_update(model, train_state: TrainState, batch: RolloutBatch,
               cfg: PPOConfig, indices=None):
    """Epochs x minibatches of clipped PPO with the adaptive-KL rate over
    the flattened (T * B) samples. ``indices`` (epochs, minibatches,
    size) replaces the generator's permutations (tests feed JAX's).
    Returns ``(train_state, metrics)``; ``model``'s parameters are updated
    in place."""
    T, B = batch.log_probs.shape
    N = T * B
    flat = {k: getattr(batch, k).reshape((N,) + getattr(batch, k).shape[2:])
            for k in ("obs", "actions", "log_probs", "values", "advantages",
                      "returns", "means")}
    flat["advantages"] = normalized(flat["advantages"])

    def minibatch(idx):
        mb = {k: v[idx] for k, v in flat.items()}
        mean, log_std, value = model(mb["obs"])
        # the KL's old log-std: the row of the minibatch's first sample
        old_log_std = batch.log_stds.index_select(0, idx[:1] // B)[0]
        return ppo_losses(cfg, mean, log_std, value, mb, old_log_std)

    with fp32_matmul():
        return run_epochs(cfg, train_state, N, minibatch, indices)


def make_learn_iteration(env, model, cfg: PPOConfig):
    """One rollout -> GAE -> update iteration:
    ``learn_iteration(train_state, env_state) -> (train_state, env_state,
    metrics)``. Its first observation is ``env._obs(env_state)``, as in
    the JAX package (here with a fresh noise draw)."""

    def learn_iteration(train_state: TrainState, env_state):
        env_state, batch, roll_metrics = rollout(env, model, env_state, cfg,
                                                 train_state.gen)
        train_state, up_metrics = ppo_update(model, train_state, batch, cfg)
        return train_state, env_state, {**roll_metrics, **up_metrics}

    return learn_iteration


def make_learn_iteration_sharded(senv, models, cfg: PPOConfig, generators):
    """The learn iteration over a device mesh: each shard rolls out its env
    (``senv``, an ``envs.base.ShardedEnv``) with its policy replica
    (``models``, ``parallel.mesh.replicate`` of the model) and generator;
    the batch is gathered onto the first device, where ``ppo_update``
    updates ``models[0]`` on the whole batch, as the JAX package's
    data-parallel step does with XLA's gradient all-reduce; the new
    parameters are then copied into every replica.
    ``learn_iteration(train_state, env_states) -> (train_state,
    env_states, metrics)``."""

    def learn_iteration(train_state: TrainState, env_states):
        env_states, batch, roll_metrics = rollout_sharded(
            senv, models, env_states, cfg, generators)
        train_state, up_metrics = ppo_update(models[0], train_state, batch,
                                             cfg)
        sync_replicas(models)
        return train_state, env_states, {**roll_metrics, **up_metrics}

    return learn_iteration
