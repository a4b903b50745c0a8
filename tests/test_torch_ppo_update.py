"""The port's PPO update against the JAX package's ``ppo_update``.

The same numpy batch (T=6 steps x B=16 envs of the hopper's 38-dim
observations) and the JAX network's parameters, Adam moments, step count
and learning rate go to both (``interop.train_state_from_numpy``); the
port is fed JAX's minibatch permutations (``indices``). The JAX train
state has taken one update of its own first, so the Adam moments and the
bias corrections are not at their initial values. After 1 or 2 epochs x 4
minibatches: parameters and Adam moments within atol 1e-5 (rtol 1e-4),
the step count and the learning rate exactly (both take the same
adaptive-KL branch at every step: the rate grows at every step in one
case and shrinks in another), the metrics within rtol 1e-4.

Also: the global-norm clip (no epsilon; gradients below the norm pass
bit for bit) against optax, and the advantage normalization (ddof 0).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.rl import networks as jnet
from legged_gym_dev_tpu.rl import ppo as jppo
from legged_gym_dev_tpu_torch.interop import (
    state_dict_from_flax,
    train_state_from_numpy,
)
from legged_gym_dev_tpu_torch.rl.ppo import (
    Adam,
    PPOConfig,
    RolloutBatch,
    normalized,
    ppo_update,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

T, B, O, A = 6, 16, 38, 4
HIDDEN = (128, 64, 32)


def jax_batch(model, params, seed):
    """A numpy-drawn rollout batch; means, log-stds, values and log-probs
    from the JAX policy, so the first minibatch's KL is near 0."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, O)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        mean, log_std, value = model.apply(params, jnp.asarray(obs))
    actions = np.asarray(mean) + rng.normal(0, 1.0, (T, B, A)).astype(
        np.float32)
    log_probs = jnet.gaussian_log_prob(jnp.asarray(actions), mean, log_std)
    return jppo.RolloutBatch(
        obs=jnp.asarray(obs), actions=jnp.asarray(actions),
        log_probs=log_probs, values=value,
        advantages=jnp.asarray(rng.normal(0, 2.0, (T, B)), jnp.float32),
        returns=value + jnp.asarray(rng.normal(0, 1.0, (T, B)),
                                    jnp.float32),
        means=mean, log_stds=jnp.broadcast_to(log_std, (T, A)))


def jax_perms(key, cfg, n):
    """The permutations ``ppo_update`` draws from ``key``: (E, M, size)."""
    size = n // cfg.num_mini_batches
    out = []
    for _ in range(cfg.num_learning_epochs):
        key, sub = jax.random.split(key)
        perm = jax.random.permutation(sub, n)
        out.append(np.asarray(perm[:size * cfg.num_mini_batches]).reshape(
            cfg.num_mini_batches, size))
    return np.stack(out)


def adam_parts(opt_state):
    inner = opt_state[1]
    adam = inner.inner_state[0]
    return adam.mu, adam.nu, adam.count


def to_torch_batch(jb):
    return RolloutBatch(*(torch.as_tensor(np.array(x)) for x in jb))


@pytest.mark.parametrize("epochs,desired_kl", [(1, 0.01), (2, 0.01),
                                               (1, 1.0), (1, 1e-7)])
def test_ppo_update_matches_jax(epochs, desired_kl):
    cfg_j = jppo.PPOConfig(num_learning_epochs=epochs, desired_kl=desired_kl)
    cfg_t = PPOConfig(num_learning_epochs=epochs, desired_kl=desired_kl)
    model = jnet.ActorCritic(num_actions=A, actor_hidden_dims=HIDDEN,
                             critic_hidden_dims=HIDDEN)
    ts = jppo.init_train_state(model, O, cfg_j, jax.random.PRNGKey(0))
    update = jax.jit(lambda ts, b: jppo.ppo_update(model, ts, b, cfg_j))
    with jax.default_matmul_precision("highest"):
        ts, _ = update(ts, jax_batch(model, ts.params, 1))   # warm moments
        jb = jax_batch(model, ts.params, 2)
        idx = jax_perms(ts.key, cfg_j, T * B)
        mu, nu, count = adam_parts(ts.opt_state)
        tmodel, tts = train_state_from_numpy(
            jax.tree.map(np.asarray, ts.params), jax.tree.map(np.asarray, mu),
            jax.tree.map(np.asarray, nu), np.asarray(count),
            np.asarray(ts.lr), torch.Generator().manual_seed(0),
            device="cpu")
        ts2, jm = update(ts, jb)
    tts2, tm = ppo_update(tmodel, tts, to_torch_batch(jb), cfg_t,
                          indices=idx)

    assert float(tm["lr"]) == float(jm["lr"])
    assert float(tts2.lr) == float(ts2.lr)
    lr0 = float(ts.lr)
    steps = epochs * cfg_t.num_mini_batches
    if desired_kl == 1.0:      # KL far below the target: grow every step
        np.testing.assert_allclose(float(tm["lr"]),
                                   min(lr0 * 1.5 ** steps, cfg_t.max_lr),
                                   rtol=1e-5)
    elif desired_kl < 1e-3:    # KL above it after the first step: shrink
        assert float(tm["lr"]) < lr0
    mu2, nu2, count2 = adam_parts(ts2.opt_state)
    assert int(tts2.opt_state.count) == int(count2) == int(count) + steps
    names = [n for n, _ in tmodel.named_parameters()]
    for want_tree, got in ((ts2.params, tts2.params),
                           (mu2, tts2.opt_state.mu),
                           (nu2, tts2.opt_state.nu)):
        want_sd = state_dict_from_flax(jax.tree.map(np.asarray, want_tree))
        for n, g in zip(names, got):
            np.testing.assert_allclose(g.detach().numpy(), want_sd[n],
                                       rtol=1e-4, atol=1e-5, err_msg=n)
    for k in ("loss", "policy_loss", "value_loss", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_clip_matches_optax(scale):
    """optax's clip: g if |g| < max_norm else g / |g| * max_norm, with no
    epsilon; below the norm the gradients pass unchanged."""
    rng = np.random.default_rng(3)
    grads = [(scale * rng.normal(size=s)).astype(np.float32)
             for s in ((32, 38), (32,), (4,))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = Adam(max_grad_norm=1.0).clip([torch.as_tensor(g) for g in grads])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads))
    for g, w, raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if norm < 1.0:
            np.testing.assert_array_equal(g.numpy(), raw)
        else:
            np.testing.assert_allclose(g.numpy(), raw / norm, rtol=1e-6)


def test_advantages_are_normalized_with_ddof_0():
    adv = np.random.default_rng(4).normal(0, 3.0, (T, B)).astype(np.float32)
    got = normalized(torch.as_tensor(adv)).numpy()
    np.testing.assert_allclose(got, (adv - adv.mean())
                               / (adv.std(ddof=0) + 1e-8), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(got, (adv - adv.mean()) / adv.std(ddof=1),
                           rtol=1e-4)
