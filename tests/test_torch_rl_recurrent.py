"""The port's LSTM actor-critic and recurrent PPO against the JAX
package's.

- ``ActorCriticRecurrent`` with the flax parameters carried over
  (``interop.actor_critic_from_numpy``: flax's per-gate
  ``OptimizedLSTMCell`` kernels stacked in gate order i, f, g, o): one step
  from a random carry, and a 24-step replay with the carry masked where
  episodes end, within atol 1e-5 (outputs and carry).
- ``mask_carry`` zeroes exactly the done envs' (c, h).
- ``ppo_update_recurrent`` on a numpy batch (T=8 x B=16, window-start
  carry, done flags) with JAX's env permutations: parameters and Adam
  moments within atol 1e-5 (rtol 1e-4), learning rate exactly, metrics
  within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.rl import networks as jnet
from legged_gym_dev_tpu.rl import ppo as jppo
from legged_gym_dev_tpu.rl import ppo_recurrent as jrec
from legged_gym_dev_tpu_torch.interop import (
    actor_critic_from_numpy,
    state_dict_from_flax,
    train_state_from_numpy,
)
from legged_gym_dev_tpu_torch.rl.networks import ActorCriticRecurrent
from legged_gym_dev_tpu_torch.rl.ppo import PPOConfig
from legged_gym_dev_tpu_torch.rl.ppo_recurrent import ppo_update_recurrent
from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul
from tests.torch_port_cases import one_torch_thread  # noqa: F401

O, A, H = 38, 4, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def jax_model():
    return jnet.ActorCriticRecurrent(num_actions=A, rnn_hidden_size=H,
                                     actor_hidden_dims=(32, 16),
                                     critic_hidden_dims=(32, 16))


def init(model, seed=0):
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, O)),
                      model.initial_carry(1))


def test_lstm_step_and_replay_match_jax():
    model = jax_model()
    params = init(model)
    tm = actor_critic_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")
    assert isinstance(tm, ActorCriticRecurrent)
    rng = np.random.default_rng(0)
    Bn, T = 8, 24
    obs = rng.normal(size=(T, Bn, O)).astype(np.float32)
    dones = rng.uniform(size=(T, Bn)) < 0.1
    carry = tuple(rng.normal(0, 0.5, (Bn, H)).astype(np.float32)
                  for _ in range(2))

    def jstep(c, inp):
        o, d = inp
        mean, log_std, value, c = model.apply(params, o, c)
        return jnet.ActorCriticRecurrent.mask_carry(c, d), (mean, value, c)

    with jax.default_matmul_precision("highest"):
        jc, (jmean, jvalue, jcarries) = jax.lax.scan(
            jstep, tuple(jnp.asarray(c) for c in carry),
            (jnp.asarray(obs), jnp.asarray(dones)))
    c = tuple(torch.as_tensor(x) for x in carry)
    with torch.no_grad(), fp32_matmul():
        for t in range(T):
            mean, log_std, value, c_new = tm(torch.as_tensor(obs[t]), c)
            # one step: outputs and the new carry (c, h)
            np.testing.assert_allclose(mean.numpy(), np.asarray(jmean[t]),
                                       err_msg=f"mean {t}", **TOL)
            np.testing.assert_allclose(value.numpy(), np.asarray(jvalue[t]),
                                       err_msg=f"value {t}", **TOL)
            for a, b in zip(c_new, jcarries):
                np.testing.assert_allclose(a.numpy(), np.asarray(b[t]),
                                           err_msg=f"carry {t}", **TOL)
            c = ActorCriticRecurrent.mask_carry(
                c_new, torch.as_tensor(dones[t]))
    for a, b in zip(c, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(log_std.detach().numpy(),
                               np.asarray(params["params"]["log_std"]))


def test_mask_carry_and_initial_carry():
    m = ActorCriticRecurrent(O, A, rnn_hidden_size=H,
                             generator=torch.Generator().manual_seed(0))
    c0 = m.initial_carry(5)
    assert all(x.shape == (5, H) and not x.any() for x in c0)
    carry = (torch.ones(5, H), 2 * torch.ones(5, H))
    done = torch.tensor([True, False, False, True, False])
    out = ActorCriticRecurrent.mask_carry(carry, done)
    for x, v in zip(out, (1.0, 2.0)):
        assert not x[done].any() and bool((x[~done] == v).all())
    # orthogonal recurrent kernels per gate, zero biases
    w = m.lstm.weight_hh.detach()[:H]
    torch.testing.assert_close(w @ w.t(), torch.eye(H), atol=1e-5, rtol=0)
    assert not m.lstm.bias_hh.detach().any()


def jax_perms(key, cfg, n):
    size = n // cfg.num_mini_batches
    out = []
    for _ in range(cfg.num_learning_epochs):
        key, sub = jax.random.split(key)
        perm = jax.random.permutation(sub, n)
        out.append(np.asarray(perm[:size * cfg.num_mini_batches]).reshape(
            cfg.num_mini_batches, size))
    return np.stack(out)


@pytest.mark.parametrize("epochs", [1, 2])
def test_ppo_update_recurrent_matches_jax(epochs):
    T, Bn = 8, 16
    cfg_j = jppo.PPOConfig(num_learning_epochs=epochs)
    cfg_t = PPOConfig(num_learning_epochs=epochs)
    model = jax_model()
    ts = jrec.init_train_state_recurrent(model, O, cfg_j,
                                         jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(T, Bn, O)).astype(np.float32)
    dones = rng.uniform(size=(T, Bn)) < 0.15
    carry0 = tuple(rng.normal(0, 0.3, (Bn, H)).astype(np.float32)
                   for _ in range(2))

    def jstep(c, inp):
        o, d = inp
        mean, log_std, value, c = model.apply(ts.params, o, c)
        return (jnet.ActorCriticRecurrent.mask_carry(c, d),
                (mean, log_std, value))

    with jax.default_matmul_precision("highest"):
        _, (means, log_stds, values) = jax.lax.scan(
            jstep, tuple(jnp.asarray(c) for c in carry0),
            (jnp.asarray(obs), jnp.asarray(dones)))
        actions = np.asarray(means) + rng.normal(size=(T, Bn, A)).astype(
            np.float32)
        batch = {
            "obs": jnp.asarray(obs), "actions": jnp.asarray(actions),
            "log_probs": jnet.gaussian_log_prob(jnp.asarray(actions), means,
                                                log_stds[:, None, :]),
            "values": values,
            "advantages": jnp.asarray(rng.normal(0, 2.0, (T, Bn)),
                                      jnp.float32),
            "returns": values + jnp.asarray(rng.normal(size=(T, Bn)),
                                            jnp.float32),
            "means": means, "log_stds": log_stds,
            "dones": jnp.asarray(dones),
            "carry0": tuple(jnp.asarray(c) for c in carry0)}
        idx = jax_perms(ts.key, cfg_j, Bn)
        adam = ts.opt_state[1].inner_state[0]
        tmodel, tts = train_state_from_numpy(
            jax.tree.map(np.asarray, ts.params),
            jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), np.asarray(adam.count),
            np.asarray(ts.lr), device="cpu")
        ts2, jm = jax.jit(lambda ts, b: jrec.ppo_update_recurrent(
            model, ts, b, cfg_j))(ts, batch)
    tbatch = {k: (tuple(torch.as_tensor(np.array(x)) for x in v)
                  if k == "carry0" else torch.as_tensor(np.array(v)))
              for k, v in batch.items()}
    tts2, tm = ppo_update_recurrent(tmodel, tts, tbatch, cfg_t, indices=idx)

    assert float(tm["lr"]) == float(jm["lr"]) == float(tts2.lr)
    adam2 = ts2.opt_state[1].inner_state[0]
    names = [n for n, _ in tmodel.named_parameters()]
    for want_tree, got in ((ts2.params, tts2.params),
                           (adam2.mu, tts2.opt_state.mu),
                           (adam2.nu, tts2.opt_state.nu)):
        want = state_dict_from_flax(jax.tree.map(np.asarray, want_tree))
        for n, g in zip(names, got):
            np.testing.assert_allclose(g.detach().numpy(), want[n],
                                       rtol=1e-4, atol=1e-5, err_msg=n)
    for k in ("loss", "policy_loss", "value_loss", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
