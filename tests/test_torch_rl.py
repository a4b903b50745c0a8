"""The port's policy network, Gaussian helpers, GAE and rollout against the
JAX package.

- ``ActorCritic`` with the JAX network's flax parameters carried over
  (``interop.actor_critic_from_numpy``): mean, log-std and value within
  1e-5 (float32 products of 512-wide layers; TF32 off).
- ``compute_gae`` on numpy rewards, values and dones: 1e-6.
- Gaussian log-prob / entropy / KL: 1e-5; a sample with the same noise.
- ``rollout``: shapes, finiteness and the bootstrapped reward on a small
  quadruped env (random draws differ from JAX's, so no value parity).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.rl import networks as jnet
from legged_gym_dev_tpu.rl.ppo import compute_gae as jax_gae
from legged_gym_dev_tpu_torch.envs.presets import (
    _anymal_c_kwargs,
    make_trajectory_env,
)
from legged_gym_dev_tpu_torch.interop import actor_critic_from_numpy
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
from legged_gym_dev_tpu_torch.rl import (
    ActorCritic,
    PPOConfig,
    compute_gae,
    rollout,
)
from legged_gym_dev_tpu_torch.rl import networks as tnet
from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul
from tests.torch_robot_cases import QUADRUPED_URDF
from tests.torch_port_cases import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("hidden", [(512, 256, 128), (64, 32)])
def test_actor_critic_with_carried_weights_matches_jax(hidden):
    model = jnet.ActorCritic(num_actions=12, actor_hidden_dims=hidden,
                             critic_hidden_dims=hidden, init_noise_std=0.7)
    obs = np.random.default_rng(0).normal(size=(32, 65)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65)))
    with jax.default_matmul_precision("highest"):
        mean_j, log_std_j, value_j = model.apply(params, jnp.asarray(obs))
    tm = actor_critic_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu")
    with torch.no_grad(), fp32_matmul():
        mean_t, log_std_t, value_t = tm(torch.as_tensor(obs))
    for a, b in ((mean_t, mean_j), (log_std_t, log_std_j),
                 (value_t, value_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_actor_critic_init_matches_flax_statistics():
    """LeCun-normal weights (std 1/sqrt(fan_in)), zero biases, log-std at
    log(init_noise_std), from an explicit generator (same seed, same
    weights)."""
    a = ActorCritic(65, 12, generator=torch.Generator().manual_seed(0))
    b = ActorCritic(65, 12, generator=torch.Generator().manual_seed(0))
    w = a.actor[0].weight.detach()
    assert w.shape == (512, 65)
    assert abs(float(w.std()) * np.sqrt(65) - 1.0) < 0.05
    assert float(a.actor[0].bias.detach().abs().max()) == 0.0
    torch.testing.assert_close(a.critic[-1].weight, b.critic[-1].weight)
    torch.testing.assert_close(a.log_std.detach(), torch.zeros(12))


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(1)
    T, B = 24, 16
    r = rng.normal(size=(T, B)).astype(np.float32)
    v = rng.normal(size=(T, B)).astype(np.float32)
    d = rng.uniform(size=(T, B)) < 0.1
    last = rng.normal(size=B).astype(np.float32)
    adv_j, ret_j = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                           jnp.asarray(last), 0.99, 0.95)
    adv_t, ret_t = compute_gae(torch.as_tensor(r), torch.as_tensor(v),
                               torch.as_tensor(d), torch.as_tensor(last),
                               0.99, 0.95)
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), atol=1e-6)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), atol=1e-6)


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(2)
    ma, mb, act = (rng.normal(size=(8, 12)).astype(np.float32)
                   for _ in range(3))
    la, lb = (rng.normal(0, 0.3, 12).astype(np.float32) for _ in range(2))
    T = torch.as_tensor
    J = jnp.asarray
    pairs = [
        (tnet.gaussian_log_prob(T(act), T(ma), T(la)),
         jnet.gaussian_log_prob(J(act), J(ma), J(la))),
        (tnet.gaussian_entropy(T(la)), jnet.gaussian_entropy(J(la))),
        (tnet.gaussian_kl(T(ma), T(la), T(mb), T(lb)),
         jnet.gaussian_kl(J(ma), J(la), J(mb), J(lb))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # a sample is mean + std * N(0, 1) noise, its log-prob as above
    gen = torch.Generator().manual_seed(3)
    action, logp = tnet.gaussian_sample(gen, T(ma), T(la))
    eps = torch.randn(ma.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(action, T(ma) + torch.exp(T(la)) * eps)
    torch.testing.assert_close(logp, tnet.gaussian_log_prob(action, T(ma),
                                                            T(la)))


def test_rollout_on_the_quadruped_task():
    B, cfg = 4, PPOConfig(num_steps=3)
    env = make_trajectory_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                              max_contact_force=350.0, num_envs=B,
                              device="cpu")
    model = ActorCritic(env.num_obs, env.num_actions,
                        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset(gen)
    sk.reset_launches()
    state, batch, metrics = rollout(env, model, state, cfg, gen, obs=obs)
    # the CPU takes the plain path
    assert sk.launches() == {"substep": 0, "substep_sharded": 0}
    assert batch.obs.shape == (3, B, 65) and batch.actions.shape == (3, B, 12)
    assert batch.log_stds.shape == (3, 12)
    torch.testing.assert_close(batch.obs[0], obs)
    for name in batch._fields:
        assert bool(torch.isfinite(getattr(batch, name)).all()), name
    assert bool(torch.isfinite(metrics["mean_reward"]))
    assert set(metrics["mean_episode_info"]) == {
        "rew_" + n for n, _ in env.reward_scales}
    torch.testing.assert_close(batch.returns,
                               batch.advantages + batch.values)
