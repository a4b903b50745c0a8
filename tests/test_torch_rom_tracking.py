"""The port's ROM-tracking slice against the JAX package: the maths
helpers, ``RomSim``, ``RomTrackingEnv``, ``DoubleSingleTracking`` and the
``rom_tracking`` preset, both built by their ``make_rom_tracking_env`` at
B=16.

The sim and env steps start from a carried-over JAX state (the JAX env
reset and stepped with its own random draws; its state goes to the port as
numpy through ``interop.rom_tracking_env_state_from_numpy``) and take the
same actions. Envs whose trajectory-generator mode expires in the step, or
that reset (new random draws the two RNGs cannot match), are left out of
the values those draws reach; the masked reset's other envs and its
deterministic parts (the clocks) are compared. Tolerance: 1e-6 relative
(atol 1e-6) on the helpers, states, observations and rewards. Reset draws
are held to their bounds and to the no-offset probability as statistics:
the random streams are not matched by seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.controllers import (
    DoubleSingleTracking as JaxDoubleSingleTracking,
)
from legged_gym_dev_tpu.core import maths as jm
from legged_gym_dev_tpu.envs import presets as jax_presets
from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
from legged_gym_dev_tpu_torch.core import maths as tm
from legged_gym_dev_tpu_torch.envs import presets, registry
from legged_gym_dev_tpu_torch.interop import (
    rom_sim_state_from_numpy,
    rom_tracking_env_state_from_numpy,
)
from legged_gym_dev_tpu_torch.rl.ppo import PPOConfig
from tests.torch_port_cases import one_torch_thread  # noqa: F401

B = 16
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **{**TOL, **kw})


# ---------------------------------------------------------------------------
# maths helpers
# ---------------------------------------------------------------------------

def test_maths_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ang = rng.uniform(-20, 20, 64).astype(np.float32)
    rpy = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    T = torch.as_tensor
    _close(tm.wrap_angles(T(ang)), jm.wrap_angles(jnp.asarray(ang)))
    _close(tm.quat_to_euler_xyz(T(q)), jm.quat_to_euler_xyz(jnp.asarray(q)))
    _close(tm.euler_xyz_to_quat(T(rpy)),
           jm.euler_xyz_to_quat(jnp.asarray(rpy)))
    _close(tm.quat_apply_yaw(T(q), T(v)),
           jm.quat_apply_yaw(jnp.asarray(q), jnp.asarray(v)))
    _close(tm.yaw2rot(T(ang)), jm.yaw2rot(jnp.asarray(ang)))
    assert tuple(tm.yaw2rot(T(ang)).shape) == (64, 2, 2)
    # the euler round trip
    _close(tm.euler_xyz_to_quat(tm.quat_to_euler_xyz(T(q))).abs(),
           np.abs(q), atol=1e-5)


# ---------------------------------------------------------------------------
# preset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    jenv = jax_presets.make_rom_tracking_env(num_envs=B)
    tenv = presets.make_rom_tracking_env(num_envs=B, device="cpu")
    return jenv, tenv, jax.jit(jenv.step)


def test_preset_defaults_match_jax(envs):
    """Every number of the two presets, and the factories' defaults."""
    jenv, tenv, _ = envs
    js, ts = jenv.sim, tenv.sim
    for rom_j, rom_t in ((js.rom, ts.rom), (js.model, ts.model)):
        assert type(rom_t).__name__ == type(rom_j).__name__
        assert rom_t.dt == float(rom_j.dt)
        for f in ("z_min", "z_max", "v_min", "v_max"):
            np.testing.assert_array_equal(getattr(rom_t, f).numpy(),
                                          np.asarray(getattr(rom_j, f)))
    for f in ("init_noise_lower", "init_noise_upper", "max_rom_distance"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.zero_rom_dist_llh == float(js.zero_rom_dist_llh)
    assert ts.randomize_rom_distance == js.randomize_rom_distance
    tg_j, tg_t = js.traj_gen, ts.traj_gen
    assert (tg_t.N, tg_t.dN) == (tg_j.N, tg_j.dN)
    for f in ("dt_loop", "freq_low", "freq_high", "prob_stationary"):
        assert getattr(tg_t, f) == float(getattr(tg_j, f)), f
    assert (tg_t.t_sampler.t_low, tg_t.t_sampler.t_high) == (
        float(tg_j.t_sampler.t_low), float(tg_j.t_sampler.t_high))
    np.testing.assert_array_equal(
        np.asarray(tg_t.weight_sampler.mask, np.float32),
        np.asarray(tg_j.weight_sampler.mask, np.float32))
    np.testing.assert_array_equal(tenv.reward_weighting.numpy(),
                                  np.asarray(jenv.reward_weighting))
    assert tenv.tracking_sigma == float(jenv.tracking_sigma)
    assert tenv.reward_scales == jenv.reward_scales
    assert tenv.episode_length_s == jenv.episode_length_s
    assert tenv.only_positive_rewards == jenv.only_positive_rewards
    assert (tenv.num_obs, tenv.num_actions, tenv.max_episode_length,
            tenv.dt) == (jenv.num_obs, jenv.num_actions,
                         jenv.max_episode_length, jenv.dt)
    # the factories' keyword defaults
    import inspect

    jd = inspect.signature(jax_presets.make_rom_tracking_env).parameters
    td = inspect.signature(presets.make_rom_tracking_env).parameters
    for k, p in jd.items():
        assert td[k].default == p.default, k
    assert registry.get("rom_tracking").train_cfg == PPOConfig()


def test_hopper_default_urdf_names_the_reference_file():
    """Both hopper presets default to the reference project's hopper URDF,
    the same file under the reference checkout; the port's default is the
    path relative to that checkout's root."""
    import inspect

    jax_path = jax_presets.HOPPER_URDF
    assert jax_path.endswith("/" + presets.HOPPER_URDF)
    for name in ("make_hopper_trajectory_env", "make_hopper_velocity_env"):
        t = inspect.signature(getattr(presets, name)).parameters
        j = inspect.signature(getattr(jax_presets, name)).parameters
        assert t["urdf_path"].default == presets.HOPPER_URDF, name
        assert j["urdf_path"].default == jax_path, name


# ---------------------------------------------------------------------------
# carried steps
# ---------------------------------------------------------------------------

def _actions(rng):
    return rng.normal(0, 2.0, (B, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def carried(envs):
    """The JAX env state after a reset and three steps."""
    jenv, _, jstep = envs
    rng = np.random.default_rng(3)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(4))
    for _ in range(3):
        js, _ = jstep(js, jnp.asarray(_actions(rng)))
    return js


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stable(js):
    """Envs whose trajectory mode does not expire in the coming step."""
    tg = js.sim.traj_gen
    return ~np.asarray(tg.t > tg.t_final - 0.06)


def test_sim_step_matches_jax(envs, carried):
    jenv, tenv, _ = envs
    jsim, tsim = jenv.sim, tenv.sim
    a = _actions(np.random.default_rng(5))
    js = carried.sim
    ts = rom_sim_state_from_numpy(_np(js), tsim)
    js2 = jax.jit(jsim.step)(js, jnp.asarray(a))
    ts2 = tsim.step(ts, torch.as_tensor(a))
    keep = _stable(carried)
    assert keep.sum() >= B - 4
    _close(ts2.root_states, js2.root_states)
    for f in ("t", "k", "trajectory", "v_trajectory", "v"):
        _close(getattr(ts2.traj_gen, f).numpy()[keep],
               np.asarray(getattr(js2.traj_gen, f))[keep], err_msg=f)
    _close(ts2.trajectory.numpy()[keep], np.asarray(js2.trajectory)[keep])
    _close(tsim.get_observations(ts2).numpy()[keep],
           np.asarray(jsim.get_observations(js2))[keep])


def test_sim_reset_idx_touches_only_the_mask(envs, carried):
    """A partial reset: the other envs keep their state bit for bit (no
    trailing zero-action step reaches them); the reset envs' clocks
    (t = dt_loop, k = 1 after the trailing step) match JAX's."""
    jenv, tenv, _ = envs
    jsim, tsim = jenv.sim, tenv.sim
    mask = np.zeros(B, bool)
    mask[[1, 4, 9]] = True
    js = carried.sim
    ts = rom_sim_state_from_numpy(_np(js), tsim)
    js2 = jax.jit(jsim.reset_idx)(js, jnp.asarray(mask))
    ts2 = tsim.reset_idx(ts, torch.as_tensor(mask))
    for f in ("root_states", "trajectory"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy()[~mask],
                                      getattr(ts, f).numpy()[~mask])
    for f in ("t", "k", "t_final", "trajectory", "v_trajectory", "v",
              "weights", "stationary"):
        np.testing.assert_array_equal(
            getattr(ts2.traj_gen, f).numpy()[~mask],
            getattr(ts.traj_gen, f).numpy()[~mask], err_msg=f)
        np.testing.assert_array_equal(
            np.asarray(getattr(js2.traj_gen, f))[~mask],
            np.asarray(getattr(js.traj_gen, f))[~mask], err_msg=f)
    for f in ("t", "k"):
        _close(getattr(ts2.traj_gen, f).numpy()[mask],
               np.asarray(getattr(js2.traj_gen, f))[mask])
    _close(ts2.traj_gen.t.numpy()[mask], tsim.traj_gen.dt_loop)
    # the reset envs' new root states, after one zero-action step, inside
    # the init-noise bounds (positions move by at most dt_loop * 0.1)
    lo = tsim.init_noise_lower.numpy() - np.array([0.005, 0.005, 0, 0])
    hi = tsim.init_noise_upper.numpy() + np.array([0.005, 0.005, 0, 0])
    r = ts2.root_states.numpy()[mask]
    assert ((r >= lo - 1e-6) & (r <= hi + 1e-6)).all()


def test_env_step_matches_jax(envs, carried):
    """Env 0 times out on this step (masked reset, its episode sums
    logged); the rest step on."""
    jenv, tenv, jstep = envs
    steps = np.asarray(carried.episode_step).copy()
    steps[0] = jenv.max_episode_length - 1
    js = carried.replace(episode_step=jnp.asarray(steps))
    ts = rom_tracking_env_state_from_numpy(_np(js), tenv)
    a = _actions(np.random.default_rng(6))
    js2, jtr = jstep(js, jnp.asarray(a))
    ts2, ttr = tenv.step(ts, torch.as_tensor(a))

    done = np.asarray(jtr.done)
    np.testing.assert_array_equal(ttr.done.numpy(), done)
    assert done[0] and done.sum() == 1
    np.testing.assert_array_equal(ttr.info["time_outs"].numpy(),
                                  np.asarray(jtr.info["time_outs"]))
    assert int(ttr.info["n_resets"]) == int(jtr.info["n_resets"]) == 1
    keep = _stable(js)
    # rewards are computed before the reset: every env whose mode holds
    _close(ttr.reward.numpy()[keep], np.asarray(jtr.reward)[keep])
    for k, v in jtr.info["episode"].items():
        _close(ttr.info["episode"][k], v, err_msg=k)
    live = keep & ~done
    _close(ttr.obs.numpy()[live], np.asarray(jtr.obs)[live])
    for f in ("prev_action", "prev_error", "episode_step"):
        _close(getattr(ts2, f).numpy()[live],
               np.asarray(getattr(js2, f))[live], err_msg=f)
    for k in js2.episode_sums:
        _close(ts2.episode_sums[k].numpy()[live],
               np.asarray(js2.episode_sums[k])[live], err_msg=k)
    # the reset env's fields that take no random draw
    assert int(ts2.episode_step[0]) == 0
    assert (ts2.prev_action[0] == 0).all()
    for k, v in ts2.episode_sums.items():
        assert float(v[0]) == 0.0, k


def test_controller_matches_jax(envs):
    jenv, tenv, _ = envs
    rng = np.random.default_rng(7)
    obs = np.concatenate([rng.uniform(-3, 3, (64, 2)),
                          rng.uniform(-2.5, 2.5, (64, 2)),
                          rng.uniform(-3, 3, (64, 4))], -1).astype(np.float32)
    jp = JaxDoubleSingleTracking.create(4.0, 4.0, jenv.sim.model.clip_v_z)
    tp = DoubleSingleTracking.create(4.0, 4.0, tenv.sim.model.clip_v_z)
    _close(tp(torch.as_tensor(obs)), jp(jnp.asarray(obs)))
    # some inputs meet the state-dependent bounds
    u = tp(torch.as_tensor(obs)).numpy()
    assert (np.abs(u) >= 4.0 - 1e-6).any()


def test_reset_draws_statistics():
    """Reset draws: root states inside the init-noise bounds, ROM offsets
    inside +-max_rom_distance, and no offset with probability
    zero_rom_dist_llh (0.05). The plan is held still (every env
    stationary) and the robot's velocity drawn as 0, so the window's first
    point minus the projection is the drawn offset."""
    env = presets.make_rom_tracking_env(num_envs=8192, device="cpu")
    sim = env.sim
    sim = dataclasses.replace(
        sim, traj_gen=dataclasses.replace(sim.traj_gen,
                                          prob_stationary=1.0),
        init_noise_lower=torch.tensor([-0.5, -0.5, 0.0, 0.0]),
        init_noise_upper=torch.tensor([0.5, 0.5, 0.0, 0.0]))
    s = sim.reset(torch.Generator().manual_seed(0))
    r = s.root_states.numpy()
    assert (np.abs(r[:, :2]) <= 0.5).all() and (r[:, 2:] == 0).all()
    # uniform positions: mean 0, std 1/sqrt(12)
    assert np.abs(r[:, :2].mean()) < 0.02
    assert np.abs(r[:, :2].std() - 1 / np.sqrt(12)) < 0.01
    off = (s.traj_gen.trajectory[:, 0] - sim.rom.proj_z(s.root_states)
           ).numpy()
    assert (np.abs(off) <= 0.3 + 1e-6).all()
    zero = (off == 0).all(-1)
    # binomial(8192, 0.05): mean 409.6, sd 19.7
    assert abs(zero.sum() - 0.05 * 8192) < 5 * 19.7, zero.sum()
    on = off[~zero]
    assert np.abs(on.std(0) - 0.3 / np.sqrt(3)).max() < 0.01
