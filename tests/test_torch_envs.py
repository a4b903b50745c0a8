"""The port's ROM-trajectory task on the quadruped of
tests/torch_robot_cases.py against the JAX package's, built by both
packages' ``make_trajectory_env`` with ANYmal-C's settings at B=8.

One env step from a carried-over JAX state: the JAX env is reset and
stepped twice with its own random draws; its state goes to the port as
numpy (``interop.env_state_from_numpy``); both take one step with the
same actions, observation noise off and the next push moved past the
step. Envs that reset, or whose trajectory mode expires (new random draws
the two RNGs cannot match), are left out. Tolerance: rtol=atol=1e-4 on
state, observations and reward (one env step chains 4 substeps, each held
to 2e-5 in tests/test_torch_substep.py); ``done`` exactly.

The velocity task's step is held the same way, with the command
curriculum on and the resample and push clocks inside the step
(``test_quadruped_velocity_step_matches_jax``).

The JAX envs run op by op (``jax.disable_jit``, as in
tests/torch_robot_steps.py): compiling a step takes over a minute on the
CPU, its few steps op by op less than that.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.envs.presets import _anymal_c_kwargs as jax_kwargs
from legged_gym_dev_tpu.envs.presets import (
    make_trajectory_env as jax_make_trajectory_env,
)
from legged_gym_dev_tpu.envs.presets import (
    make_velocity_env as jax_make_velocity_env,
)
from legged_gym_dev_tpu_torch.envs import registry
from legged_gym_dev_tpu_torch.envs.presets import (
    _anymal_c_kwargs,
    make_trajectory_env,
    make_velocity_env,
)
from legged_gym_dev_tpu_torch.interop import (
    env_state_from_numpy,
    velocity_env_state_from_numpy,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import QUADRUPED_URDF
from tests.torch_robot_steps import jax_step

B = 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def envs():
    kw = dict(max_contact_force=350.0, num_envs=B, add_noise=False)
    jenv = jax_make_trajectory_env(QUADRUPED_URDF, **jax_kwargs({}), **kw)
    tenv = make_trajectory_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                               device="cpu", **kw)
    return jenv, tenv, jax_step(jenv)


@pytest.fixture(scope="module")
def carried(envs):
    """The JAX state after a reset and two steps, next push past the
    coming step."""
    jenv, _, jstep = envs
    rng = np.random.default_rng(0)
    with jax.disable_jit():
        js, _ = jenv.reset(jax.random.PRNGKey(0))
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(rng.normal(0, 0.5, (B, 12)),
                                      jnp.float32))
    return js.replace(time_until_next_push=js.time_until_next_push * 0.0
                      + 100.0)


def test_env_matches_the_jax_preset(envs):
    jenv, tenv, _ = envs
    assert tenv.num_obs == jenv.num_obs == 65
    assert (tenv.feet_spheres, tenv.penalized_spheres,
            tenv.termination_spheres) == (jenv.feet_spheres,
                                          jenv.penalized_spheres,
                                          jenv.termination_spheres)
    assert tenv.reward_scales == jenv.reward_scales
    for name in ("default_dof_pos", "p_gains", "d_gains", "base_init_pos",
                 "noise_vec", "init_command_ranges", "reward_weighting",
                 "max_rom_distance"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(),
                                      np.asarray(getattr(jenv, name)),
                                      err_msg=name)
    assert (tenv.dt, tenv.max_episode_length) == (jenv.dt,
                                                  jenv.max_episode_length)
    assert tenv.traj_gen.dt_loop == float(jenv.traj_gen.dt_loop)


def test_one_step_matches_jax(envs, carried):
    jenv, tenv, jstep = envs
    js = carried
    actions = np.random.default_rng(1).normal(0, 0.5, (B, 12)).astype(
        np.float32)
    ts = env_state_from_numpy(jax.tree.map(np.asarray, js), tenv,
                              torch.Generator().manual_seed(0))
    tg = js.traj_gen
    expired = np.asarray(tg.t > tg.t_final)

    js2, jtr = jstep(js, jnp.asarray(actions))
    ts2, ttr = tenv.step(ts, torch.as_tensor(actions))

    done_j = np.asarray(jtr.done)
    np.testing.assert_array_equal(ttr.done.numpy(), done_j)
    keep = ~done_j & ~expired
    assert keep.sum() >= B - 3, (done_j, expired)
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_allclose(getattr(ts2.robot, f).numpy()[keep],
                                   np.asarray(getattr(js2.robot, f))[keep],
                                   err_msg=f, **TOL)
    np.testing.assert_allclose(ttr.obs.numpy()[keep],
                               np.asarray(jtr.obs)[keep], **TOL)
    np.testing.assert_allclose(ttr.reward.numpy()[keep],
                               np.asarray(jtr.reward)[keep], **TOL)
    for f in ("torques", "feet_air_time", "prev_error", "trajectory"):
        np.testing.assert_allclose(getattr(ts2, f).numpy()[keep],
                                   np.asarray(getattr(js2, f))[keep],
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(ts2.last_contacts.numpy()[keep],
                                  np.asarray(js2.last_contacts)[keep])


def test_blown_up_env_is_force_terminated(envs, carried):
    """A NaN in one env's state: that env terminates and resets, and no
    NaN reaches the observations or rewards of any env."""
    _, tenv, _ = envs
    ts = env_state_from_numpy(jax.tree.map(np.asarray, carried), tenv)
    v = ts.robot.v.clone()
    v[3, 8] = float("nan")
    ts = ts.replace(robot=ts.robot.replace(v=v))
    ts2, tr = tenv.step(ts, torch.zeros(B, 12))
    assert bool(tr.done[3])
    assert bool(torch.isfinite(tr.obs).all())
    assert bool(torch.isfinite(tr.reward).all())
    assert bool(torch.isfinite(ts2.robot.v).all())


def test_reset_and_registry():
    env = registry.make_env("anymal_c_trajectory", urdf_path=QUADRUPED_URDF,
                            num_envs=4, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, 65) and bool(torch.isfinite(obs).all())
    # the trajectory block is the window relative to the robot's position
    rel = state.trajectory - state.robot.base_pos[:, None, :2]
    torch.testing.assert_close(obs[:, 9:29], rel.reshape(4, -1))
    assert registry.get("anymal_c_trajectory").train_cfg.num_steps == 24
    with pytest.raises(ValueError):
        registry.get("no_such_task")


def test_unported_options_raise(tmp_path, monkeypatch):
    """The options whose files are not in the repository raise
    ``FileNotFoundError``: the LSTM actuator net's weights (the preset
    reads ``ACTUATOR_NET_PATH``) and the Adam preset without a URDF."""
    from legged_gym_dev_tpu_torch.envs import presets

    kw = dict(num_envs=2, device="cpu")
    monkeypatch.setattr(presets, "ACTUATOR_NET_PATH",
                        str(tmp_path / "absent.pt"))
    with pytest.raises(FileNotFoundError):
        registry.make_env("anymal_c_lstm", urdf_path=QUADRUPED_URDF, **kw)
    with pytest.raises(FileNotFoundError):
        registry.make_env("adam_velocity", **kw)


ALL_TERMS = ("lin_vel_z", "ang_vel_xy", "orientation", "base_height",
             "torques", "dof_vel", "dof_acc", "action_rate", "collision",
             "termination", "dof_pos_limits", "dof_vel_limits",
             "torque_limits", "tracking_lin_vel", "tracking_ang_vel",
             "feet_air_time", "stumble", "stand_still", "no_fly",
             "feet_contact_forces", "tracking_rom", "differential_error")


def test_reward_table_matches_jax(envs, carried):
    """Every reward term of the velocity table and the trajectory task's
    own terms, on the carried state with random contact forces."""
    jenv, tenv, _ = envs
    rng = np.random.default_rng(4)
    nc = len(tenv.sim.model.contact_body)
    f = rng.normal(0, 40.0, (B, nc, 3)).astype(np.float32)
    term = rng.uniform(size=B) < 0.3
    first = (rng.uniform(size=(B, 4)) < 0.5).astype(np.float32)
    air = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    ts = env_state_from_numpy(jax.tree.map(np.asarray, carried), tenv)
    rj = jenv._rewards(carried, carried.robot, jnp.asarray(f),
                       jnp.asarray(term), jnp.asarray(first),
                       jnp.asarray(air), names=list(ALL_TERMS))
    rt = tenv._rewards(ts, ts.robot, torch.as_tensor(f),
                       torch.as_tensor(term), torch.as_tensor(first),
                       torch.as_tensor(air), names=list(ALL_TERMS))
    assert list(rt) == list(rj)
    for k in ALL_TERMS:
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_velocity_task_steps():
    """The velocity task on the quadruped: reset, two steps with command
    resampling, the heading controller and a push, all finite."""
    from legged_gym_dev_tpu_torch.envs.presets import make_velocity_env

    env = make_velocity_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                            num_envs=4, device="cpu").replace(
        push_interval_s=0.02, resampling_time_s=0.02)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    assert obs.shape == (4, env.num_obs) == (4, 48)
    cmd0 = state.commands
    for _ in range(2):
        state, tr = env.step(state, torch.zeros(4, 12))
        assert bool(torch.isfinite(tr.obs).all())
        assert bool(torch.isfinite(tr.reward).all())
    assert not torch.equal(state.commands[:, :2], cmd0[:, :2])
    assert bool((state.commands[:, 2].abs() <= 1.0).all())


def test_quadruped_velocity_step_matches_jax():
    """The velocity task's step on the quadruped (command curriculum on)
    from a carried JAX state: env 0 times out with a tracking sum good
    enough to widen the command ranges, env 1 reaches the resample clock,
    env 2 the push clock; the heading controller rewrites every env's
    yaw-rate command. The curriculum's ranges, the resample and push masks,
    the rewards and episode info of every env, and the state and
    observations of the envs those draws do not reach match JAX's (TOL);
    the redrawn and pushed envs differ only where the draws land. (JAX's
    velocity step runs op by op.)"""
    kw = dict(num_envs=B, add_noise=False, command_curriculum=True)
    jenv = jax_make_velocity_env(QUADRUPED_URDF, **jax_kwargs({}), **kw)
    tenv = make_velocity_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                             device="cpu", **kw)
    jstep = jax_step(jenv)
    rng = np.random.default_rng(2)
    with jax.disable_jit():
        js, _ = jenv.reset(jax.random.PRNGKey(1))
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(rng.normal(0, 0.5, (B, 12)),
                                      jnp.float32))
    every = int(round(jenv.resampling_time_s / jenv.dt))
    push_every = int(round(jenv.push_interval_s / jenv.dt))
    steps = np.asarray(js.episode_step).copy()
    assert (steps + 1 < every).all() and every < push_every
    steps[:3] = (jenv.max_episode_length - 1, every - 1, push_every - 1)
    sums = {k: np.asarray(v).copy() for k, v in js.episode_sums.items()}
    scale = dict(jenv.reward_scales)["tracking_lin_vel"] * jenv.dt
    sums["tracking_lin_vel"][0] = 0.9 * scale * jenv.max_episode_length
    js = js.replace(episode_step=jnp.asarray(steps),
                    episode_sums={k: jnp.asarray(v) for k, v in
                                  sums.items()})
    ts = velocity_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv)
    actions = rng.normal(0, 0.5, (B, 12)).astype(np.float32)
    js2, jtr = jstep(js, jnp.asarray(actions))
    ts2, ttr = tenv.step(ts, torch.as_tensor(actions))

    done = np.asarray(jtr.done)
    np.testing.assert_array_equal(ttr.done.numpy(), done)
    assert done[0] and not done[1:3].any()
    np.testing.assert_array_equal(ttr.info["time_outs"].numpy(),
                                  np.asarray(jtr.info["time_outs"]))
    # the curriculum widened the lin-vel ranges by 0.5, in both
    cr0 = np.asarray(js.command_ranges)
    np.testing.assert_array_equal(ts2.command_ranges.numpy(),
                                  np.asarray(js2.command_ranges))
    np.testing.assert_allclose(np.asarray(js2.command_ranges)[:2],
                               np.clip(cr0[:2] + [-0.5, 0.5], -5, 5))
    # rewards and episode info precede every draw
    np.testing.assert_allclose(ttr.reward.numpy(), np.asarray(jtr.reward),
                               **TOL)
    for k, v in jtr.info["episode"].items():
        np.testing.assert_allclose(float(ttr.info["episode"][k]), float(v),
                                   err_msg=k, **TOL)
    # the resample clock redraws env 1's commands only, in both
    redrawn_j = (np.asarray(js2.commands)[:, [0, 1, 3]]
                 != np.asarray(js.commands)[:, [0, 1, 3]]).any(-1)
    redrawn_t = (ts2.commands[:, [0, 1, 3]]
                 != ts.commands[:, [0, 1, 3]]).any(-1).numpy()
    np.testing.assert_array_equal(redrawn_t[~done], redrawn_j[~done])
    assert redrawn_t[1] and redrawn_t[~done].sum() == 1
    # the push sets env 2's planar base velocity, in both
    v0, vj, vt = (np.asarray(js.robot.v), np.asarray(js2.robot.v),
                  ts2.robot.v.numpy())
    assert (np.abs(vt[2, :2]) <= jenv.max_push_vel).all()
    assert (vt[2, :2] != vj[2, :2]).all()
    live = ~done
    live[1:3] = False
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_allclose(getattr(ts2.robot, f).numpy()[live],
                                   np.asarray(getattr(js2.robot, f))[live],
                                   err_msg=f, **TOL)
    np.testing.assert_allclose(vt[2, 2:], vj[2, 2:], **TOL)
    np.testing.assert_allclose(ts2.commands.numpy()[live],
                               np.asarray(js2.commands)[live], **TOL)
    # the pushed env keeps its commands (yaw rate from the heading
    # controller, before the push)
    np.testing.assert_allclose(ts2.commands.numpy()[[2], :],
                               np.asarray(js2.commands)[[2], :], **TOL)
    np.testing.assert_allclose(ttr.obs.numpy()[live],
                               np.asarray(jtr.obs)[live], **TOL)
    cmd = slice(9, 12)
    rest = np.r_[0:9, 12:tenv.num_obs]
    np.testing.assert_allclose(ttr.obs.numpy()[1, rest],
                               np.asarray(jtr.obs)[1, rest], **TOL)
    np.testing.assert_allclose(ttr.obs.numpy()[2, 3:],
                               np.asarray(jtr.obs)[2, 3:], **TOL)
    assert not np.allclose(ttr.obs.numpy()[1, cmd], np.asarray(
        jtr.obs)[1, cmd])
    for f in ("last_actions", "last_dof_vel", "feet_air_time", "torques"):
        np.testing.assert_allclose(getattr(ts2, f).numpy()[~done],
                                   np.asarray(getattr(js2, f))[~done],
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(ts2.episode_step.numpy(),
                                  np.asarray(js2.episode_step))
    for k in js2.episode_sums:
        np.testing.assert_allclose(ts2.episode_sums[k].numpy()[~done],
                                   np.asarray(js2.episode_sums[k])[~done],
                                   err_msg=k, **TOL)
