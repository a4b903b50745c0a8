"""The port's hopper tasks against the JAX package's, both built by their
``make_hopper_trajectory_env`` (with the 8-stage ``single_int``
curriculum) and ``make_hopper_velocity_env`` on the hopper of
tests/torch_robot_cases.py at B=8.

One env step from a carried-over JAX state, for each task through the same
helpers: the JAX env is reset and stepped twice with its own random draws;
its state goes to the port as numpy (``interop.hopper_env_state_from_numpy``);
both take one step with the same actions, observation noise off and the
next push moved past the step. The trajectory task steps at curriculum
stage 0 and at stage 6 (sigma 0.1x); the velocity task steps with one env
timed out (its episode sums logged, its reset's fixed fields) and one on
the command-resample clock (the same envs resample). Envs that reset, or
whose trajectory mode expires or whose commands are redrawn (new random
draws the two RNGs cannot match), are left out of the values those draws
reach. Tolerance: rtol=atol=1e-4 on state, observations, reward and episode
sums, as for the quadruped task (one env step chains 8 substeps, each held
to 2e-5 in tests/test_torch_substep.py); ``done`` exactly. The controller
alone (contact gating, torque clipping, and the velocity task's wheel
spin-down in stance) and ``so3_log`` are held to 1e-5.

Each task's JAX step is compiled once for the module (up to a minute each
on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core.maths import so3_log as jax_so3_log
from legged_gym_dev_tpu.envs.presets import (
    make_hopper_trajectory_env as jax_make_hopper,
)
from legged_gym_dev_tpu.envs.presets import (
    make_hopper_velocity_env as jax_make_hopper_velocity,
)
from legged_gym_dev_tpu_torch.core.maths import so3_log
from legged_gym_dev_tpu_torch.envs import registry
from legged_gym_dev_tpu_torch.envs.presets import (
    HOPPER_REWARD_SCALES,
    make_hopper_trajectory_env,
    make_hopper_velocity_env,
)
from legged_gym_dev_tpu_torch.interop import hopper_env_state_from_numpy
from tests.torch_robot_cases import HOPPER_URDF
from tests.torch_port_cases import one_torch_thread  # noqa: F401

B = 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def envs():
    kw = dict(num_envs=B, add_noise=False, urdf_path=HOPPER_URDF,
              curriculum="single_int")
    jenv = jax_make_hopper(**kw)
    tenv = make_hopper_trajectory_env(device="cpu", **kw)
    return jenv, tenv, jax.jit(jenv.step)


def _actions(rng, n=B):
    """Quaternion-like actions (w,x,y,z) near the identity."""
    return (np.asarray([1.0, 0.0, 0.0, 0.0])
            + rng.normal(0, 0.2, (n, 4))).astype(np.float32)


@pytest.fixture(scope="module")
def vel_envs():
    kw = dict(num_envs=B, add_noise=False, urdf_path=HOPPER_URDF)
    jenv = jax_make_hopper_velocity(**kw)
    tenv = make_hopper_velocity_env(device="cpu", **kw)
    return jenv, tenv, jax.jit(jenv.step)


def _carry(envs):
    """The JAX state after a reset and two steps, next push past the
    coming step."""
    jenv, _, jstep = envs
    rng = np.random.default_rng(0)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    for _ in range(2):
        js, _ = jstep(js, jnp.asarray(_actions(rng)))
    # (same avals as the fields, so the jitted step is not traced again)
    return js.replace(time_until_next_push=js.time_until_next_push * 0.0
                      + 100.0)


@pytest.fixture(scope="module")
def carried(envs):
    return _carry(envs)


@pytest.fixture(scope="module")
def vel_carried(vel_envs):
    return _carry(vel_envs)


def _step_both(envs, js, actions):
    """One step of each package from the JAX state ``js``: (port state
    before, JAX state and transition after, port state and transition
    after)."""
    _, tenv, jstep = envs
    ts = hopper_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv,
                                     torch.Generator().manual_seed(0))
    js2, jtr = jstep(js, jnp.asarray(actions))
    ts2, ttr = tenv.step(ts, torch.as_tensor(actions))
    np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
    return ts, js2, jtr, ts2, ttr


def _assert_step_matches(js2, jtr, ts2, ttr, keep, fields, obs_cols=None):
    """State, observations (``obs_cols`` of them, all by default), reward,
    ``fields`` and episode sums on the ``keep`` envs, and the logged
    episode info (sums of the envs that reset, taken before the reset)."""
    cols = slice(None) if obs_cols is None else obs_cols
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_allclose(getattr(ts2.robot, f).numpy()[keep],
                                   np.asarray(getattr(js2.robot, f))[keep],
                                   err_msg=f, **TOL)
    np.testing.assert_allclose(ttr.obs.numpy()[keep][:, cols],
                               np.asarray(jtr.obs)[keep][:, cols], **TOL)
    np.testing.assert_allclose(ttr.reward.numpy()[keep],
                               np.asarray(jtr.reward)[keep], **TOL)
    for f in fields:
        np.testing.assert_allclose(getattr(ts2, f).numpy()[keep],
                                   np.asarray(getattr(js2, f))[keep],
                                   err_msg=f, **TOL)
    for k in ts2.episode_sums:
        np.testing.assert_allclose(ts2.episode_sums[k].numpy()[keep],
                                   np.asarray(js2.episode_sums[k])[keep],
                                   err_msg=k, **TOL)
    ep_t, ep_j = ttr.info["episode"], jtr.info["episode"]
    assert ep_t.keys() == ep_j.keys()
    for k in ep_t:
        np.testing.assert_allclose(float(ep_t[k]), float(ep_j[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(ttr.info["time_outs"].numpy(),
                                  np.asarray(jtr.info["time_outs"]))
    assert ts2.common_step == int(js2.common_step)


def test_preset_matches_the_jax_preset(envs):
    jenv, tenv, _ = envs
    assert tenv.num_obs == jenv.num_obs == 38
    assert tenv.num_actions == jenv.num_actions == 4
    assert tenv.reward_scales == jenv.reward_scales == HOPPER_REWARD_SCALES
    assert (tenv.dt, tenv.max_episode_length) == (jenv.dt,
                                                  jenv.max_episode_length)
    assert tenv.sim.model.contact_link_names == (
        "torso", "foot", "wheel1", "wheel2", "wheel3")
    for name in ("p_gains", "d_gains", "kd_spindown", "rot_actuator",
                 "torque_limits", "obs_scales", "noise_vec",
                 "reward_weighting"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(),
                                      np.asarray(getattr(jenv, name)),
                                      err_msg=name)
    for name in ("spring_stiffness", "spring_damping", "spring_setpoint",
                 "foot_pos_des", "wheel_speed_limit", "ts_ratio",
                 "tracking_sigma"):
        assert getattr(tenv, name) == float(getattr(jenv, name)), name
    for f in ("Kp", "Kv", "Kff", "clip_pos", "clip_vel", "clip_ang"):
        assert getattr(tenv.raibert, f) == float(getattr(jenv.raibert, f))
    for f in ("max_push_vel", "time_between_pushes", "termination_spheres",
              "foot_sphere", "diff_err_slopes", "control_type"):
        assert getattr(tenv, f) == getattr(jenv, f), f
    # curriculum tables and each stage's scaled trajectory generator
    jc, tc = jenv.curriculum, tenv.curriculum
    assert tc.steps == jc.steps and tc.enabled
    for f in dataclasses.fields(tc):
        if f.name not in ("steps", "enabled"):
            np.testing.assert_array_equal(
                np.asarray(getattr(tc, f.name), np.float32),
                np.asarray(getattr(jc, f.name)), err_msg=f.name)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    for stage in range(jc.push_magnitude.shape[0]):
        jg = jenv._traj_gen_cur(js.replace(
            curriculum_stage=jnp.asarray(stage, jnp.int32)))
        tg = tenv._stage_gens[stage]
        for a, b in ((tg.rom.v_min, jg.rom.v_min), (tg.rom.v_max,
                                                    jg.rom.v_max)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (tg.t_sampler.t_low, tg.t_sampler.t_high) == (
            float(jg.t_sampler.t_low), float(jg.t_sampler.t_high))
        assert (tg.freq_low, tg.freq_high) == (float(jg.freq_low),
                                               float(jg.freq_high))
        assert tg.dt_loop == float(jg.dt_loop)
        np.testing.assert_array_equal(
            np.asarray(tg.weight_sampler.mask, np.float32),
            np.asarray(jg.weight_sampler.mask))


@pytest.mark.parametrize("stage", [0, 6])
def test_one_step_matches_jax(envs, carried, stage):
    jenv, tenv, jstep = envs
    steps = jenv.curriculum.steps
    common = 2 if stage == 0 else steps[stage - 1] + 2
    js = carried.replace(
        curriculum_stage=carried.curriculum_stage * 0 + stage,
        common_step=carried.common_step * 0 + common)
    tg = js.traj_gen
    expired = np.asarray(tg.t > tg.t_final)
    ts, js2, jtr, ts2, ttr = _step_both(envs, js,
                                        _actions(np.random.default_rng(1)))
    assert (ts.curriculum_stage, ts.common_step) == (stage, common)

    keep = ~np.asarray(jtr.done) & ~expired
    assert keep.sum() >= B - 3, (np.asarray(jtr.done), expired)
    _assert_step_matches(js2, jtr, ts2, ttr, keep,
                         ("torques", "prev_error", "trajectory",
                          "last_dof_vel"))
    assert ts2.curriculum_stage == int(js2.curriculum_stage)


def test_velocity_step_matches_jax(vel_envs, vel_carried):
    """Env 0 times out on this step, env 1 reaches the resample clock;
    the rest step on their commands."""
    jenv, tenv, _ = vel_envs
    every = max(int(round(jenv.resampling_time_s / jenv.dt)), 1)
    assert every < jenv.max_episode_length - 1
    steps = np.asarray(vel_carried.episode_step).copy()
    assert (steps < every - 1).all()
    steps[:2] = (jenv.max_episode_length - 1, every - 1)
    js = vel_carried.replace(episode_step=jnp.asarray(steps))
    ts, js2, jtr, ts2, ttr = _step_both(vel_envs, js,
                                        _actions(np.random.default_rng(1)))

    done = np.asarray(jtr.done)
    assert done[0] and np.asarray(jtr.info["time_outs"])[0]
    # the resample clock redraws the same envs' commands in both
    redrawn_j = (np.asarray(js2.commands) != np.asarray(js.commands)).any(-1)
    redrawn_t = (ts2.commands != ts.commands).any(-1).numpy()
    np.testing.assert_array_equal(redrawn_t[~done], redrawn_j[~done])
    assert redrawn_t[1] and redrawn_t[~done].sum() == 1
    keep = ~done
    assert keep.sum() >= B - 3, done
    _assert_step_matches(js2, jtr, ts2, ttr, keep & ~redrawn_j,
                         ("commands", "torques", "last_actions",
                          "last_dof_vel", "time_until_next_push",
                          "episode_step"))
    # the redrawn env differs only in the command block of its obs
    cmd = slice(14, 17)
    rest = np.r_[0:14, 17:tenv.num_obs]
    _assert_step_matches(js2, jtr, ts2, ttr, keep & redrawn_j,
                         ("torques", "last_dof_vel", "episode_step"),
                         obs_cols=rest)
    torch.testing.assert_close(ttr.obs[:, cmd],
                               ts2.commands * tenv.obs_scales[cmd])
    # the reset envs' fields that take no random draw
    ident = np.tile([1.0, 0.0, 0.0, 0.0], (done.sum(), 1))
    for f, want in (("episode_step", 0), ("actions", ident),
                    ("last_actions", ident), ("last_dof_vel", 0.0)):
        np.testing.assert_array_equal(getattr(ts2, f).numpy()[done],
                                      np.asarray(getattr(js2, f))[done],
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(ts2, f).numpy()[done],
                                      np.broadcast_to(want, getattr(
                                          ts2, f).numpy()[done].shape))
    for k, v in ts2.episode_sums.items():
        assert (v.numpy()[done] == 0).all(), k


def _controller_case(envs, carried):
    """The controller on states that put half the envs' feet in contact
    (foot sphere pushed into the ground, even envs) and spin the wheels
    past their speed band (envs 0-3) or slowly (envs 4-7), with actions
    far from the attitude (clipped torques): the port's torques against
    JAX's, and (torques, state) for the task's own checks."""
    jenv, tenv, _ = envs
    rng = np.random.default_rng(5)
    js = carried
    r = js.robot
    base_pos = np.asarray(r.base_pos).copy()
    base_pos[::2, 2] = 0.35          # foot sphere 1-4 cm into the plane
    base_pos[1::2, 2] = 0.6          # in flight
    v = np.asarray(r.v).copy()
    v[:4, 7:10] = rng.uniform(-700, 700, (4, 3))
    v[4:, 7:10] = rng.uniform(-15, 15, (B - 4, 3))
    js = js.replace(robot=r.replace(base_pos=jnp.asarray(base_pos),
                                    v=jnp.asarray(v)),
                    actions=jnp.asarray(rng.normal(0, 1.0, (B, 4)),
                                        jnp.float32))
    ts = hopper_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv)
    tau_j = np.asarray(jenv._compute_torques(js, js.robot))
    tau_t = tenv._compute_torques(ts, ts.robot).numpy()
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-5, atol=1e-5)
    # stance: the foot torque is the spring force; in bounds everywhere,
    # and some wheels at their (speed-dependent) bound
    f = tenv._sphere_forces(ts.robot).numpy()
    contact = f[:, 1, 2] > 0.1
    assert contact[::2].all() and not contact[1::2].any()
    dr = ts.dr
    spring = (-tenv.spring_stiffness * dr.spring_k
              * (ts.robot.q[:, 0] - tenv.spring_setpoint * dr.spring_set)
              - tenv.spring_damping * dr.spring_d * ts.robot.v[:, 6])
    np.testing.assert_allclose(tau_t[::2, 0], spring.numpy()[::2],
                               rtol=1e-6)
    bound = (tenv.torque_limits[None, :] * dr.torque[:, None]).numpy()
    assert (np.abs(tau_t) <= bound + 1e-6).all()
    assert (np.abs(tau_t[:, 1:]) >= bound[:, 1:] - 1e-6).any()
    return tau_t, ts


def test_contact_gating_and_torque_clipping(envs, carried):
    _controller_case(envs, carried)


def test_velocity_contact_gating_and_spindown(vel_envs, vel_carried):
    """The velocity task's ``orientation_spindown`` controller: in stance
    the slow wheels (envs 4 and 6, inside the torque-speed band) get the
    spin-down damping -kd * d_gain * w in place of the attitude PD."""
    _, tenv, _ = vel_envs
    assert tenv.control_type == "orientation_spindown"
    tau_t, ts = _controller_case(vel_envs, vel_carried)
    slow = [4, 6]
    spindown = (-tenv.kd_spindown[None, :] * ts.dr.d_gain[:, 1:]
                * ts.robot.v[:, 7:10]).numpy()
    np.testing.assert_allclose(tau_t[slow, 1:], spindown[slow], rtol=1e-6)


def test_so3_log_both_branches():
    """Random rotations (both signs of w), rotations below the series
    threshold and the identity: values within 1e-6 of JAX's; gradients
    finite at the identity (the safe denominator)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    small = np.zeros((4, 4), np.float32)
    small[:, :3] = rng.normal(0, 1e-7, (4, 3))
    small[:, 3] = [1.0, -1.0, 1.0, 1.0]
    small[3] = [0.0, 0.0, 0.0, 1.0]
    q = np.concatenate([q, small])
    np.testing.assert_allclose(so3_log(torch.as_tensor(q)).numpy(),
                               np.asarray(jax_so3_log(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)
    x = torch.as_tensor(small, dtype=torch.float32).requires_grad_()
    (g,) = torch.autograd.grad(so3_log(x).sum(), x)
    assert bool(torch.isfinite(g).all())


def test_velocity_task_steps():
    """The velocity hopper: reset, steps with command resampling and a
    push, all finite; its observations carry the commands."""
    env = make_hopper_velocity_env(num_envs=4, urdf_path=HOPPER_URDF,
                                   device="cpu").replace(
        resampling_time_s=0.02, time_between_pushes=(0.01, 0.02))
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    assert obs.shape == (4, env.num_obs) == (4, 21)
    cmd0 = state.commands
    a = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(4, 4)
    for _ in range(3):
        state, tr = env.step(state, a)
        assert bool(torch.isfinite(tr.obs).all())
        assert bool(torch.isfinite(tr.reward).all())
    assert not torch.equal(state.commands, cmd0)
    assert bool((state.commands.abs() <= torch.tensor([0.35, 0.35, 1.0])
                 ).all())
    assert state.common_step == 3
    scaled = state.commands * env.obs_scales[14:17]
    torch.testing.assert_close(tr.obs[:, 14:17], scaled)


def test_registry_and_default_urdf():
    env = registry.make_env("hopper_trajectory", urdf_path=HOPPER_URDF,
                            num_envs=2, device="cpu")
    _, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (2, 38) and bool(torch.isfinite(obs).all())
    assert registry.get("hopper_velocity").train_cfg.num_steps == 24
    # the reference hopper URDF is not in the repository
    with pytest.raises(FileNotFoundError):
        registry.make_env("hopper_trajectory", num_envs=2, device="cpu")
