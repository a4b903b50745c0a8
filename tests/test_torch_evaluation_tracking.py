"""``evaluation.evaluate_tracking_policy`` of the port against the JAX
package's, and the fixture generators inside the envs.

- On ``rom_tracking`` (B=8) with each fixture: both packages swap the
  env's generator for the fixture and roll the same policy (weights drawn
  with numpy, written once for each package) for 20 steps from the same
  reset state: JAX's own reset, carried to the port through ``interop``
  (the reset's random draws are not compared: the two RNGs differ). Bar:
  rtol 1e-4 on the three metrics.
- On the test hopper under its 8-stage curriculum, the fixture's class
  survives ``env.replace`` into every stage's scaled generator and drives
  the inputs: the stage generators are rebuilt from ``traj_gen`` by
  ``dataclasses.replace``, which keeps the subclass.
- The hopper preset's ``weight_sampler`` names and ``push_interval_s``
  alias against the JAX preset.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu import evaluation as jeval
from legged_gym_dev_tpu.envs.presets import (
    make_hopper_trajectory_env as jax_make_hopper,
)
from legged_gym_dev_tpu.envs.presets import (
    make_rom_tracking_env as jax_make_rom_tracking,
)
from legged_gym_dev_tpu.trajgen import generator as jgen
from legged_gym_dev_tpu_torch import evaluation
from legged_gym_dev_tpu_torch.envs.presets import (
    make_hopper_trajectory_env,
    make_rom_tracking_env,
)
from legged_gym_dev_tpu_torch.envs.rom_tracking import RomTrackingEnv
from legged_gym_dev_tpu_torch.interop import rom_tracking_env_state_from_numpy
from legged_gym_dev_tpu_torch.trajgen import (
    TRAJ_GEN_REGISTRY,
    TrajectoryGenerator,
    ZeroTrajectoryGenerator,
)
from legged_gym_dev_tpu_torch.trajgen.samplers import SAMPLER_REGISTRY
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import HOPPER_URDF

B, STEPS = 8, 20
FIXTURES = ("ZeroTrajectoryGenerator", "SquareTrajectoryGenerator",
            "CircleTrajectoryGenerator")


def policy_weights(n_obs, n_act, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (n_obs, n_act)).astype(np.float32),
            rng.normal(0, 0.1, n_act).astype(np.float32))


@pytest.fixture(scope="module")
def rom_envs():
    return (jax_make_rom_tracking(num_envs=B),
            make_rom_tracking_env(num_envs=B, device="cpu"))


@pytest.mark.parametrize("name", FIXTURES)
def test_rom_tracking_matches_jax(rom_envs, name, monkeypatch):
    jenv, tenv = rom_envs
    W, b = policy_weights(tenv.num_obs, tenv.num_actions)

    def jpolicy(obs):
        return 2.0 * jnp.tanh(obs @ W + b)

    Wt, bt = torch.as_tensor(W), torch.as_tensor(b)

    def tpolicy(obs):
        return 2.0 * torch.tanh(obs @ Wt + bt)

    # JAX's reset with the fixture in place, as its evaluation does it
    base = jenv.sim.traj_gen
    fixture = jgen.TRAJ_GEN_REGISTRY[name].create(
        base.rom, base.t_sampler, base.weight_sampler,
        dt_loop=float(base.dt_loop), N=base.N, dN=base.dN)
    js, jobs = jenv.replace(sim=jenv.sim.replace(traj_gen=fixture)).reset(
        jax.random.PRNGKey(0))
    ts = rom_tracking_env_state_from_numpy(jax.tree.map(np.asarray, js),
                                           tenv)
    seen = {}

    def carried_reset(self, gen):
        seen["traj_gen"] = self.sim.traj_gen
        return ts, torch.as_tensor(np.array(jobs))

    monkeypatch.setattr(RomTrackingEnv, "reset", carried_reset)
    tout = evaluation.evaluate_tracking_policy(
        tenv, tpolicy, TRAJ_GEN_REGISTRY[name], steps=STEPS)
    jout = jeval.evaluate_tracking_policy(
        jenv, jpolicy, jgen.TRAJ_GEN_REGISTRY[name], steps=STEPS)
    assert type(seen["traj_gen"]) is TRAJ_GEN_REGISTRY[name]
    assert sorted(tout) == sorted(jout)
    for k, v in jout.items():
        assert np.isfinite(tout[k])
        np.testing.assert_allclose(tout[k], float(v), rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def hopper():
    return make_hopper_trajectory_env(num_envs=4, urdf_path=HOPPER_URDF,
                                      add_noise=False,
                                      curriculum="single_int", device="cpu")


def test_fixture_survives_the_hopper_curriculum(hopper):
    assert len(hopper._stage_gens) == 8
    assert all(type(g) is TrajectoryGenerator for g in hopper._stage_gens)
    base = hopper.traj_gen
    env = hopper.replace(traj_gen=ZeroTrajectoryGenerator.create(
        base.rom, base.t_sampler, base.weight_sampler,
        dt_loop=base.dt_loop, N=base.N, dN=base.dN))
    assert all(type(g) is ZeroTrajectoryGenerator for g in env._stage_gens)
    # each stage keeps its scaled ROM bounds
    for g, g0 in zip(env._stage_gens, hopper._stage_gens):
        assert torch.equal(g.rom.v_max, g0.rom.v_max)
    gen = torch.Generator().manual_seed(0)
    st, obs = env.reset(gen)
    for stage in (0, 5):
        s = st.replace(curriculum_stage=stage)
        for _ in range(3):
            s, tr = env.step(s, torch.zeros(4, env.num_actions))
        # the fixture drives the inputs: every env stationary, a still
        # window
        assert bool(s.traj_gen.stationary.all())
        assert float(s.traj_gen.v_trajectory.abs().max()) == 0.0
        win = s.trajectory
        assert float((win - win[:, :1]).abs().max()) == 0.0


def test_evaluate_tracking_policy_runs_on_the_hopper(hopper):
    out = evaluation.evaluate_tracking_policy(
        hopper, lambda obs: torch.zeros(obs.shape[0], hopper.num_actions),
        ZeroTrajectoryGenerator, steps=3)
    assert sorted(out) == ["final_tracking_error", "max_tracking_error",
                           "mean_tracking_error"]
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("sampler", [
    None, "UniformWeightSampler", "UniformWeightSamplerNoExtreme",
    "UniformWeightSamplerNoRamp", "WeightSamplerSampleAndHold",
    "UniformWeightSamplerTurnBiased"])
def test_hopper_preset_weight_sampler_matches_jax(sampler):
    kw = dict(num_envs=2, urdf_path=HOPPER_URDF, weight_sampler=sampler)
    jenv = jax_make_hopper(**kw)
    tenv = make_hopper_trajectory_env(device="cpu", **kw)
    np.testing.assert_array_equal(
        np.asarray(tenv.traj_gen.weight_sampler.mask, np.float32),
        np.asarray(jenv.traj_gen.weight_sampler.mask, np.float32))
    inst = SAMPLER_REGISTRY["UniformWeightSamplerTurnBiased"](2.0)
    assert make_hopper_trajectory_env(
        device="cpu", num_envs=2, urdf_path=HOPPER_URDF,
        weight_sampler=inst).traj_gen.weight_sampler is inst


@pytest.mark.parametrize("interval", [None, 0.3, 4.0])
def test_hopper_preset_push_interval_matches_jax(interval):
    kw = dict(num_envs=2, urdf_path=HOPPER_URDF, push_interval_s=interval)
    jenv = jax_make_hopper(**kw)
    tenv = make_hopper_trajectory_env(device="cpu", **kw)
    assert tuple(tenv.time_between_pushes) == tuple(
        float(x) for x in jenv.time_between_pushes)
