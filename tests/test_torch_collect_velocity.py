"""The port's velocity-command tube-data collector,
``collect_velocity_tracking``, against the JAX package's on the quadruped
of tests/torch_robot_cases.py (ANYmal-C settings, the velocity task) at
B=4 with a zero-action policy (tests/test_collect_velocity.py, as a
JAX-against-port test).

- T, steps a tick and the shapes of the recorded arrays equal JAX's;
- one ROM tick (5 env steps, the P law writing body-frame commands before
  each) from a carried JAX env and generator state, no mode expiring and
  no resample or push clock in the tick: the records at rtol=atol=5e-4
  (one env step is held to 1e-4 in tests/test_torch_envs.py).

JAX compiles the velocity step twice here (its collector's scan and the
step alone), about a minute each on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import SingleInt2D as JaxSingleInt2D
from legged_gym_dev_tpu.core.maths import quat_to_yaw, yaw2rot
from legged_gym_dev_tpu.envs.presets import _anymal_c_kwargs as jax_kwargs
from legged_gym_dev_tpu.envs.presets import (
    make_velocity_env as jax_make_velocity_env,
)
from legged_gym_dev_tpu.trajgen import TrajectoryGenerator as JaxGenerator
from legged_gym_dev_tpu.trajgen import UniformSampleHoldDT as JaxHold
from legged_gym_dev_tpu.trajgen import UniformWeightSampler as JaxWeights
from legged_gym_dev_tpu.tube import collect as jcol
from legged_gym_dev_tpu_torch.core import SingleInt2D
from legged_gym_dev_tpu_torch.envs.presets import (
    _anymal_c_kwargs,
    make_velocity_env,
)
from legged_gym_dev_tpu_torch.interop import (
    traj_gen_state_from_numpy,
    velocity_env_state_from_numpy,
)
from legged_gym_dev_tpu_torch.trajgen import (
    TrajectoryGenerator,
    UniformSampleHoldDT,
    UniformWeightSampler,
)
from legged_gym_dev_tpu_torch.tube import collect as tcol
from tests.torch_robot_cases import QUADRUPED_URDF
from tests.torch_port_cases import one_torch_thread  # noqa: F401

B = 4
ROM = (0.1, [-10, -10], [10, 10], [-0.5, -0.5], [0.5, 0.5])


@pytest.fixture(scope="module")
def setup():
    kw = dict(num_envs=B, add_noise=False, episode_length_s=4.0)
    jenv = jax_make_velocity_env(QUADRUPED_URDF, **jax_kwargs({}), **kw)
    tenv = make_velocity_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                             device="cpu", **kw)
    jgen = JaxGenerator.create(JaxSingleInt2D.create(*ROM),
                               JaxHold.create(1.0, 3.0), JaxWeights(),
                               dt_loop=jenv.dt, N=4, dN=1,
                               prob_stationary=0.0)
    tgen = TrajectoryGenerator.create(
        SingleInt2D.create(*ROM, device="cpu"),
        UniformSampleHoldDT.create(1.0, 3.0), UniformWeightSampler(),
        dt_loop=tenv.dt, N=4, dN=1, prob_stationary=0.0)
    return jenv, tenv, jgen, tgen


def _zero(n):
    return lambda obs: obs[:, :n] * 0.0


def test_collect_velocity_tracking_shapes(setup):
    jenv, tenv, jgen, tgen = setup
    jd = jcol.collect_velocity_tracking(
        jenv, lambda obs: jnp.zeros((B, jenv.num_actions)), jgen,
        jax.random.PRNGKey(0), episode_length_s=0.2)
    td = tcol.collect_velocity_tracking(
        tenv, lambda obs: torch.zeros(B, tenv.num_actions), tgen,
        torch.Generator().manual_seed(0), episode_length_s=0.2)
    assert tcol._ticks(0.2, tgen.rom.dt, tenv.dt) == (2, 5)
    for f in ("z", "v", "pz_x", "done"):
        assert getattr(td, f).shape == getattr(jd, f).shape, f
        assert getattr(td, f).dtype == getattr(jd, f).dtype, f
    assert td.z.shape == (B, 3, 2)
    assert np.isfinite(td.z).all() and np.isfinite(td.pz_x).all()


def test_velocity_tick_matches_jax(setup):
    """The JAX collector's tick, written out, against the port's
    ``velocity_tick`` from the same carried env and generator state."""
    jenv, tenv, jgen, tgen = setup
    rom = jgen.rom
    jstep = jax.jit(jenv.step)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    js, _ = jstep(js, jnp.zeros((B, 12)))
    tg = jgen.init_state(jax.random.PRNGKey(2), B)
    tg = jgen.reset(tg, jnp.ones((B,), bool),
                    rom.proj_z(js.robot.root_states))
    # every mode held past the tick
    tg = tg.replace(t_final=tg.t_final + 100.0)
    every = int(round(jenv.resampling_time_s / jenv.dt))
    assert (np.asarray(js.episode_step) + 5 < every).all()
    ts = velocity_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv)
    ttg = traj_gen_state_from_numpy(jax.tree.map(np.asarray, tg), ts.gen)

    done = np.zeros(B, bool)
    for _ in range(5):
        pz_x = rom.proj_z(js.robot.root_states)
        cmd_world = (jgen.get_trajectory(tg)[:, 0, :2] - pz_x[:, :2]
                     + tg.v[:, :2])
        cmd = jnp.clip(jnp.einsum("bij,bj->bi",
                                  yaw2rot(quat_to_yaw(js.robot.base_quat)),
                                  cmd_world), -1.0, 1.0)
        js = js.replace(commands=js.commands.at[:, :2].set(cmd)
                        .at[:, 2].set(0.0))
        js, tr = jstep(js, jnp.zeros((B, 12)))
        tg = jgen.step(tg)
        done |= np.asarray(tr.done)
    j_rec = (np.asarray(jgen.get_trajectory(tg)[:, 0]),
             np.asarray(rom.proj_z(js.robot.root_states)), np.asarray(tg.v))
    _, _, t_rec = tcol.velocity_tick(tenv, _zero(12), tgen, ts, ttg, 5)
    np.testing.assert_array_equal(t_rec[3].numpy(), done)
    keep = ~done
    assert keep.sum() >= B - 1
    for a, b, name in zip(t_rec[:3], j_rec, ("z", "pz_x", "v")):
        np.testing.assert_allclose(a.numpy()[keep], b[keep], rtol=5e-4,
                                   atol=5e-4, err_msg=name)
