"""The port's rigid-body tube-data collector, ``collect_tracking`` with the
Raibert heuristic (``raibert_obs=True``), against the JAX package's on the
hopper of tests/torch_robot_cases.py at B=4 (observation noise, domain
randomization and pushes off).

- T, steps a tick and the shapes of the recorded arrays equal JAX's;
- the Raibert observation on a carried JAX state: 1e-6;
- one ROM tick (5 env steps under the heuristic) from a carried JAX state:
  the records at rtol=atol=5e-4, envs that reset or whose trajectory mode
  expires in the tick left out (one env step is held to 1e-4 in
  tests/test_torch_hopper_env.py; the tick chains five).

JAX compiles the hopper step twice here (its collector's scan and the
step alone), about a minute each on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.envs.presets import (
    make_hopper_trajectory_env as jax_make_hopper,
)
from legged_gym_dev_tpu.tube import collect as jcol
from legged_gym_dev_tpu_torch.envs.presets import make_hopper_trajectory_env
from legged_gym_dev_tpu_torch.interop import hopper_env_state_from_numpy
from legged_gym_dev_tpu_torch.tube import collect as tcol
from tests.torch_robot_cases import HOPPER_URDF
from tests.torch_port_cases import one_torch_thread  # noqa: F401

B = 4
KW = dict(num_envs=B, add_noise=False, domain_rand=False, push_robots=False,
          episode_length_s=8.0, urdf_path=HOPPER_URDF)


@pytest.fixture(scope="module")
def envs():
    return jax_make_hopper(**KW), make_hopper_trajectory_env(device="cpu",
                                                             **KW)


def test_collect_tracking_shapes(envs):
    jenv, tenv = envs
    jd = jcol.collect_tracking(jenv, jenv.raibert, jax.random.PRNGKey(0),
                               episode_length_s=0.2, raibert_obs=True)
    td = tcol.collect_hopper_tracking(tenv, tenv.raibert,
                                      torch.Generator().manual_seed(0),
                                      episode_length_s=0.2, raibert_obs=True)
    assert tcol._ticks(0.2, tenv.rom.dt, tenv.dt) == (2, 5)
    for f in ("z", "v", "pz_x", "done"):
        assert getattr(td, f).shape == getattr(jd, f).shape, f
        assert getattr(td, f).dtype == getattr(jd, f).dtype, f
    assert td.z.shape == (B, 3, 2)
    assert np.isfinite(td.pz_x).all() and td.done[:, -1].all()


def _jax_raibert_obs(env, state):
    """The JAX collector's Raibert observation (its inner function)."""
    pz_x = env.rom.proj_z(state.robot.root_states)
    des_vel = env.traj_gen.get_v_trajectory(state.traj_gen)[:, -1, :2]
    return jnp.concatenate([state.trajectory[:, -1, :] - pz_x,
                            state.robot.v[:, :2], des_vel,
                            state.robot.base_quat], axis=-1)


def test_tracking_tick_matches_jax(envs):
    jenv, tenv = envs
    jstep = jax.jit(jenv.step)
    js, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    for _ in range(3):
        js, tr = jstep(js, jenv.raibert(_jax_raibert_obs(jenv, js)))
        jobs = tr.obs
    ts = hopper_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv)
    np.testing.assert_allclose(
        tcol.build_raibert_obs(tenv, ts).numpy(),
        np.asarray(_jax_raibert_obs(jenv, js)), rtol=1e-6, atol=1e-6)
    tg = js.traj_gen
    stable = ~np.asarray(tg.t + 5 * jenv.dt >= tg.t_final)
    done = np.zeros(B, bool)
    for _ in range(5):
        js, tr = jstep(js, jenv.raibert(_jax_raibert_obs(jenv, js)))
        done |= np.asarray(tr.done)
    j_rec = (np.asarray(js.trajectory[:, 0]),
             np.asarray(jenv.rom.proj_z(js.robot.root_states)),
             np.asarray(js.traj_gen.v))
    _, _, t_rec = tcol.tracking_tick(tenv, tenv.raibert, ts,
                                     torch.as_tensor(np.array(jobs)), 5,
                                     raibert_obs=True)
    np.testing.assert_array_equal(t_rec[3].numpy(), done)
    keep = stable & ~done
    assert keep.sum() >= B - 1, (stable, done)
    for a, b, name in zip(t_rec[:3], j_rec, ("z", "pz_x", "v")):
        np.testing.assert_allclose(a.numpy()[keep], b[keep], rtol=5e-4,
                                   atol=5e-4, err_msg=name)
