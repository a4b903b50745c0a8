"""``evaluate_velocity_tracking`` of the port against the JAX package's,
value for value, on the quadruped of tests/torch_robot_cases.py.

Both packages build the velocity task with ANYmal-C's settings at B=4,
observation noise off and pushes off (the push interval moved past the
run). Both evaluations start from JAX's reset state, carried to the port
with ``interop.velocity_env_state_from_numpy``: each env is wrapped so
that its reset returns that state. A fixed linear policy drawn with numpy
rolls ``STEPS`` steps inside the command-resampling interval, and no env
terminates, so no random draw reaches the state and the two rollouts see
the same inputs.

Tolerance: the mean planar tracking error to rtol 1e-4, the velocity
step's bar in tests/test_torch_envs.py (the six steps here chain their
substeps through contact; the two agree to 7.3e-8 relative); the stance
fractions and the done rate, counts of discrete events, exactly. The
policy's weights (normal, 0.5) make the quadruped stand on one foot in
about 44% of the counted env steps, so the stance statistics are not
trivially zero.

The JAX evaluation runs op by op (``jax.disable_jit``): compiling its scan
of env steps takes over a minute on the CPU.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu import evaluation as jev
from legged_gym_dev_tpu.envs.presets import _anymal_c_kwargs as jax_kwargs
from legged_gym_dev_tpu.envs.presets import (
    make_velocity_env as jax_make_velocity_env,
)
from legged_gym_dev_tpu_torch import evaluation as tev
from legged_gym_dev_tpu_torch.envs.presets import (
    _anymal_c_kwargs,
    make_velocity_env,
)
from legged_gym_dev_tpu_torch.interop import velocity_env_state_from_numpy
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import QUADRUPED_URDF

B = 4
STEPS, SETTLE = 6, 2
NO_PUSH_S = 1.0e6     # a push interval past the run


class CarriedReset:
    """``env`` with a reset that returns a fixed (state, observations)."""

    def __init__(self, env, state, obs):
        self._env, self._start = env, (state, obs)

    def reset(self, key):
        return self._start

    def __getattr__(self, name):
        return getattr(self._env, name)


def test_velocity_tracking_evaluation_matches_jax():
    kw = dict(num_envs=B, add_noise=False)
    jenv = jax_make_velocity_env(QUADRUPED_URDF, **jax_kwargs({}),
                                 **kw).replace(push_interval_s=NO_PUSH_S)
    tenv = make_velocity_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                             device="cpu", **kw).replace(
        push_interval_s=NO_PUSH_S)
    every = int(round(jenv.resampling_time_s / jenv.dt))
    assert STEPS < every < jenv.max_episode_length
    with jax.disable_jit():
        js, jobs = jenv.reset(jax.random.PRNGKey(3))
    assert not np.asarray(js.episode_step).any()
    ts = velocity_env_state_from_numpy(jax.tree.map(np.asarray, js), tenv)
    tobs = tenv._obs(ts)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-6)
    w = np.random.default_rng(0).normal(
        0.0, 0.5, (tenv.num_obs, tenv.num_actions)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    with jax.disable_jit():
        ref = jev.evaluate_velocity_tracking(
            CarriedReset(jenv, js, jobs), lambda obs: obs @ jw,
            jax.random.PRNGKey(0), steps=STEPS, settle=SETTLE)
    out = tev.evaluate_velocity_tracking(
        CarriedReset(tenv, ts, tobs), lambda obs: obs @ tw,
        torch.Generator().manual_seed(0), steps=STEPS, settle=SETTLE)
    assert list(out) == list(ref)
    # the premise: no env terminated, so no reset drew anything
    assert ref["done_rate_per_step"] == 0.0
    np.testing.assert_allclose(out["track_err_m_s"], ref["track_err_m_s"],
                               rtol=1e-4)
    for k in ("single_stance_frac", "single_stance_moving",
              "done_rate_per_step"):
        assert out[k] == ref[k], (k, out[k], ref[k])
    # the statistics are not trivially equal: the policy tracks badly and
    # often stands on one foot
    assert ref["track_err_m_s"] > 0.1 and ref["single_stance_frac"] > 0.1
