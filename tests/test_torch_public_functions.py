"""Four small public functions of the JAX package and their counterparts in
the port, on the same numpy inputs.

- ``sim.kinematics.dynamics_terms``: M, bias, contact positions,
  velocities and Jacobian on every test robot, at the kinematics tests'
  tolerance (rtol=atol=2e-5, tests/test_torch_sim.py).
- ``envs.base.scaled_reward_terms`` / ``compute_total_reward``: the dt
  scaling, zero-scale and ``termination`` terms left out, an unknown term
  refused, the clip at 0, the termination term added after the clip
  (float32 sums, rtol 1e-6).
- ``core.maths.torch_rand_sqrt_float``: its signed-sqrt map against the
  JAX function on one given uniform draw (JAX's ``jax.random.uniform``
  replaced by that draw; atol 1e-6), then the port's own draw from a
  ``torch.Generator`` for range, shape and device (generator streams of
  the two packages are not matched).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import maths as jmaths
from legged_gym_dev_tpu.envs import base as jbase
from legged_gym_dev_tpu.sim.kinematics import (
    dynamics_terms as jax_dynamics_terms,
)
from legged_gym_dev_tpu_torch.core import maths
from legged_gym_dev_tpu_torch.envs import base
from legged_gym_dev_tpu_torch.sim.kinematics import dynamics_terms
from tests.torch_port_cases import jax_robot_sim, jax_robot_state
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import (
    ROBOTS,
    substep_inputs,
    torch_sim,
    torch_state,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_dynamics_terms_match_jax(robot):
    inp = substep_inputs(robot, 6, seed=3)
    ref = jax_dynamics_terms(jax_robot_sim(robot).model,
                             jax_robot_state(inp)[0])
    out = dynamics_terms(torch_sim(robot).model, torch_state(inp)[0])
    assert len(out) == len(ref) == 5
    for a, b, name in zip(out, ref, ("M", "bias", "pos", "vel", "Jc")):
        assert tuple(a.shape) == np.shape(b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def _terms(xp):
    """A term table over a state dict of arrays (``xp``: jnp or torch)."""
    return {
        "tracking": lambda env, s: s["a"] * 2.0,
        "torques": lambda env, s: -s["b"] ** 2,
        "feet_air_time": lambda env, s: s["a"] - s["b"],
        "termination": lambda env, s: xp.where(s["done"], 1.0, 0.0),
    }


SCALES = {"tracking": 1.5, "torques": -0.2, "feet_air_time": 0.0,
          "termination": -50.0}


@pytest.mark.parametrize("only_positive", [False, True])
@pytest.mark.parametrize("with_termination", [False, True])
def test_reward_terms_and_total_match_jax(only_positive, with_termination):
    rng = np.random.default_rng(5)
    st = {"a": rng.normal(0, 1, 16).astype(np.float32),
          "b": rng.normal(0, 1, 16).astype(np.float32),
          "done": rng.uniform(size=16) < 0.3}
    dt = 0.02
    jt = jbase.scaled_reward_terms(_terms(jnp), SCALES, dt)
    tt = base.scaled_reward_terms(_terms(torch), SCALES, dt)
    assert [(n, s) for n, _, s in tt] == [(n, s) for n, _, s in jt]
    assert [n for n, _, _ in tt] == ["tracking", "torques"]
    term_kw = {}
    if with_termination:
        term_kw = dict(termination_scale=SCALES["termination"])
    j_total, j_ep = jbase.compute_total_reward(
        jt, None, {k: jnp.asarray(v) for k, v in st.items()},
        only_positive=only_positive,
        termination_fn=_terms(jnp)["termination"] if term_kw else None,
        **term_kw)
    t_total, t_ep = base.compute_total_reward(
        tt, None, {k: torch.as_tensor(v) for k, v in st.items()},
        only_positive=only_positive,
        termination_fn=_terms(torch)["termination"] if term_kw else None,
        **term_kw)
    np.testing.assert_allclose(t_total.numpy(), np.asarray(j_total),
                               rtol=1e-6)
    assert t_ep.keys() == j_ep.keys()
    for k in t_ep:
        np.testing.assert_allclose(t_ep[k].numpy(), np.asarray(j_ep[k]),
                                   rtol=1e-6)
    if with_termination and only_positive:
        # the termination term is added after the clip: totals go below 0
        assert float(t_total.min()) < 0.0


def test_reward_terms_refuse_an_unknown_term():
    for mod, xp in ((jbase, jnp), (base, torch)):
        with pytest.raises(ValueError, match="not in table"):
            mod.scaled_reward_terms(_terms(xp), {"nope": 1.0}, 0.02)
    # nothing active: both totals are 0 (clipped or not)
    for only_positive in (False, True):
        total, ep = base.compute_total_reward([], None, {},
                                              only_positive=only_positive)
        ref, _ = jbase.compute_total_reward([], None, {},
                                            only_positive=only_positive)
        assert float(total) == float(ref) == 0.0 and ep == {}


def test_rand_sqrt_float_map_matches_jax(monkeypatch):
    u = np.concatenate([[-1.0, -0.25, 0.0, 0.25, 1.0],
                        np.random.default_rng(9).uniform(-1, 1, 59)])
    u = u.astype(np.float32).reshape(8, 8)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval, maxval: jnp.asarray(u))
    for lower, upper in ((-2.0, 3.0), (0.5, 1.5)):
        ref = np.asarray(jmaths.torch_rand_sqrt_float(
            jax.random.PRNGKey(0), lower, upper, u.shape))
        ours = maths._signed_sqrt_to_range(torch.as_tensor(u), lower, upper)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    # the ends and the midpoint of the interval
    np.testing.assert_allclose(ours.numpy().reshape(-1)[:5],
                               [0.5, 0.75, 1.0, 1.25, 1.5], atol=1e-6)


def test_rand_sqrt_float_draw_range_and_shape():
    gen = torch.Generator().manual_seed(0)
    out = maths.torch_rand_sqrt_float(gen, -2.0, 3.0, (1000,))
    assert out.shape == (1000,) and out.dtype == torch.float32
    assert out.device.type == "cpu"
    assert float(out.min()) >= -2.0 and float(out.max()) <= 3.0
    # the signed sqrt pushes samples toward the ends: fewer in the middle
    # half than a uniform draw puts there (0.5), about 0.25
    mid = float(((out > -0.75) & (out < 1.75)).float().mean())
    assert 0.15 < mid < 0.35
    again = maths.torch_rand_sqrt_float(torch.Generator().manual_seed(0),
                                        -2.0, 3.0, (1000,))
    assert torch.equal(out, again)
