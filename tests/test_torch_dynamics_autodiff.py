"""The port's autodiff dynamics (``sim/dynamics.py``: the mass matrix,
bias forces and contact kinematics by ``torch.func``, ``solve_qdd`` and
``forward_dynamics``) against the JAX package's, on the test hopper (nj=4,
a prismatic foot) and the 12-joint test quadruped, B=4, from numpy-drawn
states with random base orientations. Bar: rtol 1e-4 / atol 1e-5 of the
largest entry. The port's autodiff forms are also held to its analytic
``sim/kinematics.py`` (the cross-check they exist for), at the same bar.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.sim import dynamics as jdyn
from legged_gym_dev_tpu_torch.sim import dynamics as tdyn
from legged_gym_dev_tpu_torch.sim import kinematics as tkin
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    jax_call,
    jax_robot_sim,
    jax_robot_state,
    one_torch_thread,
)
from tests.torch_robot_cases import substep_inputs, torch_sim, torch_state

B = 4
AUTODIFF = ("mass_matrix_autodiff", "bias_forces_autodiff",
            "contact_kinematics_autodiff")


def close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=1e-4,
                               atol=1e-5 * max(np.abs(j).max(), 1.0))


@pytest.fixture(scope="module", params=["hopper", "quadruped"])
def robot(request):
    inp = substep_inputs(request.param, B, seed=3)
    rng = np.random.default_rng(1)
    quat = rng.normal(size=(B, 4))
    inp["base_quat"] = (quat / np.linalg.norm(quat, axis=1,
                                              keepdims=True)).astype(
        np.float32)
    jsim = jax_robot_sim(request.param)
    tsim = torch_sim(request.param)
    return (jsim.model, *jax_robot_state(inp), tsim.model,
            *torch_state(inp))


@pytest.mark.parametrize("name", AUTODIFF)
def test_autodiff_forms_match_jax(robot, name):
    jm, js, _, tm, ts, _ = robot
    t_out = getattr(tdyn, name)(tm, ts)
    j_out = jax_call(lambda st: getattr(jdyn, name)(jm, st), js)
    if not isinstance(t_out, tuple):
        t_out, j_out = (t_out,), (j_out,)
    for a, b in zip(t_out, j_out):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, b)


def test_autodiff_forms_match_the_analytic_ones(robot):
    _, _, _, tm, ts, _ = robot
    close(tdyn.mass_matrix_autodiff(tm, ts), tdyn.mass_matrix(tm, ts))
    close(tdyn.bias_forces_autodiff(tm, ts), tdyn.bias_forces(tm, ts))
    for a, b in zip(tdyn.contact_kinematics_autodiff(tm, ts),
                    tkin.contact_kinematics(tm, ts)):
        close(a, b)
    M = tdyn.mass_matrix(tm, ts)
    close(M, M.transpose(-1, -2))


def test_bias_forces_first_on_a_fresh_model():
    """The bias forces as the first autodiff call on a new model: its
    constants are loaded before the transforms run, so none is first made
    inside one transform's level and read from another."""
    inp = substep_inputs("hopper", 2, seed=5)
    model = torch_sim("hopper").model
    st, _ = torch_state(inp)
    close(tdyn.bias_forces_autodiff(model, st), tkin.bias_forces(model, st))


def test_fk_and_body_jacobians_match_jax(robot):
    jm, js, _, tm, ts, _ = robot
    from legged_gym_dev_tpu.core.maths import quat_to_rotmat as jrot
    from legged_gym_dev_tpu_torch.core.maths import quat_to_rotmat as trot

    j_fk = jax_call(lambda p, q4, q: jdyn.fk(jm, p, q4, q),
                    js.base_pos[0], js.base_quat[0], js.q[0])
    for a, b in zip(tdyn.fk(tm, ts.base_pos[0], ts.base_quat[0], ts.q[0]),
                    j_fk):
        close(a, b)
    t_out = tdyn._body_jacobians(tm, ts.base_pos[1], trot(ts.base_quat[1]),
                                 ts.q[1])
    j_out = jax_call(lambda p, q4, q: jdyn._body_jacobians(jm, p, jrot(q4),
                                                           q),
                     js.base_pos[1], js.base_quat[1], js.q[1])
    for a, b in zip(t_out, j_out):
        close(a, b)


def test_solve_qdd_and_forward_dynamics_match_jax(robot):
    jm, js, jtau, tm, ts, ttau = robot
    rng = np.random.default_rng(2)
    f_ext = rng.normal(0, 5.0, (B, tm.nv)).astype(np.float32)
    qdd_t = tdyn.forward_dynamics(tm, ts, ttau, torch.as_tensor(f_ext))
    qdd_j = jdyn.forward_dynamics(jm, js, jtau, jnp.asarray(f_ext))
    close(qdd_t, qdd_j)
    M = tdyn.mass_matrix(tm, ts)
    rhs = torch.as_tensor(rng.normal(size=(B, tm.nv)).astype(np.float32))
    x = tdyn.solve_qdd(M, rhs)
    close(x, jdyn.solve_qdd(jnp.asarray(M.numpy()), jnp.asarray(rhs.numpy())))
    # M x = rhs up to the 1e-6 relative regularization
    close((M @ x[..., None])[..., 0], rhs)
