"""The port's robot model, kinematics, contact model, non-finite guard and
quaternion helpers against the JAX package, on the test robots of
tests/torch_robot_cases.py and numpy-drawn inputs.

Tolerances: model fields exact (same float64 parse, same float32 cast);
kinematics and contact forces rtol=atol=2e-5, as the JAX package holds its
own two substep paths (tests/test_pallas_substep.py); elementwise helpers
atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.core import maths as jmaths
from legged_gym_dev_tpu.envs.base import guard_finite_state as jax_guard
from legged_gym_dev_tpu.sim.contact import contact_forces as jax_contact
from legged_gym_dev_tpu.sim.dynamics import integrate as jax_integrate
from legged_gym_dev_tpu.sim.kinematics import (
    contact_kinematics as jax_contact_kin,
)
from legged_gym_dev_tpu_torch.core import maths
from legged_gym_dev_tpu_torch.envs.base import guard_finite_state
from legged_gym_dev_tpu_torch.sim.contact import ContactParams, contact_forces
from legged_gym_dev_tpu_torch.sim.dynamics import integrate
from legged_gym_dev_tpu_torch.sim.kinematics import contact_kinematics
from tests.torch_port_cases import jax_robot_sim, jax_robot_state
from tests.torch_robot_cases import (
    ROBOTS,
    substep_inputs,
    torch_sim,
    torch_state,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = ("origin_pos", "origin_rot", "axis", "mass", "com", "inertia",
          "q_lower", "q_upper", "effort_limit", "vel_limit",
          "contact_offset", "contact_radius", "gravity")
STATIC = ("nj", "parent", "jtype", "contact_body", "dof_names", "body_names",
          "contact_link_names")


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_model_from_spec_fields_exact(robot):
    jm, tm = jax_robot_sim(robot).model, torch_sim(robot).model
    for f in STATIC:
        assert getattr(jm, f) == getattr(tm, f), f
    for f in FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_quadruped_has_anymal_widths():
    m = torch_sim("quadruped").model
    assert (m.nj, m.nv, m.nb) == (12, 18, 13)
    assert m.dof_names[:3] == ("LF_HAA", "LF_HFE", "LF_KFE")
    # the fixed base_inertia and *_FOOT links merged into their parents
    assert len(m.body_names) == 13 and "LF_FOOT" not in m.body_names
    assert sum("FOOT" in n for n in m.contact_link_names) == 4


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_contact_kinematics_matches_jax(robot):
    inp = substep_inputs(robot, 8, seed=1)
    ref = jax_contact_kin(jax_robot_sim(robot).model, jax_robot_state(inp)[0])
    out = contact_kinematics(torch_sim(robot).model, torch_state(inp)[0])
    for a, b, name in zip(out, ref, ("pos", "vel", "Jc")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("dr", [False, True], ids=["nominal", "dr"])
def test_contact_forces_matches_jax(dr):
    """Flat-plane forces at spheres above, in and deep in the ground, with
    and without the envs' per-env friction (B,1,1) and stiffness/damping
    (B,1) rows."""
    B, nc = 16, 5
    rng = np.random.default_rng(2)
    pos = rng.normal(0, 0.3, (B, nc, 3)).astype(np.float32)
    pos[..., 2] = rng.uniform(-0.05, 0.1, (B, nc))
    vel = rng.normal(0, 1.0, (B, nc, 3)).astype(np.float32)
    radius = rng.uniform(0.02, 0.06, nc).astype(np.float32)
    kw = dict(stiffness=5000.0, damping=50.0, friction=0.8, slip_vel=0.1)
    if dr:
        kw.update(friction=rng.uniform(0.5, 1.25, (B, 1, 1)),
                  stiffness=5000.0 * rng.uniform(0.7, 1.3, (B, 1)),
                  damping=50.0 * rng.uniform(0.7, 1.3, (B, 1)))
        kw = {k: np.asarray(v, np.float32) for k, v in kw.items()}
    from legged_gym_dev_tpu.sim.contact import ContactParams as JaxContact

    ref = jax_contact(JaxContact.create(**kw), jnp.asarray(pos),
                      jnp.asarray(vel), jnp.asarray(radius))
    out = contact_forces(ContactParams.create(**kw, device="cpu"),
                         torch.as_tensor(pos), torch.as_tensor(vel),
                         torch.as_tensor(radius))
    assert float(np.abs(np.asarray(ref)).max()) > 10.0   # contact happens
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_non_flat_terrain_raises():
    """A height function without ``value_and_grad`` (a slope, h = 0.3 x)
    takes the autodiff route and matches JAX's ``jax.grad`` route; the
    substep kernel, which raises on it, is kept from it by
    ``supports_kernel``."""
    from legged_gym_dev_tpu.sim.contact import ContactParams as JaxContact
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    rng = np.random.default_rng(8)
    pos = rng.normal(0, 0.2, (3, 2, 3)).astype(np.float32)
    pos[..., 2] = 0.3 * pos[..., 0] + rng.uniform(-0.02, 0.01, (3, 2))
    vel = rng.normal(0, 0.5, (3, 2, 3)).astype(np.float32)
    radius = np.asarray([0.02, 0.03], np.float32)
    ref = jax_contact(JaxContact.create(), jnp.asarray(pos),
                      jnp.asarray(vel), jnp.asarray(radius),
                      lambda xy: 0.3 * xy[..., 0])
    out = contact_forces(ContactParams.create(device="cpu"),
                         torch.as_tensor(pos), torch.as_tensor(vel),
                         torch.as_tensor(radius),
                         terrain_fn=lambda xy: 0.3 * xy[..., 0])
    assert float(np.abs(np.asarray(ref)).max()) > 10.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    sim = torch_sim("quadruped")
    assert sk.supports_kernel(sim)
    assert not sk.supports_kernel(sim.replace(
        terrain_fn=lambda xy: 0.3 * xy[..., 0]))


def test_guard_finite_state_matches_jax():
    """A NaN env, an inf env, a 60 m/s env and healthy envs: the same
    envs are flagged and reset to the safe state in both packages."""
    inp = substep_inputs("quadruped", 6, seed=3)
    inp["v"][1, 7] = np.nan
    inp["base_pos"][2, 0] = np.inf
    inp["v"][3, 0] = 60.0          # finite but non-physical
    inp["v"][4, 4] = -49.0         # below the 50 m/s bar: healthy
    js, _ = jax_robot_state(inp)
    ts, _ = torch_state(inp)
    safe = substep_inputs("quadruped", 6, seed=4)
    rj, bad_j = jax_guard(js, jax_robot_state(safe)[0])
    rt, bad_t = guard_finite_state(ts, torch_state(safe)[0])
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bad_t.tolist() == [False, True, True, True, False, False]
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))


def test_integrate_and_root_states_match_jax():
    inp = substep_inputs("quadruped", 8, seed=5)
    qdd = np.random.default_rng(5).normal(0, 5, (8, 18)).astype(np.float32)
    js, _ = jax_robot_state(inp)
    ts, _ = torch_state(inp)
    rj = jax_integrate(None, js, jnp.asarray(qdd), 0.005)
    rt = integrate(None, ts, torch.as_tensor(qdd), 0.005)
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), atol=1e-6)
    np.testing.assert_allclose(rt.root_states.numpy(),
                               np.asarray(rj.root_states), atol=1e-6)


def test_maths_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    phi = (rng.normal(size=(32, 3)) * np.geomspace(1e-8, 1.0, 32)[:, None]
           ).astype(np.float32)
    ang = rng.uniform(-20, 20, 32).astype(np.float32)
    mask = rng.uniform(size=32) > 0.5
    pairs = [
        (maths.quat_normalize(torch.as_tensor(q)),
         jmaths.quat_normalize(jnp.asarray(q))),
        (maths.quat_mul(torch.as_tensor(qn), torch.as_tensor(qn[::-1].copy())),
         jmaths.quat_mul(jnp.asarray(qn), jnp.asarray(qn[::-1]))),
        (maths.quat_apply(torch.as_tensor(qn), torch.as_tensor(v)),
         jmaths.quat_apply(jnp.asarray(qn), jnp.asarray(v))),
        (maths.quat_to_rotmat(torch.as_tensor(q)),
         jmaths.quat_to_rotmat(jnp.asarray(q))),
        (maths.quat_to_yaw(torch.as_tensor(qn)),
         jmaths.quat_to_yaw(jnp.asarray(qn))),
        (maths.so3_exp(torch.as_tensor(phi)), jmaths.so3_exp(jnp.asarray(phi))),
        (maths.wrap_to_pi(torch.as_tensor(ang)),
         jmaths.wrap_to_pi(jnp.asarray(ang))),
        (maths.masked_update(torch.as_tensor(mask), torch.as_tensor(v),
                             torch.as_tensor(-v)),
         jmaths.masked_update(jnp.asarray(mask), jnp.asarray(v),
                              jnp.asarray(-v))),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   err_msg=str(i))


def test_rom_vel_inds_and_weighting_match_jax():
    from legged_gym_dev_tpu.core import make_rom as jax_make_rom
    from legged_gym_dev_tpu.envs.presets import RewardWeighting as JaxRW
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.envs.presets import RewardWeighting

    args = (0.1, [-1e9] * 4, [1e9] * 4, [-0.35] * 2, [0.35] * 2)
    for name, n in (("SingleInt2D", 2), ("DoubleInt2D", 4)):
        jr = jax_make_rom(name, *(a[:n] if isinstance(a, list) and len(a) == 4
                                  else a for a in args))
        tr = make_rom(name, *(a[:n] if isinstance(a, list) and len(a) == 4
                              else a for a in args), device="cpu")
        np.testing.assert_array_equal(tr.vel_inds.numpy(),
                                      np.asarray(jr.vel_inds))
        w = dict(position=2.0, velocity=0.5)
        np.testing.assert_array_equal(
            tr.weighting_vector(RewardWeighting(**w)).numpy(),
            np.asarray(jr.weighting_vector(JaxRW(**w))))
