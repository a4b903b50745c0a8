"""Port of the ROM zoo (core/rom.py: SingleInt2D, the plan ROM;
DoubleInt2D, the closed-loop plant; Unicycle, LateralUnicycle,
ExtendedUnicycle and ExtendedLateralUnicycle) against the JAX package at
random states: array form (``f``, ``proj_z``, ``des_pose_vel``, the
state-dependent input bounds and ``clip_v_z``, ``vel_inds``,
``weighting_vector``), entry form and its exact Jacobians. Tolerance: atol
1e-6 (a few fp32 operations on O(1) values)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu_torch.core import ROM_REGISTRY, make_rom
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 1e-6
ROMS = {
    "SingleInt2D": (0.1, [-10.0] * 2, [10.0] * 2, [-0.2] * 2, [0.2] * 2),
    "DoubleInt2D": (0.1, [-np.inf, -np.inf, -0.3, -0.3],
                    [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5]),
    "Unicycle": (0.1, [-10, -10, -4 * np.pi], [10, 10, 4 * np.pi], [-1, -2],
                 [1, 2]),
    "LateralUnicycle": (0.1, [-10, -10, -4 * np.pi], [10, 10, 4 * np.pi],
                        [-1, -0.5, -2], [1, 0.5, 2]),
    "ExtendedUnicycle": (0.1, [-10, -10, -4 * np.pi, -0.4, -0.6],
                         [10, 10, 4 * np.pi, 0.4, 0.6], [-2, -3], [2, 3]),
    "ExtendedLateralUnicycle": (
        0.1, [-10, -10, -4 * np.pi, -0.4, -0.3, -0.6],
        [10, 10, 4 * np.pi, 0.4, 0.3, 0.6], [-2, -1.5, -3], [2, 1.5, 3]),
}
WEIGHTS = SimpleNamespace(position=1.5, velocity=0.25, orientation=0.75,
                          angular_velocity=0.125)


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_registry_holds_the_zoo():
    assert sorted(ROM_REGISTRY) == sorted(ROMS)


@pytest.mark.parametrize("name", sorted(ROMS))
def test_array_form_matches_jax(name):
    jr = jax_make_rom(name, *ROMS[name])
    tr = make_rom(name, *ROMS[name], device="cpu")
    rng = np.random.default_rng(0)
    z = rng.normal(size=(7, tr.n)).astype(np.float32) * 0.3
    v = rng.normal(size=(7, tr.m)).astype(np.float32)
    x13 = rng.normal(size=(7, 13)).astype(np.float32)
    x13[:, 3:7] /= np.linalg.norm(x13[:, 3:7], axis=-1, keepdims=True)
    zt, vt = torch.as_tensor(z), torch.as_tensor(v)
    zj, vj = jnp.asarray(z), jnp.asarray(v)
    np.testing.assert_allclose(tr.f(zt, vt).numpy(), np.asarray(jr.f(zj, vj)),
                               atol=ATOL)
    np.testing.assert_allclose(
        tr.proj_z(torch.as_tensor(x13)).numpy(),
        np.asarray(jr.proj_z(jnp.asarray(x13))), atol=ATOL)
    for a, b in zip(tr.des_pose_vel(zt, vt), jr.des_pose_vel(zj, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert tr.vel_inds.tolist() == np.asarray(jr.vel_inds).tolist()
    np.testing.assert_array_equal(tr.weighting_vector(WEIGHTS).numpy(),
                                  np.asarray(jr.weighting_vector(WEIGHTS)))


@pytest.mark.parametrize("name", sorted(ROMS))
def test_input_bounds_and_clip_match_jax(name):
    """State-dependent input bounds (velocity states near their bounds
    shrink the inputs) and the clip against them."""
    jr = jax_make_rom(name, *ROMS[name])
    tr = make_rom(name, *ROMS[name], device="cpu")
    rng = np.random.default_rng(3)
    z = rng.uniform(-0.5, 0.5, size=(9, tr.n)).astype(np.float32)
    v = rng.normal(size=(9, tr.m)).astype(np.float32) * 3
    lo_t, hi_t = tr.compute_state_dependent_input_bounds(torch.as_tensor(z))
    lo_j, hi_j = jr.compute_state_dependent_input_bounds(jnp.asarray(z))
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=ATOL)
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), atol=ATOL)
    np.testing.assert_allclose(
        tr.clip_v_z(torch.as_tensor(z), torch.as_tensor(v)).numpy(),
        np.asarray(jr.clip_v_z(jnp.asarray(z), jnp.asarray(v))), atol=ATOL)


@pytest.mark.parametrize("name", sorted(ROMS))
def test_entry_form_matches_jax(name):
    jr = jax_make_rom(name, *ROMS[name])
    tr = make_rom(name, *ROMS[name], device="cpu")
    rng = np.random.default_rng(1)
    z = rng.normal(size=(tr.n, 4, 9)).astype(np.float32)
    v = rng.normal(size=(tr.m, 4, 9)).astype(np.float32)
    zt = [torch.as_tensor(a) for a in z]
    vt = [torch.as_tensor(a) for a in v]
    zj = [jnp.asarray(a) for a in z]
    vj = [jnp.asarray(a) for a in v]
    for a, b in zip(tr.f_entries(zt, vt), jr.f_entries(zj, vj)):
        np.testing.assert_allclose(as_np(a), np.asarray(b), atol=ATOL)
    (A_j, B_j) = jr.f_jac_entries(zj, vj)
    (A_t, B_t) = tr.f_jac_entries(zt, vt)
    for M_t, M_j in ((A_t, A_j), (B_t, B_j)):
        for row_t, row_j in zip(M_t, M_j):
            for a, b in zip(row_t, row_j):
                # symbolic zeros must stay symbolic: the solver skips them
                assert (isinstance(a, float) and a == 0.0) == (
                    isinstance(b, float) and b == 0.0)
                np.testing.assert_allclose(as_np(a), np.asarray(b),
                                           atol=ATOL)


def test_unknown_rom_raises():
    with pytest.raises(ValueError):
        make_rom("NoSuchRom", 0.1, [-1] * 2, [1] * 2, [-1] * 2, [1] * 2,
                 device="cpu")
