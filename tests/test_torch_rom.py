"""Port of the plan ROM (SingleInt2D) and the closed-loop plant
(DoubleInt2D) against core/rom.py of the JAX package at random states:
array form, entry form and its exact Jacobians. Tolerance: atol 1e-6
(a few fp32 operations on O(1) values)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu_torch.core import make_rom

ATOL = 1e-6
ROMS = {
    "SingleInt2D": (0.1, [-10.0] * 2, [10.0] * 2, [-0.2] * 2, [0.2] * 2),
    "DoubleInt2D": (0.1, [-np.inf, -np.inf, -0.3, -0.3],
                    [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5]),
}


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(ROMS))
def test_array_form_matches_jax(name):
    jr = jax_make_rom(name, *ROMS[name])
    tr = make_rom(name, *ROMS[name], device="cpu")
    rng = np.random.default_rng(0)
    z = rng.normal(size=(7, tr.n)).astype(np.float32) * 0.3
    v = rng.normal(size=(7, tr.m)).astype(np.float32)
    x13 = rng.normal(size=(7, 13)).astype(np.float32)
    zt, vt = torch.as_tensor(z), torch.as_tensor(v)
    np.testing.assert_allclose(tr.f(zt, vt).numpy(),
                               np.asarray(jr.f(jnp.asarray(z),
                                               jnp.asarray(v))), atol=ATOL)
    np.testing.assert_allclose(
        tr.proj_z(torch.as_tensor(x13)).numpy(),
        np.asarray(jr.proj_z(jnp.asarray(x13))), atol=ATOL)
    np.testing.assert_allclose(
        tr.clip_v_z(zt, vt * 3).numpy(),
        np.asarray(jr.clip_v_z(jnp.asarray(z), jnp.asarray(v * 3))),
        atol=ATOL)


@pytest.mark.parametrize("name", sorted(ROMS))
def test_entry_form_matches_jax(name):
    jr = jax_make_rom(name, *ROMS[name])
    tr = make_rom(name, *ROMS[name], device="cpu")
    rng = np.random.default_rng(1)
    z = rng.normal(size=(tr.n, 4, 9)).astype(np.float32)
    v = rng.normal(size=(tr.m, 4, 9)).astype(np.float32)
    f_j = jr.f_entries([jnp.asarray(a) for a in z], [jnp.asarray(a) for a in v])
    f_t = tr.f_entries([torch.as_tensor(a) for a in z],
                       [torch.as_tensor(a) for a in v])
    for a, b in zip(f_t, f_j):
        np.testing.assert_allclose(as_np(a), np.asarray(b), atol=ATOL)
    (A_j, B_j) = jr.f_jac_entries(list(z), list(v))
    (A_t, B_t) = tr.f_jac_entries(list(z), list(v))
    for M_t, M_j in ((A_t, A_j), (B_t, B_j)):
        for row_t, row_j in zip(M_t, M_j):
            for a, b in zip(row_t, row_j):
                # symbolic zeros must stay symbolic: the solver skips them
                assert (isinstance(a, float) and a == 0.0) == (
                    isinstance(b, float) and b == 0.0)
                np.testing.assert_allclose(as_np(a), np.asarray(b),
                                           atol=ATOL)


def test_unported_roms_raise():
    with pytest.raises(NotImplementedError):
        make_rom("Unicycle", 0.1, [-1] * 3, [1] * 3, [-1] * 2, [1] * 2,
                 device="cpu")
    with pytest.raises(ValueError):
        make_rom("NoSuchRom", 0.1, [-1] * 2, [1] * 2, [-1] * 2, [1] * 2,
                 device="cpu")
