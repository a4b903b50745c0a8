"""Port of the factor-once multi-RHS block-tridiagonal solve (kernels
bt_factor + bt_msolve, for the TPU's K2 wrapper) against the JAX Pallas
wrapper in interpret mode, including column counts R that are not
multiples of the TPU's chunk of 4; at b=10 and the main path's S=51,
against the JAX package's XLA solve (``solver/block_tridiag``, vmapped
over scenarios and columns), the reference tests/test_pallas_ops.py holds
the Pallas kernel to: in interpret mode those two cases took 35 and 56 s.
Tolerance: atol 3e-5, as
tests/test_pallas_ops.py::test_multirhs_pallas_matches_xla."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.ops.pallas_block_tridiag import (
    block_tridiag_multirhs_pallas_entries,
)
from legged_gym_dev_tpu.solver.block_tridiag import (
    block_tridiag_factor,
    block_tridiag_solve,
)
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from tests.test_torch_kernels_cuda import entry_lists, make_systems
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 3e-5


@jax.jit
def xla_multirhs(D, L, rhs):
    """JAX's XLA factor and solve (``solver/block_tridiag``) of every
    scenario and column: (B, S, b, R)."""
    fac = jax.vmap(block_tridiag_factor)(D, L)
    return jax.vmap(jax.vmap(block_tridiag_solve, in_axes=(None, -1),
                             out_axes=-1))(fac, rhs)


@pytest.mark.parametrize("B,S,b,R", [(8, 12, 5, 7), (16, 51, 5, 11),
                                     (4, 6, 3, 5), (4, 6, 6, 3),
                                     (4, 6, 7, 5), (4, 6, 8, 3),
                                     (4, 7, 10, 5), (2, 51, 10, 3),
                                     (2, 51, 10, 50)])
def test_multirhs_plain_matches_pallas(B, S, b, R):
    """The plain version against JAX's kernel in interpret mode, up to
    b=10 at the main path's S=51 and R=50 (the plain version the CUDA
    kernels at b=10 are held to on the card), there against JAX's XLA
    solve."""
    D, L, rhs = make_systems(B, S, b, R, seed=B + 100)
    if (S, b) == (51, 10):
        x_ref = np.moveaxis(np.asarray(xla_multirhs(
            jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs))), 2, 0)
    else:
        Dj, Lj = entry_lists(D, L, jnp.asarray)
        x_ref = block_tridiag_multirhs_pallas_entries(
            Dj, Lj, [jnp.asarray(rhs[:, :, i, :]) for i in range(b)], b,
            rhs_chunk=4, tile_b=4, interpret=True)
    Dt, Lt = entry_lists(D, L, torch.as_tensor)
    cols = [torch.as_tensor(rhs[:, :, i, :]) for i in range(b)]
    x = btk.block_tridiag_multirhs_entries(Dt, Lt, cols, b)
    for i in range(b):
        assert tuple(x[i].shape) == (B, S, R)
        np.testing.assert_allclose(x[i].numpy(), np.asarray(x_ref[i]),
                                   atol=ATOL, err_msg=f"entry {i}")


def test_multirhs_matches_single_rhs_columns():
    """Each column of the multi-RHS solve equals the single-RHS solve of
    that column (plain versions; same factor, same substitution)."""
    B, S, b, R = 5, 9, 5, 3
    D, L, rhs = make_systems(B, S, b, R, seed=11)
    Dt, Lt = entry_lists(D, L, torch.as_tensor)
    cols = [torch.as_tensor(rhs[:, :, i, :]) for i in range(b)]
    x = btk.block_tridiag_multirhs_entries(Dt, Lt, cols, b)
    for c in range(R):
        xc = btk.block_tridiag_solve_entries(
            Dt, Lt, [col[:, :, c] for col in cols], b)
        for i in range(b):
            torch.testing.assert_close(x[i][:, :, c], xc[i], atol=1e-6,
                                       rtol=1e-6)
