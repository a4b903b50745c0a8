"""Port of the single-RHS block-tridiagonal solve (kernel bt_solve, for the
TPU's K1 entry-form and K1b array-form wrappers) against the JAX package's
Pallas wrappers in interpret mode, as tests/test_pallas_ops.py runs them;
and the port's entry-form block-Thomas ("thomas") against the JAX one.

The entry form at b=10 and the main path's S=51 is held to the JAX
package's XLA solve (``solver/block_tridiag``, vmapped), the reference
tests/test_pallas_ops.py holds the Pallas kernel to: in interpret mode
that case took 34 s.

Tolerance: atol 3e-5 on O(1) solutions of well-conditioned fp32 systems
(the same bar as test_pallas_ops.py's multi-RHS check; the two sides sum
in different orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.ops.pallas_block_tridiag import (
    block_tridiag_solve_pallas,
    block_tridiag_solve_pallas_entries,
)
from legged_gym_dev_tpu.solver.block_tridiag import (
    block_tridiag_factor,
    block_tridiag_solve,
)
from legged_gym_dev_tpu.solver.staged_scalar import (
    factor_solve_entries as jax_factor_solve_entries,
)
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from legged_gym_dev_tpu_torch.solver.staged_scalar import (
    factor_solve_entries,
)
from tests.test_torch_kernels_cuda import entry_lists, make_systems
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 3e-5
SHAPES = [(8, 12, 5), (16, 51, 5), (4, 6, 3)]
# the entry form (the solver's) also at every other staged block size of
# the ROM zoo, and at b=10 at the zoo's stage count; the array form is the
# same kernel behind another table
ZOO_SHAPES = [(4, 6, 6), (4, 6, 7), (4, 6, 8), (4, 7, 10),
              (2, 51, 10)]


@pytest.mark.parametrize("B,S,b", SHAPES + ZOO_SHAPES)
def test_entries_plain_matches_pallas(B, S, b):
    D, L, rhs = make_systems(B, S, b, seed=B)
    if (S, b) == (51, 10):      # JAX's XLA solve of every scenario
        x_ref = np.moveaxis(np.asarray(jax.jit(jax.vmap(
            lambda d, l, r: block_tridiag_solve(block_tridiag_factor(d, l),
                                                r)))(
            jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs[..., 0]))),
            -1, 0)
    else:
        Dj, Lj = entry_lists(D, L, jnp.asarray)
        x_ref = block_tridiag_solve_pallas_entries(
            Dj, Lj, [jnp.asarray(rhs[:, :, i, 0]) for i in range(b)], b,
            tile_b=4, interpret=True)
    Dt, Lt = entry_lists(D, L, torch.as_tensor)
    r = [torch.as_tensor(rhs[:, :, i, 0]) for i in range(b)]
    x = btk.block_tridiag_solve_entries_plain(Dt, Lt, r, b)
    for i in range(b):
        np.testing.assert_allclose(x[i].numpy(), np.asarray(x_ref[i]),
                                   atol=ATOL, err_msg=f"entry {i}")
    # the wrapper takes the plain version on CPU tensors, and only there
    xw = btk.block_tridiag_solve_entries(Dt, Lt, r, b)
    for i in range(b):
        assert torch.equal(xw[i], x[i])


@pytest.mark.parametrize("B,S,b", SHAPES)
def test_array_form_plain_matches_pallas(B, S, b):
    D, L, rhs = make_systems(B, S, b, seed=B + 1)
    x_ref = block_tridiag_solve_pallas(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs[..., 0]),
        tile_b=min(4, B), interpret=True)
    x = btk.block_tridiag_solve(torch.as_tensor(D), torch.as_tensor(L),
                                torch.as_tensor(rhs[..., 0]))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=ATOL)


@pytest.mark.parametrize("S,b,R", [(1, 3, 1), (7, 4, 1), (21, 5, 1),
                                   (21, 5, 6)])
def test_thomas_entries_match_jax(S, b, R):
    """The "thomas" linsolve (entry-form block-Thomas with symbolic zeros,
    single and multi-RHS) against the JAX factor_solve_entries; one
    scenario per JAX call, a batch of 3 in the port."""
    B = 3
    D, L, rhs = make_systems(B, S, b, R, seed=S * 10 + b)
    zero_rows = {0}                      # symbolic-zero sub-diagonal rows
    out_ref = []
    for s in range(B):
        D_e = [[jnp.asarray(D[s, :, i, j]) for j in range(i + 1)]
               for i in range(b)]
        L_e = [[0.0 if (i in zero_rows or S == 1)
                else jnp.asarray(L[s, :, i, j]) for j in range(b)]
               for i in range(b)]
        rhs_e = [jnp.asarray(rhs[s, :, i] if R > 1 else rhs[s, :, i, 0])
                 for i in range(b)]
        out_ref.append(np.stack([np.asarray(x) for x in
                                 jax_factor_solve_entries(D_e, L_e, rhs_e,
                                                          b)], 1))
    D_e = [[torch.as_tensor(D[:, :, i, j]) for j in range(i + 1)]
           for i in range(b)]
    L_e = [[0.0 if (i in zero_rows or S == 1)
            else torch.as_tensor(L[:, :, i, j]) for j in range(b)]
           for i in range(b)]
    rhs_e = [torch.as_tensor(rhs[:, :, i] if R > 1 else rhs[:, :, i, 0])
             for i in range(b)]
    out = torch.stack(factor_solve_entries(D_e, L_e, rhs_e, b), 2).numpy()
    np.testing.assert_allclose(out, np.stack(out_ref), atol=ATOL)


def test_wrappers_reject_other_devices():
    D, L, rhs = make_systems(2, 4, 5, seed=3)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a).to("meta"))
    r = [torch.as_tensor(rhs[:, :, i, 0]).to("meta") for i in range(5)]
    with pytest.raises(RuntimeError, match="no kernel"):
        btk.block_tridiag_solve_entries(Dt, Lt, r, 5)
