"""The port's blocked capacitance Cholesky (ops/blocked_chol.py) against the
JAX package's on numpy-drawn SPD systems shaped like the NN tube's Woodbury
capacitance C = I + U^T Hb^{-1} U (B, N, N), for each panel size the solver
picks (``staged_scalar._cap_psize``) and for vector and matrix right-hand
sides. Tolerance: 1e-5 relative to the largest entry (fp32, n <= 50)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.ops.blocked_chol import (
    blocked_cho_solve as jax_cho_solve,
)
from legged_gym_dev_tpu.ops.blocked_chol import (
    blocked_cholesky as jax_cholesky,
)
from legged_gym_dev_tpu_torch.ops.blocked_chol import (
    blocked_cho_solve,
    blocked_cholesky,
)
from legged_gym_dev_tpu_torch.solver.staged_scalar import _cap_psize
from tests.torch_port_cases import one_torch_thread  # noqa: F401


def rel_err(t, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(t, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("B,n,k", [(4, 50, 0), (3, 20, 3), (2, 12, 1)])
def test_blocked_cholesky_matches_jax(B, n, k):
    p = _cap_psize(n)
    rng = np.random.default_rng(n)
    U = rng.normal(size=(B, 3 * n, n)).astype(np.float32) / np.sqrt(n)
    C = (np.eye(n, dtype=np.float32)
         + np.einsum("bsi,bsj->bij", U, U)).astype(np.float32)
    rhs = rng.normal(size=(B, n) if k == 0 else (B, n, k)).astype(np.float32)
    Lj = jax_cholesky(jnp.asarray(C), p=p)
    xj = jax_cho_solve(Lj, jnp.asarray(rhs), p=p)
    Lt = blocked_cholesky(torch.as_tensor(C), p=p)
    xt = blocked_cho_solve(Lt, torch.as_tensor(rhs), p=p)
    assert rel_err(Lt.numpy(), Lj) <= 1e-5
    assert rel_err(xt.numpy(), xj) <= 1e-5
    assert tuple(xt.shape) == rhs.shape


def test_panel_must_divide():
    with pytest.raises(ValueError):
        blocked_cholesky(torch.eye(7)[None], p=5)
