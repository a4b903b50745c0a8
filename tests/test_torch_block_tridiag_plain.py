"""The port's plain block-Thomas (``solver/block_tridiag.py``) against the
JAX package's on random SPD block systems (numpy draws): S=51 stages,
b in {5, 7, 10}, a batch of 3 (JAX vmapped). ``small_cholesky``, the
factor, the solve, the matvec and ``woodbury_solve`` (rank 6): rtol 1e-5
(atol 1e-5 of the largest entry, where entries cross zero)."""
import numpy as np
import pytest
import torch

import jax

from legged_gym_dev_tpu.solver import block_tridiag as jbt
from legged_gym_dev_tpu_torch.solver import block_tridiag as tbt
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    jax_call,
    one_torch_thread,
)

S, BATCH, R = 51, 3, 6


def system(b, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(BATCH, S, b, b))
    D = A @ A.transpose(0, 1, 3, 2) + 4.0 * b * np.eye(b)
    L = rng.normal(size=(BATCH, S - 1, b, b))
    rhs = rng.normal(size=(BATCH, S, b))
    U = 0.3 * rng.normal(size=(BATCH, S, b, R))
    return [x.astype(np.float32) for x in (D, L, rhs, U)]


def close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                               atol=1e-5 * np.abs(j).max())


@pytest.fixture(scope="module", params=[5, 7, 10])
def case(request):
    b = request.param
    D, L, rhs, U = system(b, seed=b)
    jfac = jax_call(jax.vmap(jbt.block_tridiag_factor), D, L)
    tfac = tbt.block_tridiag_factor(torch.as_tensor(D), torch.as_tensor(L))
    return b, (D, L, rhs, U), jfac, tfac


def test_small_cholesky_matches_jax(case):
    _, (D, *_), _, _ = case
    M = D[:, :7]
    c = tbt.small_cholesky(torch.as_tensor(M))
    close(c, jax_call(jbt.small_cholesky, M))
    # lower triangular, and c c^T = M
    assert float(torch.triu(c, 1).abs().max()) == 0.0
    close(c @ c.transpose(-1, -2), M)


def test_factor_matches_jax(case):
    _, _, jfac, tfac = case
    close(tfac.chol, jfac.chol)
    close(tfac.L, jfac.L)


def test_solve_and_matvec_match_jax(case):
    _, (D, L, rhs, _), jfac, tfac = case
    x = tbt.block_tridiag_solve(tfac, torch.as_tensor(rhs))
    close(x, jax_call(jax.vmap(jbt.block_tridiag_solve), jfac, rhs))
    Tx = tbt.block_tridiag_matvec(torch.as_tensor(D), torch.as_tensor(L), x)
    close(Tx, jax_call(jax.vmap(jbt.block_tridiag_matvec), D, L, x.numpy()))
    close(Tx, rhs)


def test_woodbury_matches_jax(case):
    _, (D, L, rhs, U), jfac, tfac = case
    x = tbt.woodbury_solve(tfac, torch.as_tensor(U), torch.as_tensor(rhs))
    close(x, jax_call(jax.vmap(jbt.woodbury_solve), jfac, U, rhs))
    # (T + U U^T) x = rhs
    Ut = torch.as_tensor(U)
    lhs = (tbt.block_tridiag_matvec(torch.as_tensor(D), torch.as_tensor(L),
                                    x)
           + torch.einsum("nsbr,nr->nsb", Ut,
                          torch.einsum("nsbr,nsb->nr", Ut, x)))
    close(lhs, rhs)


def test_single_instance_form():
    """Without a batch axis, as the JAX functions take one system."""
    D, L, rhs, _ = system(5, seed=11)
    fac = tbt.block_tridiag_factor(torch.as_tensor(D[0]),
                                   torch.as_tensor(L[0]))
    close(tbt.block_tridiag_solve(fac, torch.as_tensor(rhs[0])),
          jax_call(lambda d, l, r: jbt.block_tridiag_solve(
              jbt.block_tridiag_factor(d, l), r), D[0], L[0], rhs[0]))
