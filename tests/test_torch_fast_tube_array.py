"""The port's array-form staged solver (``fast_tube._assemble``,
``solve_tube_fast_single_array``) against the JAX package's, on the same
numpy-drawn gap batch (B=4, N=8, seed 2: away from a kink of the tube) and
the same staged warm start.

- ``_assemble``'s grad, D, L (and the NN tube's Woodbury factor) at the
  warm start with numpy-drawn multipliers, l1 and NN_oneshot: rtol 1e-5
  of the largest entry.
- The 8x6 schedule against JAX's array form (vmapped): iterates within
  2e-3 and each scenario's violation within 1e-4 of JAX's (the 8x6
  schedule leaves some scenarios above 1e-3 in the JAX package too, so the
  violation is held to the reference's, as in test_torch_fast_tube.py).
- The port's array form against its entry form (``solve_tube_fast_single``,
  the kernels' plain versions on the CPU): the same bars.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import fast_tube as jft
from legged_gym_dev_tpu_torch.solver import ALConfig
from legged_gym_dev_tpu_torch.solver import fast_tube as tft
from legged_gym_dev_tpu_torch.solver.trajopt import (
    get_tube_warm_start,
    get_warm_start,
)
from legged_gym_dev_tpu_torch.solver.tube_dynamics import get_tube_dynamics
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    gap_case,
    jax_call,
    jax_params,
    one_torch_thread,
    torch_params,
)

N, H_REV, B = 8, 10, 4
CFG = dict(outer_iters=8, inner_iters=6)


@pytest.fixture(scope="module", params=["l1", "NN_oneshot"])
def problem(request):
    tube = request.param
    case = gap_case(B, N, H_REV, tube, seed=2)
    pt, pj = torch_params(case), jax_params(case)
    sp = tft._staged_problem(pt, N, tube, 0.5, False)
    z, v = get_warm_start("interpolate", pt, N, ALConfig(**CFG))
    w = get_tube_warm_start("evaluate", get_tube_dynamics(tube, N, 0.5), z,
                            v, pt, N)
    u0 = tft.pack_staged(z, w, v, sp.n, sp.m, N)
    lb, ub = tft.staged_bounds(pt, sp.n, sp.m, N)
    return tube, sp, pt, pj, u0, lb, ub


def test_stage_layout():
    b, iz, iw, iv = tft._stage_layout(2, 2)
    assert (b, iz, iw, iv) == jft._stage_layout(2, 2)


def test_assemble_matches_jax(problem):
    tube, sp, pt, pj, u0, _, _ = problem
    rng = np.random.default_rng(0)
    E, I = N * sp.n + 2 + N, (N + 1) * sp.K
    lam = rng.normal(size=(B, E)).astype(np.float32)
    mu = np.abs(rng.normal(size=(B, I))).astype(np.float32)
    rho = np.full((B,), 100.0, np.float32)
    t_out = tft._assemble(sp, u0, pt, torch.as_tensor(lam),
                          torch.as_tensor(mu), torch.as_tensor(rho)[:, None])
    spj = jft.StagedProblem(*sp)
    j_out = jax_call(jax.vmap(lambda p, u, l, m, r: jft._assemble(
        spj, u, p, l, m, r)), pj, u0.numpy(), lam, mu, rho)
    assert (t_out[3] is None) == (tube == "l1")
    for name, a, b in zip(("grad", "D", "L", "U_nn"), t_out, j_out):
        if a is None:
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    m_t = tft._merit(sp, u0, pt, torch.as_tensor(lam), torch.as_tensor(mu),
                     torch.as_tensor(rho)[:, None])
    m_j = jax.vmap(lambda p, u, l, m, r: jft._merit(spj, u, p, l, m, r))(
        pj, u0.numpy(), lam, mu, rho)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5)


@pytest.fixture(scope="module")
def solved(problem):
    tube, sp, pt, pj, u0, lb, ub = problem
    out_t = tft.solve_tube_fast_single_array(sp, pt, u0, lb, ub,
                                             ALConfig(**CFG))
    spj = jft.StagedProblem(*sp)
    full = (u0.shape[0],) + tuple(lb.shape[-2:])

    def jax_solve(p, u, lo, hi):
        return jft.solve_tube_fast_single_array(spj, p, u, lo, hi,
                                                JaxConfig(**CFG))

    out_j = jax_call(jax.vmap(jax_solve), pj, u0.numpy(),
                     lb.expand(full).numpy(), ub.expand(full).numpy())
    return problem, out_t, out_j


def _held(out, ref):
    dx = np.abs(out.x.numpy() - np.asarray(ref.x)).max()
    dviol = np.abs(out.viol.numpy() - np.asarray(ref.viol)).max()
    assert dx < 2e-3, dx
    assert dviol < 1e-4, dviol


def test_array_solve_matches_jax(solved):
    (_, sp, *_), out_t, out_j = solved
    assert tuple(out_t.x.shape) == (B, (N + 1) * (sp.n + 1 + sp.m))
    for f in ("viol", "grad_norm", "obj", "rho"):
        assert bool(torch.isfinite(getattr(out_t, f)).all()), f
    _held(out_t, out_j)
    np.testing.assert_array_equal(out_t.outer_used.numpy(),
                                  np.asarray(out_j.outer_used))


def test_array_form_matches_entry_form(solved):
    (_, sp, pt, _, u0, lb, ub), out_a, _ = solved
    out_e = tft.solve_tube_fast_single(sp, pt, u0, lb, ub, ALConfig(**CFG))
    _held(out_a, out_e)
    np.testing.assert_allclose(out_a.obj.numpy(), out_e.obj.numpy(),
                               rtol=1e-3)
