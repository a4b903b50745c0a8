"""The port's verdicts (restoration.certify_staged_batched) against the JAX
package's on the batch of tests/test_restoration.py::test_batched_verdicts_mixed:
the gap problem (feasible) beside an obstacle set that walls off the start
(locally infeasible), l1 tube, N=20, the default 20x10 schedule.

Bar: equal verdict codes; the feasible scenario restores to a violation
below 1e-3 on both sides.
"""
import numpy as np
import pytest
import torch

import jax

from legged_gym_dev_tpu.solver import PROBLEM_DICT
from legged_gym_dev_tpu.solver import (
    certify_staged_batched as jax_certify_batched,
)
from legged_gym_dev_tpu.solver.fast_tube import StagedProblem as JaxProblem
from legged_gym_dev_tpu.solver.fast_tube import (
    solve_tube_fast_batched as jax_solve_batched,
)
from legged_gym_dev_tpu.solver.fast_tube import staged_bounds as jax_bounds
from legged_gym_dev_tpu_torch.solver import (
    VERDICT_FEASIBLE,
    VERDICT_INFEASIBLE,
    StagedProblem,
    certify_staged_batched,
    solve_tube_fast_batched,
    staged_bounds,
)
from tests.torch_port_cases import jax_params, torch_params
from tests.torch_port_cases import one_torch_thread  # noqa: F401

N, H_REV = 20, 10
PROB = PROBLEM_DICT["gap"]
KW = dict(tube_kind="l1", scaling=0.5, warm_start="interpolate",
          tube_ws="evaluate")


def mixed_case():
    f32 = np.float32
    return dict(
        N=N, H_rev=H_REV, tube="l1", Qw=0.0, mlp=None,
        z0=np.array([PROB["start"], [0.3, 0.3]], f32),
        zf=np.array([PROB["goal"], [1.5, 1.5]], f32),
        obs_c=np.array([PROB["obs"]["c"], [[0.35, 0.35], [1.0, 1.0]]], f32),
        obs_r=np.array([PROB["obs"]["r"], [0.45, 0.3]], f32))


@pytest.fixture(scope="module")
def verdicts():
    case = mixed_case()
    pj = jax_params(case)
    out_j = jax_solve_batched(pj, N, H_REV, **KW)
    sp_j = JaxProblem(n=2, m=2, N=N, K=2, tube_kind="l1", scaling=0.5,
                      track_ref=False)
    lb, ub = jax_bounds(jax.tree.map(lambda x: x[0], pj), 2, 2, N)
    cert_j = jax_certify_batched(sp_j, pj, out_j.sol.x.reshape(2, N + 1, -1),
                                 out_j.sol.viol, lb, ub)

    pt = torch_params(case)
    out_t = solve_tube_fast_batched(pt, N, H_REV, device="cpu", **KW)
    sp_t = StagedProblem(n=2, m=2, N=N, K=2, tube_kind="l1", scaling=0.5,
                         track_ref=False)
    lb_t, ub_t = staged_bounds(pt, 2, 2, N)
    cert_t = certify_staged_batched(sp_t, pt, out_t.sol.x.reshape(2, N + 1, -1),
                                    out_t.sol.viol, lb_t, ub_t, device="cpu")
    return cert_j, cert_t


def test_verdicts_match_jax(verdicts):
    cert_j, cert_t = verdicts
    v = cert_t.verdict.numpy()
    np.testing.assert_array_equal(v, np.asarray(cert_j.verdict))
    assert v[0] == VERDICT_FEASIBLE and v[1] == VERDICT_INFEASIBLE


def test_restored_point_of_feasible_scenario(verdicts):
    cert_j, cert_t = verdicts
    assert float(np.asarray(cert_j.viol_restored)[0]) < 1e-3
    assert float(cert_t.viol_restored[0]) < 1e-3
    assert cert_t.u_restored.shape == (2, N + 1, 5)


@pytest.mark.parametrize("tube", ["l1", "NN_oneshot"])
def test_theta_value_and_grad_match_jax(tube):
    """The violation measure theta and its gradient (``torch.autograd`` of
    the batch sum against ``jax.value_and_grad`` under ``vmap``) at an
    iterate with inputs exactly 0, the l1 tube's kink, where the
    derivative of |v| is JAX's +1. Bar: 1e-5 relative."""
    from legged_gym_dev_tpu.solver.restoration import _theta_fn as jax_theta
    from legged_gym_dev_tpu_torch.solver.restoration import (
        _theta_fn,
        _value_and_grad,
    )
    from tests.torch_port_cases import gap_case

    B = 4
    case = gap_case(B, N, H_REV, tube, seed=6)
    rng = np.random.default_rng(6)
    u = np.zeros((B, N + 1, 5), np.float32)
    u[:, :, :2] = case["z0"][:, None] + 0.05 * rng.normal(size=(B, N + 1, 2))
    u[:, :, 2] = 0.1 * rng.random((B, N + 1))
    u[:, :-1, 3:] = rng.uniform(-0.2, 0.2, (B, N, 2))
    u[:, ::3, 3] = 0.0
    u[:, 1::4, 4] = 0.0
    kind = "nn" if tube == "NN_oneshot" else "l1"
    sp_j = JaxProblem(n=2, m=2, N=N, K=2, tube_kind=kind, scaling=0.5,
                      track_ref=False)
    sp_t = StagedProblem(n=2, m=2, N=N, K=2, tube_kind=kind, scaling=0.5,
                         track_ref=False)
    th_j, gr_j = jax.vmap(lambda pp, uu: jax.value_and_grad(
        jax_theta(sp_j, pp))(uu))(jax_params(case), u)
    th_t, gr_t = _value_and_grad(_theta_fn(sp_t, torch_params(case)),
                                 torch.as_tensor(u))
    for t, r in ((th_t, th_j), (gr_t, gr_j)):
        r = np.asarray(r, np.float64)
        err = np.abs(t.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-5, (tube, err)
