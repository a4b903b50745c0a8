"""Whole batched tube solves of the port (solver/fast_tube.py) against the
JAX package on the same numpy-drawn gap batch (bench.py's randomised
starts, goals and obstacles; B=8, N=20, an 8x6 schedule, NN refresh 3).

Both sides take linsolve="pallas": the JAX Pallas kernels in interpret
mode, the port's kernel wrappers (their plain versions on the CPU), as
tests/test_fast_tube.py::test_pallas_linsolve_matches_thomas runs JAX.

Bar: plans z and w within 2e-3 (that test's bar), and each scenario's
final violation within 1e-4 of JAX's. The 8x6 schedule does not drive
every scenario below 1e-3 in the JAX package either, so the violation is
held to the reference's rather than to a fixed level; the full 20x10
schedule is held to feasibility below.
"""
import numpy as np
import pytest

import jax

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver.fast_tube import (
    solve_tube_fast_batched as jax_solve_batched,
)
from legged_gym_dev_tpu_torch.solver import ALConfig, solve_tube_fast_batched
from tests.torch_port_cases import gap_case, jax_params, torch_params
from tests.torch_port_cases import one_torch_thread  # noqa: F401

N, H_REV, B = 20, 10, 8
# A draw whose scenarios all sit away from a kink of the tube: near one
# (seed 0, scenario 6 of NN_oneshot) fp32 rounding alone moves the plan by
# 2e-2, between the port's own two linsolve routes as well.
SEED = 2
KW = dict(scaling=0.5, warm_start="interpolate", tube_ws="evaluate")


def _cfg(tube, **kw):
    if tube == "NN_oneshot":
        kw["nn_basis_refresh"] = 3
    return kw


@pytest.fixture(scope="module", params=["l1", "NN_oneshot"])
def solved(request):
    tube = request.param
    case = gap_case(B, N, H_REV, tube, seed=SEED)
    cfg = _cfg(tube, outer_iters=8, inner_iters=6, linsolve="pallas")
    out_j = jax.jit(lambda pb: jax_solve_batched(
        pb, N, H_REV, tube_kind=tube, cfg=JaxConfig(**cfg), **KW))(
            jax_params(case))
    out_t = solve_tube_fast_batched(torch_params(case), N, H_REV,
                                    tube_kind=tube, cfg=ALConfig(**cfg),
                                    device="cpu", **KW)
    return tube, case, out_j, out_t


def test_full_solve_matches_jax_pallas(solved):
    tube, _, out_j, out_t = solved
    assert tuple(out_t.z.shape) == (B, N + 1, 2)
    assert tuple(out_t.v.shape) == (B, N, 2)
    dz = np.abs(out_t.z.numpy() - np.asarray(out_j.z)).max()
    dw = np.abs(out_t.w.numpy() - np.asarray(out_j.w)).max()
    assert dz < 2e-3, (tube, dz)
    assert dw < 2e-3, (tube, dw)
    dviol = np.abs(out_t.sol.viol.numpy() - np.asarray(out_j.sol.viol))
    assert dviol.max() < 1e-4, (tube, dviol)


def test_thomas_and_pallas_routes_agree(solved):
    """linsolve='thomas' (entry-form block-Thomas) and 'pallas' (kernel
    wrappers; their plain versions on the CPU) give the same plans."""
    tube, case, _, out_p = solved
    out_t = solve_tube_fast_batched(
        torch_params(case), N, H_REV, tube_kind=tube,
        cfg=ALConfig(**_cfg(tube, outer_iters=8, inner_iters=6,
                            linsolve="thomas")), device="cpu", **KW)
    assert float((out_t.z - out_p.z).abs().max()) < 2e-3
    assert float((out_t.w - out_p.w).abs().max()) < 2e-3


@pytest.mark.parametrize("tube", ["l1", "NN_oneshot"])
def test_default_schedule_is_feasible(tube):
    """The bench schedule (20x10) brings every scenario of the batch below
    a violation of 1e-3, the bench's feasibility bar."""
    case = gap_case(B, N, H_REV, tube, seed=SEED)
    out = solve_tube_fast_batched(
        torch_params(case), N, H_REV, tube_kind=tube,
        cfg=ALConfig(**_cfg(tube, linsolve="pallas")), device="cpu", **KW)
    viol = out.sol.viol.numpy()
    assert np.all(viol < 1e-3), viol
