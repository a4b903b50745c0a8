"""Port of the generic closed-loop tube MPC (solver/mpc.py) against the
JAX package on numpy-drawn gap scenarios with the l1 tube, and of the
executed-trace evaluation (evaluation.evaluate_tube_on_mpc_trace,
trace_conformal_scale) on the JAX package's trace.

Tolerance: executed z, v and w within 2e-3 (per-tick solves agree to
solver tolerance and compound over the horizon), the execution gate's
``adopted`` pattern equal. The starved re-solve schedule (1x1) makes some
re-solves violate the 1e-3 gate, so the last feasible plan runs on and its
age grows, and a starved first solve executes its stage 0 regardless (age
starts at -1). With no re-solve iterations at all (violation inf) every
tick after the first runs the first plan on: at N=4 its age reaches the
clamp N-1 and stays there.
"""
import numpy as np
import pytest

import jax

from legged_gym_dev_tpu import evaluation as jev
from legged_gym_dev_tpu.core import DoubleInt2D as JaxDoubleInt2D
from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import get_tube_dynamics as jax_tube_dynamics
from legged_gym_dev_tpu.solver.mpc import MPCConfig as JaxMPCConfig
from legged_gym_dev_tpu.solver.mpc import (
    closed_loop_tube_mpc as jax_closed_loop,
)
from legged_gym_dev_tpu.solver.mpc import (
    closed_loop_tube_mpc_batched as jax_closed_loop_batched,
)
from legged_gym_dev_tpu_torch import evaluation as tev
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.interop import mpc_trace_from_numpy
from legged_gym_dev_tpu_torch.solver import ALConfig, get_tube_dynamics
from legged_gym_dev_tpu_torch.solver.mpc import (
    MPCConfig,
    closed_loop_tube_mpc,
    closed_loop_tube_mpc_batched,
)
from tests.torch_port_cases import (
    PLANT_ARGS,
    gap_case,
    jax_params,
    torch_params,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

H_REV = 4
CASES = {
    # name: (B, N, H, first solve's schedule, re-solves' schedule)
    "single": (1, 10, 5, None, (4, 6)),
    "batched_gated": (3, 10, 5, (1, 1), (1, 1)),
    "age_clamp": (3, 4, 7, None, (0, 1)),
}


def _run(name):
    B, N, H, first, loop = CASES[name]
    case = gap_case(B, N, H_REV, "l1", seed=0)
    kw_j, kw_t = {}, {}
    if first is not None:
        kw_j["al_first"] = JaxConfig(outer_iters=first[0],
                                     inner_iters=first[1])
        kw_t["al_first"] = ALConfig(outer_iters=first[0],
                                    inner_iters=first[1])
    kw_j["al_loop"] = JaxConfig(outer_iters=loop[0], inner_iters=loop[1])
    kw_t["al_loop"] = ALConfig(outer_iters=loop[0], inner_iters=loop[1])
    robot_j = JaxDoubleInt2D.create(*PLANT_ARGS)
    f_j = jax_tube_dynamics("l1", N)
    pj = jax_params(case)
    mpc_j = JaxMPCConfig(H=H, N=N, H_rev=H_REV)
    if B == 1:
        p1 = jax.tree.map(lambda x: x[0], pj)
        tr_j = jax.jit(lambda p: jax_closed_loop(p, f_j, robot_j, mpc_j,
                                                 **kw_j))(p1)
        run_t = closed_loop_tube_mpc
    else:
        tr_j = jax.jit(lambda p: jax_closed_loop_batched(
            p, f_j, robot_j, mpc_j, **kw_j))(pj)
        run_t = closed_loop_tube_mpc_batched
    tr_t = run_t(torch_params(case), get_tube_dynamics("l1", N),
                 make_rom("DoubleInt2D", *PLANT_ARGS, device="cpu"),
                 MPCConfig(H=H, N=N, H_rev=H_REV), device="cpu", **kw_t)
    return jax.tree.map(np.asarray, tr_j), tr_t


@pytest.fixture(scope="module", params=sorted(CASES))
def traces(request):
    return request.param, _run(request.param)


def test_closed_loop_matches_jax(traces):
    name, (tr_j, tr_t) = traces
    B, N, H = CASES[name][:3]
    single = B == 1
    for f in ("z", "v", "w", "pz_x", "x", "u"):
        ref = getattr(tr_j, f)
        ref = ref[None] if single else ref
        got = getattr(tr_t, f).numpy()
        assert got.shape == ref.shape, (f, got.shape, ref.shape)
        assert np.abs(got - ref).max() < 2e-3, (f, np.abs(got - ref).max())
    adopted = tr_j.adopted[None] if single else tr_j.adopted
    assert tr_t.adopted.numpy().tolist() == adopted.tolist()
    assert tuple(tr_t.z_sol.shape) == (B, H, N + 1, 2)
    if name != "single":
        # the gate rejected some re-solves: the last plan ran on
        assert not adopted.all()


def test_trace_evaluation_matches_jax(traces):
    """The port's evaluation on JAX's own trace arrays (one scenario, as
    the JAX functions take it) gives JAX's numbers exactly."""
    name, (tr_j, _) = traces
    one = jax.tree.map(lambda a: a[0], tr_j) if CASES[name][0] > 1 else tr_j
    port = mpc_trace_from_numpy(one, device="cpu")
    assert tuple(port.z.shape) == (1,) + one.z.shape
    assert tev.evaluate_tube_on_mpc_trace(port) == \
        jev.evaluate_tube_on_mpc_trace(one)
    for alpha in (0.5, 0.9):
        assert tev.trace_conformal_scale(port, alpha) == \
            jev.trace_conformal_scale(one, alpha)
