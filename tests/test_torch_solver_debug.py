"""Port of the solver's observability (solver/debug.py) against the JAX
package: the named columns equal, the per-family violation segmentation
equal on a feasible point (a converged plan) and an infeasible one (the
straight-line warm start through the obstacles), within 1e-6 (the same
fp32 residuals; the feasible point is the port's 20x10 plan, fed to both
packages), and the iteration CSV's header and rows (a 4x3 tube solve of
two scenarios in each package, one CSV each): the convergence flags
equal, the numbers within 1e-3 relative (the projected-gradient norm is a
maximum over components that fp32 summation order moves by 1e-4)."""
import csv

import numpy as np
import pytest

import jax

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import (
    compute_constraint_violation as jax_violation,
)
from legged_gym_dev_tpu.solver import generate_col_names as jax_col_names
from legged_gym_dev_tpu.solver import get_tube_dynamics as jax_tube_dynamics
from legged_gym_dev_tpu.solver import (
    segment_constraint_violation as jax_segment,
)
from legged_gym_dev_tpu.solver import solve_tube as jax_solve_tube
from legged_gym_dev_tpu.solver import trace_to_csv as jax_trace_to_csv
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    compute_constraint_violation,
    generate_col_names,
    get_tube_dynamics,
    get_warm_start,
    segment_constraint_violation,
    solve_tube,
    trace_to_csv,
)
from tests.torch_port_cases import (
    gap_case,
    jax_params,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    torch_params,
)

B, N, H_REV = 2, 10, 4


@pytest.mark.parametrize("with_tube", [True, False])
@pytest.mark.parametrize("n,m,n_obs,H_rev", [(2, 2, 2, 4), (6, 3, 3, 0)])
def test_col_names_match_jax(n, m, n_obs, H_rev, with_tube):
    assert generate_col_names(n, m, N, n_obs, with_tube, H_rev) == \
        jax_col_names(n, m, N, n_obs, with_tube, H_rev)


@pytest.fixture(scope="module")
def solved():
    case = gap_case(B, N, H_REV, "l1", seed=2)
    pj, pt = jax_params(case), torch_params(case)
    fj = jax_tube_dynamics("l1", N)
    ft = get_tube_dynamics("l1", N)
    cfg = dict(outer_iters=4, inner_iters=3)
    _, tr_j = jax.vmap(lambda p: jax_solve_tube(
        p, fj, N, H_REV, JaxConfig(**cfg), warm_start="interpolate",
        return_trace=True))(pj)
    _, tr_t = solve_tube(pt, ft, N, H_REV, ALConfig(**cfg),
                             warm_start="interpolate", return_trace=True,
                             device="cpu")
    plan = solve_tube(pt, ft, N, H_REV, ALConfig(), warm_start="interpolate",
                      device="cpu")
    return dict(pj=pj, pt=pt, fj=fj, ft=ft, plan=plan, tr_j=tr_j, tr_t=tr_t)


@pytest.mark.parametrize("point", ["solution", "warm_start"])
def test_segmentation_matches_jax(solved, point):
    s = solved
    if point == "solution":
        z, v, w = (getattr(s["plan"], k).numpy() for k in ("z", "v", "w"))
    else:
        z, v = (a.numpy() for a in get_warm_start("interpolate", s["pt"], N))
        w = np.full((B, N + 1), 0.1, np.float32)
    _, h_cols, g_cols, _ = generate_col_names(2, 2, N, 2, True, H_REV)
    vh_t, vg_t = compute_constraint_violation(s["pt"], z, v, w, N,
                                              tube_fn=s["ft"])
    assert vh_t.shape == (B, len(h_cols)) and vg_t.shape == (B, len(g_cols))
    seg_t = segment_constraint_violation(vh_t, vg_t, h_cols, g_cols)
    worst = 0.0
    for k in range(B):
        pk = jax.tree.map(lambda x: x[k], s["pj"])
        vh_j, vg_j = jax_violation(pk, z[k], v[k], w[k], N, tube_fn=s["fj"])
        seg_j = jax_segment(vh_j, vg_j, h_cols, g_cols)
        assert list(seg_t) == list(seg_j)
        for name in seg_j:
            np.testing.assert_allclose(seg_t[name][k], seg_j[name],
                                       atol=1e-6, err_msg=name)
        worst = max(worst, max(float(a.max()) for a in seg_j.values()))
    if point == "solution":
        assert worst < 1e-3
    else:
        assert seg_t["Obstacle 1"].max() > 0.01 or \
            seg_t["Obstacle 0"].max() > 0.01


def test_trace_csv_matches_jax(solved, tmp_path):
    s = solved
    with pytest.raises(ValueError, match="scenario"):
        trace_to_csv(s["tr_t"], str(tmp_path / "x.csv"))
    for k in range(B):
        rows = []
        for name, write, tr in (("port", trace_to_csv, s["tr_t"]),
                                ("jax", jax_trace_to_csv, s["tr_j"])):
            path = write(tr, str(tmp_path / f"{name}_{k}.csv"), scenario=k)
            with open(path) as f:
                rows.append(list(csv.reader(f)))
        assert rows[0][0] == rows[1][0] == ["iter", "converged", "grad_norm",
                                            "obj", "rho", "viol"]
        got = np.array(rows[0][1:], np.float64)
        ref = np.array(rows[1][1:], np.float64)
        assert got.shape == ref.shape == (4, 6)
        np.testing.assert_array_equal(got[:, :2], ref[:, :2])
        np.testing.assert_allclose(got[:, 2:], ref[:, 2:], rtol=1e-3,
                                   atol=1e-6)
