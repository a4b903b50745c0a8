"""Port of the two-phase bucketed solve (solver/bucketed.py) against the
JAX package on a bench-drawn gap batch of 8 (N=20, l1, phase 1 = 14 of
the 20 outer iterations). The JAX package holds the bucketed solve to
feasibility statistics only (the penalty hysteresis restarts at the phase
boundary): the phase-1 unconverged count and the bucket are equal, the
feasible fractions (viol < 1e-3) equal, and the bucketed solve is no less
feasible than the single-phase one; co-feasible plans within 2e-3 of the
single-phase ones."""
import numpy as np

import jax

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver.bucketed import (
    solve_tube_fast_bucketed as jax_bucketed,
)
from legged_gym_dev_tpu_torch.solver import ALConfig, solve_tube_fast_batched
from legged_gym_dev_tpu_torch.solver.bucketed import (
    _next_bucket,
    solve_tube_fast_bucketed,
)
from tests.torch_port_cases import (
    gap_case,
    jax_params,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    torch_params,
)

B, N, H_REV = 8, 20, 10
KW = dict(tube_kind="l1", scaling=0.5, warm_start="interpolate",
          tube_ws="evaluate")


def test_next_bucket():
    assert [_next_bucket(n) for n in (1, 128, 129, 300)] == [128, 128, 256,
                                                              512]


def test_bucketed_stats_match_jax():
    case = gap_case(B, N, H_REV, "l1", seed=1)
    out_j, st_j = jax_bucketed(jax_params(case), N, H_REV, cfg=JaxConfig(),
                               phase1_outers=6, **KW)
    out_t, st_t = solve_tube_fast_bucketed(torch_params(case), N, H_REV,
                                           cfg=ALConfig(), phase1_outers=6,
                                           device="cpu", **KW)
    assert st_t == jax.tree.map(lambda x: x, st_j)
    assert st_t["unconverged_after_phase1"] > 0     # phase 2 ran
    feas_t = out_t.sol.viol.numpy() < 1e-3
    feas_j = np.asarray(out_j.sol.viol) < 1e-3
    assert feas_t.mean() == feas_j.mean()
    single = solve_tube_fast_batched(torch_params(case), N, H_REV,
                                     cfg=ALConfig(), device="cpu", **KW)
    feas_s = single.sol.viol.numpy() < 1e-3
    assert feas_t.mean() >= feas_s.mean()
    both = feas_t & feas_s
    assert np.abs(out_t.z.numpy() - single.z.numpy())[both].max() < 2e-3
    assert tuple(out_t.z.shape) == (B, N + 1, 2)
