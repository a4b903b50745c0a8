from .al_solver import ALConfig, ALSolution, solve_al, solve_al_batched
from .fast_tube import (
    StagedProblem,
    closed_loop_tube_mpc_fast,
    solve_tube_fast,
    solve_tube_fast_batched,
    staged_bounds,
)
from .restoration import (
    VERDICT_FAILED,
    VERDICT_FEASIBLE,
    VERDICT_INFEASIBLE,
    VERDICT_NAMES,
    VERDICT_RESTORED,
    CertResult,
    certify_staged,
    certify_staged_batched,
    restore_feasibility,
)
from .trajopt import (
    PROBLEM_DICT,
    TrajOptParams,
    TrajOptSolution,
    build_nlp_fns,
    get_warm_start,
    make_bounds,
    pack_x,
    solve_nominal,
    solve_tube,
    solve_tube_batched,
    unpack_x,
)
from .tube_dynamics import get_tube_dynamics
from .debug import (
    compute_constraint_violation,
    generate_col_names,
    segment_constraint_violation,
    trace_to_csv,
)

__all__ = [
    "ALConfig", "ALSolution", "solve_al", "solve_al_batched",
    "StagedProblem", "closed_loop_tube_mpc_fast", "solve_tube_fast",
    "solve_tube_fast_batched", "staged_bounds",
    "VERDICT_FAILED", "VERDICT_FEASIBLE", "VERDICT_INFEASIBLE",
    "VERDICT_NAMES", "VERDICT_RESTORED", "CertResult", "certify_staged",
    "certify_staged_batched", "restore_feasibility",
    "PROBLEM_DICT", "TrajOptParams", "TrajOptSolution", "build_nlp_fns",
    "get_warm_start", "make_bounds", "pack_x", "solve_nominal",
    "solve_tube", "solve_tube_batched", "unpack_x", "get_tube_dynamics",
    "compute_constraint_violation", "generate_col_names",
    "segment_constraint_violation", "trace_to_csv",
]
