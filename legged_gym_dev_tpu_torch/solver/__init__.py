from .al_solver import ALConfig, ALSolution
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
from .trajopt import PROBLEM_DICT, TrajOptParams, TrajOptSolution
from .tube_dynamics import get_tube_dynamics

__all__ = [
    "ALConfig", "ALSolution", "StagedProblem", "closed_loop_tube_mpc_fast",
    "solve_tube_fast", "solve_tube_fast_batched", "staged_bounds",
    "VERDICT_FAILED", "VERDICT_FEASIBLE", "VERDICT_INFEASIBLE",
    "VERDICT_NAMES", "VERDICT_RESTORED", "CertResult", "certify_staged",
    "certify_staged_batched", "restore_feasibility", "PROBLEM_DICT",
    "TrajOptParams", "TrajOptSolution", "get_tube_dynamics",
]
