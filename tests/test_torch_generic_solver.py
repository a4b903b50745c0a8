"""Port of the generic dense solver (solver/al_solver.py, the NLP of
solver/trajopt.py, the rolling tubes of solver/tube_dynamics.py) against
the JAX package on the same numpy-drawn gap batch (B=3, N=10, H_rev=4).

- The NLP Jacobians (forward mode, ``torch.func``) against ``jax.jacfwd``
  at the 'start' warm start, where every input v is exactly 0: the l1
  tubes' |v| must have JAX's derivative +1 there (``torch.abs`` has 0).
  Tolerance 1e-6 relative (the same few fp32 operations).
- One AL step, then a 4x4 ``solve_al``: 1e-4 relative on x, lam, mu,
  viol, obj and rho (fp32; the two sum and factor in different orders).
- ``solve_nominal`` and ``solve_tube`` (l1, l2, both rolling tubes,
  NN_oneshot) on the default 20x10 schedule: plans within 2e-3, viol
  within 1e-4 of JAX's.
- ``return_trace``'s keys and shapes, and a step whose GN matrix is
  indefinite (a negative penalty): the factorization fails and x stays,
  as JAX's NaN step fails its line search.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import build_nlp_fns as jax_build_nlp_fns
from legged_gym_dev_tpu.solver import get_tube_dynamics as jax_tube_dynamics
from legged_gym_dev_tpu.solver import make_bounds as jax_make_bounds
from legged_gym_dev_tpu.solver import pack_x as jax_pack_x
from legged_gym_dev_tpu.solver import solve_al as jax_solve_al
from legged_gym_dev_tpu.solver import solve_nominal as jax_solve_nominal
from legged_gym_dev_tpu.solver import solve_tube as jax_solve_tube
from legged_gym_dev_tpu.solver.trajopt import (
    get_tube_warm_start as jax_tube_ws,
)
from legged_gym_dev_tpu.solver.trajopt import get_warm_start as jax_ws
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    build_nlp_fns,
    get_tube_dynamics,
    get_warm_start,
    make_bounds,
    pack_x,
    solve_al,
    solve_nominal,
    solve_tube,
)
from legged_gym_dev_tpu_torch.solver.al_solver import jacobian
from legged_gym_dev_tpu_torch.solver.trajopt import get_tube_warm_start
from tests.torch_port_cases import (
    gap_case,
    jax_params,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    torch_params,
)

B, N, H_REV = 3, 10, 4
KINDS = ["l1", "l2", "l1_rolling", "l2_rolling", "NN_oneshot"]


def rel_err(t, ref):
    t, ref = np.asarray(t, np.float64), np.asarray(ref, np.float64)
    return np.abs(t - ref).max() / max(np.abs(ref).max(), 1e-12)


def problem(kind, seed=0):
    """Both packages' params, NLP functions, 'start' warm start and
    bounds of a gap batch with the ``kind`` tube."""
    case = gap_case(B, N, H_REV, kind, seed=seed)
    pj, pt = jax_params(case), torch_params(case)
    fj = jax_tube_dynamics(kind, N, scaling=0.5, window_size=3)
    ft = get_tube_dynamics(kind, N, scaling=0.5, window_size=3)
    nlp_j = jax_build_nlp_fns(2, 2, N, True, tube_fn=fj)
    nlp_t = build_nlp_fns(2, 2, N, True, tube_fn=ft)

    def x0_j(p):
        z, v = jax_ws("start", p, N)
        return jax_pack_x(z, v, jax_tube_ws("evaluate", fj, z, v, p, N))

    xj = jax.vmap(x0_j)(pj)
    z, v = get_warm_start("start", pt, N)
    xt = pack_x(z, v, get_tube_warm_start("evaluate", ft, z, v, pt, N))
    bj = jax.vmap(lambda p: jax_make_bounds(p, N, True))(pj)
    return dict(pj=pj, pt=pt, fj=fj, ft=ft, nlp_j=nlp_j, nlp_t=nlp_t, xj=xj,
                xt=xt, bj=bj, bt=make_bounds(pt, N, True))


@pytest.mark.parametrize("kind", ["l1", "l1_rolling", "NN_oneshot"])
def test_nlp_jacobians_match_jax_at_zero_inputs(kind):
    pb = problem(kind)
    np.testing.assert_allclose(pb["xt"].numpy(), np.asarray(pb["xj"]),
                               rtol=1e-6, atol=1e-6)
    v = pb["xt"][:, (N + 1) * 2:(N + 1) * 2 + N * 2]
    assert bool((v == 0).all())
    for fn_t, fn_j, name in zip(pb["nlp_t"], pb["nlp_j"], "rhg"):
        np.testing.assert_allclose(fn_t(pb["xt"], pb["pt"]).numpy(),
                                   np.asarray(jax.vmap(fn_j)(pb["xj"],
                                                             pb["pj"])),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        J_t = jacobian(fn_t, pb["xt"], pb["pt"]).numpy()
        J_j = np.asarray(jax.vmap(jax.jacfwd(fn_j))(pb["xj"], pb["pj"]))
        assert J_t.shape == J_j.shape
        assert rel_err(J_t, J_j) <= 1e-6, (name, rel_err(J_t, J_j))


def _both_al(pb, cfg_kw, **kw):
    r_j, h_j, g_j = pb["nlp_j"]
    sol_j = jax.jit(jax.vmap(lambda x, p, lb, ub: jax_solve_al(
        r_j, h_j, g_j, x, p, lb, ub, JaxConfig(**cfg_kw), **kw)))(
        pb["xj"], pb["pj"], *pb["bj"])
    sol_t = solve_al(*pb["nlp_t"], pb["xt"], pb["pt"], *pb["bt"],
                     ALConfig(**cfg_kw), device="cpu", **kw)
    return sol_j, sol_t


@pytest.mark.parametrize("sched", [(1, 1), (4, 4)], ids=["one_step", "4x4"])
def test_solve_al_matches_jax(sched):
    pb = problem("l2", seed=1)
    sol_j, sol_t = _both_al(pb, dict(outer_iters=sched[0],
                                     inner_iters=sched[1]))
    for name in ("x", "lam", "mu", "viol", "obj", "rho"):
        r = rel_err(getattr(sol_t, name).numpy(),
                    np.asarray(getattr(sol_j, name)))
        assert r <= 1e-4, (name, r)
    assert sol_t.outer_used.tolist() == np.asarray(sol_j.outer_used).tolist()


def test_nominal_matches_jax():
    case = gap_case(B, N, H_REV, "l2", seed=2)
    pj, pt = jax_params(case), torch_params(case)
    z_j, v_j, s_j = jax.jit(jax.vmap(
        lambda p: jax_solve_nominal(p, N, JaxConfig())))(pj)
    z_t, v_t, s_t = solve_nominal(pt, N, ALConfig(), device="cpu")
    assert np.abs(z_t.numpy() - np.asarray(z_j)).max() < 2e-3
    assert np.abs(v_t.numpy() - np.asarray(v_j)).max() < 2e-3
    assert np.abs(s_t.viol.numpy() - np.asarray(s_j.viol)).max() < 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_solve_tube_matches_jax(kind):
    """The JAX default warm start ('start': v = 0) and schedule."""
    pb = problem(kind, seed=3)
    out_j = jax.jit(jax.vmap(lambda p: jax_solve_tube(
        p, pb["fj"], N, H_REV, JaxConfig())))(pb["pj"])
    out_t = solve_tube(pb["pt"], pb["ft"], N, H_REV, ALConfig(),
                       device="cpu")
    for name in ("z", "v", "w"):
        d = np.abs(getattr(out_t, name).numpy()
                   - np.asarray(getattr(out_j, name))).max()
        assert d < 2e-3, (name, d)
    assert np.abs(out_t.sol.viol.numpy()
                  - np.asarray(out_j.sol.viol)).max() < 1e-4


def test_return_trace_keys_and_shapes():
    pb = problem("l1")
    out, trace = solve_tube(pb["pt"], pb["ft"], N, H_REV,
                            ALConfig(outer_iters=3, inner_iters=2),
                            return_trace=True, device="cpu")
    assert sorted(trace) == ["converged", "grad_norm", "obj", "rho", "viol"]
    for k, v in trace.items():
        assert tuple(v.shape) == (B, 3), k
    assert trace["converged"].dtype == torch.bool
    assert torch.equal(trace["viol"][:, -1], out.sol.viol)
    assert torch.equal(trace["rho"][:, -1], out.sol.rho)


def test_indefinite_step_keeps_x():
    """A negative penalty makes the GN matrix indefinite: JAX's Cholesky
    gives NaNs and the NaN step fails its line search; the port's
    ``cholesky_ex`` reports the failure and the step is not taken. Both
    keep x; the multipliers move as JAX's."""
    pb = problem("l2", seed=4)
    kw = dict(rho_init=-1e3)
    sol_j, sol_t = _both_al(pb, dict(outer_iters=1, inner_iters=2), **kw)
    x0 = torch.minimum(torch.maximum(pb["xt"], pb["bt"][0]), pb["bt"][1])
    assert torch.equal(sol_t.x, x0)
    np.testing.assert_array_equal(np.asarray(sol_j.x), x0.numpy())
    assert rel_err(sol_t.lam.numpy(), np.asarray(sol_j.lam)) <= 1e-5
