"""Port of the staged tube solver (solver/staged_scalar.py, fast_tube.py)
against the JAX package on the same numpy-drawn gap batch (B=4..8, N=20).

- The GN assembly and the merit, batch-major in the port, against the
  module-level JAX functions under ``jax.vmap``: 1e-5 relative to each
  quantity's largest magnitude (fp32; penalties of 1e2-1e4 scale it).
- One AL step (ALConfig(outer_iters=1, inner_iters=1)) end to end: 1e-4
  relative.

Whole solves are compared in tests/test_torch_fast_tube.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import staged_scalar as jss
from legged_gym_dev_tpu.solver.fast_tube import StagedProblem as JaxProblem
from legged_gym_dev_tpu.solver.fast_tube import (
    solve_tube_fast_batched as jax_solve_batched,
)
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    StagedProblem,
    solve_tube_fast_batched,
)
from legged_gym_dev_tpu_torch.solver import staged_scalar as tss
from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul
from tests.torch_port_cases import gap_case, jax_params, torch_params
from tests.torch_port_cases import one_torch_thread  # noqa: F401

N, H_REV = 20, 10
S, b = N + 1, 5
E, I = 2 * N + 2 + N, 2 * S


def rel_err(t, ref):
    t, ref = np.asarray(t, np.float64), np.asarray(ref, np.float64)
    return np.abs(t - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture(scope="module", params=["l1", "NN_oneshot"])
def state(request):
    """A gap batch and an AL state (iterate, multipliers, penalty) drawn
    with numpy, in both packages' forms."""
    tube = request.param
    B = 4
    case = gap_case(B, N, H_REV, tube, seed=3)
    rng = np.random.default_rng(5)
    alpha = np.linspace(0.0, 1.0, S)[None, :, None]
    z = case["z0"][:, None] + alpha * (case["zf"] - case["z0"])[:, None]
    u = np.zeros((B, S, b), np.float32)
    u[:, :, :2] = z + 0.02 * rng.normal(size=z.shape)
    u[:, :, 2] = 0.1 + 0.02 * rng.random((B, S))
    u[:, :-1, 3:] = rng.uniform(-0.2, 0.2, (B, N, 2))
    u[:, 3, 3] = 0.0                                  # an l1 kink
    lam = (0.5 * rng.normal(size=(B, E))).astype(np.float32)
    mu = np.maximum(rng.normal(size=(B, I)), 0.0).astype(np.float32)
    rho = np.array([100.0, 500.0, 2500.0, 3e4][:B], np.float32)
    kind = "nn" if tube == "NN_oneshot" else "l1"
    return dict(
        tube=tube, case=case, u=u, lam=lam, mu=mu, rho=rho,
        sp_j=JaxProblem(n=2, m=2, N=N, K=2, tube_kind=kind, scaling=0.5,
                        track_ref=False),
        sp_t=StagedProblem(n=2, m=2, N=N, K=2, tube_kind=kind, scaling=0.5,
                           track_ref=False),
        pj=jax_params(case), pt=torch_params(case))


def _dense_jax(grad, D, L, U):
    g = jnp.stack(grad)
    Dl = jnp.stack([jnp.zeros(S) + D[i][j] for i in range(b)
                    for j in range(i + 1)])
    Ll = jnp.stack([jnp.zeros(N) + L[i][j] for i in range(b)
                    for j in range(b)])
    Ul = (jnp.zeros((1,)) if U is None else
          jnp.stack([jnp.zeros((S, N)) + U[i] for i in range(b)]))
    return g, Dl, Ll, Ul


def _dense_torch(grad, D, L, U, B):
    g = torch.stack(grad, 1)
    Dl = torch.stack([torch.zeros(B, S) + D[i][j] for i in range(b)
                      for j in range(i + 1)], 1)
    Ll = torch.stack([torch.zeros(B, N) + L[i][j] for i in range(b)
                      for j in range(b)], 1)
    Ul = (torch.zeros(B, 1) if U is None else
          torch.stack([torch.zeros(B, S, N) + U[i] for i in range(b)], 1))
    return g, Dl, Ll, Ul


@pytest.mark.parametrize("variant", ["full", "grad_rho0", "vjp"])
def test_assemble_matches_jax(state, variant):
    st = state
    if variant == "vjp" and st["tube"] != "NN_oneshot":
        pytest.skip("the VJP gradient exists for the NN tube only")
    kw = dict(grad_rho=0.0) if variant == "grad_rho0" else {}
    if variant == "vjp":
        kw = dict(nn_need_U=False)

    def jax_fn(pp, uu, ll, mm, rr):
        u_e = tuple(uu[:, i] for i in range(b))
        return _dense_jax(*jss._assemble_e(st["sp_j"], u_e, pp, ll, mm, rr,
                                           **kw))

    ref = jax.vmap(jax_fn)(st["pj"], jnp.asarray(st["u"]),
                           jnp.asarray(st["lam"]), jnp.asarray(st["mu"]),
                           jnp.asarray(st["rho"]))
    u = torch.as_tensor(st["u"])
    with fp32_matmul():
        out = _dense_torch(*tss._assemble_e(
            st["sp_t"], tuple(u[:, :, i] for i in range(b)), st["pt"],
            torch.as_tensor(st["lam"]), torch.as_tensor(st["mu"]),
            torch.as_tensor(st["rho"])[:, None], **kw), 4)
    for name, t, r in zip(("grad", "D", "L", "U"), out, ref):
        assert rel_err(t.numpy(), r) <= 1e-5, (name, rel_err(t.numpy(), r))


def test_merit_matches_jax(state):
    """Merit of the iterate and of a stack of line-search candidates
    (leading candidate axis in both packages' per-batch form)."""
    st = state
    rng = np.random.default_rng(9)
    cand = st["u"][None] + 0.01 * rng.normal(size=(3,) + st["u"].shape)
    cand = cand.astype(np.float32)

    def jax_fn(pp, uu, cc, ll, mm, rr):
        m0 = jss._merit_e(st["sp_j"], tuple(uu[:, i] for i in range(b)), pp,
                          ll, mm, rr)
        mc = jss._merit_e(st["sp_j"], tuple(cc[:, :, i] for i in range(b)),
                          pp, ll, mm, rr)
        return m0, mc

    m0_j, mc_j = jax.vmap(jax_fn)(
        st["pj"], jnp.asarray(st["u"]), jnp.asarray(cand.transpose(1, 0, 2, 3)),
        jnp.asarray(st["lam"]), jnp.asarray(st["mu"]), jnp.asarray(st["rho"]))
    u, c = torch.as_tensor(st["u"]), torch.as_tensor(cand)
    args = (st["pt"], torch.as_tensor(st["lam"]), torch.as_tensor(st["mu"]),
            torch.as_tensor(st["rho"])[:, None])
    with fp32_matmul():
        m0 = tss._merit_e(st["sp_t"], tuple(u[:, :, i] for i in range(b)),
                          *args)
        mc = tss._merit_e(st["sp_t"], tuple(c[..., i] for i in range(b)),
                          *args)
    assert tuple(m0.shape) == (4, 1) and tuple(mc.shape) == (3, 4, 1)
    assert rel_err(m0[:, 0].numpy(), m0_j) <= 1e-5
    assert rel_err(mc[..., 0].numpy().T, mc_j) <= 1e-5


def _solve_both(case, tube, cfg_kw, linsolve_jax, linsolve_port):
    kw = dict(tube_kind=tube, scaling=0.5, warm_start="interpolate",
              tube_ws="evaluate")
    out_j = jax.jit(lambda pb: jax_solve_batched(
        pb, N, H_REV, cfg=JaxConfig(linsolve=linsolve_jax, **cfg_kw),
        **kw))(jax_params(case))
    out_t = solve_tube_fast_batched(
        torch_params(case), N, H_REV,
        cfg=ALConfig(linsolve=linsolve_port, **cfg_kw), device="cpu", **kw)
    return out_j, out_t


@pytest.mark.parametrize("tube", ["l1", "NN_oneshot"])
def test_one_al_step_matches_jax(tube):
    case = gap_case(4, N, H_REV, tube, seed=4)
    out_j, out_t = _solve_both(case, tube, dict(outer_iters=1, inner_iters=1),
                               "thomas", "thomas")
    for name in ("x", "lam", "mu", "viol", "obj", "grad_norm", "rho"):
        r = rel_err(getattr(out_t.sol, name).numpy(),
                    np.asarray(getattr(out_j.sol, name)))
        assert r <= 1e-4, (name, r)


@pytest.mark.parametrize("S,bs", [(1, 3), (2, 3), (7, 4), (21, 5), (51, 5),
                                  (51, 10)])
def test_cr_solve_entries_matches_jax(S, bs):
    """Block cyclic reduction against the JAX package's on the same SPD
    systems (two scenarios, (B, S) entries; symbolic zeros in L's first
    row), and both against a dense float64 solve. Tolerance: 1e-5
    relative between the packages (the same operations in the same
    order), 1e-3 absolute against the dense solve."""
    rng = np.random.default_rng(S * 100 + bs)
    B = 2
    A = rng.normal(size=(B, S, bs, bs)).astype(np.float32)
    Dfull = (A @ np.swapaxes(A, -1, -2)
             + 5.0 * bs * np.eye(bs, dtype=np.float32)).astype(np.float32)
    Lfull = (0.3 * rng.normal(size=(B, max(S - 1, 0), bs, bs))
             ).astype(np.float32)
    if S > 1:
        Lfull[:, :, 0, :] = 0.0
    rhs = rng.normal(size=(B, S, bs)).astype(np.float32)

    def entries(conv):
        D_e = [[conv(Dfull[:, :, i, j]) for j in range(i + 1)]
               for i in range(bs)]
        L_e = [[0.0 if (S == 1 or i == 0) else conv(Lfull[:, :, i, j])
                for j in range(bs)] for i in range(bs)]
        return D_e, L_e, [conv(rhs[:, :, i]) for i in range(bs)]

    x_t = np.stack([x.numpy() for x in tss.cr_solve_entries(
        *entries(torch.as_tensor), bs)], -1)
    x_j = np.stack([np.asarray(x) for x in jss.cr_solve_entries(
        *entries(jnp.asarray), bs)], -1)
    assert rel_err(x_t, x_j) <= 1e-5, rel_err(x_t, x_j)
    for k in range(B):
        K = np.zeros((S * bs, S * bs))
        for s in range(S):
            K[s * bs:(s + 1) * bs, s * bs:(s + 1) * bs] = Dfull[k, s]
        for s in range(S - 1):
            K[(s + 1) * bs:(s + 2) * bs, s * bs:(s + 1) * bs] = Lfull[k, s]
            K[s * bs:(s + 1) * bs, (s + 1) * bs:(s + 2) * bs] = Lfull[k, s].T
        x_ref = np.linalg.solve(K, rhs[k].reshape(-1)).reshape(S, bs)
        assert np.abs(x_t[k] - x_ref).max() < 1e-3


def test_long_horizon_auto_takes_cr_and_matches_jax():
    """N=130 (S=131 >= 128 stages): ``linsolve="auto"`` takes cyclic
    reduction in both packages; a short l1 solve (3x3 schedule) of a
    gap batch of 2, against JAX's at 1e-4 relative (x, lam, mu, viol,
    obj, rho)."""
    N_long = 130
    assert tss._linsolve(ALConfig(), N_long + 1) == "cr"
    case = gap_case(2, N_long, H_REV, "l1", seed=6)
    cfg_kw = dict(outer_iters=3, inner_iters=3)
    kw = dict(tube_kind="l1", scaling=0.5, warm_start="interpolate",
              tube_ws="evaluate")
    out_j = jax.jit(lambda pb: jax_solve_batched(
        pb, N_long, H_REV, cfg=JaxConfig(**cfg_kw), **kw))(jax_params(case))
    out_t = solve_tube_fast_batched(torch_params(case), N_long, H_REV,
                                    cfg=ALConfig(**cfg_kw), device="cpu",
                                    **kw)
    for name in ("x", "lam", "mu", "viol", "obj", "rho"):
        r = rel_err(getattr(out_t.sol, name).numpy(),
                    np.asarray(getattr(out_j.sol, name)))
        assert r <= 1e-4, (name, r)
