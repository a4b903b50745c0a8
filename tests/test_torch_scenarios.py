"""Per-scenario ROMs and tube networks in the port against the JAX
package's vmapped ``TrajOptParams``, whose ``rom`` and ``tube_params``
leaves carry the leading scenario axis.

The batch's scenarios differ: on the gap batch of ``torch_port_cases``
(B=8, N=20, an 8x6 schedule, NN refresh 3, MLP width 32), each scenario
draws its own input bound ``vel_max`` per axis in [0.18, 0.22], its own
``dt`` in [0.09, 0.11], and its own tube network: the case MLP plus
N(0, 0.01) on the last layer's weights and U(-0.2, 0.2) on its bias.

Bars: ROM entries within 1e-6 and the MLP's value, Jacobian and VJP within
1e-5 of JAX's; ``solve_tube_fast_batched`` plans z, w within 2e-3 and each
scenario's violation within 1e-4 of JAX's (``test_torch_fast_tube.py``'s
bars); verdicts equal; the per-scenario form of B identical copies gives
the shared form's plans (l1 within 1e-6, NN_oneshot within 1e-4: ``einsum``
and ``matmul`` may round differently); sharded solves equal unsharded ones.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import (
    certify_staged_batched as jax_certify_batched,
)
from legged_gym_dev_tpu.solver import get_tube_dynamics as jax_tube_dynamics
from legged_gym_dev_tpu.solver import solve_tube as jax_solve_tube
from legged_gym_dev_tpu.solver.fast_tube import StagedProblem as JaxProblem
from legged_gym_dev_tpu.solver.fast_tube import (
    closed_loop_tube_mpc_fast as jax_closed_loop,
)
from legged_gym_dev_tpu.solver.fast_tube import (
    solve_tube_fast_batched as jax_solve_batched,
)
from legged_gym_dev_tpu.solver.fast_tube import staged_bounds as jax_bounds
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.core.rom import ROM_REGISTRY
from legged_gym_dev_tpu_torch.interop import (
    mlp_from_numpy,
    trajopt_params_from_numpy,
    tube_mlp_from_numpy,
)
from legged_gym_dev_tpu_torch.parallel import (
    gather,
    make_mesh,
    map_shards,
    shard_batch,
)
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    StagedProblem,
    certify_staged_batched,
    closed_loop_tube_mpc_fast,
    get_tube_dynamics,
    solve_tube_batched,
    solve_tube_fast_batched,
    staged_bounds,
)
from legged_gym_dev_tpu_torch.tube.models import MLP, load_mlp, save_mlp
from tests.torch_port_cases import (
    PLANT_ARGS,
    ROM_ARGS,
    gap_case,
    jax_params,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    torch_params,
)

N, H_REV, B = 20, 10, 8
SEED = 2            # the draw of test_torch_fast_tube.py, away from a kink
KW = dict(scaling=0.5, warm_start="interpolate", tube_ws="evaluate")


def scenario_draws(case, seed):
    """Per-scenario ``vel_max`` (B, 2), ``dt`` (B,) and, for the NN tube,
    the per-scenario network's weights and biases (leading axis B)."""
    rng = np.random.default_rng(1000 + seed)
    nb = case["z0"].shape[0]
    d = dict(vel_max=rng.uniform(0.18, 0.22, (nb, 2)).astype(np.float32),
             dt=rng.uniform(0.09, 0.11, nb).astype(np.float32))
    if case["mlp"] is not None:
        ws, bs = case["mlp"]
        ws = [np.repeat(w[None], nb, 0) for w in ws]
        bs = [np.repeat(b[None], nb, 0) for b in bs]
        ws[-1] = (ws[-1] + rng.normal(0.0, 0.01, ws[-1].shape)).astype(
            np.float32)
        bs[-1] = (bs[-1] + rng.uniform(-0.2, 0.2, bs[-1].shape)).astype(
            np.float32)
        d.update(ws=ws, bs=bs)
    return d


def jax_scenarios(case, d):
    """The JAX batch: ``jax_params``'s broadcast pytree with the ROM and
    network leaves replaced by the per-scenario draws."""
    pb = jax_params(case)
    pb = pb.replace(rom=pb.rom.replace(
        dt=jnp.asarray(d["dt"]), v_min=jnp.asarray(-d["vel_max"]),
        v_max=jnp.asarray(d["vel_max"])))
    if "ws" in d:
        pb = pb.replace(tube_params=pb.tube_params.replace(
            weights=tuple(jnp.asarray(w) for w in d["ws"]),
            biases=tuple(jnp.asarray(b) for b in d["bs"])))
    return pb


def torch_scenarios(case, d):
    nn = None
    if "ws" in d:
        nn = mlp_from_numpy(d["ws"], d["bs"], final_activation="softplus",
                            device="cpu")
    name, _, z_min, z_max, _, _ = ROM_ARGS
    return trajopt_params_from_numpy(
        name, d["dt"], z_min, z_max, -d["vel_max"], d["vel_max"], case["N"],
        case["H_rev"], 10 * np.eye(2), 10 * np.eye(2), case["z0"],
        case["zf"], case["obs_c"], case["obs_r"], Qw=case["Qw"], w_max=1.0,
        tube_params=nn, device="cpu")


def _cfg(tube, **kw):
    if tube == "NN_oneshot":
        kw["nn_basis_refresh"] = 3
    return kw


def _max_abs(t, r):
    return float(np.abs(np.asarray(t) - np.asarray(r)).max())


# ---------------------------------------------------------------------------
# (a) the ROM zoo, per scenario
# ---------------------------------------------------------------------------

def _rom_inputs(name, nb, T, seed):
    cls = ROM_REGISTRY[name]
    rng = np.random.default_rng(seed)
    n, m = cls.n, cls.m
    return dict(
        dt=rng.uniform(0.09, 0.11, nb).astype(np.float32),
        z_min=-rng.uniform(1.0, 2.0, (nb, n)).astype(np.float32),
        z_max=rng.uniform(1.0, 2.0, (nb, n)).astype(np.float32),
        v_min=-rng.uniform(0.5, 1.0, (nb, m)).astype(np.float32),
        v_max=rng.uniform(0.5, 1.0, (nb, m)).astype(np.float32),
        z=rng.uniform(-1.5, 1.5, (nb, T, n)).astype(np.float32),
        v=rng.uniform(-1.5, 1.5, (nb, T, m)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(ROM_REGISTRY))
def test_rom_entries_match_jax(name):
    """f, clip_v_z, f_entries and f_jac_entries of a per-scenario ROM
    (each scenario its own dt and bounds) against JAX's ROM vmapped over
    the same leaves; entries ``(B, T)``, dt a ``(B, 1)`` column."""
    nb, T = 5, 7
    x = _rom_inputs(name, nb, T, seed=len(name))
    keys = ("dt", "z_min", "z_max", "v_min", "v_max")
    rom_t = make_rom(name, *(x[k] for k in keys), device="cpu")
    assert rom_t.per_scenario and rom_t.batch_size == nb
    rom_j = jax_make_rom(name, *(x[k][0] for k in keys)).replace(
        **{k: jnp.asarray(x[k]) for k in keys})
    z, v = x["z"], x["v"]
    zt, vt = torch.as_tensor(z), torch.as_tensor(v)

    f_j = jax.vmap(lambda r, a, b: r.f(a, b))(rom_j, z, v)
    assert _max_abs(rom_t.f(zt, vt), f_j) < 1e-6
    c_j = jax.vmap(lambda r, a, b: r.clip_v_z(a, b))(rom_j, z, 3.0 * v)
    assert _max_abs(rom_t.clip_v_z(zt, 3.0 * vt), c_j) < 1e-6

    z_e = [z[..., i] for i in range(rom_t.n)]
    v_e = [v[..., j] for j in range(rom_t.m)]
    fe_j = jax.vmap(lambda r, a, b: r.f_entries(a, b))(rom_j, z_e, v_e)
    fe_t = rom_t.f_entries([torch.as_tensor(a) for a in z_e],
                           [torch.as_tensor(b) for b in v_e])
    for a, b in zip(fe_t, fe_j):
        assert tuple(a.shape) == (nb, T)
        assert _max_abs(a, b) < 1e-6
    jac_j = jax.vmap(lambda r, a, b: r.f_jac_entries(a, b))(rom_j, z_e, v_e)
    jac_t = rom_t.f_jac_entries([torch.as_tensor(a) for a in z_e],
                                [torch.as_tensor(b) for b in v_e])
    for mat_t, mat_j in zip(jac_t, jac_j):
        for row_t, row_j in zip(mat_t, mat_j):
            for e_t, e_j in zip(row_t, row_j):
                e_j = np.asarray(e_j).reshape(nb, -1)
                if isinstance(e_t, float):      # a symbolic constant
                    assert np.all(e_j == e_t)
                    continue
                assert e_t.shape[0] == nb and e_t.ndim == 2
                assert _max_abs(np.broadcast_to(e_t.numpy(), (nb, T)),
                                np.broadcast_to(e_j, (nb, T))) < 1e-6


def test_rom_stack_and_shared_form():
    """``stack`` of shared ROMs is their per-scenario form; the shared
    form keeps a float dt."""
    x = _rom_inputs("DoubleInt2D", 3, 4, seed=1)
    keys = ("dt", "z_min", "z_max", "v_min", "v_max")
    roms = [make_rom("DoubleInt2D", *(x[k][i] for k in keys), device="cpu")
            for i in range(3)]
    assert isinstance(roms[0].dt, float) and not roms[0].per_scenario
    st = type(roms[0]).stack(roms, device="cpu")
    ref = make_rom("DoubleInt2D", *(x[k] for k in keys), device="cpu")
    for k in keys:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    zt, vt = torch.as_tensor(x["z"]), torch.as_tensor(x["v"])
    for i, r in enumerate(roms):
        assert torch.equal(st.f(zt, vt)[i], r.f(zt[i:i + 1], vt[i:i + 1])[0])


# ---------------------------------------------------------------------------
# (b) the per-scenario tube network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [None, "scalar", "per_scenario"])
def test_mlp_matches_jax(scale):
    case = gap_case(4, N, H_REV, "NN_oneshot", seed=SEED)
    d = scenario_draws(case, SEED)
    rng = np.random.default_rng(5)
    nb, n_in = 4, d["ws"][0].shape[1]
    s = {None: None, "scalar": np.float32(1.3),
         "per_scenario": rng.uniform(0.8, 1.2, nb).astype(np.float32)}[scale]
    jm = JaxMLP(weights=tuple(jnp.asarray(w) for w in d["ws"]),
                biases=tuple(jnp.asarray(b) for b in d["bs"]),
                final_activation="softplus",
                out_scale=None if s is None else jnp.asarray(s))
    tm = mlp_from_numpy(d["ws"], d["bs"], final_activation="softplus",
                        out_scale=s, device="cpu")
    assert tm.per_scenario and tm.batch_size == nb
    x = rng.normal(0.0, 0.3, (nb, n_in)).astype(np.float32)
    ct = rng.normal(0.0, 1.0, (nb, N)).astype(np.float32)
    in_mlp = jax.tree.map(lambda _: 0, jm)
    if s is not None and np.ndim(s) == 0:
        in_mlp = in_mlp.replace(out_scale=None)
    val_j = jax.vmap(lambda mm, a: mm(a), in_axes=(in_mlp, 0))(jm, x)
    out_j, J_j = jax.vmap(lambda mm, a: mm.value_and_jacobian(a),
                          in_axes=(in_mlp, 0))(jm, x)
    _, g_j = jax.vmap(lambda mm, a, c: mm.value_and_vjp(a, c),
                      in_axes=(in_mlp, 0, 0))(jm, x, ct)
    xt, ctt = torch.as_tensor(x), torch.as_tensor(ct)
    out_t, J_t = tm.value_and_jacobian(xt)
    _, g_t = tm.value_and_vjp(xt, ctt)
    assert _max_abs(tm(xt), val_j) < 1e-5
    assert _max_abs(out_t, out_j) < 1e-5
    assert _max_abs(J_t, J_j) < 1e-5
    assert _max_abs(g_t, g_j) < 1e-5
    # a leading candidate axis, as the staged solver's line search feeds it
    x3 = torch.stack([xt, 0.5 * xt, -xt])
    assert torch.allclose(tm(x3)[1], tm(0.5 * xt), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# (c) the staged solve on the differing batch
# ---------------------------------------------------------------------------

def _solve_both(tube):
    case = gap_case(B, N, H_REV, tube, seed=SEED)
    d = scenario_draws(case, SEED)
    cfg = _cfg(tube, outer_iters=8, inner_iters=6, linsolve="pallas")
    out_j = jax.jit(lambda pb: jax_solve_batched(
        pb, N, H_REV, tube_kind=tube, cfg=JaxConfig(**cfg), **KW))(
            jax_scenarios(case, d))
    pt = torch_scenarios(case, d)
    out_t = solve_tube_fast_batched(pt, N, H_REV, tube_kind=tube,
                                    cfg=ALConfig(**cfg), device="cpu", **KW)
    return tube, case, d, out_j, out_t


@pytest.fixture(scope="module")
def solved_l1():
    return _solve_both("l1")


@pytest.fixture(scope="module", params=["l1", "NN_oneshot"])
def solved(request):
    if request.param == "l1":
        return request.getfixturevalue("solved_l1")
    return _solve_both(request.param)


def test_per_scenario_solve_matches_jax(solved):
    tube, _, _, out_j, out_t = solved
    assert tuple(out_t.z.shape) == (B, N + 1, 2)
    dz = _max_abs(out_t.z, out_j.z)
    dw = _max_abs(out_t.w, out_j.w)
    assert dz < 2e-3, (tube, dz)
    assert dw < 2e-3, (tube, dw)
    dviol = np.abs(out_t.sol.viol.numpy() - np.asarray(out_j.sol.viol))
    assert dviol.max() < 1e-4, (tube, dviol)


def test_per_scenario_plans_keep_their_bounds(solved):
    """Each scenario's inputs stay inside its own bound, and its dynamics
    residual is that of its own dt."""
    tube, case, d, _, out_t = solved
    vmax = torch.as_tensor(d["vel_max"])[:, None, :]
    assert bool(torch.all(out_t.v.abs() <= vmax + 1e-6))
    dt = torch.as_tensor(d["dt"])[:, None, None]
    h = out_t.z[:, :-1] + dt * out_t.v - out_t.z[:, 1:]
    hv = h.abs().amax(dim=(1, 2))
    assert bool(torch.all(hv <= out_t.sol.viol + 1e-6))


def _kkt_shapes(p, tube, monkeypatch):
    """The shapes of the KKT entries one 1x2 solve hands the
    block-tridiagonal wrappers, call by call."""
    from legged_gym_dev_tpu_torch.solver import staged_scalar

    seen = []

    def shapes(D, L):
        return ({tuple(x.shape) for row in D for x in row
                 if isinstance(x, torch.Tensor)},
                {tuple(x.shape) for row in L for x in row
                 if isinstance(x, torch.Tensor)})

    def wrap(kind, fn):
        def call(D, L, r, b):
            seen.append((kind,) + shapes(D, L))
            return fn(D, L, r, b)
        return call

    for kind, name in (("K1", "block_tridiag_solve_entries"),
                       ("K2", "block_tridiag_multirhs_entries")):
        monkeypatch.setattr(staged_scalar, name,
                            wrap(kind, getattr(staged_scalar, name)))
    solve_tube_fast_batched(
        p, N, H_REV, tube_kind=tube,
        cfg=ALConfig(**_cfg(tube, outer_iters=1, inner_iters=2,
                            linsolve="pallas")), device="cpu", **KW)
    monkeypatch.undo()
    return seen


def test_staged_kernels_route_per_scenario(solved, monkeypatch):
    """The per-scenario solve reaches the block-tridiagonal wrappers (K1,
    and K2f/K2s for the NN tube's Woodbury rows) with KKT entries of the
    shared form's shapes, call for call."""
    tube, case, d, _, _ = solved
    per = _kkt_shapes(torch_scenarios(case, d), tube, monkeypatch)
    shared = _kkt_shapes(torch_params(case), tube, monkeypatch)
    assert per == shared
    kinds = {k for k, _, _ in per}
    assert kinds == ({"K1", "K2"} if tube == "NN_oneshot" else {"K1"})


# ---------------------------------------------------------------------------
# (d) identical copies give the shared form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tube", ["l1", "NN_oneshot"])
def test_identical_copies_give_shared_plans(tube):
    case = gap_case(B, N, H_REV, tube, seed=SEED)
    p = torch_params(case)
    rom = type(p.rom).stack([p.rom] * B, device="cpu")
    nn = (None if p.tube_params is None
          else MLP.stack([p.tube_params] * B, device="cpu"))
    pc = p.replace(rom=rom, tube_params=nn)
    assert pc.rom.per_scenario and not p.rom.per_scenario
    cfg = ALConfig(**_cfg(tube, outer_iters=8, inner_iters=6,
                          linsolve="pallas"))
    out_s = solve_tube_fast_batched(p, N, H_REV, tube_kind=tube, cfg=cfg,
                                    device="cpu", **KW)
    out_c = solve_tube_fast_batched(pc, N, H_REV, tube_kind=tube, cfg=cfg,
                                    device="cpu", **KW)
    bar = 1e-6 if tube == "l1" else 1e-4
    for name in ("z", "w", "v"):
        d = float((getattr(out_s, name) - getattr(out_c, name)).abs().max())
        assert d <= bar, (tube, name, d)


# ---------------------------------------------------------------------------
# (e) the generic solve, the verdicts and the closed loop
# ---------------------------------------------------------------------------

def test_generic_solve_matches_jax():
    """The dense AL path (``solve_tube_batched``, l1 tube) on a differing
    batch of 3 at N=10 with JAX's default schedule."""
    nb, n_g, h_g = 3, 10, 4
    case = gap_case(nb, n_g, h_g, "l1", seed=3)
    d = scenario_draws(case, 3)
    out_j = jax.jit(jax.vmap(lambda pp: jax_solve_tube(
        pp, jax_tube_dynamics("l1", n_g, 0.5), n_g, h_g, JaxConfig())))(
            jax_scenarios(case, d))
    out_t = solve_tube_batched(torch_scenarios(case, d),
                               get_tube_dynamics("l1", n_g, 0.5), n_g, h_g,
                               ALConfig(), device="cpu")
    for name in ("z", "v", "w"):
        assert _max_abs(getattr(out_t, name), getattr(out_j, name)) < 2e-3
    assert _max_abs(out_t.sol.viol, out_j.sol.viol) < 1e-4


def test_verdicts_match_jax(solved_l1):
    """``certify_staged_batched`` on the l1 8x6 plans of the differing
    batch, shared bounds (scenario 0's), without escalation."""
    _, case, d, out_j, out_t = solved_l1
    pj = jax_scenarios(case, d)
    sp_j = JaxProblem(n=2, m=2, N=N, K=2, tube_kind="l1", scaling=0.5,
                      track_ref=False)
    lb, ub = jax_bounds(jax.tree.map(lambda x: x[0], pj), 2, 2, N)
    cert_j = jax_certify_batched(sp_j, pj, out_j.sol.x.reshape(B, N + 1, -1),
                                 out_j.sol.viol, lb, ub, escalate=False)
    pt = torch_scenarios(case, d)
    sp_t = StagedProblem(n=2, m=2, N=N, K=2, tube_kind="l1", scaling=0.5,
                         track_ref=False)
    lb_t, ub_t = staged_bounds(pt, 2, 2, N)
    cert_t = certify_staged_batched(
        sp_t, pt, out_t.sol.x.reshape(B, N + 1, -1), out_t.sol.viol,
        lb_t[:1], ub_t[:1], escalate=False, device="cpu")
    np.testing.assert_array_equal(cert_t.verdict.numpy(),
                                  np.asarray(cert_j.verdict))


def test_closed_loop_matches_jax():
    """Three ticks of ``closed_loop_tube_mpc_fast`` (l1, B=3) on a
    differing batch, against JAX's loop vmapped over it: traces within
    2e-3 and the adoption flags equal."""
    nb, H = 3, 3
    case = gap_case(nb, N, H_REV, "l1", seed=1)
    d = scenario_draws(case, 1)
    first = dict(outer_iters=8, inner_iters=6)
    loop = dict(outer_iters=4, inner_iters=6)
    kw = dict(tube_kind="l1", scaling=0.5, H=H, N=N, H_rev=H_REV,
              warm_start="interpolate", tube_ws="evaluate")
    plant_j = jax_make_rom("DoubleInt2D", *PLANT_ARGS)
    out_j = jax.jit(jax.vmap(lambda pp: jax_closed_loop(
        pp, plant_j, cfg_first=JaxConfig(**first),
        cfg_loop=JaxConfig(**loop), **kw)))(jax_scenarios(case, d))
    out_t = closed_loop_tube_mpc_fast(
        torch_scenarios(case, d),
        make_rom("DoubleInt2D", *PLANT_ARGS, device="cpu"),
        cfg_first=ALConfig(**first), cfg_loop=ALConfig(**loop),
        device="cpu", **kw)
    for name, t, r in zip(("z", "v", "w", "pz_x", "viol"), out_t[:5],
                          out_j[:5]):
        assert tuple(t.shape) == r.shape, name
        assert _max_abs(t, r) < 2e-3, name
    np.testing.assert_array_equal(out_t[5].numpy(), np.asarray(out_j[5]))


def test_bucketed_matches_jax():
    """The two-phase bucketed solve (l1, phase 1 = 6 outers) of a
    differing batch: its phase-2 bucket takes each scenario's ROM rows
    and, as JAX's, clips to scenario 0's bounds. Equal statistics and
    feasible fractions, co-feasible plans within 2e-3 of JAX's."""
    from legged_gym_dev_tpu.solver.bucketed import (
        solve_tube_fast_bucketed as jax_bucketed,
    )
    from legged_gym_dev_tpu_torch.solver.bucketed import (
        solve_tube_fast_bucketed,
    )

    case = gap_case(B, N, H_REV, "l1", seed=1)
    d = scenario_draws(case, 1)
    kw = dict(tube_kind="l1", phase1_outers=6, **KW)
    out_j, st_j = jax_bucketed(jax_scenarios(case, d), N, H_REV,
                               cfg=JaxConfig(), **kw)
    out_t, st_t = solve_tube_fast_bucketed(torch_scenarios(case, d), N,
                                           H_REV, cfg=ALConfig(),
                                           device="cpu", **kw)
    assert st_t == dict(st_j) and st_t["unconverged_after_phase1"] > 0
    feas_t = out_t.sol.viol.numpy() < 1e-3
    feas_j = np.asarray(out_j.sol.viol) < 1e-3
    assert feas_t.mean() == feas_j.mean()
    both = feas_t & feas_j
    assert np.abs(out_t.z.numpy() - np.asarray(out_j.z))[both].max() < 2e-3


# ---------------------------------------------------------------------------
# (f) sharding a per-scenario batch
# ---------------------------------------------------------------------------

def test_shard_batch_splits_per_scenario_mlp():
    case = gap_case(4, N, H_REV, "NN_oneshot", seed=SEED)
    d = scenario_draws(case, SEED)
    p = torch_scenarios(case, d)
    shared = torch_params(case).tube_params
    mesh = make_mesh(2, devices=["cpu"] * 2)
    sh = shard_batch(p, mesh, batch_size=4)
    for i, part in enumerate(sh):
        assert part.tube_params.batch_size == 2
        assert torch.equal(part.tube_params.weights[-1],
                           p.tube_params.weights[-1][2 * i:2 * i + 2])
        assert torch.equal(part.rom.dt, p.rom.dt[2 * i:2 * i + 2])
        assert torch.equal(part.rom.v_max, p.rom.v_max[2 * i:2 * i + 2])
        assert torch.equal(part.rom.z_max, p.rom.z_max)    # shared (n,)
    back = gather(sh)
    for a, b in zip(back.tube_params.parameters(),
                    p.tube_params.parameters()):
        assert torch.equal(a, b)
    # a shared network replicates
    sh2 = shard_batch(p.replace(tube_params=shared), mesh, batch_size=4)
    for part in sh2:
        assert not part.tube_params.per_scenario
        assert torch.equal(part.tube_params.weights[0], shared.weights[0])


@pytest.mark.parametrize("shards", [1, 2])
def test_map_shards_solves_equal_unsharded(shards):
    """Solves of the per-scenario NN batch shard by shard equal the
    unsharded solve: bit for bit on one shard, to 1e-6 on two."""
    nb = 4
    case = gap_case(nb, N, H_REV, "NN_oneshot", seed=SEED)
    p = torch_scenarios(case, scenario_draws(case, SEED))
    cfg = ALConfig(**_cfg("NN_oneshot", outer_iters=3, inner_iters=3,
                          linsolve="pallas"))

    def solve(pp):
        return solve_tube_fast_batched(pp, N, H_REV, tube_kind="NN_oneshot",
                                       cfg=cfg, device="cpu", **KW)

    ref = solve(p)
    mesh = make_mesh(shards, devices=["cpu"] * shards)
    out = gather(map_shards(solve, shard_batch(p, mesh, batch_size=nb)))
    for name in ("z", "w", "v"):
        dd = float((getattr(out, name) - getattr(ref, name)).abs().max())
        assert dd <= (0.0 if shards == 1 else 1e-6), (name, dd)


# ---------------------------------------------------------------------------
# (g) interop and the model file
# ---------------------------------------------------------------------------

def test_interop_round_trip(tmp_path):
    case = gap_case(4, N, H_REV, "NN_oneshot", seed=SEED)
    d = scenario_draws(case, SEED)
    s = np.linspace(0.9, 1.1, 4).astype(np.float32)
    jm = jax.tree.map(np.asarray, JaxMLP(
        weights=tuple(jnp.asarray(w) for w in d["ws"]),
        biases=tuple(jnp.asarray(b) for b in d["bs"]),
        final_activation="softplus", out_scale=jnp.asarray(s)))
    tm = tube_mlp_from_numpy(jm, device="cpu")
    assert tm.per_scenario and tm.final_activation == "softplus"
    for w_t, w in zip(tm.weights, d["ws"]):
        np.testing.assert_array_equal(w_t.numpy(), w)
    np.testing.assert_array_equal(tm.out_scale.numpy(), s)
    path = tmp_path / "tube.pt"
    save_mlp(tm, path)
    back = load_mlp(path, device="cpu")
    x = torch.randn(4, d["ws"][0].shape[1], generator=torch.Generator()
                    .manual_seed(0))
    assert torch.equal(back(x), tm(x))
    shared = mlp_from_numpy(*case["mlp"], final_activation="softplus",
                            device="cpu")
    save_mlp(shared, tmp_path / "shared.pt")
    assert not load_mlp(tmp_path / "shared.pt", device="cpu").per_scenario
    # the per-scenario TrajOptParams carry the numpy leaves as given
    p = torch_scenarios(case, d)
    np.testing.assert_array_equal(p.rom.dt.numpy(), d["dt"])
    np.testing.assert_array_equal(p.rom.v_max.numpy(), d["vel_max"])
    assert p.rom.z_min.shape == (2,) and p.batch_size == 4
    with pytest.raises(ValueError, match="scenarios"):
        trajopt_params_from_numpy(
            "SingleInt2D", d["dt"][:3], *ROM_ARGS[2:4], -d["vel_max"][:3],
            d["vel_max"][:3], N, H_REV, np.eye(2), np.eye(2), case["z0"],
            case["zf"], case["obs_c"], case["obs_r"], device="cpu")
