"""The port's profiling and schedule tools (``scripts/torch_profile_*.py``,
``torch_measure_imbalance.py``, ``torch_sweep_schedule.py``,
``torch_tune_loop_schedule.py``, ``torch_compile_time_quadruped.py``, the
counterparts of the JAX package's measurement tools in ``scripts/``) on
the CPU.

- Every JAX script in ``scripts/`` but the benchmarks, the goldens' maker,
  the training drivers and the flagships has a ``torch_<name>.py`` that
  reads the same environment knobs with the same defaults, plus
  ``E2E_CPU`` and, where it makes a robot, ``OVERRIDES`` (an AST scan of
  both files); the positional arguments keep the JAX defaults.
- Each tool runs at a tiny size (B 2-8, N 8 or 10, H 2, one timed rep, 4-step
  solve schedules, 2 shards, 2 of the sweep's schedules; the robot tools
  through ``main`` on a test robot of tests/torch_robot_cases.py named in
  ``OVERRIDES``) and returns its keys, every number finite.
- ``torch_profile_staged``'s rebuilt inner step agrees with the JAX file's
  rebuilt step (built here from the same private pieces, since that file
  times at import) for 2 steps at B=2 on the same numpy inputs.
- The summary arithmetic (per-inner and fixed tick cost, straggler
  penalty, the drift over co-feasible scenarios, the tick budget) against
  the JAX files' formulas on hand-made inputs.
- Without a card and without ``--cpu`` / ``E2E_CPU`` every tool raises
  before any work; ``BARRIER`` other than ``auto`` raises.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_robot_cases as rc
from tests.test_torch_train_drivers import env_knobs, load
from tests.torch_port_cases import (  # noqa: F401
    gap_case,
    jax_params,
    one_torch_thread,
    torch_params,
)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TOOLS = ("profile_solver", "profile_staged", "profile_nn_tube",
         "profile_tick", "profile_sim", "profile_quadruped", "profile_rough",
         "measure_imbalance", "sweep_schedule", "tune_loop_schedule",
         "compile_time_quadruped")
ROBOT_TOOLS = {"profile_sim", "profile_quadruped", "profile_rough",
               "compile_time_quadruped"}
NOT_TOOLS = ("torch_", "bench_", "train_", "flagship_", "make_goldens")


def jax_tools():
    return sorted(p.stem for p in SCRIPTS.glob("*.py")
                  if not p.name.startswith(NOT_TOOLS))


def test_the_tools_are_the_jax_scripts_left():
    assert jax_tools() == sorted(TOOLS)


@pytest.mark.parametrize("name", TOOLS)
def test_every_jax_tool_has_a_counterpart_with_its_knobs(name):
    """The counterpart reads the JAX file's environment knobs with the
    same defaults, plus E2E_CPU (``torch_tool_common.parse``) and, for a
    robot tool, OVERRIDES (``env_overrides``)."""
    port = SCRIPTS / f"torch_{name}.py"
    got = env_knobs(port)
    got.update(env_knobs(SCRIPTS / "torch_tool_common.py"))
    want = {**env_knobs(SCRIPTS / f"{name}.py"), "E2E_CPU": None}
    if name in ROBOT_TOOLS:
        assert "env_overrides()" in port.read_text()
        got.update({k: v for k, v in env_knobs(
            SCRIPTS / "torch_train_velocity_task.py").items()
            if k == "OVERRIDES"})
        want["OVERRIDES"] = "{}"
    assert got == want


@pytest.mark.parametrize("name, argv, want", [
    ("profile_sim", [], {"B": 4096}),
    ("profile_quadruped", [], {"B": 4096, "task": "anymal_c_trajectory"}),
    ("profile_quadruped", ["16", "a1_trajectory"],
     {"B": 16, "task": "a1_trajectory"}),
])
def test_positional_arguments_keep_the_jax_defaults(name, argv, want,
                                                    monkeypatch):
    tool = load(f"torch_{name}")
    seen = {}
    monkeypatch.setattr(tool, name, lambda **kw: seen.update(kw) or {})
    monkeypatch.setattr(tool, "print_launches", dict)
    tool.main(argv + ["--cpu"])
    assert {k: seen[k] for k in want} == want


def finite(tree):
    """Every number of a returned record is finite."""
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return bool(np.isfinite(tree))
    return True


def small_cfg(**kw):
    from legged_gym_dev_tpu_torch.solver import ALConfig

    return ALConfig(outer_iters=2, inner_iters=2, linsolve="pallas", **kw)


def run_tool(name, monkeypatch):
    """The tool at its tiny size on the CPU: the solver tools through
    their functions, the robot tools through ``main`` with OVERRIDES."""
    tool = load(f"torch_{name}")
    cpu = "cpu"
    if name == "profile_solver":
        return tool.profile_solver(B=4, N=8, cfg=small_cfg(), reps=1,
                                   device=cpu)
    if name == "profile_staged":
        return tool.profile_staged(B=4, N=8, cfg=small_cfg(), reps=1,
                                   device=cpu)
    if name == "profile_nn_tube":
        return tool.profile_nn_tube(B=4, N=10, iters=2, reps=1, jac_ad=True,
                                    chol_xla=True, device=cpu)
    if name == "profile_tick":
        return tool.profile_tick(B=2, H=2, N=8, reps=1,
                                 cfg_first=small_cfg(nn_basis_refresh=3),
                                 device=cpu)
    if name == "measure_imbalance":
        return tool.measure_imbalance(B=8, shards=2, N=8, cfg=small_cfg(),
                                      reps=1, device=cpu)
    if name == "sweep_schedule":
        return tool.sweep_schedule(B=4, N=8, default=(2, 2, 4),
                                   schedules=((2, 1, 4), (1, 2, 4)), reps=1,
                                   device=cpu)
    if name == "tune_loop_schedule":
        return {"combos": tool.tune_loop_schedule(
            B=2, H=2, N=8, combos=((2, 2, 1), (1, 2, 2)), first=(2, 2),
            reps=1, device=cpu)}
    const = "HOPPER_URDF" if name == "profile_sim" else "QUADRUPED_URDF"
    monkeypatch.setenv("OVERRIDES", json.dumps(
        {"urdf_path": getattr(rc, const)}))
    argv = ["--cpu", "--reps", "1"]
    if name == "profile_sim":
        return tool.main(["4"] + argv)
    if name == "profile_quadruped":
        return tool.main(["4", "anymal_c_trajectory"] + argv)
    if name == "profile_rough":
        monkeypatch.setenv("ENVS", "4")
        monkeypatch.setattr(tool, "profile_rough", functools.partial(
            tool.profile_rough, k=2))
        return tool.main(argv)
    monkeypatch.setenv("TARGET", "ppo")
    monkeypatch.setenv("B", "4")
    return tool.main(argv)


KEYS = {
    "profile_solver": {"batch", "inner_steps", "full_solve_ms",
                       "solves_per_s", "assemble_ms", "factor_solve_ms",
                       "merit_ms", "unaccounted_ms"},
    "profile_staged": {"batch", "N", "inner_steps", "full_solve_ms",
                       "solves_per_s", "inner_ms", "inner_bt_solve_ms",
                       "assemble_ms", "factor_ms", "factor_bt_solve_ms",
                       "merit_ms"},
    "profile_nn_tube": {"jacfwd_highest", "jacrev_highest",
                        "jacrev_default", "value_and_jacobian",
                        "mlp_fwd_11", "cho_library", "blocked_chol",
                        "capacitance", "thomas_1", "bt_solve_1",
                        "thomas_51", "bt_msolve_51"},
    "profile_tick": {"batch", "H", "schedules", "per_inner_ms",
                     "fixed_per_tick_ms"},
    "profile_sim": {"mass_matrix", "bias_forces", "contact_kin",
                    "forward_dyn", "substep", "env.step", "env_steps_per_s",
                    "decimation", "launches"},
    "profile_quadruped": {"substep", "sim.step(x4)", "trajgen.step",
                          "trajgen.window", "contact_forces", "rewards",
                          "obs", "do_reset(none)", "env.step",
                          "learn_iteration", "learn_env_steps_per_s",
                          "decimation", "num_steps", "launches"},
    "profile_rough": {"batch", "steps_a_call", "nc", "decimation",
                      "flat_kernel_ms", "flat_plain_ms", "rough_no_scan_ms",
                      "rough_ms", "attribution_ms", "launches"},
    "measure_imbalance": {"shards", "per_shard_batch", "wall_ms",
                          "wall_spread", "straggler_penalty_pct",
                          "outer_used_mean_p90_max"},
    "sweep_schedule": {"batch", "schedules"},
    "tune_loop_schedule": {"combos"},
    "compile_time_quadruped": {"target", "barrier", "batch", "first_call_s",
                               "build_s", "decimation", "launches"},
}
TUNE_KEYS = {"sched", "B", "per_tick_ms", "fits_budget", "adopted_frac",
             "coverage", "goal_reach_10cm", "resolves_per_s"}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_on_the_cpu(name, monkeypatch):
    for k in ("E2E_CPU", "B", "ENVS", "TARGET", "BARRIER"):
        monkeypatch.delenv(k, raising=False)
    out = run_tool(name, monkeypatch)
    assert set(out) == KEYS[name]
    assert finite(out)
    if name == "profile_tick":
        assert [r["schedule"] for r in out["schedules"]] == [
            "4x6", "2x6", "4x3", "1x2", "4x6"]
    if name == "sweep_schedule":
        assert [r["schedule"] for r in out["schedules"]] == [
            "2x2x4", "2x1x4", "1x2x4"]
    if name == "tune_loop_schedule":
        assert [r["sched"] for r in out["combos"]] == ["2x2c1", "1x2c2"]
        assert all(set(r) == TUNE_KEYS for r in out["combos"])
    if name == "measure_imbalance":
        assert (out["shards"], out["per_shard_batch"]) == (2, 4)
        assert len(out["wall_ms"]) == 2
    if "launches" in out:    # the CPU launches no kernel
        assert out["launches"]["bt_solve"] == 0
        assert out["launches"]["substep"] == {}


def test_rebuilt_inner_step_matches_jax():
    """Two steps of ``torch_profile_staged.inner_step`` (on
    ``factor_solve_entries``, as the JAX file's) against the JAX file's
    rebuilt inner step, B=2, N=8, from its start on the same inputs."""
    from legged_gym_dev_tpu.solver import ALConfig as JaxALConfig
    from legged_gym_dev_tpu.solver import fast_tube as jft
    from legged_gym_dev_tpu.solver.staged_scalar import (
        _add,
        _assemble_e,
        _is0,
        _merit_e,
        _mul,
        factor_solve_entries,
    )
    from legged_gym_dev_tpu_torch.solver import ALConfig
    from legged_gym_dev_tpu_torch.solver import staged_scalar as tss

    tps = load("torch_profile_staged")
    B, N, steps = 2, 8, 2
    case = gap_case(B, N, 10, "l1")

    p = torch_params(case)
    cfg = ALConfig()
    sp = tps.staged_problem(p, N)
    u0, lb, ub = tps.make_u0(p, N)
    lam, mu, rho = tps.lam_mu(sp, B, cfg, torch.device("cpu"))
    step = tps.inner_step(sp, p, cfg, tps.entries(lb), tps.entries(ub), lam,
                          mu, rho, tss.factor_solve_entries)
    u = tps.entries(u0)
    for _ in range(steps):
        u = step(u)
    got = np.stack([x.numpy() for x in u], axis=-1)

    # the JAX file's rebuilt step (scripts/profile_staged.py:173-236)
    jcfg = JaxALConfig()
    n, m, S, b = 2, 2, N + 1, 5
    jsp = jft.StagedProblem(n=n, m=m, N=N, K=2, tube_kind="l1",
                            scaling=0.5, track_ref=False)

    def one(pp):
        z_ws = (pp.z0[None] + (pp.zf - pp.z0)[None]
                * jnp.linspace(0, 1, S)[:, None])
        u0 = jft.pack_staged(z_ws, jnp.full((S,), 0.1), jnp.zeros((N, m)),
                             n, m, N)
        lb, ub = jft.staged_bounds(pp, n, m, N)
        u_e = tuple(u0[:, i] for i in range(b))
        lb_e = tuple(lb[:, i] for i in range(b))
        ub_e = tuple(ub[:, i] for i in range(b))
        lam = jnp.zeros((N * n + 2 + N,))
        mu = jnp.zeros((S * jsp.K,))
        rho = jnp.asarray(jcfg.rho0)
        eps_e = tuple(1e-9 + 1e-6 * (ub_e[i] - lb_e[i]) for i in range(b))

        def inner_step(u_e):
            merit = _merit_e(jsp, u_e, pp, lam, mu, rho)
            grad_e, D_e, L_e, _ = _assemble_e(jsp, u_e, pp, lam, mu, rho)
            fm = []
            for i in range(b):
                at_lb = (u_e[i] <= lb_e[i] + eps_e[i]) & (grad_e[i] > 0.0)
                at_ub = (u_e[i] >= ub_e[i] - eps_e[i]) & (grad_e[i] < 0.0)
                fm.append((~(at_lb | at_ub)).astype(jnp.float32))
            reg = jcfg.reg + 1e-6 * rho
            Dm = [[0.0] * b for _ in range(b)]
            for i in range(b):
                for j in range(i + 1):
                    if _is0(D_e[i][j]) and i != j:
                        Dm[i][j] = jnp.zeros((S,))
                        continue
                    v = _mul(D_e[i][j], fm[i] * fm[j])
                    if i == j:
                        v = _add(v, (1.0 - fm[i]) + reg)
                    Dm[i][j] = v if not _is0(v) else jnp.zeros((S,))
            Lm = [[_mul(L_e[i][j], fm[i][1:] * fm[j][:-1])
                   for j in range(b)] for i in range(b)]
            gf = [grad_e[i] * fm[i] for i in range(b)]
            d_e = factor_solve_entries(Dm, Lm, [-g for g in gf], b)
            d_e = [jnp.where(fm[i] > 0.0, d_e[i], 0.0) for i in range(b)]
            dir_deriv = 0.0
            for i in range(b):
                dir_deriv = dir_deriv + jnp.sum(grad_e[i] * d_e[i])
            alphas = jcfg.ls_backtrack ** jnp.arange(jcfg.ls_iters,
                                                     dtype=jnp.float32)
            u_try = tuple(jnp.clip(u_e[i][None] + alphas[:, None]
                                   * d_e[i][None], lb_e[i], ub_e[i])
                          for i in range(b))
            m_trys = _merit_e(jsp, u_try, pp, lam, mu, rho)
            ok = m_trys <= merit + jcfg.armijo * alphas * dir_deriv
            idx = jnp.argmax(ok)
            any_ok = jnp.any(ok)
            return tuple(jnp.where(any_ok, u_try[i][idx], u_e[i])
                         for i in range(b))

        for _ in range(steps):
            u_e = inner_step(u_e)
        return jnp.stack(u_e, axis=-1)

    want = np.asarray(jax.vmap(one)(jax_params(case)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the steps moved the iterate
    assert np.abs(got - u0.numpy()).max() > 1e-3


def test_summary_arithmetic_matches_the_jax_formulas():
    tick = load("torch_profile_tick")
    t_44, t_12 = 0.31, 0.075
    per_inner = (t_44 - t_12) / (4 * 6 - 1 * 2)          # profile_tick.py:87
    assert tick.tick_split(t_44, t_12) == pytest.approx(
        (per_inner, t_12 - per_inner * 2))

    imb = load("torch_measure_imbalance")
    walls = np.asarray([0.20, 0.25, 0.21, 0.22])
    spread = walls.max() / walls.mean() - 1.0           # :89-91
    assert imb.imbalance(walls) == (round(float(spread), 4),
                                    round(100 * float(spread), 2))
    assert imb.imbalance([0.3, 0.3]) == (0.0, 0.0)

    sweep = load("torch_sweep_schedule")
    rng = np.random.default_rng(3)
    ref_z = rng.normal(size=(5, 4, 2))
    z = ref_z + rng.normal(size=(5, 4, 2)) * np.arange(5)[:, None, None]
    feas = np.array([True, True, False, True, False])
    ref_feas = np.array([True, False, True, True, False])
    both = feas & ref_feas                               # :75-76
    assert sweep.drift(z, ref_z, feas, ref_feas) == pytest.approx(
        np.abs(z - ref_z)[both].max())
    assert sweep.drift(z, ref_z, feas, ~feas) == -1

    tune = load("torch_tune_loop_schedule")
    assert tune.fits_budget(0.0999, 0.1) is True        # :97
    assert tune.fits_budget(0.1, 0.1) is False

    rough = load("torch_profile_rough")
    assert rough.attribution(1.0, 3.0, 4.5, 7.0) == {
        "scan": 2.5, "terrain_in_contact": 1.5, "kernel_vs_fallback": 2.0}


def test_tools_raise_without_card(monkeypatch):
    """Without a card, and without ``--cpu`` / ``E2E_CPU``, each tool
    raises before any work (there is no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("E2E_CPU", raising=False)
    for name in TOOLS:
        tool = load(f"torch_{name}")
        called = []
        for attr in dir(tool):
            if attr.startswith(("profile_", "measure_", "sweep_", "tune_",
                                "compile_")):
                monkeypatch.setattr(tool, attr,
                                    lambda *a, **k: called.append(1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
        assert not called, name


@pytest.mark.parametrize("barrier", ["all", "fk", "off"])
def test_barrier_other_than_auto_raises(barrier, monkeypatch):
    monkeypatch.setenv("BARRIER", barrier)
    monkeypatch.setenv("E2E_CPU", "1")
    tool = load("torch_compile_time_quadruped")
    with pytest.raises(ValueError, match="fusion barriers"):
        tool.main([])
