"""The port's flagship pipelines (``scripts/torch_flagship_e2e.py`` and
``scripts/torch_flagship_rl_e2e.py``) against the JAX scripts
(``scripts/flagship_e2e.py``, ``scripts/flagship_rl_e2e.py``).

The JAX scripts are monoliths run on a chip, so their glue is held piece
by piece on the same numpy inputs: the scenario batch (the same
``default_rng`` draws, bit for bit), the episode-level calibration split
and both tube datasets (exact), the report arithmetic (the JAX scripts'
expressions; the tube coverage and trace-conformal functions of the JAX
package on the flattened traces; the calibrated net against the JAX MLP
with ``out_scale`` replaced, at 1e-6), and the checkpoint selection. Then
both scripts run end to end on the CPU at tiny sizes (the RL one on the
test hopper): their reports carry every key of the JAX scripts' reports
(``chip_smoke.FLAGSHIP_KEYS``, itself read against the JAX scripts'
source), every number is finite, and the kernel wrappers' plain versions
are called exactly as often as ``chip_smoke.flagship_expected`` says the
kernels launch on the card.
"""
import ast
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import DoubleInt2D as JaxDoubleInt2D
from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.evaluation import (
    evaluate_tube_on_mpc_trace as jax_trace_cov,
)
from legged_gym_dev_tpu.evaluation import (
    trace_conformal_scale as jax_trace_scale,
)
from legged_gym_dev_tpu.solver import PROBLEM_DICT
from legged_gym_dev_tpu.solver import TrajOptParams as JaxParams
from legged_gym_dev_tpu.tube.datasets import RolloutData as JaxRollout
from legged_gym_dev_tpu.tube.datasets import (
    scalar_horizon_tube_dataset as jax_horizon_ds,
)
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.evaluation import (
    evaluate_tube_on_mpc_trace,
    trace_conformal_scale,
)
from legged_gym_dev_tpu_torch.interop import mlp_from_numpy
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
from legged_gym_dev_tpu_torch.solver import ALConfig
from legged_gym_dev_tpu_torch.tube.datasets import RolloutData
from legged_gym_dev_tpu_torch.tube.datasets import (
    scalar_horizon_tube_dataset,
)
from tests.torch_port_cases import mlp_weights
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import HOPPER_URDF

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


rom_fs = _load("torch_flagship_e2e",
               ROOT / "scripts" / "torch_flagship_e2e.py")
rl_fs = _load("torch_flagship_rl_e2e",
              ROOT / "scripts" / "torch_flagship_rl_e2e.py")
chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")

N, H_REV = 8, 2
TINY = ALConfig(outer_iters=2, inner_iters=2, nn_basis_refresh=3)
SCHEDULES = ((2, 2, 3), (2, 2, 3))


def _jax_batch(prob, v_plan, B, seed):
    """The JAX scripts' scenario batch (``flagship_e2e.py:113-129``,
    ``flagship_rl_e2e.py:314-330``)."""
    pm = jax_make_rom("SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
                      [prob["pos_max"]] * 2, [-v_plan] * 2, [v_plan] * 2)
    p = JaxParams.create(
        pm, N, H_REV, 10 * np.eye(2), 10 * np.eye(2),
        prob["start"], prob["goal"], prob["obs"]["c"], prob["obs"]["r"],
        Qw=0.1, w_max=1.0, tube_params=None)
    rng = np.random.default_rng(seed)
    pb = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    return pb.replace(
        z0=pb.z0 + jnp.asarray(rng.uniform(-0.15, 0.15, (B, 2)),
                               jnp.float32),
        zf=pb.zf + jnp.asarray(rng.uniform(-0.15, 0.15, (B, 2)),
                               jnp.float32),
        obs_r=pb.obs_r * jnp.asarray(rng.uniform(0.85, 1.0, (B, 2)),
                                     jnp.float32))


@pytest.mark.parametrize("script,seed", [("rom", 0), ("rom", 101),
                                         ("rl", 0), ("rl", 101)])
def test_scenario_batch_matches_jax(script, seed):
    """(a) z0, zf, obs_c, obs_r bit for bit; the RL script's planning ROM
    bounded by v_plan (0.15 here), the ROM script's by the problem's."""
    prob = PROBLEM_DICT["gap"]
    v_plan = prob["vel_max"] if script == "rom" else 0.15
    B = 6
    ref = _jax_batch(prob, v_plan, B, seed)
    pm = make_rom("SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
                  [prob["pos_max"]] * 2, [-v_plan] * 2, [v_plan] * 2,
                  device="cpu")
    p = rom_fs.nn_tube_batch(pm, prob, B, N, H_REV, None, seed, "cpu")
    for f in ("z0", "zf", "obs_c", "obs_r", "sqrt_qw", "w_max", "Lq", "Lr"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(p.rom.v_max[0].numpy(),
                                  np.asarray(ref.rom.v_max[0]))


def _rollouts(E=23, T=16, seed=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, (E, T + 1, 2)).astype(np.float32)
    pz = z + rng.normal(0, 0.1, (E, T + 1, 2)).astype(np.float32)
    v = rng.uniform(-0.2, 0.2, (E, T, 2)).astype(np.float32)
    done = rng.uniform(size=(E, T)) < 0.03
    return z, v, pz, done


def test_calibration_split_and_datasets_match_jax():
    """(b) the last E // 10 episodes (at least one) held out, and the
    training and calibration horizon datasets of both packages equal,
    down to their clean-window lists and a batch drawn from each."""
    z, v, pz, done = _rollouts()
    train, cal = rl_fs.calibration_split(RolloutData(z=z, v=v, pz_x=pz,
                                                     done=done))
    jd = JaxRollout(z=z, v=v, pz_x=pz, done=done)
    E = jd.z.shape[0]
    n_cal = max(E // 10, 1)
    jtrain = JaxRollout(z=jd.z[:-n_cal], v=jd.v[:-n_cal],
                        pz_x=jd.pz_x[:-n_cal], done=jd.done[:-n_cal])
    jcal = JaxRollout(z=jd.z[-n_cal:], v=jd.v[-n_cal:],
                      pz_x=jd.pz_x[-n_cal:], done=jd.done[-n_cal:])
    assert cal.z.shape[0] == n_cal == 2
    for ours, ref in ((train, jtrain), (cal, jcal)):
        for f in ("z", "v", "pz_x", "done"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
        ds = scalar_horizon_tube_dataset(ours, H_fwd=N, H_rev=H_REV)
        rds = jax_horizon_ds(ref, H_fwd=N, H_rev=H_REV)
        for f in ("w", "z_rest", "v", "valid"):
            np.testing.assert_array_equal(getattr(ds, f), getattr(rds, f),
                                          err_msg=f)
        x, y = ds.sample_batch(np.random.default_rng(12), 64)
        rx, ry = rds.sample_batch(np.random.default_rng(12), 64)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    # a one-episode rollout set still holds one episode out
    one = RolloutData(z=z[:3], v=v[:3], pz_x=pz[:3], done=done[:3])
    assert rl_fs.calibration_split(one)[1].z.shape[0] == 1


def test_report_arithmetic_matches_jax():
    """(c) the JAX scripts' expressions on fixed arrays: the shifted
    adopted-violation index, goal statistics, timing keys, v_plan and the
    surrogate robot's bounds, the trace coverage and trace-conformal scale
    on the flattened traces (JAX's functions), and the compounded
    ``out_scale``."""
    rng = np.random.default_rng(7)
    B, H = 5, 6
    viols = rng.uniform(0, 2e-3, (B, H)).astype(np.float32)
    adopts = rng.uniform(size=(B, H)) < 0.6
    assert rom_fs.max_adopted_viol(viols, adopts) == float(
        np.where(adopts[:, 1:], viols[:, :-1], 0.0).max())
    z_t = rng.normal(1.5, 0.1, (B, H + 1, 2)).astype(np.float32)
    goal = PROBLEM_DICT["gap"]["goal"]
    goal_dist = np.linalg.norm(z_t[:, -1] - np.asarray(goal), axis=-1)
    assert rom_fs.goal_stats(z_t, goal) == {
        "median_goal_dist": float(np.median(goal_dist)),
        "goal_reach_frac_10cm": float(np.mean(goal_dist < 0.1))}
    t_mpc, t_first, dt = 0.731, 2.4, 0.1
    per = t_mpc / (H + 1)
    assert rom_fs.loop_timing(B, H, t_mpc, t_first, dt) == {
        "wall_s": round(t_mpc, 3),
        "compile_plus_first_s": round(t_first, 1),
        "per_resolve_batched_s": round(per, 4), "rom_tick_budget_s": dt,
        "realtime_batched": bool(per < dt),
        "resolves_per_s": round(B * (H + 1) / t_mpc, 1)}

    prob = PROBLEM_DICT["gap"]
    for v_max_data in (0.15, 0.35):
        env = rl_fs.mpc_env(prob["vel_max"], v_max_data, 1.5, 2.5)
        assert env == {"v_max_data": v_max_data,
                       "v_plan": min(float(prob["vel_max"]), v_max_data),
                       "robot_vel": 1.5 * v_max_data,
                       "robot_acc": 2.5 * v_max_data}
        rv, ra = env["robot_vel"], env["robot_acc"]
        ours = rom_fs.surrogate_robot(prob["dt"], rv, ra, "cpu")
        ref = JaxDoubleInt2D.create(prob["dt"], [-np.inf, -np.inf, -rv, -rv],
                                    [np.inf, np.inf, rv, rv], [-ra, -ra],
                                    [ra, ra])
        for f in ("z_min", "z_max", "v_min", "v_max"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(ref, f)))

    w_t = rng.uniform(0.05, 0.3, (B, H + 1)).astype(np.float32)
    w_t[:, 0] = 0.0
    pzx = z_t + rng.normal(0, 0.1, z_t.shape).astype(np.float32)
    ours = evaluate_tube_on_mpc_trace(rom_fs.flat_trace(z_t, w_t, pzx,
                                                        viols))
    ref_trace = types.SimpleNamespace(
        z=z_t.reshape(-1, 2), w=w_t.reshape(-1), pz_x=pzx.reshape(-1, 2),
        viol=viols, converged=viols < 1e-3)
    ref = jax_trace_cov(ref_trace)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-7), k
    q = trace_conformal_scale(rom_fs.flat_trace(z_t, w_t, pzx), alpha=0.9)
    assert q == pytest.approx(jax_trace_scale(ref_trace, alpha=0.9),
                              rel=1e-6)

    ws, bs = mlp_weights(2 * H_REV + 3, N, 16, seed=3)
    model = mlp_from_numpy(ws, bs, activation="softplus_b5",
                           final_activation="softplus", device="cpu")
    jm = JaxMLP(weights=tuple(jnp.asarray(w) for w in ws),
                biases=tuple(jnp.asarray(b) for b in bs),
                final_activation="softplus")
    x = rng.normal(0, 1, (9, 2 * H_REV + 3)).astype(np.float32)
    s = 0.8123
    for scale in (1.0, s, s * q):       # uncalibrated, calibrated, trace
        ours = rom_fs.with_out_scale(model, scale)
        ref = jm.replace(out_scale=jnp.asarray(scale))
        assert float(ours.out_scale) == float(np.asarray(ref.out_scale))
        np.testing.assert_allclose(ours(torch.as_tensor(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)


class _FakeRunner:
    """A runner whose checkpoints are names: the inference policy returns
    the name last loaded."""

    def __init__(self, stages):
        self.ckpt = type("C", (), {"best_stages": lambda _: stages})()
        self.loaded = []

    def load(self, name):
        self.loaded.append(name)

    def get_inference_policy(self):
        name = self.loaded[-1]
        return lambda obs=None: name


@pytest.mark.parametrize("errs,winner", [
    ({"latest": (0.3, 0.2, 0.4), "best0": (0.1, 0.2, 0.1),
      "best3": (0.2, 0.2, 0.2)}, "best0"),
    ({"latest": (0.1, 0.1, 0.1), "best1": (0.1, 0.1, 0.1)}, "latest"),
])
def test_selection_loads_lowest_mean_fixture_error(errs, winner):
    """(d) every candidate, ``latest`` first, rolled on the three
    fixtures; the lowest mean error (the first on a tie, as JAX's strict
    ``<``) is loaded last and reported."""
    stages = sorted(int(k[4:]) for k in errs if k != "latest")
    runner = _FakeRunner(stages)

    def eval_fixtures(policy):
        return {f: {"mean_tracking_error": e}
                for f, e in zip(rl_fs.FIXTURE_NAMES, errs[policy()])}

    name, selection, fixtures = rl_fs.select_checkpoint(runner,
                                                        eval_fixtures)
    assert name == winner and runner.loaded[-1] == winner
    assert list(selection) == ["latest"] + [f"best{s}" for s in stages]
    for cand, e in errs.items():
        assert selection[cand]["fixture_mean_err"] == round(
            float(np.mean(e)), 4)
        assert [selection[cand][f] for f in rl_fs.FIXTURE_NAMES] == list(e)
    assert fixtures["circle"]["mean_tracking_error"] == errs[winner][2]


def _report_keys(path):
    """{section: keys} of a JAX flagship script's report: the string keys
    of the dict literal a section is assigned, "call" for a function's
    result (the RL script's ``run_loop``), None for anything else; and
    ``run_loop``'s record's keys."""
    sections, rec = {}, None
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Assign):
            continue
        keys = ([k.value for k in node.value.keys
                 if isinstance(k, ast.Constant)]
                if isinstance(node.value, ast.Dict) else
                "call" if isinstance(node.value, ast.Call) else None)
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "report":
                sections.update({k: [] for k in keys})
            elif isinstance(t, ast.Name) and t.id == "rec":
                rec = keys
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name)
                  and t.value.id == "report"):
                sections[t.slice.value] = keys
    return sections, rec


@pytest.mark.parametrize("kind,script", [("rom", "flagship_e2e.py"),
                                         ("rl", "flagship_rl_e2e.py")])
def test_chip_smoke_keys_are_the_jax_reports(kind, script):
    """``chip_smoke.FLAGSHIP_KEYS`` names each section of the JAX script's
    report, with the keys of the dict literal it is assigned (the RL
    closed loops: ``run_loop``'s record; the trace coverage: the keys of
    the JAX package's ``evaluate_tube_on_mpc_trace``)."""
    sections, rec = _report_keys(ROOT / "scripts" / script)
    ours = chip_smoke.FLAGSHIP_KEYS[kind]
    assert set(ours) == set(sections)
    for sec, keys in sections.items():
        if keys == "call":
            keys = rec
        if keys:
            assert set(ours[sec]) == set(keys), sec
    z = np.zeros((3, 2), np.float32)
    cov_keys = jax_trace_cov(types.SimpleNamespace(
        z=z, w=np.ones(3), pz_x=z, viol=np.zeros(2),
        converged=np.ones(2, bool))).keys()
    assert set(chip_smoke.TRACE_KEYS) == set(cov_keys)
    assert sections.get("fixture_tracking", None) is None


def test_chip_smoke_schedules_are_the_scripts():
    cfgs = (rom_fs.CFG_FIRST, rom_fs.CFG_LOOP)
    for cfg, (outer, inner, refresh) in zip(cfgs,
                                            chip_smoke.FLAGSHIP_SCHEDULES):
        assert (cfg.outer_iters, cfg.inner_iters, cfg.nn_basis_refresh) == (
            outer, inner, refresh)
    assert (rom_fs.N, rom_fs.H_REV) == (50, 10)


@pytest.fixture
def counted(monkeypatch):
    """Counts the kernels' plain versions as the wrappers count launches
    on the card: bt_solve, bt_factor + bt_msolve, substep per nj."""
    counts = {"bt_solve": 0, "bt_factor": 0, "bt_msolve": 0, "substep": {}}
    solve = btk.block_tridiag_solve_entries_plain
    multi = btk.block_tridiag_multirhs_entries_plain
    plain = sk.substep_plain

    def solve_c(*a, **k):
        counts["bt_solve"] += 1
        return solve(*a, **k)

    def multi_c(*a, **k):
        counts["bt_factor"] += 1
        counts["bt_msolve"] += 1
        return multi(*a, **k)

    def plain_c(sim, *a, **k):
        nj = str(sim.model.nj)
        counts["substep"][nj] = counts["substep"].get(nj, 0) + 1
        return plain(sim, *a, **k)

    monkeypatch.setattr(btk, "block_tridiag_solve_entries_plain", solve_c)
    monkeypatch.setattr(btk, "block_tridiag_multirhs_entries_plain", multi_c)
    monkeypatch.setattr(sk, "substep_plain", plain_c)
    return counts


def _assert_report(kind, rep):
    for sec, keys in chip_smoke.FLAGSHIP_KEYS[kind].items():
        assert sec in rep, sec
        assert not [k for k in keys if k not in rep[sec]], sec
    bad = [p for p, v in chip_smoke._numbers(rep) if not np.isfinite(v)]
    assert not bad
    # on the CPU no kernel launches: the wrappers took the plain versions
    assert rep["launches"] == {"bt_solve": 0, "bt_factor": 0,
                               "bt_msolve": 0, "substep": {}}
    json.dumps(rep)


def test_rom_flagship_end_to_end_cpu(counted):
    """(e) the ROM flagship at B=4, H=2, N=8, H_rev=2, 2x2 schedules, one
    epoch, one timed call."""
    knobs = {"B": 4, "H": 2, "REPS": 1}
    rep = rom_fs.run_flagship(B=4, H=2, epochs=1, collect_envs=6,
                              linsolve="pallas", reps=1, N=N, H_rev=H_REV,
                              cfg_first=TINY, cfg_loop=TINY, device="cpu")
    _assert_report("rom", rep)
    assert rep["mpc"]["scenarios"] == 4 and rep["mpc"]["H"] == 2
    assert rep["collect"]["episodes"] == 12
    assert counted == chip_smoke.flagship_expected("rom", knobs, rep,
                                                   schedules=SCHEDULES)


def test_rl_flagship_end_to_end_cpu(counted, tmp_path):
    """(e) the RL flagship on the test hopper: 16 train envs, one
    iteration, 2 fixture steps, one collection epoch of 1 s (10 ROM ticks
    = N + 2), B=4, H=2, 2x2 schedules, one epoch, one timed call; the
    report is also written to REPORT."""
    from legged_gym_dev_tpu_torch.envs import task_registry

    knobs = {"TRAIN_ITERS": 1, "FIXTURE_STEPS": 2, "COLLECT_EPOCHS": 1,
             "EPISODE_S": 1.0, "B": 4, "H": 2, "REPS": 1}
    report = tmp_path / "report.json"
    rep = rl_fs.run_rl_flagship(
        train_iters=1, train_envs=16, collect_epochs=1, collect_envs=10,
        B=4, H=2, epochs=1, fixture_envs=4, fixture_steps=2,
        urdf=HOPPER_URDF, episode_s=1.0, reps=1, N=N, H_rev=H_REV,
        cfg_first=TINY, cfg_loop=TINY, device="cpu",
        report_path=str(report), log_root=str(tmp_path / "logs"))
    _assert_report("rl", rep)
    assert json.loads(report.read_text()) == rep
    assert rep["curriculum"] == "single_int"
    assert rep["checkpoint_selection"]["selected"] in \
        rep["checkpoint_selection"]["candidates"]
    assert rep["collect"]["episodes"] == 10
    assert rep["mpc_env"] == {"v_max_data": 0.2, "v_plan": 0.2,
                              "robot_vel": 0.3, "robot_acc": 0.5}
    assert rep["trace_conformal"]["out_scale"] == pytest.approx(
        rep["tube_train"]["conformal_scale"]
        * rep["trace_conformal"]["scale_q"], abs=2e-4)
    env = task_registry.make_env("hopper_trajectory", num_envs=1,
                                 urdf_path=HOPPER_URDF, device="cpu")
    hopper = {"nj": env.sim.model.nj, "decimation": env.sim.decimation,
              "dt": float(env.dt), "rom_dt": float(env.rom.dt),
              "num_steps": task_registry.get(
                  "hopper_trajectory").train_cfg.num_steps}
    assert counted == chip_smoke.flagship_expected("rl", knobs, rep, hopper,
                                                   schedules=SCHEDULES)
