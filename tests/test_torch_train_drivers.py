"""The port's RL training drivers (``scripts/torch_train_*.py``, the
counterparts of the JAX package's ``scripts/train_*.py``) on the CPU.

Each driver's ``main`` runs at ENVS=8 and ITERS=2 (the rough one in
chunks of CHUNK=1) on a test robot of tests/torch_robot_cases.py named
through ``OVERRIDES``, with its evaluation cut to a few steps by
monkeypatching the driver's ``evaluate_velocity_tracking``; the LSTM
driver's actuator net is ``write_actuator_net``'s, set as the presets'
``ACTUATOR_NET_PATH``. The numbers returned are finite and keyed as the
JAX file prints them; rough terrain has its 235 observations and a level
curve of one entry a chunk. Without a card, and without ``--cpu`` or
``E2E_CPU``, every driver raises before any work. Each JAX driver has its
counterpart, which reads the same environment knobs with the same
defaults (an AST scan of both files).
"""
import ast
import functools
import importlib.util
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch.envs import presets
from tests import torch_robot_cases as rc
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TRAIN = {"task", "iterations", "envs", "wall_s", "steps_per_s",
         "reward_first5", "reward_last5", "finite"}
EVAL = {"track_err_m_s", "single_stance_frac", "single_stance_moving",
        "done_rate_per_step"}
# driver -> (test robot, knobs, keys of the returned dict, the CPU flag)
DRIVERS = {
    "torch_train_velocity_task": (
        "A1_URDF", {"TASK": "a1_velocity"},
        TRAIN | {"reward_max", "eval"}, "--cpu"),
    "torch_train_cassie": (
        "CASSIE_URDF", {}, TRAIN | {"reward_max", "eval"}, "--cpu"),
    "torch_train_cassie_sanity": ("CASSIE_URDF", {}, TRAIN, "--cpu"),
    "torch_train_anymal_lstm": (
        "QUADRUPED_URDF", {}, TRAIN | {"reward_max", "eval", "pd"}, "--cpu"),
    "torch_train_rough_sanity": (
        "QUADRUPED_URDF", {"CHUNK": "1"}, TRAIN | {"obs", "level_curve"},
        "E2E_CPU"),
}


def env_knobs(path):
    """{name: default} of every ``os.environ.get(NAME, DEFAULT)`` in a
    script."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ"):
            args = [ast.literal_eval(a) for a in node.args]
            out[args[0]] = args[1] if len(args) > 1 else None
    return out


@pytest.mark.parametrize("jax_name", sorted(
    p.name for p in (ROOT / "scripts").glob("train_*.py")))
def test_every_jax_driver_has_a_counterpart_with_its_knobs(jax_name):
    """Each JAX ``scripts/train_*.py`` has ``scripts/torch_train_*.py``
    reading the same environment knobs with the same defaults, plus
    ``OVERRIDES`` (JSON factory keywords) and ``E2E_CPU``."""
    port = ROOT / "scripts" / f"torch_{jax_name}"
    assert port.name[:-3] in DRIVERS
    want = env_knobs(ROOT / "scripts" / jax_name)
    got = env_knobs(port)
    # the drivers share the velocity driver's readers of these two
    shared = env_knobs(ROOT / "scripts" / "torch_train_velocity_task.py")
    got.update({k: v for k, v in shared.items()
                if k in ("OVERRIDES", "E2E_CPU")})
    assert got == {**want, "OVERRIDES": "{}", "E2E_CPU": None}


def load(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_train(rec, task, keys):
    assert set(rec) == keys
    assert rec["task"] == task
    assert (rec["iterations"], rec["envs"]) == (2, 8)
    assert rec["finite"] is True
    for k in keys - {"task", "finite", "eval", "pd", "level_curve"}:
        assert np.isfinite(rec[k]), (k, rec[k])


def check_eval(stats):
    assert set(stats) == EVAL
    assert np.isfinite(stats["track_err_m_s"]) and stats["track_err_m_s"] >= 0
    for k in EVAL - {"track_err_m_s"}:
        assert 0.0 <= stats[k] <= 1.0, (k, stats[k])


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_runs_on_the_cpu(name, monkeypatch, tmp_path):
    const, knobs, keys, cpu_flag = DRIVERS[name]
    for k in ("TASK", "CHUNK", "SKIP_PD", "E2E_CPU"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ENVS", "8")
    monkeypatch.setenv("ITERS", "2")
    monkeypatch.setenv("OVERRIDES", json.dumps(
        {"urdf_path": getattr(rc, const)}))
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(presets, "ACTUATOR_NET_PATH", str(
        rc.write_actuator_net(tmp_path / "net.pt", seed=0)))
    driver = load(name)
    if hasattr(driver, "evaluate_velocity_tracking"):
        monkeypatch.setattr(driver, "evaluate_velocity_tracking",
                            functools.partial(
                                driver.evaluate_velocity_tracking,
                                steps=3, settle=1))
    if cpu_flag == "E2E_CPU":
        monkeypatch.setenv("E2E_CPU", "1")
        out = driver.main([])
    else:
        out = driver.main([cpu_flag])
    task = {"torch_train_velocity_task": "a1_velocity",
            "torch_train_anymal_lstm": "anymal_c_lstm",
            "torch_train_rough_sanity": "anymal_c_rough"}.get(
        name, "cassie_velocity")
    check_train(out, task, keys)
    if "eval" in keys:
        check_eval(out["eval"])
    if "pd" in keys:
        check_train(out["pd"], "anymal_c_velocity", TRAIN | {"reward_max"})
    if name == "torch_train_rough_sanity":
        assert out["obs"] == 235
        assert [c[0] for c in out["level_curve"]] == [1, 2]
        for _, mean, mx in out["level_curve"]:
            assert 0 <= mean <= mx
    # the runner logged under the temporary directory
    assert any(tmp_path.glob("*_logs/*/*/metrics.jsonl"))


def test_drivers_raise_without_card(monkeypatch):
    """Without a card, and without ``--cpu`` / ``E2E_CPU``, each driver
    raises before any work (there is no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("E2E_CPU", raising=False)
    for name in DRIVERS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(name).main([])
