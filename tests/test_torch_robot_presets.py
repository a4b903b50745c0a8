"""The port's task registry and robot presets against the JAX package's:
the same 13 task names and PPO configs; every task built from a test
robot of tests/torch_robot_cases.py and stepped on the CPU; the presets'
settings (reward tables, gains, noise vectors, height-scan grid, terrain
tables) equal to the JAX presets' on the same URDF; and ``cli train``
building the rough task from ``configs/rl/anymal_c_rough.yaml`` and the
new tasks from ``--task``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu.envs import presets as jax_presets
from legged_gym_dev_tpu.envs.registry import task_registry as jax_registry
from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.envs import presets, task_registry
from tests.torch_robot_cases import (
    A1_URDF,
    BIPED10_URDF,
    CASSIE_URDF,
    HOPPER_URDF,
    QUADRUPED_URDF,
    write_actuator_net,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NEW_TASKS = ("a1_velocity", "anymal_c_velocity", "anymal_b_velocity",
             "a1_trajectory", "anymal_c_lstm", "cassie_velocity",
             "adam_velocity", "anymal_c_rough", "anymal_c_rough_trajectory")
# task -> (test URDF, observations at 12 joints / the robot's)
TASKS = {
    "a1_velocity": (A1_URDF, 48),
    "anymal_c_velocity": (QUADRUPED_URDF, 48),
    "anymal_b_velocity": (QUADRUPED_URDF, 48),
    "a1_trajectory": (A1_URDF, 65),
    "anymal_c_trajectory": (QUADRUPED_URDF, 65),
    "anymal_c_lstm": (QUADRUPED_URDF, 48),
    "cassie_velocity": (CASSIE_URDF, 48),
    "adam_velocity": (BIPED10_URDF, 12 + 3 * 10),
    "anymal_c_rough": (QUADRUPED_URDF, 235),
    "anymal_c_rough_trajectory": (QUADRUPED_URDF, 252),
    "hopper_trajectory": (HOPPER_URDF, 38),
    "hopper_velocity": (HOPPER_URDF, None),
    "rom_tracking": (None, None),
}
SMALL_TERRAIN = dict(terrain_rows=2, terrain_cols=2)


@pytest.fixture
def net_path(tmp_path, monkeypatch):
    """The actuator net's file, written by the test, as both packages'
    ``ACTUATOR_NET_PATH``."""
    path = str(write_actuator_net(tmp_path / "net.pt", seed=1))
    monkeypatch.setattr(presets, "ACTUATOR_NET_PATH", path)
    monkeypatch.setattr(jax_presets, "ACTUATOR_NET_PATH", path)
    return path


def task_kwargs(task):
    urdf, _ = TASKS[task]
    kw = {} if urdf is None else {"urdf_path": urdf}
    if "rough" in task:
        kw.update(SMALL_TERRAIN)
    return kw


def test_registry_lists_the_jax_tasks():
    assert task_registry.list_tasks() == jax_registry.list_tasks()
    assert len(task_registry.list_tasks()) == 13 == len(TASKS)
    for name in task_registry.list_tasks():
        ours = dataclasses.asdict(task_registry.get(name).train_cfg)
        theirs = dataclasses.asdict(jax_registry.get(name).train_cfg)
        assert {k: ours[k] for k in theirs if k in ours} == {
            k: v for k, v in theirs.items() if k in ours}, name


@pytest.mark.parametrize("task", sorted(TASKS))
def test_every_task_builds_and_steps_on_the_cpu(task, net_path):
    env = task_registry.make_env(task, num_envs=4, device="cpu",
                                 **task_kwargs(task))
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    width = TASKS[task][1]
    assert obs.shape == (4, width or env.num_obs) == (4, env.num_obs)
    actions = 0.3 * torch.randn((4, env.num_actions), generator=gen)
    state, tr = env.step(state, actions)
    assert bool(torch.isfinite(tr.obs).all())
    assert bool(torch.isfinite(tr.reward).all())


def jax_env(task, monkeypatch, **kw):
    """The JAX preset of ``task`` on its test URDF (the preset's URDF
    constant set to it; the Adam preset takes it as ``urdf_path``)."""
    urdf = TASKS[task][0]
    const = {"a1": "A1_URDF", "cassie": "CASSIE_URDF"}.get(
        task.split("_")[0], "ANYMAL_B_URDF" if "anymal_b" in task
        else "ANYMAL_C_URDF")
    if task == "adam_velocity":
        kw["urdf_path"] = urdf
    else:
        monkeypatch.setattr(jax_presets, const, urdf)
    return jax_registry.make_env(task, **kw)


FIELDS = ("default_dof_pos", "p_gains", "d_gains", "base_init_pos",
          "noise_vec", "init_command_ranges")


@pytest.mark.parametrize("task", NEW_TASKS)
def test_presets_match_jax(task, monkeypatch, net_path):
    kw = dict(num_envs=6, **({k: v for k, v in task_kwargs(task).items()
                              if k != "urdf_path"}))
    jenv = jax_env(task, monkeypatch, **kw)
    tenv = task_registry.make_env(task, device="cpu", **task_kwargs(task),
                                  num_envs=6)
    assert tenv.num_obs == jenv.num_obs
    assert tenv.reward_scales == jenv.reward_scales
    assert (tenv.feet_spheres, tenv.penalized_spheres,
            tenv.termination_spheres) == (jenv.feet_spheres,
                                          jenv.penalized_spheres,
                                          jenv.termination_spheres)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tenv, name).numpy(),
                                      np.asarray(getattr(jenv, name)),
                                      err_msg=name)
    for name in ("action_scale", "measured_points_x", "measured_points_y",
                 "randomize_base_mass", "added_mass_range",
                 "command_curriculum", "only_positive_rewards", "dt",
                 "terrain_curriculum"):
        assert getattr(tenv, name) == getattr(jenv, name), name
    assert float(tenv.max_contact_force) == float(jenv.max_contact_force)
    assert float(tenv.base_height_target) == float(jenv.base_height_target)
    for name in ("terrain_origins", "terrain_types", "env_origins"):
        t, j = getattr(tenv, name), getattr(jenv, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if "trajectory" in task:
        np.testing.assert_array_equal(tenv.reward_weighting.numpy(),
                                      np.asarray(jenv.reward_weighting))
    if task == "anymal_c_lstm":
        for f in ("w_ih", "w_hh", "b_ih", "b_hh"):
            for a, b in zip(getattr(tenv.actuator_net, f),
                            getattr(jenv.actuator_net, f)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def run_args(tmp_path, task_args, env):
    cfg = tmp_path / "config.yaml"
    lines = [f"{k}: {v}" for k, v in env.items()]
    cfg.write_text("defaults:\n  - " + str(ROOT / "configs/rl/default.yaml")
                   + "\n  - _self_\nenv:\n"
                   + "".join(f"  {x}\n" for x in lines))
    return cli.build_parser().parse_args(
        ["train", "--config", str(cfg), "--log-root", str(tmp_path),
         "--num-envs", "4", "--cpu", *task_args])


def test_cli_builds_the_rough_task(tmp_path):
    """``configs/rl/anymal_c_rough.yaml`` through ``cli.make_runner``, its
    terrain cut to 2x2 by the config's ``env`` keys, then one learn
    iteration."""
    urdf = tmp_path / "robot.urdf"
    urdf.write_text(QUADRUPED_URDF)
    cfg = tmp_path / "rough.yaml"
    cfg.write_text("defaults:\n  - " + str(ROOT / "configs/rl/"
                                           "anymal_c_rough.yaml")
                   + "\n  - _self_\nenv:\n  urdf_path: " + str(urdf)
                   + "\n  terrain_rows: 2\n  terrain_cols: 2\n")
    args = cli.build_parser().parse_args(
        ["train", "--config", str(cfg), "--log-root", str(tmp_path),
         "--num-envs", "4", "--cpu"])
    runner, iters = cli.make_runner(args)
    env = runner.env
    assert iters == 1500 and env.num_obs == 235
    assert Path(runner.log_dir).parent.name == "anymal_c_rough"
    assert tuple(env.terrain_origins.shape) == (2, 2, 3)
    assert env.terrain_curriculum and env.num_height_points == 187
    hist = runner.learn(1)
    assert np.isfinite(hist[-1]["mean_reward"])


@pytest.mark.parametrize("task", NEW_TASKS)
def test_cli_train_task_builds_each_new_task(task, tmp_path, net_path):
    urdf = tmp_path / "robot.urdf"
    urdf.write_text(TASKS[task][0])
    env = {"urdf_path": str(urdf)}
    env.update({k: v for k, v in task_kwargs(task).items()
                if k != "urdf_path"})
    runner, _ = cli.make_runner(run_args(tmp_path, ["--task", task], env))
    assert Path(runner.log_dir).parent.name == task
    assert runner.env.num_obs == TASKS[task][1]
    assert runner.env.num_envs == 4
