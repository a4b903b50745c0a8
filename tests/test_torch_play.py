"""``cli play`` of the port: its signals, its log and its exports.

- ``_play_signals`` on the quadruped trajectory task (the 12-joint test
  robot, B=4) against the JAX package's, from JAX's reset state carried
  to the port and a transition drawn with numpy: every key, atol 1e-5
  (the contact force: rtol 1e-5).
- ``Logger.save_mat`` round trip.
- ``cli train`` then ``cli play`` on ``rom_tracking`` with ``--cpu``:
  1 iteration, then 5 steps with ``--export`` and ``--mat``; the exported
  TorchScript and ``.pt2`` programs give the inference policy's actions.
- A recurrent run exports the stateful LSTM module (JAX's
  tests/test_cli.py::test_play_recurrent_exports_lstm).
"""
import json

import numpy as np
import pytest
import torch

import jax

from legged_gym_dev_tpu import cli as jcli
from legged_gym_dev_tpu.envs.base import Transition as JaxTransition
from legged_gym_dev_tpu.envs.presets import _anymal_c_kwargs as jax_kwargs
from legged_gym_dev_tpu.envs.presets import (
    make_trajectory_env as jax_make_trajectory_env,
)
from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.envs.base import Transition
from legged_gym_dev_tpu_torch.envs.presets import (
    _anymal_c_kwargs,
    make_trajectory_env,
)
from legged_gym_dev_tpu_torch.interop import env_state_from_numpy
from legged_gym_dev_tpu_torch.utils.export import load_policy_exported
from legged_gym_dev_tpu_torch.utils.logger import Logger
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    jax_call,
    one_torch_thread,
)
from tests.torch_robot_cases import QUADRUPED_URDF

B = 4
RIGID_KEYS = {"reward", "dof_pos", "dof_vel", "base_vel_x", "base_vel_y",
              "base_vel_z", "base_vel_yaw", "dof_torque", "dof_pos_target",
              "command_x", "command_y", "command_yaw", "tracking_error",
              "contact_forces_z"}


def test_play_signals_match_jax():
    kw = dict(max_contact_force=350.0, num_envs=B, add_noise=False)
    jenv = jax_make_trajectory_env(QUADRUPED_URDF, **jax_kwargs({}), **kw)
    tenv = make_trajectory_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                               device="cpu", **kw)
    js, _ = jax_call(jenv.reset, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    js = js.replace(
        actions=rng.normal(0, 0.5, (B, 12)).astype(np.float32),
        torques=rng.normal(0, 5.0, (B, 12)).astype(np.float32),
        prev_error=rng.uniform(0, 0.1, (B, 2)).astype(np.float32))
    # env 0's feet in the ground, so the contact force is not zero
    js = js.replace(robot=js.robot.replace(
        base_pos=js.robot.base_pos.at[0, 2].add(-0.1)))
    js = jax.tree.map(np.asarray, js)
    obs = rng.normal(size=(B, tenv.num_obs)).astype(np.float32)
    rew = rng.normal(size=B).astype(np.float32)
    jsig = jcli._play_signals(jenv, js, JaxTransition(obs, None, rew, None,
                                                      {}))
    ts = env_state_from_numpy(js, tenv)
    tsig = cli._play_signals(tenv, ts, Transition(
        torch.as_tensor(obs), None, torch.as_tensor(rew), None, {}))
    assert set(jsig) == RIGID_KEYS and set(tsig) == set(jsig)
    for k, v in jsig.items():
        v = np.asarray(v)
        assert tuple(tsig[k].shape) == v.shape, k
        rtol = 1e-5 if k == "contact_forces_z" else 0.0
        np.testing.assert_allclose(tsig[k].numpy(), v, atol=1e-5,
                                   rtol=rtol, err_msg=k)
    assert float(tsig["contact_forces_z"].max()) > 1.0


def test_logger_save_mat_round_trip(tmp_path):
    from scipy.io import loadmat

    log = Logger(dt=0.02)
    rng = np.random.default_rng(0)
    rows = [rng.normal(size=3).astype(np.float32) for _ in range(5)]
    for r in rows:
        log.log_states({"dof_pos": torch.as_tensor(r),
                        "reward": np.float32(r[0])})
    log.log_rewards({"rew_tracking": 0.5, "other": 1.0}, num_episodes=2)
    path = log.save_mat(str(tmp_path / "sub" / "log.mat"))
    d = loadmat(path)
    np.testing.assert_array_equal(d["dof_pos"], np.stack(rows))
    np.testing.assert_array_equal(d["reward"][0],
                                  np.asarray([r[0] for r in rows]))
    assert float(d["dt"]) == pytest.approx(0.02)
    assert log.rew_log == {"rew_tracking": [1.0]} and log.num_episodes == 2
    log.reset()
    assert not log.state_log and log.num_episodes == 0


def _last_json(out):
    return json.loads([line for line in out.splitlines()
                       if line.startswith("{")][-1])


def test_cmd_play_end_to_end(tmp_path, capsys):
    from scipy.io import loadmat

    logs = str(tmp_path / "logs")
    # a run name of its own: play's run dir, made in the same second,
    # must not take the trained run's name
    cli.main(["train", "--task", "rom_tracking", "--cpu", "--num-envs",
              "8", "--max-iterations", "1", "--log-root", logs,
              "--run-name", "t"])
    capsys.readouterr()
    exp, mat = tmp_path / "export", tmp_path / "play.mat"
    cli.main(["play", "--task", "rom_tracking", "--cpu", "--num-envs", "2",
              "--steps", "5", "--log-root", logs, "--export", str(exp),
              "--mat", str(mat)])
    out = capsys.readouterr().out
    rec = _last_json(out)
    assert rec["steps"] == 5 and rec["num_envs"] == 2
    assert "exported TorchScript" in out and "exported ONNX: None" in out
    d = loadmat(str(mat))
    assert d["reward"].shape == (1, 5) and d["base_vel_x"].shape == (1, 5)
    assert np.all(np.isfinite(d["reward"]))
    # the exports give the trained policy's actions
    from legged_gym_dev_tpu_torch.envs import task_registry

    env = task_registry.make_env("rom_tracking", num_envs=2, device="cpu")
    runner = task_registry.make_alg_runner(
        env, "rom_tracking", log_root=logs, resume=True,
        load_dir=str(tmp_path / "logs" / "rom_tracking" / sorted(
            p.name for p in (tmp_path / "logs" / "rom_tracking").iterdir()
            if (p / "model_0.pt").exists())[0]))
    obs = torch.as_tensor(np.random.default_rng(1).normal(
        size=(3, env.num_obs)).astype(np.float32))
    want = runner.get_inference_policy()(obs)
    for f in (torch.jit.load(rec["exports"]["torchscript"]),
              load_policy_exported(rec["exports"]["exported"])):
        np.testing.assert_allclose(f(obs).detach().numpy(), want.numpy(),
                                   atol=1e-6)


def test_play_recurrent_exports_lstm(tmp_path, capsys):
    cfg = tmp_path / "rec.yaml"
    cfg.write_text("task: rom_tracking\n"
                   "policy:\n"
                   "  recurrent: true\n"
                   "  rnn_hidden_size: 16\n"
                   "  actor_hidden_dims: [16]\n"
                   "  critic_hidden_dims: [16]\n"
                   "  activation: elu\n")
    logs = str(tmp_path / "logs")
    cli.main(["train", "--config", str(cfg), "--cpu", "--num-envs", "8",
              "--max-iterations", "1", "--log-root", logs,
              "--run-name", "t"])
    capsys.readouterr()
    exp = tmp_path / "export"
    cli.main(["play", "--task", "rom_tracking", "--cpu", "--num-envs", "2",
              "--steps", "3", "--log-root", logs, "--export", str(exp)])
    out = capsys.readouterr().out
    assert "exported LSTM TorchScript" in out
    assert _last_json(out)["exports"] == {
        "lstm_torchscript": str(exp / "policy_lstm.pt")}
    m = torch.jit.load(str(exp / "policy_lstm.pt"))
    x = torch.ones(1, m.cell.weight_ih.shape[1])
    a = m(x)
    assert float(m.hidden_state.abs().max()) > 0.0
    m.reset_memory()
    assert float(m.hidden_state.abs().max()) == 0.0
    assert torch.equal(m(x), a)
