"""The port's MuJoCo slice: the MJCF export, the video and live-viewer
renderers, the sim2sim evaluations and ``cli play --video``, on the test
robots of ``tests/torch_robot_cases.py`` (the reference project's hopper
files are not in the repository).

- ``build_mjcf`` / ``build_mjcf_from_model(visual=True)``: the XML string
  equals the JAX package's for the same URDF (hopper and quadruped).
- ``render_state_trace`` / ``record_rollout_video`` write a non-empty gif
  at 160x120 from the hopper task; a ROM env raises ``ValueError``.
- ``LiveViewer`` over HTTP with keys (JAX's tests/test_live_viewer.py).
- ``evaluate_sim2sim_hopper`` within JAX's bars (tests/test_evaluation.py:
  base position < 1e-3, joints < 1e-2) and the reference variant on an
  XML the test writes (the export with the reference asset's joint names,
  ``implicitfast`` and its foot servo) within JAX's bars (2e-4, 1e-4,
  1%).
- ``cli play --cpu --video ... --video-steps 5`` end to end, and the error
  that names ``mujoco`` where it is not installed.
"""
import dataclasses
import functools
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from legged_gym_dev_tpu.sim.dynamics import (  # noqa: E402
    RobotModel as JaxModel,
)
from legged_gym_dev_tpu.sim.mjcf import (  # noqa: E402
    build_mjcf as jax_build_mjcf,
)
from legged_gym_dev_tpu.sim.mjcf import (  # noqa: E402
    build_mjcf_from_model as jax_build_from_model,
)
from legged_gym_dev_tpu.sim.urdf import parse_urdf as jax_parse  # noqa: E402
from legged_gym_dev_tpu_torch import cli  # noqa: E402
from legged_gym_dev_tpu_torch.evaluation import (  # noqa: E402
    evaluate_sim2sim_hopper,
    evaluate_sim2sim_hopper_reference,
)
from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel  # noqa: E402
from legged_gym_dev_tpu_torch.sim.mjcf import (  # noqa: E402
    build_mjcf,
    build_mjcf_from_model,
)
from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf  # noqa: E402
from legged_gym_dev_tpu_torch.utils.live_viewer import LiveViewer  # noqa: E402
from legged_gym_dev_tpu_torch.utils.video import (  # noqa: E402
    record_rollout_video,
    render_state_trace,
)
from tests.torch_port_cases import one_torch_thread  # noqa: E402,F401
from tests.torch_robot_cases import HOPPER_URDF, QUADRUPED_URDF  # noqa: E402

URDFS = {"hopper": HOPPER_URDF, "quadruped": QUADRUPED_URDF}


@pytest.fixture(scope="module")
def urdf_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("hopper") / "hopper.urdf"
    path.write_text(HOPPER_URDF)
    return str(path)


def _hopper_env(urdf_file, num_envs=2):
    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
    )

    return make_hopper_trajectory_env(num_envs=num_envs, add_noise=False,
                                      urdf_path=urdf_file, device="cpu")


@pytest.mark.parametrize("robot", sorted(URDFS))
def test_mjcf_equals_jax(robot):
    urdf = URDFS[robot]
    assert build_mjcf(parse_urdf(urdf), timestep=0.002) == jax_build_mjcf(
        jax_parse(urdf), timestep=0.002)
    vis_t = build_mjcf_from_model(RobotModel.from_spec(parse_urdf(urdf)),
                                  visual=True)
    vis_j = jax_build_from_model(JaxModel.from_spec(jax_parse(urdf)),
                                 visual=True)
    assert vis_t == vis_j
    m = mujoco.MjModel.from_xml_string(vis_t)
    m_plain = mujoco.MjModel.from_xml_string(build_mjcf(parse_urdf(urdf)))
    assert m.ngeom > m_plain.ngeom      # skeleton geoms, mass-free
    np.testing.assert_allclose(m.body_mass, m_plain.body_mass, atol=1e-8)


def test_render_state_trace_writes_gif(tmp_path):
    model = RobotModel.from_spec(parse_urdf(HOPPER_URDF))
    T = 3
    pos = np.tile([0.0, 0.0, 0.6], (T, 1))
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (T, 1))
    q = np.linspace(0.0, 0.5, T)[:, None] * np.ones((T, model.nj))
    out = render_state_trace(model, pos, quat, q, str(tmp_path / "t"),
                             fps=10.0, width=160, height=120)
    assert out.endswith(".gif") and os.path.getsize(out) > 0


def test_record_rollout_video(tmp_path, urdf_file):
    env = _hopper_env(urdf_file)
    gen = torch.Generator().manual_seed(0)
    out = record_rollout_video(
        env, lambda obs: torch.zeros(2, env.num_actions), gen, steps=5,
        out_path=str(tmp_path / "roll.gif"), width=160, height=120,
        device="cpu")
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_rom_env_rejects_video(tmp_path):
    from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env

    env = make_rom_tracking_env(num_envs=2, device="cpu")
    with pytest.raises(ValueError, match="rigid-body"):
        record_rollout_video(env, lambda o: torch.zeros(2, 2),
                             torch.Generator().manual_seed(0), 2,
                             str(tmp_path / "x.gif"), device="cpu")


def test_live_viewer_http_and_keys():
    model = RobotModel.from_spec(parse_urdf(HOPPER_URDF))
    v = LiveViewer(model, port=0, width=128, height=96)
    try:
        base = f"http://127.0.0.1:{v.port}"
        html = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"live viewer" in html
        nj = model.nj
        v.push_state(torch.tensor([0.0, 0.0, 0.6]),
                     torch.tensor([0.0, 0.0, 0.0, 1.0]),
                     torch.zeros(nj), force_render=True)
        png = urllib.request.urlopen(base + "/frame.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 500

        def key(k):
            urllib.request.urlopen(urllib.request.Request(
                base + "/key", data=json.dumps({"key": k}).encode(),
                method="POST"), timeout=5).read()

        for k in (" ", "v", "ArrowLeft", "-", "Escape"):
            key(k)
        st = json.loads(urllib.request.urlopen(
            base + "/state.json", timeout=5).read())
        assert st["paused"] is True and st["sync"] is False
        assert st["cam"]["azimuth"] == 125.0
        assert st["cam"]["distance"] == pytest.approx(2.5 * 1.25)
        assert st["frames"] == 1
        assert "quit" in v.pop_events()
        # batched state path + gating: sync off -> no render
        v.push_state(np.zeros((4, 3)), np.tile([0, 0, 0, 1.0], (4, 1)),
                     np.zeros((4, nj)))
        assert v._frames == 1
    finally:
        v.close()


def test_sim2sim_free_space_parity(urdf_file):
    out = evaluate_sim2sim_hopper(steps=60, urdf_path=urdf_file,
                                  device="cpu")
    assert out["steps"] == 60
    assert out["free_space_pos_err"] < 1e-3, out
    assert out["free_space_q_err"] < 1e-2, out


def test_sim2sim_vs_hand_written_xml(tmp_path, urdf_file):
    """The reference variant on an MJCF written here: the export of the
    same hopper with the reference asset's joint names, ``implicitfast``
    and its foot servo, read as a file the way the reference's
    ``hopper.xml`` is."""
    xml = build_mjcf(parse_urdf(HOPPER_URDF), timestep=0.001)
    names = {"foot_slide": "knee", "wheel1_joint": "joint_wheel1",
             "wheel2_joint": "joint_wheel2", "wheel3_joint": "joint_wheel3"}
    for ours, theirs in names.items():
        xml = xml.replace(f'<joint name="{ours}"', f'<joint name="{theirs}"')
    xml = xml.replace("<option ", '<option integrator="implicitfast" ')
    xml = xml.replace("</mujoco>", (
        '<actuator><position name="position_actuator" joint="knee" '
        'kp="11732" forcelimited="true" forcerange="-250 0"/></actuator>'
        "</mujoco>"))
    path = tmp_path / "hopper.xml"
    path.write_text(xml)
    out = evaluate_sim2sim_hopper_reference(
        steps=300, urdf_path=urdf_file, xml_path=str(path), device="cpu")
    assert out["free_space_pos_err"] < 2e-4, out
    assert out["knee_err"] < 1e-4, out
    assert out["wheel_rel_err"] < 0.01, out


def _hopper_task(monkeypatch, urdf_file):
    """The registry's ``hopper_trajectory`` on the test hopper."""
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
    )

    entry = task_registry.get("hopper_trajectory")
    factory = functools.partial(make_hopper_trajectory_env,
                                urdf_path=urdf_file)
    monkeypatch.setitem(task_registry._tasks, "hopper_trajectory",
                        dataclasses.replace(entry, env_factory=factory))


def test_cli_play_video_end_to_end(tmp_path, capsys, monkeypatch, urdf_file):
    _hopper_task(monkeypatch, urdf_file)
    logs = str(tmp_path / "logs")
    cli.main(["train", "--task", "hopper_trajectory", "--cpu", "--num-envs",
              "2", "--max-iterations", "1", "--log-root", logs,
              "--run-name", "t"])
    capsys.readouterr()
    video = str(tmp_path / "play.gif")
    cli.main(["play", "--task", "hopper_trajectory", "--cpu", "--num-envs",
              "1", "--steps", "6", "--log-root", logs, "--video", video,
              "--video-steps", "5"])
    out = capsys.readouterr().out
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["steps"] == 6 and rec["video"] == video
    assert "rollout video saved" in out
    assert os.path.getsize(video) > 0
    # a gif of the 5 frames asked for
    import imageio.v3 as iio

    assert iio.imread(video, index=None).shape[0] == 5


def test_cli_play_without_mujoco_names_it(monkeypatch):
    import importlib.util

    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "mujoco"
                        else find(name, *a))
    for flags in (["--video", "x.gif"], ["--live"]):
        with pytest.raises(SystemExit, match="mujoco"):
            cli.main(["play", "--task", "hopper_trajectory", "--cpu",
                      *flags])


def test_package_sets_headless_gl_defaults():
    import legged_gym_dev_tpu_torch  # noqa: F401

    assert os.environ.get("MUJOCO_GL") == "egl"
    assert os.environ.get("EGL_PLATFORM") == "surfaceless"
