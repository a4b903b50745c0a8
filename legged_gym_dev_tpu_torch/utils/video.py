"""Headless rollout video rendering (mp4/gif).

Counterpart of ``legged_gym_dev_tpu/utils/video.py``. The reference's
``play.py`` records camera frames from the Isaac Gym viewer (ref:
legged_gym/scripts/play.py:88-110); here a rollout of the port's env
records the robot's state trace, which is replayed through MuJoCo's
kinematics for frames (``mujoco.Renderer`` over the MJCF export
``sim/mjcf.build_mjcf_from_model(visual=True)``). Physics stays in the
port's sim: MuJoCo is a renderer here (``mj_forward`` only, no stepping).

``mujoco`` renders on the CPU through EGL; the package sets
``MUJOCO_GL=egl`` / ``EGL_PLATFORM=surfaceless`` defaults before anything
imports it (``legged_gym_dev_tpu_torch/__init__.py``). Without ``mujoco``
installed these functions raise ``ModuleNotFoundError`` naming it.

Output: ``.mp4`` via OpenCV when the path ends in .mp4 (a ``.gif`` beside
it when no mp4 codec exists), else ``.gif`` via imageio.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _quat_xyzw_to_wxyz(q):
    return np.asarray([q[3], q[0], q[1], q[2]])


def render_state_trace(model, base_pos: np.ndarray, base_quat: np.ndarray,
                       q: np.ndarray, out_path: str, fps: float = 50.0,
                       width: int = 640, height: int = 480,
                       cam_distance: float = 2.5) -> str:
    """Render a recorded state trace to a video file; returns its path.

    model: sim.dynamics.RobotModel;  base_pos (T, 3);  base_quat (T, 4)
    in the xyzw convention;  q (T, nj) (numpy arrays).
    """
    import os

    os.environ.setdefault("MUJOCO_GL", "egl")
    os.environ.setdefault("EGL_PLATFORM", "surfaceless")
    import mujoco

    from ..sim.mjcf import build_mjcf_from_model

    m = mujoco.MjModel.from_xml_string(
        build_mjcf_from_model(model, visual=True))
    d = mujoco.MjData(m)
    renderer = mujoco.Renderer(m, height=height, width=width)
    cam = mujoco.MjvCamera()
    mujoco.mjv_defaultFreeCamera(m, cam)
    cam.distance = cam_distance
    cam.elevation = -15.0
    cam.azimuth = 135.0

    # dof order -> MuJoCo qpos by joint name: MuJoCo's qpos follows a DFS
    # of the MJCF body tree, which need not be the model's dof order.
    qadr = {m.joint(i).name: int(m.joint(i).qposadr[0])
            for i in range(m.njnt)}
    dof_adr = [qadr[name] for name in model.dof_names]

    frames = []
    for t in range(base_pos.shape[0]):
        d.qpos[:3] = base_pos[t]
        d.qpos[3:7] = _quat_xyzw_to_wxyz(base_quat[t])
        for j, adr in enumerate(dof_adr):
            d.qpos[adr] = q[t, j]
        mujoco.mj_forward(m, d)
        cam.lookat[:] = base_pos[t]          # tracking camera
        renderer.update_scene(d, camera=cam)
        frames.append(renderer.render().copy())
    renderer.close()
    return write_video(frames, out_path, fps)


def write_video(frames, out_path: str, fps: float) -> str:
    """Frames (H, W, 3 uint8) to ``out_path``: mp4 through OpenCV, falling
    back to a gif beside it when no mp4 codec opens; else a gif."""
    if out_path.endswith(".mp4"):
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
        if not vw.isOpened():  # codec unavailable -> gif fallback
            vw.release()
            return write_video(frames, out_path[:-4] + ".gif", fps)
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return out_path
    import imageio

    if not out_path.endswith(".gif"):
        out_path += ".gif"
    imageio.mimsave(out_path, frames, duration=1.0 / fps, loop=0)
    return out_path


def record_rollout_video(env, policy: Callable, gen, steps: int,
                         out_path: str, env_index: int = 0,
                         fps: Optional[float] = None,
                         width: int = 640, height: int = 480,
                         device=None) -> str:
    """Roll ``env`` with ``policy`` from ``env.reset(gen)`` (``gen`` a
    ``torch.Generator``) and render ``env_index``'s trajectory.

    The rollout runs on ``device`` (None = the CUDA card; raises without
    one), where ``env`` must live. Works for every rigid-body task (its
    state carries ``.robot``); raises ``ValueError`` for a physics-free
    env (rom_tracking), which has nothing to render in 3D.
    """
    import torch

    from .runtime import resolve_device

    dev = resolve_device(device)
    if torch.device(env.device) != dev:
        raise ValueError(f"env lives on {env.device}, not on {dev}")
    with torch.no_grad():
        state, obs = env.reset(gen)
        if not hasattr(state, "robot"):
            raise ValueError(
                f"{type(env).__name__} has no rigid-body state to render "
                "(physics-free ROM env); use the logger dashboard instead")
        pos, quat, qs = [], [], []
        for _ in range(steps):
            r = state.robot
            pos.append(r.base_pos[env_index])
            quat.append(r.base_quat[env_index])
            qs.append(r.q[env_index])
            state, tr = env.step(state, policy(obs))
            obs = tr.obs
    pos, quat, qs = (torch.stack(x).cpu().numpy() for x in (pos, quat, qs))
    return render_state_trace(
        env.sim.model, pos, quat, qs, out_path,
        fps=fps or (1.0 / env.dt), width=width, height=height)
