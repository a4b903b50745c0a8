"""Evaluation suite: tube coverage, error dynamics, policy tracking and
sim2sim.

Counterpart of ``legged_gym_dev_tpu/evaluation.py``:

- ``evaluate_tube_one_step``, ``evaluate_tube_recursive`` and
  ``compare_tube_models``: one-step and rollout-recursive coverage of tube
  networks on held-out rollouts;
- ``evaluate_tube_on_mpc_trace`` and ``trace_conformal_scale``: the tube
  along an executed closed-loop trace, and the width multiplier that
  restores coverage there;
- ``evaluate_error_dynamics``: recursive signed-error prediction;
- ``evaluate_tracking_policy``: a tracking policy against the
  deterministic zero/square/circle trajectory fixtures;
- ``evaluate_velocity_tracking``: command tracking and gait statistics of
  a velocity-command policy;
- ``evaluate_sim2sim_hopper`` and ``evaluate_sim2sim_hopper_reference``:
  the port's rigid-body dynamics (plain ``forward_dynamics`` +
  ``integrate`` on ``device``) against MuJoCo, on the MJCF export and on a
  hand-written MJCF asset. They need ``mujoco`` on the host.

Models run on the device their weights lie on.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .tube.datasets import RolloutData
from .tube.models import MLP
from .utils.runtime import fp32_matmul


def _apply(model: MLP, x) -> np.ndarray:
    """``model`` on host inputs, back on the host."""
    dev = model.weights[0].device
    with torch.no_grad(), fp32_matmul():
        return model(torch.as_tensor(np.asarray(x, np.float32),
                                     device=dev)).cpu().numpy()


def evaluate_tube_one_step(model: MLP, data: np.ndarray,
                           target: np.ndarray) -> Dict[str, float]:
    """Coverage and error of one-step tube predictions on a dataset."""
    fw = _apply(model, data)
    covered = np.all(fw >= target, axis=-1)
    return {
        "coverage": float(np.mean(covered)),
        "mean_pred": float(fw.mean()),
        "mean_target": float(target.mean()),
        "mean_excess": float(np.mean(fw - target)),
    }


@torch.no_grad()
def _recurse(model: MLP, first: torch.Tensor, feats: torch.Tensor,
             width: int) -> torch.Tensor:
    """Feed ``model`` its own output along time, for every episode at
    once: the input at step t is [previous output, feats[:, t]]; the
    first output is fed ``first`` (E, width). Returns (E, T, out)."""
    prev, outs = first, []
    with fp32_matmul():
        for t in range(feats.shape[1]):
            prev = model(torch.cat([prev[:, :width], feats[:, t]], dim=-1))
            outs.append(prev)
    return torch.stack(outs, dim=1)


def evaluate_tube_recursive(model: MLP, rollouts: RolloutData,
                            window: int = 3) -> Dict[str, float]:
    """Rollout-recursive evaluation: the model gets its own prediction as
    the width input along each trajectory. The input layout is
    ``scalar_tube_dataset(recursive=False)``'s with N=window:
    [w, sliding(z_rest, v)]. One loop over time for all episodes."""
    from .tube.datasets import sliding_window

    z, v = rollouts.z[:, :-1], rollouts.v
    w_true = np.linalg.norm(rollouts.pz_x - rollouts.z, axis=-1)  # (E, T+1)
    zv = sliding_window(np.concatenate((z[:, :, 2:], v), axis=-1), window,
                        1, v.shape[-1])
    T = v.shape[1]
    dev = model.weights[0].device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    preds = _recurse(model, t(w_true[:, :1]), t(zv), 1)[..., 0]
    preds = preds.cpu().numpy()
    covered = preds >= w_true[:, 1:]
    return {
        "recursive_coverage": float(np.mean(covered)),
        "recursive_mean_excess": float(np.mean(preds - w_true[:, 1:])),
        "horizon_coverage_half": float(np.mean(covered[:, : T // 2])),
    }


def compare_tube_models(models: Dict[str, tuple], rollouts: RolloutData,
                        batch: int = 4096, seed: int = 0
                        ) -> Dict[str, Dict[str, float]]:
    """Side-by-side coverage of tube-model variants on one shared rollout
    set, each windowed by the dataset spec it was trained on.

    ``models``: {display_name: (MLP, spec)} with spec either
    ``{"kind": "scalar", "N": int, "dN": int, "recursive": bool}`` or
    ``{"kind": "oneshot", "H_fwd": int, "H_rev": int}``. Returns
    {name: metrics}: one-step coverage and excess for every model (for the
    one-shot kind, whole-horizon coverage and the first step's), and
    rollout-recursive coverage for the non-recursive scalar variants with
    dN=1 (the only layout ``evaluate_tube_recursive`` defines)."""
    from .tube.datasets import (
        scalar_horizon_tube_dataset,
        scalar_tube_dataset,
    )

    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, float]] = {}
    for name, (model, spec) in models.items():
        if spec.get("kind", "scalar") == "oneshot":
            ds = scalar_horizon_tube_dataset(
                rollouts, H_fwd=spec.get("H_fwd", 50),
                H_rev=spec.get("H_rev", 10))
            x, y = ds.sample_batch(rng, batch)
            fw = _apply(model, x)
            metrics = {
                "coverage": float(np.mean(np.all(fw >= y, axis=-1))),
                "one_step_coverage": float(np.mean(fw[:, 0] >= y[:, 0])),
                "mean_excess": float(np.mean(fw - y)),
            }
        else:
            ds = scalar_tube_dataset(
                rollouts, N=spec.get("N", 1), dN=spec.get("dN", 1),
                recursive=spec.get("recursive", False))
            metrics = evaluate_tube_one_step(model, ds.data, ds.target)
            if not spec.get("recursive", False) and spec.get("dN", 1) == 1:
                metrics.update(evaluate_tube_recursive(
                    model, rollouts, window=spec.get("N", 1)))
        out[name] = metrics
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def evaluate_tube_on_mpc_trace(trace) -> Dict[str, float]:
    """Does the planned tube bound the tracked robot's error along an
    executed closed-loop trace? ``trace`` has ``z``, ``w``, ``pz_x``,
    ``converged`` and ``viol`` (arrays or tensors), for one scenario
    (z (H+1, n), as the JAX package's) or batch-leading (z (B, H+1, n), as
    ``solver.mpc.MPCTrace``); each scenario's first step is skipped (w is
    0 before the first solve has committed a width) and the statistics
    pool the rest."""
    z = _host(trace.z)[..., 1:, :]
    w = _host(trace.w)[..., 1:]
    err = np.linalg.norm(_host(trace.pz_x)[..., 1:, :] - z, axis=-1)
    return {
        "coverage": float(np.mean(w >= err)),
        "mean_width": float(w.mean()),
        "mean_error": float(err.mean()),
        "max_error": float(err.max()),
        "mean_margin": float(np.mean(w - err)),
        "solver_converged_frac": float(_host(trace.converged).mean()),
        "max_solver_viol": float(_host(trace.viol).max()),
    }


def trace_conformal_scale(trace, alpha: float = 0.9,
                          w_min: float = 1e-4) -> float:
    """Split-conformal width multiplier on an executed closed-loop trace:
    the finite-sample-corrected alpha-quantile of realized error / width
    over the steps with w > w_min (the pre-first-solve zeros are left
    out). One scenario's trace or a batch-leading one, whose steps pool.
    Compound it onto the model's ``out_scale``."""
    z = _host(trace.z)
    w = _host(trace.w).reshape(-1)
    err = np.linalg.norm(_host(trace.pz_x).reshape(-1, z.shape[-1])
                         - z.reshape(-1, z.shape[-1]), axis=-1)
    m = w > w_min
    ratio = err[m] / w[m]
    n = ratio.size
    if n == 0:
        return 1.0
    q = min(1.0, np.ceil((n + 1) * alpha) / n)
    return float(np.quantile(ratio, q, method="higher"))


def evaluate_error_dynamics(model: MLP, rollouts: RolloutData,
                            horizon: int = 25) -> Dict[str, float]:
    """Recursive signed-error prediction accuracy: from each rollout's
    initial error, feed the model its own prediction for ``horizon`` steps
    and compare with the recorded errors. The model maps
    [e_t, z_t, v_t] -> e_{t+1} (``error_dynamics_dataset`` at N=1)."""
    e = rollouts.pz_x - rollouts.z          # (B, T+1, n) signed error
    z = rollouts.z[:, :-1]                   # (B, T, n) planned states
    v = rollouts.v                           # (B, T, m)
    T = min(horizon, v.shape[1])
    n = e.shape[-1]
    dev = model.weights[0].device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    feats = np.concatenate([z[:, :T], v[:, :T]], axis=-1)
    pred = _recurse(model, t(e[:, 0]), t(feats), n).cpu().numpy()
    actual = e[:, 1:T + 1]
    one_step_in = np.concatenate([e[:, :-1], z, v], axis=-1).reshape(
        -1, 2 * n + v.shape[-1])
    one_step_pred = _apply(model, one_step_in).reshape(e[:, 1:].shape)
    return {
        "one_step_mse": float(np.mean((one_step_pred - e[:, 1:]) ** 2)),
        "recursive_mse": float(np.mean((pred - actual) ** 2)),
        "recursive_final_err": float(
            np.mean(np.linalg.norm(pred[:, -1] - actual[:, -1], axis=-1))),
    }


@torch.no_grad()
def evaluate_tracking_policy(env, policy, traj_gen_cls, steps: int = 400,
                             seed: int = 0) -> Dict[str, float]:
    """Swap the env's trajectory generator for a deterministic fixture
    (``ZeroTrajectoryGenerator``, ``SquareTrajectoryGenerator`` or
    ``CircleTrajectoryGenerator``), reset from a ``torch.Generator``
    seeded by ``seed`` and roll ``policy`` for ``steps`` env steps; the
    planar distance between the robot's ROM projection and the window's
    first point, per env and step, stays on the device and is fetched
    once."""
    rigid = hasattr(env, "traj_gen")
    base = env.traj_gen if rigid else env.sim.traj_gen
    fixture = traj_gen_cls.create(
        base.rom, base.t_sampler, base.weight_sampler,
        dt_loop=base.dt_loop, N=base.N, dN=base.dN)
    if rigid:
        env = env.replace(traj_gen=fixture)
    else:  # ROM-only envs hold the generator inside their sim
        env = env.replace(sim=env.sim.replace(traj_gen=fixture))
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    state, obs = env.reset(gen)

    def step_err(state):
        if hasattr(state, "robot"):            # rigid-body envs
            pz_x = env.rom.proj_z(state.robot.root_states)
            desired = state.trajectory[:, 0, :]
        else:                                   # ROM-only envs
            pz_x = env.sim.rom.proj_z(state.sim.root_states)
            desired = state.sim.trajectory[:, 0, :]
        return torch.linalg.vector_norm(pz_x[..., :2] - desired[..., :2],
                                        dim=-1)

    errs = []
    for _ in range(steps):
        state, tr = env.step(state, policy(obs))
        obs = tr.obs
        errs.append(step_err(state))
    errs = torch.stack(errs).cpu().numpy()
    return {
        "mean_tracking_error": float(errs.mean()),
        "max_tracking_error": float(errs.max()),
        "final_tracking_error": float(errs[-50:].mean()),
    }


@torch.no_grad()
def evaluate_velocity_tracking(env, policy, gen: torch.Generator,
                               steps: int = 500,
                               settle: int = 50) -> Dict[str, float]:
    """Command tracking and gait statistics of a velocity-command env:
    rolls ``policy`` from a reset and reports, over the steps after
    ``settle``, the mean planar velocity-tracking error, the single-stance
    fraction (overall and while commanded to move) and the per-step
    termination rate. One host transfer at the end."""
    from .core.maths import quat_to_rotmat

    es, obs = env.reset(gen)
    feet = list(env.feet_spheres)
    stats = []
    for _ in range(steps):
        es, tr = env.step(es, policy(obs))
        obs = tr.obs
        robot = es.robot
        R = quat_to_rotmat(robot.base_quat)
        v_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        err = torch.linalg.vector_norm(v_body[:, :2] - es.commands[:, :2],
                                       dim=-1)
        f = env._contact_forces(robot)
        single = torch.sum((f[:, feet, 2] > 1.0).int(), dim=-1) == 1
        moving = torch.linalg.vector_norm(es.commands[:, :2], dim=-1) > 0.1
        stats.append(torch.stack([
            err.mean(), single.float().mean(),
            (single & moving).sum() / (moving.sum() + 1e-6),
            tr.done.float().mean()]))
    s = torch.stack(stats)[settle:].mean(dim=0).cpu().numpy()
    return {
        "track_err_m_s": float(s[0]),
        "single_stance_frac": float(s[1]),
        "single_stance_moving": float(s[2]),
        "done_rate_per_step": float(s[3]),
    }


# ---------------------------------------------------------------------------
# Sim2sim: the port's dynamics against MuJoCo (ref evaluate_sim2sim.py)
# ---------------------------------------------------------------------------

# The reference project's hopper assets, relative to its root (as
# ``envs.presets.HOPPER_URDF``); pass ``urdf_path`` / ``xml_path`` to use
# other files.
HOPPER_URDF = "resources/robots/hopper/urdf/hopper.urdf"
HOPPER_XML = "resources/robots/hopper/urdf/hopper.xml"
# The reference XML's joint names in the model's dof order (foot, wheels
# 1-3), and its foot-spring servo.
HOPPER_XML_JOINTS = ("knee", "joint_wheel1", "joint_wheel2", "joint_wheel3")
HOPPER_XML_ACTUATOR = "position_actuator"


def _free_fall_start(model, device, q0=0.0):
    """The hopper 2 m above the ground, level, joints at rest but the foot
    at ``q0``."""
    from .sim.dynamics import RobotState

    q = torch.zeros(1, model.nj, device=device)
    q[0, 0] = q0
    return RobotState(
        base_pos=torch.tensor([[0.0, 0.0, 2.0]], device=device),
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device),
        q=q, v=torch.zeros(1, model.nv, device=device))


def _roll(model, state, taus, dt, spring=None):
    """``steps`` plain ``forward_dynamics`` + ``integrate`` steps of one
    robot under joint torques ``taus (steps, nj)``; ``spring(q)`` adds a
    torque on the first joint. Returns the base positions and joint
    coordinates after each step, on the host."""
    from .sim.dynamics import forward_dynamics, integrate

    f_ext = torch.zeros(1, model.nv, device=state.q.device)
    pos, qs = [], []
    with torch.no_grad():
        for tau in taus:
            if spring is not None:
                tau = torch.cat([tau[:1] + spring(state.q[0, 0]), tau[1:]])
            qdd = forward_dynamics(model, state, tau[None], f_ext)
            state = integrate(model, state, qdd, dt)
            pos.append(state.base_pos[0])
            qs.append(state.q[0])
    return torch.stack(pos).cpu().numpy(), torch.stack(qs).cpu().numpy()


def _random_torques(model, steps, torque_amp):
    """The JAX function's torques: numpy seed 0, the foot's zeroed."""
    rng = np.random.default_rng(0)
    taus = (torque_amp * rng.normal(size=(steps, model.nj))).astype(
        np.float32)
    taus[:, 0] = 0.0  # keep the foot spring-free for the free-space check
    return taus


def evaluate_sim2sim_hopper(steps: int = 200, dt: float = 0.005,
                            torque_amp: float = 0.5,
                            save_mat: Optional[str] = None,
                            urdf_path: str = HOPPER_URDF,
                            device=None) -> Dict[str, float]:
    """Free-space hopper trace against MuJoCo on the MJCF export
    (``sim.mjcf.build_mjcf``) of the same URDF (a file or URDF text).

    The port's rollout runs on ``device`` (None = the CUDA card; raises
    without one); MuJoCo steps on the host. Reports the max divergence of
    the base position and of the joints over the horizon.
    """
    from .sim.dynamics import RobotModel
    from .sim.mjcf import build_mjcf
    from .sim.urdf import parse_urdf
    from .utils.runtime import resolve_device

    dev = resolve_device(device)
    import mujoco

    spec = parse_urdf(urdf_path)
    model = RobotModel.from_spec(spec)
    m = mujoco.MjModel.from_xml_string(build_mjcf(spec, timestep=dt))
    d = mujoco.MjData(m)
    d.qpos[:3] = [0.0, 0.0, 2.0]
    d.qpos[3] = 1.0

    taus = _random_torques(model, steps, torque_amp)
    pos_tr, q_tr = _roll(model, _free_fall_start(model, dev),
                         torch.as_tensor(taus, device=dev), dt)
    mj_pos, mj_q = [], []
    for t in range(steps):
        d.qfrc_applied[6:] = taus[t]
        mujoco.mj_step(m, d)
        mj_pos.append(d.qpos[:3].copy())
        mj_q.append(d.qpos[7:].copy())
    mj_pos, mj_q = np.stack(mj_pos), np.stack(mj_q)
    out = {"free_space_pos_err": float(np.abs(pos_tr - mj_pos).max()),
           "free_space_q_err": float(np.abs(q_tr - mj_q).max()),
           "steps": steps}
    if save_mat:
        from scipy.io import savemat

        savemat(save_mat, {"pos_ours": pos_tr, "pos_mjc": mj_pos,
                           "q_ours": q_tr, "q_mjc": mj_q})
    return out


def evaluate_sim2sim_hopper_reference(
        steps: int = 300, dt: float = 0.001, torque_amp: float = 0.5,
        save_mat: Optional[str] = None, urdf_path: str = HOPPER_URDF,
        xml_path: str = HOPPER_XML, joint_names=HOPPER_XML_JOINTS,
        actuator: str = HOPPER_XML_ACTUATOR,
        device=None) -> Dict[str, float]:
    """Sim2sim against a hand-written MJCF asset of the hopper (the
    reference's ``hopper.xml`` by default), independent of the port's MJCF
    export.

    ``joint_names`` are the XML's joints in the model's dof order (foot
    first); ``actuator`` is the XML's position servo on the foot (kp 11732,
    force range [-250, 0]: the foot spring), whose clamped force the
    port's rollout applies too. Mesh geoms (visual only, their files may
    be absent) are stripped before loading. The port's rollout runs on
    ``device`` (None = the CUDA card; raises without one). Reports the
    base position's and the foot's max error and the wheels' max relative
    error.
    """
    import re

    from .sim.dynamics import RobotModel
    from .sim.urdf import parse_urdf
    from .utils.runtime import resolve_device

    dev = resolve_device(device)
    import mujoco

    with open(xml_path) as f:
        xml = f.read()
    xml = re.sub(r"<mesh[^>]*/>", "", xml)
    xml = re.sub(r"<geom[^>]*type='mesh'[^>]*/>", "", xml)
    m = mujoco.MjModel.from_xml_string(xml)
    model = RobotModel.from_spec(parse_urdf(urdf_path))

    adr = {m.joint(i).name: (m.joint(i).qposadr[0], m.joint(i).dofadr[0])
           for i in range(m.njnt)}
    d = mujoco.MjData(m)
    d.qpos[:3] = [0.0, 0.0, 2.0]
    d.qpos[3] = 1.0
    d.qpos[adr[joint_names[0]][0]] = 0.05
    taus = _random_torques(model, steps, torque_amp)
    KP, CTRL = 11732.0, 0.05

    def spring(q_foot):
        return torch.clamp(KP * (CTRL - q_foot), -250.0, 0.0)

    pos_tr, q_tr = _roll(model, _free_fall_start(model, dev, q0=0.05),
                         torch.as_tensor(taus, device=dev), dt,
                         spring=spring)
    d.ctrl[m.actuator(actuator).id] = CTRL
    mj_pos, mj_q = [], []
    for t in range(steps):
        for j, name in enumerate(joint_names):
            d.qfrc_applied[adr[name][1]] = taus[t][j]
        mujoco.mj_step(m, d)
        mj_pos.append(d.qpos[:3].copy())
        mj_q.append([d.qpos[adr[name][0]] for name in joint_names])
    mj_pos, mj_q = np.stack(mj_pos), np.asarray(mj_q)
    wheel_rel = (np.abs(q_tr[:, 1:] - mj_q[:, 1:]).max(0)
                 / (1e-6 + np.abs(mj_q[:, 1:]).max(0)))
    out = {
        "free_space_pos_err": float(np.abs(pos_tr - mj_pos).max()),
        "knee_err": float(np.abs(q_tr[:, 0] - mj_q[:, 0]).max()),
        "wheel_rel_err": float(wheel_rel.max()),
        "steps": steps,
    }
    if save_mat:
        from scipy.io import savemat

        savemat(save_mat, {"pos_ours": pos_tr, "pos_mjc": mj_pos,
                           "q_ours": q_tr, "q_mjc": mj_q})
    return out
