"""One rigid-body physics substep: the CUDA kernel and its plain version.

Counterpart of ``legged_gym_dev_tpu/ops/pallas_substep.py``. ``substep``
advances a batch of envs by one physics step of ``sim.dt`` under applied
joint torques, in the order of ``RobotSim.substep``: effort clip, joint
springs and soft limits, the scalar-graph FK / mass matrix / bias, flat
compliant contact with per-env DR, unrolled Cholesky, velocity clamp,
semi-implicit Euler.

On CUDA tensors it launches the kernel ``substep`` of ``csrc/substep.cu``
(built at first use) or raises; on CPU tensors, and only there, it runs
``substep_plain`` (``sim/kinematics.substep_core`` and the array-form
contact model, as the JAX package's XLA path). The kernel takes flat
terrain, per-robot (not per-env) springs and robots of 4 or 12 joints
(``SUPPORTED_NJ``); it raises for anything else. Per-env DR rides in as
value rows, as in the TPU kernel: an optional base payload mass and
per-contact stiffness, damping and friction broadcast from scalars,
``(nc,)``, ``(B, 1)`` or ``(B, 1, 1)``, and the slip velocity.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sim.contact import contact_forces, flat_terrain
from ..sim.dynamics import RobotState
from ..sim.kinematics import _ancestor_dofs, substep_core
from . import _build

SOURCE = "substep.cu"
SUPPORTED_NJ = (4, 12)   # joint counts the CUDA source instantiates
MAX_NC = 32              # contact spheres the kernel's model struct holds

SUBSTEP = _build.Kernel(SOURCE, "substep", n_ptr=4, n_int=4)


def reset_launches() -> None:
    SUBSTEP.launches = 0


def launches() -> dict:
    return {"substep": SUBSTEP.launches}


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path)
# ---------------------------------------------------------------------------

def _passive_tau(sim, state: RobotState) -> torch.Tensor:
    """Joint springs/dampers + soft joint-limit forces."""
    s, model, dev = sim.springs, sim.model, state.q.device
    qd = state.v[..., 6:]
    tau = s.stiffness * (s.setpoint - state.q) - s.damping * qd
    below = torch.clamp(model.tensor("q_lower", dev) - state.q, min=0.0)
    above = torch.clamp(state.q - model.tensor("q_upper", dev), min=0.0)
    lim = sim.joint_limit_stiffness * (below - above)
    lim = lim - torch.where((below > 0) | (above > 0),
                            sim.joint_limit_damping * qd, 0.0)
    return tau + lim


def substep_plain(sim, state: RobotState, tau: torch.Tensor) -> RobotState:
    """One physics substep as PyTorch ops (the JAX package's XLA path of
    ``RobotSim.substep``)."""
    from ..core.maths import quat_mul, quat_normalize, so3_exp

    model, dev = sim.model, state.q.device
    eff = model.tensor("effort_limit", dev)
    tau = torch.clamp(tau, -eff, eff)
    tau = tau + _passive_tau(sim, state)
    radius = model.tensor("contact_radius", dev)
    qdd = substep_core(
        model, state, tau,
        lambda pos, vel: contact_forces(sim.contact, pos, vel, radius,
                                        sim.terrain_fn),
        base_mass_delta=sim.base_mass_delta)
    # Velocity caps before the position update (clamped-velocity
    # integration bounds each substep's excursion to base_vel_limit * dt).
    v_cap = torch.cat([
        torch.full((6,), float(np.float32(sim.base_vel_limit)),
                   device=dev),
        model.tensor("vel_limit", dev)])
    v_new = torch.clamp(state.v + sim.dt * qdd, -v_cap, v_cap)
    base_pos = state.base_pos + sim.dt * v_new[..., :3]
    dq_quat = so3_exp(sim.dt * v_new[..., 3:6])
    base_quat = quat_normalize(quat_mul(state.base_quat, dq_quat))
    q = state.q + sim.dt * v_new[..., 6:]
    return RobotState(base_pos=base_pos, base_quat=base_quat, q=q, v=v_new)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def pack_model(sim) -> np.ndarray:
    """The model's constants in the all-float layout of ``Model<NJ>`` in
    ``csrc/substep.cu`` (same field order)."""
    model = sim.model
    nj, nb, nc = model.nj, model.nb, len(model.contact_body)
    if nc > MAX_NC:
        raise ValueError(f"{nc} contact spheres; the kernel holds {MAX_NC}")
    anc = [sum(1 << j for j in dofs)
           for dofs in _ancestor_dofs(model.parent, nj)]

    def per_joint(x):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        x = np.asarray(x, np.float32)
        if x.ndim > 1:
            raise ValueError("per-env joint springs have no kernel")
        return np.broadcast_to(x, (nj,))

    def padded(x, shape):
        out = np.zeros(shape, np.float32)
        x = np.asarray(x, np.float32)
        out[:len(x)] = x
        return out

    s = sim.springs
    parts = [
        model.parent, model.jtype, anc, model.origin_pos, model.origin_rot,
        model.axis, model.mass, model.com, model.inertia, model.gravity,
        [np.asarray(model.mass, np.float32).sum()],
        np.broadcast_to(model.effort_limit, (nj,)),
        np.broadcast_to(model.vel_limit, (nj,)),
        model.q_lower, model.q_upper,
        per_joint(s.stiffness), per_joint(s.damping), per_joint(s.setpoint),
        [sim.joint_limit_stiffness, sim.joint_limit_damping,
         sim.base_vel_limit, sim.dt],
        [nc],
        padded(model.contact_body, (MAX_NC,)),
        padded(model.contact_offset.reshape(nc, 3), (MAX_NC, 3)),
        padded(model.contact_radius, (MAX_NC,)),
    ]
    assert len(parts[0]) == nj and len(anc) == nb
    return np.concatenate([np.asarray(p, np.float32).ravel()
                           for p in parts])


def _model_tensor(sim, device) -> torch.Tensor:
    """``pack_model`` on the card, cached on the model per device, springs
    object and scalar settings (a replaced sim shares them)."""
    cache = sim.model.__dict__.setdefault("_substep_params", {})
    key = (str(device), id(sim.springs), sim.joint_limit_stiffness,
           sim.joint_limit_damping, sim.base_vel_limit, sim.dt)
    hit = cache.get(key)
    if hit is None or hit[0] is not sim.springs:
        packed = pack_model(sim)
        want = _build.load(SOURCE).substep_model_floats(sim.model.nj)
        if want != packed.size:
            raise RuntimeError(f"model packing has {packed.size} floats, "
                               f"the kernel expects {want}")
        hit = (sim.springs, torch.as_tensor(packed, device=device))
        cache[key] = hit
    return hit[1]


def dr_rows(sim, B: int, device) -> torch.Tensor:
    """Per-env DR value rows (has_bmd + 3 nc + 1, B): [base payload mass],
    contact stiffness, damping and friction per sphere, slip velocity."""
    c = sim.contact
    nc = len(sim.model.contact_body)
    ones = torch.ones((B, nc), dtype=torch.float32, device=device)

    def rows_of(p):
        p = torch.as_tensor(p, dtype=torch.float32, device=device)
        p = p.reshape(p.shape[0], -1) if p.ndim == 3 else p
        return (p * ones).t()

    rows = []
    if sim.base_mass_delta is not None:
        rows.append(torch.as_tensor(sim.base_mass_delta, dtype=torch.float32,
                                    device=device).expand(B)[None, :])
    rows += [rows_of(c.stiffness), rows_of(c.damping), rows_of(c.friction)]
    rows.append(torch.as_tensor(c.slip_vel, dtype=torch.float32,
                                device=device).expand(B)[None, :])
    return torch.cat(rows, dim=0).contiguous()


def _ptr(t: torch.Tensor):
    return t.data_ptr() or None


def substep(sim, state: RobotState, tau: torch.Tensor) -> RobotState:
    """One physics substep: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    dev = state.base_pos.device
    if dev.type == "cpu":
        return substep_plain(sim, state, tau)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    model = sim.model
    nj, nv, nc = model.nj, model.nv, len(model.contact_body)
    if nj not in SUPPORTED_NJ:
        raise ValueError(f"{nj} joints: the kernel is built for "
                         f"{SUPPORTED_NJ}")
    if sim.terrain_fn is not flat_terrain:
        raise NotImplementedError("the substep kernel takes flat terrain "
                                  "only")
    B = state.base_pos.shape[0]
    xs = torch.cat([state.base_pos, state.base_quat, state.q, state.v, tau],
                   dim=1)
    if xs.dtype != torch.float32 or tuple(xs.shape) != (B, 7 + nj + nv + nj):
        raise TypeError(f"expected float32 (B, {7 + nj + nv + nj}) inputs, "
                        f"got {xs.dtype} {tuple(xs.shape)}")
    xs = xs.t().contiguous()
    dr = dr_rows(sim, B, dev)
    out = torch.empty((7 + nj + nv, B), dtype=torch.float32, device=dev)
    SUBSTEP([_ptr(_model_tensor(sim, dev)), _ptr(xs), _ptr(dr), _ptr(out)],
            [nj, nc, B, int(sim.base_mass_delta is not None)], dev)
    return RobotState(base_pos=out[0:3].t(), base_quat=out[3:7].t(),
                      q=out[7:7 + nj].t(), v=out[7 + nj:].t())

