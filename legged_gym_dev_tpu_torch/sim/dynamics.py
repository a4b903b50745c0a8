"""Articulated rigid-body model and state in generalized coordinates.

Counterpart of ``legged_gym_dev_tpu/sim/dynamics.py``: the floating-base
kinematic tree (``RobotModel.from_spec``, fixed links merged into their
movable parent), the batched ``RobotState`` and the semi-implicit
``integrate``. The autodiff cross-check forms of the JAX module are not
ported; the analytic hot path is ``sim/kinematics.py``.

Conventions are the JAX package's: base position, base quaternion (xyzw),
joint coordinates; velocity ``v = [v_world, omega_body, qdot]``; body
i >= 1 is the child of joint i-1, body 0 the floating base. The model's
constants are float32 numpy arrays (the JAX leaves' values), read as
Python floats by the scalar graph and packed for the substep kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.maths import quat_mul, quat_normalize, quat_to_rotmat, so3_exp
from .urdf import RobotSpec, _rpy_to_mat

REVOLUTE, PRISMATIC = 0, 1


@dataclasses.dataclass(eq=False)
class RobotModel:
    """Static tree description + per-body parameters (float32 numpy)."""

    nj: int
    parent: Tuple[int, ...]         # body index per joint
    jtype: Tuple[int, ...]          # REVOLUTE/PRISMATIC
    contact_body: Tuple[int, ...]
    dof_names: Tuple[str, ...]
    origin_pos: np.ndarray     # (nj, 3)
    origin_rot: np.ndarray     # (nj, 3, 3)
    axis: np.ndarray           # (nj, 3)
    mass: np.ndarray           # (nb,)
    com: np.ndarray            # (nb, 3)
    inertia: np.ndarray        # (nb, 3, 3) about COM in link frame
    q_lower: np.ndarray        # (nj,)
    q_upper: np.ndarray        # (nj,)
    effort_limit: np.ndarray   # (nj,)
    vel_limit: np.ndarray      # (nj,)
    contact_offset: np.ndarray  # (nc, 3)
    contact_radius: np.ndarray  # (nc,)
    gravity: np.ndarray        # (3,)
    body_names: Tuple[str, ...] = ()
    contact_link_names: Tuple[str, ...] = ()

    @property
    def nb(self) -> int:
        return self.nj + 1

    @property
    def nv(self) -> int:
        return 6 + self.nj

    def tensor(self, name: str, device) -> torch.Tensor:
        """A constant field as a float32 tensor on ``device`` (cached)."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name),
                                         device=device)
        return cache[key]

    @classmethod
    def from_spec(cls, spec: RobotSpec, gravity=(0.0, 0.0, -9.81)):
        """Build the articulated model, merging fixed-joint subtrees into
        their parent movable body: masses and inertias composed with the
        parallel-axis theorem, collision spheres moved into the body frame
        (the collapse Isaac Gym's asset importer performs)."""
        frame = {spec.root: (0, np.eye(3), np.zeros(3))}
        bodies = [[]]
        body_names = [spec.root]
        bodies[0].append((spec.links[spec.root], np.eye(3), np.zeros(3)))

        joints = []
        parent, jtype = [], []
        origin_pos, origin_rot, axis = [], [], []
        lo, up, eff, vel = [], [], [], []
        for j in spec.joints:
            pb, Rp, pp = frame[j.parent]
            Rj = Rp @ _rpy_to_mat(j.origin_rpy)
            pj = pp + Rp @ j.origin_pos
            if j.joint_type == "fixed":
                frame[j.child] = (pb, Rj, pj)
                bodies[pb].append((spec.links[j.child], Rj, pj))
            else:
                bi = len(bodies)
                frame[j.child] = (bi, np.eye(3), np.zeros(3))
                bodies.append([(spec.links[j.child], np.eye(3), np.zeros(3))])
                body_names.append(j.child)
                joints.append(j)
                parent.append(pb)
                jtype.append(
                    REVOLUTE if j.joint_type == "revolute" else PRISMATIC)
                origin_pos.append(pj)
                origin_rot.append(Rj)
                axis.append(j.axis / max(np.linalg.norm(j.axis), 1e-9))
                lo.append(j.lower)
                up.append(j.upper)
                eff.append(j.effort)
                vel.append(j.velocity)

        masses, coms, inertias = [], [], []
        contact_body, contact_offset, contact_radius, contact_link = \
            [], [], [], []
        for bi, parts in enumerate(bodies):
            m_tot = sum(link.mass for link, _, _ in parts)
            if m_tot > 0:
                com = sum(link.mass * (p + R @ link.com)
                          for link, R, p in parts) / m_tot
            else:
                com = np.zeros(3)
            I_tot = np.zeros((3, 3))
            for link, R, p in parts:
                I_l = R @ link.inertia @ R.T
                d = (p + R @ link.com) - com
                I_tot += I_l + link.mass * (
                    np.dot(d, d) * np.eye(3) - np.outer(d, d))
                for center, radius in link.collision_spheres:
                    contact_body.append(bi)
                    contact_offset.append(p + R @ center)
                    contact_radius.append(radius)
                    contact_link.append(link.name)
            masses.append(m_tot)
            coms.append(com)
            inertias.append(I_tot)

        def f32(x, empty_shape=None):
            if empty_shape is not None and not len(x):
                return np.zeros(empty_shape, np.float32)
            return np.asarray(np.asarray(x), np.float32)

        return cls(
            nj=len(joints),
            parent=tuple(parent),
            jtype=tuple(jtype),
            contact_body=tuple(contact_body),
            dof_names=tuple(j.name for j in joints),
            body_names=tuple(body_names),
            contact_link_names=tuple(contact_link),
            origin_pos=f32(origin_pos, (0, 3)),
            origin_rot=f32(origin_rot, (0, 3, 3)),
            axis=f32(axis, (0, 3)),
            mass=f32(masses),
            com=f32(coms),
            inertia=f32(inertias),
            q_lower=f32(lo), q_upper=f32(up),
            effort_limit=f32(eff), vel_limit=f32(vel),
            contact_offset=f32(contact_offset, (0, 3)),
            contact_radius=f32(contact_radius, (0,)),
            gravity=f32(gravity),
        )


@dataclasses.dataclass
class RobotState:
    """Batched state: leading axis B."""

    base_pos: torch.Tensor    # (B, 3)
    base_quat: torch.Tensor   # (B, 4) xyzw
    q: torch.Tensor           # (B, nj)
    v: torch.Tensor           # (B, 6+nj): [v_world, omega_body, qdot]

    def replace(self, **kw) -> "RobotState":
        return dataclasses.replace(self, **kw)

    @property
    def root_states(self) -> torch.Tensor:
        """Isaac-Gym-style 13-dim root state [p, quat, v_world, w_world]."""
        R = quat_to_rotmat(self.base_quat)
        w_world = torch.einsum("...ij,...j->...i", R, self.v[..., 3:6])
        return torch.cat([self.base_pos, self.base_quat, self.v[..., :3],
                          w_world], dim=-1)


def integrate(model, state: RobotState, qdd: torch.Tensor,
              dt: float) -> RobotState:
    """Semi-implicit Euler with Lie-group quaternion update."""
    v_new = state.v + dt * qdd
    base_pos = state.base_pos + dt * v_new[..., :3]
    dq_quat = so3_exp(dt * v_new[..., 3:6])
    base_quat = quat_normalize(quat_mul(state.base_quat, dq_quat))
    q = state.q + dt * v_new[..., 6:]
    return RobotState(base_pos=base_pos, base_quat=base_quat, q=q, v=v_new)
