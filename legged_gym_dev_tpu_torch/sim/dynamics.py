"""Articulated rigid-body model and state in generalized coordinates.

Counterpart of ``legged_gym_dev_tpu/sim/dynamics.py``: the floating-base
kinematic tree (``RobotModel.from_spec``, fixed links merged into their
movable parent), the batched ``RobotState``, the semi-implicit
``integrate``, and the autodiff reference forms: the mass matrix as the
Gauss sum of body-Jacobian quadratic forms (``jacfwd`` of the perturbed
forward kinematics at d = 0), the bias forces from the Lagrangian
identity c = (d(Mv)/dd) v - 1/2 d(v^T M v)/dd + dV/dd, the contact
Jacobians, ``solve_qdd`` and ``forward_dynamics``. The public
``mass_matrix`` / ``bias_forces`` / ``contact_kinematics`` delegate to the
analytic hot path, ``sim/kinematics.py``; the autodiff forms
(``torch.func``) are its independent cross-check.

A tangent perturbation d = [dp, dphi, dq] acts on the base position, on
the base rotation from the right (R <- R exp(dphi^)) and on the joints.

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

    def replace(self, **kw) -> "RobotModel":
        return dataclasses.replace(self, **kw)

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


# ---------------------------------------------------------------------------
# Autodiff reference forms
# ---------------------------------------------------------------------------

_CONSTANTS = ("origin_rot", "origin_pos", "axis", "com", "inertia", "mass",
              "gravity", "contact_offset")


def _load_constants(model: RobotModel, device) -> None:
    """Put the model's constants in its tensor cache before any
    ``torch.func`` transform runs: a cached tensor first made inside one
    transform's level would escape that level when a later one reads it."""
    for name in _CONSTANTS:
        model.tensor(name, device)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _exp_mat_small(phi):
    """SO(3) exp to 2nd order: exact value and 1st/2nd derivatives at
    phi = 0, where it is evaluated (a norm-based Rodrigues formula has a
    non-differentiable sqrt there)."""
    K = _skew(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + K + 0.5 * (K @ K)


def _exp_mat_axis(axis, theta):
    """Exact Rodrigues rotation about a constant unit axis."""
    K = _skew(axis)
    s, c = torch.sin(theta), torch.cos(theta)
    return (torch.eye(3, dtype=axis.dtype, device=axis.device) + s * K
            + (1.0 - c) * (K @ K))


def fk_perturbed(model: RobotModel, base_pos, base_R, q, d):
    """World rotations (nb, 3, 3) and positions (nb, 3) of all body
    frames under the tangent perturbation d (single env)."""
    dev = base_pos.device
    origin_rot = model.tensor("origin_rot", dev)
    origin_pos = model.tensor("origin_pos", dev)
    axis = model.tensor("axis", dev)
    dp, dphi, dq = d[:3], d[3:6], d[6:]
    Rs = [base_R @ _exp_mat_small(dphi)]
    ps = [base_pos + dp]
    for j in range(model.nj):
        Rp, pp = Rs[model.parent[j]], ps[model.parent[j]]
        Rj = Rp @ origin_rot[j]
        pj = pp + Rp @ origin_pos[j]
        theta = q[j] + dq[j]
        if model.jtype[j] == REVOLUTE:
            Rc = Rj @ _exp_mat_axis(axis[j], theta)
            pc = pj
        else:
            Rc = Rj
            pc = pj + Rj @ (axis[j] * theta)
        Rs.append(Rc)
        ps.append(pc)
    return torch.stack(Rs), torch.stack(ps)


def fk(model: RobotModel, state_pos, state_quat, q):
    """Body rotations and positions of one env."""
    base_R = quat_to_rotmat(state_quat)
    return fk_perturbed(model, state_pos, base_R, q,
                        torch.zeros(model.nv, dtype=q.dtype,
                                    device=q.device))


def _coms_fn(model, base_pos, base_R, q):
    """d -> (COM positions (nb, 3), rotations (nb, 3, 3))."""
    com = model.tensor("com", base_pos.device)

    def coms(d):
        Rs, ps = fk_perturbed(model, base_pos, base_R, q, d)
        return ps + torch.einsum("bij,bj->bi", Rs, com), Rs

    return coms


def _rot_jacobians(dRs, Rs0):
    """omega^ = dR R^T per tangent direction: Jr[:, :, k] = vee(dR_k R^T),
    (nb, 3, nv)."""
    W = torch.einsum("bimk,bjm->bijk", dRs, Rs0)
    return torch.stack([W[:, 2, 1, :], W[:, 0, 2, :], W[:, 1, 0, :]], dim=1)


def _body_jacobians(model, base_pos, base_R, q):
    """COM positions, world rotations, COM translational Jacobians Jp
    (nb, 3, nv) and rotational Jacobians Jr (nb, 3, nv) of one env."""
    _load_constants(model, base_pos.device)
    coms = _coms_fn(model, base_pos, base_R, q)
    zero = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    c0, Rs0 = coms(zero)
    Jp, dRs = torch.func.jacfwd(coms)(zero)
    return c0, Rs0, Jp, _rot_jacobians(dRs, Rs0)


def mass_matrix_at(model, base_pos, base_R, q, d):
    """M(q (+) d) of one env: the Gauss sum of the bodies' Jacobian
    quadratic forms."""
    dev = base_pos.device
    _load_constants(model, dev)
    coms = _coms_fn(model, base_pos, base_R, q)
    Jp, dRs = torch.func.jacfwd(coms)(d)
    _, Rs0 = coms(d)
    Jr = _rot_jacobians(dRs, Rs0)
    I_world = torch.einsum("bij,bjk,blk->bil", Rs0,
                           model.tensor("inertia", dev), Rs0)
    return (torch.einsum("b,bik,bil->kl", model.tensor("mass", dev), Jp, Jp)
            + torch.einsum("bik,bij,bjl->kl", Jr, I_world, Jr))


def mass_matrix_autodiff(model, state: RobotState):
    """Batched M(q): (B, nv, nv), the autodiff reference form."""
    _load_constants(model, state.q.device)

    def single(base_pos, base_quat, q):
        return mass_matrix_at(model, base_pos, quat_to_rotmat(base_quat), q,
                              torch.zeros(model.nv, dtype=q.dtype,
                                          device=q.device))

    return torch.func.vmap(single)(state.base_pos, state.base_quat, state.q)


def bias_forces_autodiff(model, state: RobotState):
    """Batched Coriolis/centrifugal + gravity bias c(q, v): (B, nv), from
    the Lagrangian identity in tangent coordinates at d = 0:

        c = (d(M v)/dd) v - 1/2 d(v^T M v)/dd + dV/dd.

    Cost note: the first term is one directional derivative (``jvp``
    along v) and the second one reverse-mode gradient of a scalar, not a
    full Jacobian of d -> M(d) v, which would nest ``jacfwd`` in
    ``jacfwd`` and pay nv^2 kinematics passes."""
    dev = state.q.device
    _load_constants(model, dev)
    mass, gravity = model.tensor("mass", dev), model.tensor("gravity", dev)

    def single(base_pos, base_quat, q, v):
        base_R = quat_to_rotmat(base_quat)
        coms = _coms_fn(model, base_pos, base_R, q)

        def Mv(d):
            return mass_matrix_at(model, base_pos, base_R, q, d) @ v

        def vMv(d):
            return 0.5 * (v @ Mv(d))

        def V(d):
            return -torch.sum(mass * (coms(d)[0] @ gravity))

        zero = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
        _, dMv_v = torch.func.jvp(Mv, (zero,), (v,))   # (d(Mv)/dd) v
        c_cor = dMv_v - torch.func.grad(vMv)(zero)     # - 1/2 d(v^T M v)/dd
        return c_cor + torch.func.grad(V)(zero)

    return torch.func.vmap(single)(state.base_pos, state.base_quat, state.q,
                                   state.v)


def contact_kinematics_autodiff(model, state: RobotState):
    """World positions, velocities and Jacobians of the contact spheres:
    (pos (B, nc, 3), vel (B, nc, 3), Jc (B, nc, 3, nv))."""
    dev = state.q.device
    _load_constants(model, dev)
    cb = torch.as_tensor(model.contact_body, dtype=torch.long, device=dev)
    offset = model.tensor("contact_offset", dev)

    def single(base_pos, base_quat, q, v):
        base_R = quat_to_rotmat(base_quat)

        def points(d):
            Rs, ps = fk_perturbed(model, base_pos, base_R, q, d)
            return ps[cb] + torch.einsum("cij,cj->ci", Rs[cb], offset)

        zero = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
        Jc = torch.func.jacfwd(points)(zero)          # (nc, 3, nv)
        return points(zero), torch.einsum("cik,k->ci", Jc, v), Jc

    return torch.func.vmap(single)(state.base_pos, state.base_quat, state.q,
                                   state.v)


# The public forms delegate to the analytic hot path (kinematics.py); the
# autodiff forms above are independent references for tests.
def mass_matrix(model, state: RobotState):
    """Batched M(q): (B, nv, nv)."""
    from .kinematics import mass_matrix as _mm
    return _mm(model, state)


def bias_forces(model, state: RobotState):
    """Batched Coriolis/centrifugal + gravity bias c(q, v): (B, nv)."""
    from .kinematics import bias_forces as _bf
    return _bf(model, state)


def contact_kinematics(model, state: RobotState):
    """World positions, velocities and Jacobians of the contact spheres:
    (pos (B, nc, 3), vel (B, nc, 3), Jc (B, nc, 3, nv))."""
    from .kinematics import contact_kinematics as _ck
    return _ck(model, state)


def solve_qdd(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """qdd = M^-1 rhs through the unrolled Cholesky of
    ``solver/block_tridiag.py``, with a scale-relative regularization of
    1e-6 of the smallest diagonal entry (small robots have joint inertias
    of about 1e-3, which an absolute epsilon would perturb)."""
    from ..solver.block_tridiag import _chol_solve, small_cholesky

    diag_min = torch.amin(torch.diagonal(M, dim1=-2, dim2=-1), dim=-1)
    M = M + (1e-6 * diag_min)[..., None, None] * torch.eye(
        M.shape[-1], dtype=M.dtype, device=M.device)
    return _chol_solve(small_cholesky(M), rhs)


def forward_dynamics(model, state: RobotState, tau: torch.Tensor,
                     f_ext_generalized: torch.Tensor) -> torch.Tensor:
    """qdd = M^-1 (S tau + f_ext - c); tau (B, nj) joint torques."""
    M = mass_matrix(model, state)
    c = bias_forces(model, state)
    rhs = f_ext_generalized - c
    rhs = torch.cat([rhs[..., :6], rhs[..., 6:] + tau], dim=-1)
    return solve_qdd(M, rhs)
