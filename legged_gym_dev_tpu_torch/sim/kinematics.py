"""Analytic batched kinematics and dynamics as a scalar graph over (B,)
tensors: the plain version of the substep kernel and the CPU path.

Counterpart of ``legged_gym_dev_tpu/sim/kinematics.py``, line for line:
every 3-vector, 3x3 matrix and Jacobian column is a Python list of (B,)
tensors or Python floats (structural constants), and all tiny contractions
are unrolled in Python. Costs are cut the same way: a Jacobian column
exists only for the dofs on the path base -> body, and the base
translation columns (identity) are handled symbolically.

Conventions: v = [v_world, omega_body, qdot]; the base rotation is
perturbed on the right (R <- R exp(dphi^)), so the base angular Jacobian
block is R0 and the translational block is -skew(x - p0) @ R0.

``substep_core`` runs as PyTorch ops; ``ops/substep_kernels.py`` holds the
CUDA kernel that computes the same substep in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from .dynamics import REVOLUTE, RobotModel, RobotState


def _vadd(a, b):
    return [a[i] + b[i] for i in range(3)]


def _vsub(a, b):
    return [a[i] - b[i] for i in range(3)]


def _vscale(a, s):
    return [a[i] * s for i in range(3)]


def _vcross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _mv(A, v):
    """A (3x3 list) @ v."""
    return [sum(A[i][j] * v[j] for j in range(3)) for i in range(3)]


def _mm(A, B):
    return [[sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]


def _minimum(a, b):
    """NaN-propagating minimum of tensors or Python floats (jnp.minimum)."""
    if isinstance(a, float) and isinstance(b, float):
        return min(a, b)
    if isinstance(a, float):
        a, b = b, a
    if isinstance(b, float):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b)


def _quat_to_R(q):
    """q = [x, y, z, w] of (B,) -> 3x3 list (normalizes first)."""
    x, y, z, w = q
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]


def _axis_rot(axis, theta):
    """Rodrigues about a constant numpy unit axis; theta (B,) -> 3x3 list."""
    s, c = torch.sin(theta), torch.cos(theta)
    a0, a1, a2 = (float(axis[0]), float(axis[1]), float(axis[2]))
    one_c = 1.0 - c
    return [
        [c + a0 * a0 * one_c, a0 * a1 * one_c - a2 * s,
         a0 * a2 * one_c + a1 * s],
        [a1 * a0 * one_c + a2 * s, c + a1 * a1 * one_c,
         a1 * a2 * one_c - a0 * s],
        [a2 * a0 * one_c - a1 * s, a2 * a1 * one_c + a0 * s,
         c + a2 * a2 * one_c],
    ]


def _const_mat(M):
    M = np.asarray(M, np.float64)
    return [[float(M[i, j]) for j in range(3)] for i in range(3)]


def _const_vec(v):
    v = np.asarray(v, np.float64)
    return [float(v[0]), float(v[1]), float(v[2])]


def _ancestor_dofs(parent: tuple, nj: int):
    """Per body: list of joint indices on the path base -> body."""
    out = [[] for _ in range(nj + 1)]
    for b in range(1, nj + 1):
        j, path = b - 1, []
        while True:
            path.append(j)
            pb = parent[j]
            if pb == 0:
                break
            j = pb - 1
        out[b] = sorted(path)
    return out


class ChainLM:
    """Per-body world-frame kinematics, scalar-graph form: R (3x3), p, w,
    vo, dw, ao (3,) per body; ax_w, pj_w per joint. dw/ao are the
    accelerations with qdd = 0 (the Newton-Euler bias accelerations)."""

    __slots__ = ("R", "p", "w", "vo", "dw", "ao", "ax_w", "pj_w")

    def __init__(self, R, p, w, vo, dw, ao, ax_w, pj_w):
        self.R, self.p, self.w, self.vo = R, p, w, vo
        self.dw, self.ao, self.ax_w, self.pj_w = dw, ao, ax_w, pj_w


def _state_lm(state: RobotState):
    """Batch-major RobotState -> per-scalar (B,) lists."""
    p0 = list(state.base_pos.unbind(1))
    quat = list(state.base_quat.unbind(1))
    q = list(state.q.unbind(1))
    v = list(state.v.unbind(1))
    return p0, quat, q, v


def fk_chain_lm(model: RobotModel, p0, quat, q, v) -> ChainLM:
    """One pass down the tree: pose + velocity + bias acceleration."""
    R0 = _quat_to_R(quat)
    w0 = _mv(R0, v[3:6])
    zero3 = [0.0, 0.0, 0.0]

    Rs, ps = [R0], [p0]
    ws, vos = [w0], [v[0:3]]
    dws, aos = [zero3], [zero3]
    axs, pjs = [], []

    for j in range(model.nj):
        pb = model.parent[j]
        Rp, pp = Rs[pb], ps[pb]
        wp, vop, dwp, aop = ws[pb], vos[pb], dws[pb], aos[pb]

        Oj = _const_mat(model.origin_rot[j])
        Rj = _mm(Rp, Oj)
        pj = _vadd(pp, _mv(Rp, _const_vec(model.origin_pos[j])))
        a_w = _mv(Rj, _const_vec(model.axis[j]))
        qj, qdj = q[j], v[6 + j]

        # velocity/acceleration of the joint-origin point (fixed in parent)
        r = _vsub(pj, pp)
        v_j = _vadd(vop, _vcross(wp, r))
        a_j = _vadd(aop, _vadd(_vcross(dwp, r),
                               _vcross(wp, _vcross(wp, r))))

        if model.jtype[j] == REVOLUTE:
            Rc = _mm(Rj, _axis_rot(model.axis[j], qj))
            ps.append(pj)
            ws.append(_vadd(wp, _vscale(a_w, qdj)))
            vos.append(v_j)
            dws.append(_vadd(dwp, _vscale(_vcross(wp, a_w), qdj)))
            aos.append(a_j)
        else:  # PRISMATIC
            Rc = Rj
            off = _vscale(a_w, qj)
            v_rel = _vscale(a_w, qdj)
            ps.append(_vadd(pj, off))
            ws.append(wp)
            vos.append(_vadd(v_j, _vadd(_vcross(wp, off), v_rel)))
            dws.append(dwp)
            aos.append(_vadd(a_j, _vadd(
                _vadd(_vcross(dwp, off), _vcross(wp, _vcross(wp, off))),
                _vscale(_vcross(wp, v_rel), 2.0))))
        Rs.append(Rc)
        axs.append(a_w)
        pjs.append(pj)

    return ChainLM(Rs, ps, ws, vos, dws, aos, axs, pjs)


def _point_jac_cols(model, chain: ChainLM, body: int, x):
    """Translational Jacobian columns {dof: 3-list} of world point x on
    ``body``; base translation columns (identity) are not included."""
    R0, p0 = chain.R[0], chain.p[0]
    rel = _vsub(x, p0)
    cols = {}
    for k in range(3):
        r0col = [R0[0][k], R0[1][k], R0[2][k]]
        cols[3 + k] = _vcross(r0col, rel)   # = -(rel x r0col)
    for j in _ancestor_dofs(model.parent, model.nj)[body]:
        a = chain.ax_w[j]
        if model.jtype[j] == REVOLUTE:
            cols[6 + j] = _vcross(a, _vsub(x, chain.pj_w[j]))
        else:
            cols[6 + j] = a
    return cols


def _rot_jac_cols(model, chain: ChainLM, body: int):
    """Rotational Jacobian columns {dof: 3-list}; k<3 are zero (omitted)."""
    R0 = chain.R[0]
    cols = {}
    for k in range(3):
        cols[3 + k] = [R0[0][k], R0[1][k], R0[2][k]]
    for j in _ancestor_dofs(model.parent, model.nj)[body]:
        if model.jtype[j] == REVOLUTE:
            cols[6 + j] = chain.ax_w[j]
    return cols


def _com_chain(model, chain: ChainLM):
    """Per body: COM position c, COM bias acceleration a_c, world inertia
    I_w (3x3 list)."""
    cs, acs, Iws = [], [], []
    for n in range(model.nb):
        R, p = chain.R[n], chain.p[n]
        r_c = _mv(R, _const_vec(model.com[n]))
        cs.append(_vadd(p, r_c))
        acs.append(_vadd(chain.ao[n], _vadd(
            _vcross(chain.dw[n], r_c),
            _vcross(chain.w[n], _vcross(chain.w[n], r_c)))))
        RI = _mm(R, _const_mat(model.inertia[n]))
        Iws.append([[sum(RI[i][k] * R[j][k] for k in range(3))
                     for j in range(3)] for i in range(3)])
    return cs, acs, Iws


def _assemble_M(model, chain, cs, Iws, base_mass_delta=None):
    """Mass matrix as an nv x nv nested list of (B,)/float entries:
    sum_n m_n Jp_n^T Jp_n + Jr_n^T I_n Jr_n with structural zeros skipped.
    ``base_mass_delta`` (B,) is a point payload at the base origin."""
    nv = 6 + model.nj
    mass_np = np.asarray(model.mass)
    M = [[0.0] * nv for _ in range(nv)]
    total_mass = float(mass_np.sum())
    if base_mass_delta is not None:
        total_mass = total_mass + base_mass_delta
    for i in range(3):
        M[i][i] = M[i][i] + total_mass

    for n in range(model.nb):
        m_n = float(mass_np[n])
        if n == 0 and base_mass_delta is not None:
            m_n = m_n + base_mass_delta
        jp = _point_jac_cols(model, chain, n, cs[n])
        jr = _rot_jac_cols(model, chain, n)
        dofs = sorted(jp.keys())
        # structural-zero check on the nominal mass
        if not (isinstance(m_n, float) and m_n == 0.0):
            for k in dofs:
                col = jp[k]
                for i in range(3):
                    M[i][k] = M[i][k] + m_n * col[i]
            for ka in range(len(dofs)):
                k = dofs[ka]
                for la in range(ka, len(dofs)):
                    l = dofs[la]
                    M[k][l] = M[k][l] + m_n * _vdot(jp[k], jp[l])
        rdofs = sorted(jr.keys())
        Ijr = {l: _mv(Iws[n], jr[l]) for l in rdofs}
        for ka in range(len(rdofs)):
            k = rdofs[ka]
            for la in range(ka, len(rdofs)):
                l = rdofs[la]
                M[k][l] = M[k][l] + _vdot(jr[k], Ijr[l])
    for k in range(nv):
        for l in range(k + 1, nv):
            M[l][k] = M[k][l]
    return M


def _assemble_bias(model, chain, cs, acs, Iws, base_mass_delta=None):
    """Generalized bias c(q, v) = sum_n Jp^T m(a_c - g) + Jr^T (I dw +
    w x I w) as an nv list of (B,) entries (gravity folded in)."""
    nv = 6 + model.nj
    mass_np = np.asarray(model.mass)
    g = _const_vec(model.gravity)
    out = [0.0] * nv
    for n in range(model.nb):
        m_n = float(mass_np[n])
        if n == 0 and base_mass_delta is not None:
            m_n = m_n + base_mass_delta
        f = [m_n * (acs[n][i] - g[i]) for i in range(3)]
        Iw, w, dw = Iws[n], chain.w[n], chain.dw[n]
        tq = _vadd(_mv(Iw, dw), _vcross(w, _mv(Iw, w)))
        for i in range(3):
            out[i] = out[i] + f[i]
        jp = _point_jac_cols(model, chain, n, cs[n])
        for k, col in jp.items():
            out[k] = out[k] + _vdot(col, f)
        jr = _rot_jac_cols(model, chain, n)
        for k, col in jr.items():
            out[k] = out[k] + _vdot(col, tq)
    return out


def _contact_points_lm(model, chain: ChainLM):
    """Per contact sphere: world position, velocity (3-lists)."""
    pos, vel = [], []
    for c, b in enumerate(model.contact_body):
        R, p = chain.R[b], chain.p[b]
        off = _mv(R, _const_vec(model.contact_offset[c]))
        pos.append(_vadd(p, off))
        vel.append(_vadd(chain.vo[b], _vcross(chain.w[b], off)))
    return pos, vel


def _chol_solve_lm(M, rhs, nv):
    """Solve M x = rhs for nested-list SPD M: unrolled Cholesky with
    scale-relative regularization (1e-6 of the smallest diagonal entry)
    and pivots floored at 1e-12."""
    diag_min = M[0][0]
    for i in range(1, nv):
        diag_min = _minimum(diag_min, M[i][i])
    reg = 1e-6 * diag_min
    L = [[None] * nv for _ in range(nv)]
    for j in range(nv):
        acc = M[j][j] + reg
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(acc, min=1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, nv):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * nv
    for i in range(nv):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * nv
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _bcast(cols, B, like):
    """A list of (B,) tensors / Python floats as a (B, n) tensor."""
    arrs = [torch.full((B,), float(c), dtype=torch.float32,
                       device=like.device)
            if isinstance(c, (int, float)) else c for c in cols]
    return torch.stack(arrs, dim=-1)


def mass_matrix(model: RobotModel, state: RobotState,
                base_mass_delta=None) -> torch.Tensor:
    """Batched M(q): (B, nv, nv)."""
    B = state.base_pos.shape[0]
    p0, quat, q, v = _state_lm(state)
    chain = fk_chain_lm(model, p0, quat, q, v)
    cs, _, Iws = _com_chain(model, chain)
    M = _assemble_M(model, chain, cs, Iws, base_mass_delta)
    return torch.stack([_bcast(row, B, state.base_pos) for row in M], dim=-2)


def bias_forces(model: RobotModel, state: RobotState) -> torch.Tensor:
    """Batched Coriolis/centrifugal + gravity bias c(q, v): (B, nv)."""
    B = state.base_pos.shape[0]
    p0, quat, q, v = _state_lm(state)
    chain = fk_chain_lm(model, p0, quat, q, v)
    cs, acs, Iws = _com_chain(model, chain)
    return _bcast(_assemble_bias(model, chain, cs, acs, Iws), B,
                  state.base_pos)


def contact_points(model: RobotModel, state: RobotState):
    """(pos (B,nc,3), vel (B,nc,3)) of the contact spheres: the part of
    ``contact_kinematics`` that callers who discard the Jacobian need (XLA
    drops the unused Jacobian from the JAX package's traced steps; eager
    PyTorch would build it)."""
    pos_a, vel_a, _ = _contact_points(model, state)
    return pos_a, vel_a


def _contact_points(model, state):
    B = state.base_pos.shape[0]
    ref = state.base_pos
    p0, quat, q, v = _state_lm(state)
    chain = fk_chain_lm(model, p0, quat, q, v)
    pos, vel = _contact_points_lm(model, chain)
    if not pos:
        z = ref.new_zeros((B, 0, 3))
        return z, z, (chain, pos)
    pos_a = torch.stack([_bcast(p, B, ref) for p in pos], dim=1)
    vel_a = torch.stack([_bcast(vl, B, ref) for vl in vel], dim=1)
    return pos_a, vel_a, (chain, pos)


def contact_kinematics(model: RobotModel, state: RobotState):
    """(pos (B,nc,3), vel (B,nc,3), Jc (B,nc,3,nv))."""
    B = state.base_pos.shape[0]
    nv = 6 + model.nj
    ref = state.base_pos
    pos_a, vel_a, (chain, pos) = _contact_points(model, state)
    nc = len(pos)
    if not nc:
        return pos_a, vel_a, ref.new_zeros((B, 0, 3, nv))
    Js = []
    for c in range(nc):
        cols = _point_jac_cols(model, chain, model.contact_body[c], pos[c])
        full = []
        for k in range(nv):
            if k < 3:
                col = [1.0 if i == k else 0.0 for i in range(3)]
            else:
                col = cols.get(k, [0.0, 0.0, 0.0])
            full.append(_bcast(col, B, ref))        # (B, 3)
        Js.append(torch.stack(full, dim=-1))        # (B, 3, nv)
    return pos_a, vel_a, torch.stack(Js, dim=1)


def dynamics_terms(model: RobotModel, state: RobotState):
    """(M, bias, contact pos/vel/Jc) of one state: the array API for
    observation and reward code and for tests."""
    M = mass_matrix(model, state)
    c = bias_forces(model, state)
    pos, vel, Jc = contact_kinematics(model, state)
    return M, c, pos, vel, Jc


def substep_core(model: RobotModel, state: RobotState, tau: torch.Tensor,
                 contact_force_fn, base_mass_delta=None) -> torch.Tensor:
    """qdd (B, nv) from one scalar-graph pass.

    ``contact_force_fn(pos (B,nc,3), vel (B,nc,3)) -> (B,nc,3)`` is the
    compliant terrain model (sim/contact.py). The JAX module's XLA fusion
    barriers have no meaning here and are left out.
    """
    B = state.base_pos.shape[0]
    ref = state.base_pos
    nv = 6 + model.nj
    p0, quat, q, v = _state_lm(state)
    chain = fk_chain_lm(model, p0, quat, q, v)
    cs, acs, Iws = _com_chain(model, chain)
    M = _assemble_M(model, chain, cs, Iws, base_mass_delta)
    bias = _assemble_bias(model, chain, cs, acs, Iws, base_mass_delta)

    pos, vel = _contact_points_lm(model, chain)
    rhs = [-bias[k] for k in range(nv)]
    if pos:
        pos_a = torch.stack([_bcast(p, B, ref) for p in pos], dim=1)
        vel_a = torch.stack([_bcast(vl, B, ref) for vl in vel], dim=1)
        f = contact_force_fn(pos_a, vel_a)      # (B, nc, 3)
        for c in range(len(pos)):
            fc = [f[:, c, 0], f[:, c, 1], f[:, c, 2]]
            cols = _point_jac_cols(model, chain, model.contact_body[c],
                                   pos[c])
            for i in range(3):
                rhs[i] = rhs[i] + fc[i]
            for k, col in cols.items():
                rhs[k] = rhs[k] + _vdot(col, fc)
    for j in range(model.nj):
        rhs[6 + j] = rhs[6 + j] + tau[:, j]
    return _bcast(_chol_solve_lm(M, rhs, nv), B, ref)
