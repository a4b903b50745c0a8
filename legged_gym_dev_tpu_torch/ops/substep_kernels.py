"""One rigid-body physics substep: the CUDA kernel and its plain version.

Counterpart of ``legged_gym_dev_tpu/ops/pallas_substep.py``. ``substep``
advances a batch of envs by one physics step of ``sim.dt`` under applied
joint torques, in the order of ``RobotSim.substep``: effort clip, joint
springs and soft limits, the scalar-graph FK / mass matrix / bias, flat
compliant contact with per-env DR, unrolled Cholesky, velocity clamp,
semi-implicit Euler.

On CUDA tensors it launches the kernel ``substep`` of ``csrc/substep.cu``
or raises; on CPU tensors, and only there, it runs ``substep_plain``
(``sim/kinematics.substep_core`` and the array-form contact model, as the
JAX package's XLA path). The kernel takes what ``supports_kernel`` admits
(flat terrain, per-robot, not per-env, springs: the JAX kernel's
``supports_pallas``) at 1 to ``MAX_NJ`` joints, each joint count a library
of its own built at first use (``-DSUBSTEP_NJ=<nj>``); it raises for
anything else. ``RobotSim.substep`` sends the sims the predicate refuses
to ``substep_plain``, as the JAX package sends them to its XLA path.

The kernel reads the state tensors and the per-env DR parameters in place,
through a table of (pointer, batch stride, column stride) passed by value
(``SubstepArgs``): an optional base payload mass (scalar or (B,)), per-
contact stiffness, damping and friction (scalar, ``(nc,)``, ``(B, 1)``,
``(B, 1, 1)`` or ``(B, nc)``; stride 0 where broadcast) and the slip
velocity. It writes ``base_pos``, ``base_quat``, ``q`` and ``v`` into four
contiguous (B, n) tensors. ``dr_rows`` is the TPU kernel's row layout of
the same DR values, which the tests hold the table against.

``substep_sharded`` is the counterpart of ``pallas_substep_sharded``
(K3s): the substep under a device mesh, one launch per shard on its
device, on that shard's envs and its rows of every per-env DR field. On a
CUDA shard it launches ``substep_shard`` of the same library
(``substep_shard_kernel``: a warp per env, designed for a shard's batch),
whose outputs equal K3's bit for bit; its schedules are
``pack_shard_topology``'s. Launches are counted per kernel where each
launches: ``launches()`` gives K3's as ``"substep"`` and the shard
kernel's as ``"substep_sharded"``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sim.contact import contact_forces, flat_terrain
from ..sim.dynamics import RobotState
from ..sim.kinematics import _ancestor_dofs, substep_core
from . import _build

SOURCE = "substep.cu"
MAX_NJ = 24    # joints: the ancestor mask is exact in a float up to 24 bits
MAX_NC = 32    # contact spheres the kernel's model struct holds

_KERNELS: dict = {}
_SHARD_KERNELS: dict = {}


def kernel(nj: int) -> _build.Kernel:
    """The kernel's instance for ``nj`` joints (its library is built at
    first use); raises outside 1..MAX_NJ."""
    if not 1 <= nj <= MAX_NJ:
        raise ValueError(f"{nj} joints: the kernel is built for 1 to "
                         f"{MAX_NJ}")
    if nj not in _KERNELS:
        _KERNELS[nj] = _build.Kernel(SOURCE, "substep", n_ptr=3, n_int=3,
                                     defines=(f"SUBSTEP_NJ={nj}",))
    return _KERNELS[nj]


def shard_kernel(nj: int) -> _build.Kernel:
    """The shard kernel's (K3s) instance for ``nj`` joints, in the library
    of ``kernel(nj)``; raises outside 1..MAX_NJ."""
    defines = kernel(nj).defines
    if nj not in _SHARD_KERNELS:
        _SHARD_KERNELS[nj] = _build.Kernel(SOURCE, "substep_shard", n_ptr=3,
                                           n_int=5, defines=defines)
    return _SHARD_KERNELS[nj]


def build(njs) -> dict:
    """Builds the instances for the joint counts ``njs`` at once (one
    ``nvcc`` each, in parallel) unless they are built: {nj: (library path,
    compiler report)}."""
    import concurrent.futures

    njs = sorted(set(njs))
    defines = [kernel(nj).defines for nj in njs]
    with concurrent.futures.ThreadPoolExecutor(len(njs) or 1) as pool:
        return dict(zip(njs, pool.map(
            lambda d: _build.build(SOURCE, d), defines)))


def reset_launches() -> None:
    for k in (*_KERNELS.values(), *_SHARD_KERNELS.values()):
        k.launches = 0


def launches() -> dict:
    """Launches since the last reset: K3's (``substep``) and the shard
    kernel's (``substep_sharded``), over every joint count."""
    return {"substep": sum(k.launches for k in _KERNELS.values()),
            "substep_sharded": sum(k.launches
                                   for k in _SHARD_KERNELS.values())}


def launches_by_nj() -> dict:
    """K3's launches per joint count since the last reset: {nj: n}."""
    return {nj: k.launches for nj, k in sorted(_KERNELS.items())
            if k.launches}


def ent_shift(nj: int) -> int:
    """Bits of an entry's index of M in the packed schedules (``ent_shift``
    of the source): 8 while the packed M has at most 256 entries, else
    10."""
    return 8 if (nj + 6) * (nj + 7) // 2 <= 256 else 10


def supports_kernel(sim) -> bool:
    """Whether the kernel takes this sim (the counterpart of the JAX
    kernel's ``supports_pallas``): flat terrain, and joint springs of at
    most one dimension (per robot, not per env)."""
    if sim.terrain_fn is not flat_terrain:
        return False
    s = sim.springs
    return all(torch.as_tensor(x).ndim <= 1
               for x in (s.stiffness, s.damping, s.setpoint))


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


def pack_topology(model, team: int) -> np.ndarray:
    """The team's schedules in the int32 layout of ``Topo<NJ>`` in
    ``csrc/substep.cu`` (same field order), for ``team`` lanes per env:
    each lane's FK joints (whole subtrees of the base, dealt to the lanes
    in turn, joints in index order); each body's Jacobian columns (dofs 3,
    4, 5, then those of the joints on its path, ascending); the prismatic
    joints as a bit mask; and each body's entries of M, one int each: the
    packed index lo(l, k) | a << S | b << (S + 5) | kind << (S + 10), for
    the pairs of column positions a >= b (kind 1 if both columns are
    rotational, else 0), then each column a against base dof b < 3 (kind
    2), with S = ``ent_shift(nj)``."""
    nj, nb = model.nj, model.nb
    na, S = nj + 3, ent_shift(nj)
    sched = _fk_schedule(model, team)
    prism, rotational = _prismatic(model)
    cols = _body_columns(model)
    ents = []
    for c in cols:
        ents.append(
            [_lo(c[a], c[b]) | a << S | b << (S + 5)
             | int(rotational(c[a]) and rotational(c[b])) << (S + 10)
             for a in range(len(c)) for b in range(a + 1)]
            + [_lo(c[a], i) | a << S | i << (S + 5) | 2 << (S + 10)
               for a in range(len(c)) for i in range(3)])
    return np.concatenate([
        np.asarray([len(js) for js in sched], np.int32), _rows(sched, nj),
        np.asarray([len(c) for c in cols], np.int32), _rows(cols, na),
        np.asarray([prism], np.int32),
        np.asarray([len(e) for e in ents], np.int32),
        _rows(ents, na * (na + 1) // 2 + 3 * na)])


def _lo(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


def _rows(lists, width) -> np.ndarray:
    out = np.zeros((len(lists), width), np.int32)
    for r, x in enumerate(lists):
        out[r, :len(x)] = x
    return out.ravel()


def _fk_schedule(model, team: int) -> list:
    """Each lane's FK joints: whole subtrees of the base dealt to the lanes
    in turn, joints in index order."""
    parent = [int(p) for p in model.parent]
    branch, roots = [], 0
    sched = [[] for _ in range(team)]
    for j in range(model.nj):
        if parent[j] == 0:
            br, roots = roots, roots + 1
        elif parent[j] - 1 < j:
            br = branch[parent[j] - 1]
        else:
            raise ValueError("joints are not in topological order")
        branch.append(br)
        sched[br % team].append(j)
    return sched


def _prismatic(model):
    """The prismatic joints as a bit mask, and whether dof k is
    rotational."""
    prism = sum(1 << j for j in range(model.nj)
                if float(model.jtype[j]) != 0.0)
    return prism, lambda k: k < 6 or not prism >> (k - 6) & 1


def _body_columns(model) -> list:
    """Each body's Jacobian columns: dofs 3, 4, 5, then those of the joints
    on its path, ascending."""
    return [[3, 4, 5] + sorted(6 + j for j in dofs)
            for dofs in _ancestor_dofs(model.parent, model.nj)]


def _shard_header_ints(nj: int, team: int) -> int:
    """int32s of ``ShardTopo<NJ>`` before its items: nsteps, prism, the FK
    schedules and the column list, padded to an even count (the items are
    8-byte aligned)."""
    n = 2 + team + team * nj + (nj + 1) * (nj + 3)
    return n + n % 2


def _shard_items(nj: int, team: int) -> int:
    """Items ``ShardTopo<NJ>`` has room for: every body's entries of M, its
    columns' and the base's bias terms, and a lane's padding."""
    nb, na = nj + 1, nj + 3
    return nb * (na * (na + 1) // 2 + 3 * na + na + 3) + team * nb


def shard_topo_ints(nj: int, team: int) -> int:
    """int32s of ``ShardTopo<NJ>`` (csrc/substep.cu) at ``team`` lanes: the
    header and the items, two ints each."""
    return _shard_header_ints(nj, team) + 2 * _shard_items(nj, team)


def pack_shard_topology(model, team: int) -> tuple:
    """The shard kernel's schedules in the int32 layout of
    ``ShardTopo<NJ>`` in ``csrc/substep.cu`` (same field order), for
    ``team`` lanes per env, the number of Jacobian columns and the steps of
    items a lane walks.

    The inverse of ``pack_topology``'s per-body lists: every body's columns
    numbered body by body (column c: body | dof << 5); for each target, an
    entry e of M or a dof k of the bias, its terms, one per body that adds
    to it, in ascending body order: an entry's are the per-body entries of
    ``pack_topology`` (kinds 0-2, the column pair as numbered here, or
    column a and base dof b < 3 for kind 2); a dof's bias term is its
    column's (kind 3 rotational, 4 prismatic), a base translation dof's the
    body's force (kind 5). The targets are dealt to the lanes longest first,
    each to the lane with the fewest items so far; lane l's s-th item is
    ``item[s * team + l]``: x = a | b << 10 | body << 20 | kind << 25 |
    last of its target << 28, y = the target (-1 pads a lane to
    ``nsteps``). The items come last, after a header padded to an even
    count of ints, so a block copies the header and ``nsteps`` steps."""
    nj, nb = model.nj, model.nb
    na, ni = nj + 3, _shard_items(nj, team)
    sched = _fk_schedule(model, team)
    prism, rotational = _prismatic(model)
    cols = _body_columns(model)
    first = np.cumsum([0] + [len(c) for c in cols]).tolist()
    terms = {}       # (0, e) or (1, k): [x] in body order

    def add(target, a, b, n, kind):
        terms.setdefault(target, []).append(
            a | b << 10 | n << 20 | kind << 25)

    for n, c in enumerate(cols):
        f = first[n]
        for a in range(len(c)):
            for b in range(a + 1):
                add((0, _lo(c[a], c[b])), f + a, f + b, n,
                    int(rotational(c[a]) and rotational(c[b])))
            for i in range(3):
                add((0, _lo(c[a], i)), f + a, i, n, 2)
        for a, k in enumerate(c):
            add((1, k), f + a, 0, n, 3 if rotational(k) else 4)
        for i in range(3):
            add((1, i), 0, 0, n, 5)
    lanes = [[] for _ in range(team)]
    for target in sorted(terms, key=lambda t: -len(terms[t])):
        lane = min(range(team), key=lambda ln: len(lanes[ln]))
        xs = terms[target]
        lanes[lane] += [(x | int(i == len(xs) - 1) << 28, target[1])
                        for i, x in enumerate(xs)]
    nsteps = max(len(xs) for xs in lanes)   # <= ni / team (longest first)
    item = np.zeros((ni, 2), np.int32)
    item[:, 1] = -1
    for ln, xs in enumerate(lanes):
        for st, xy in enumerate(xs):
            item[st * team + ln] = xy
    col = np.zeros(nb * na, np.int32)
    col[:first[-1]] = [n | k << 5 for n, c in enumerate(cols) for k in c]
    head = np.concatenate([
        np.asarray([nsteps, prism], np.int32),
        np.asarray([len(js) for js in sched], np.int32), _rows(sched, nj),
        col])
    pad = np.zeros(_shard_header_ints(nj, team) - head.size, np.int32)
    return np.concatenate([head, pad, item.ravel()]), first[-1], nsteps


def _query(symbol: str, nj: int) -> int:
    """An int-valued query of the nj instance's library, e.g. a struct's
    size."""
    fn = getattr(_build.load(SOURCE, kernel(nj).defines), symbol)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(nj)


def _model_tensors(sim, device):
    """``pack_model`` and ``pack_topology`` on the card, cached on the model
    per device, springs object and scalar settings (a replaced sim shares
    them)."""
    cache = sim.model.__dict__.setdefault("_substep_params", {})
    key = (str(device), id(sim.springs), sim.joint_limit_stiffness,
           sim.joint_limit_damping, sim.base_vel_limit, sim.dt)
    hit = cache.get(key)
    if hit is None or hit[0] is not sim.springs:
        nj = sim.model.nj
        packed = pack_model(sim)
        want = _query("substep_model_floats", nj)
        if want != packed.size:
            raise RuntimeError(f"model packing has {packed.size} floats, "
                               f"the kernel expects {want}")
        if _query("substep_ent_shift", nj) != ent_shift(nj):
            raise RuntimeError("the schedules' entry layout differs from "
                               "the kernel's")
        topo = pack_topology(sim.model, _query("substep_team", nj))
        want = _query("substep_topo_ints", nj)
        if want != topo.size:
            raise RuntimeError(f"schedule packing has {topo.size} ints, "
                               f"the kernel expects {want}")
        hit = (sim.springs, torch.as_tensor(packed, device=device),
               torch.as_tensor(topo, device=device))
        cache[key] = hit
    return hit[1], hit[2]


def _shard_topology(sim, device):
    """``pack_shard_topology`` on the card, cached on the model per device:
    (the schedules, the number of columns, the steps of items)."""
    cache = sim.model.__dict__.setdefault("_substep_shard_topo", {})
    hit = cache.get(str(device))
    if hit is None:
        nj = sim.model.nj
        topo, ncol, nsteps = pack_shard_topology(
            sim.model, _query("substep_shard_team", nj))
        want = _query("substep_shard_topo_ints", nj)
        if want != topo.size:
            raise RuntimeError(f"shard schedule packing has {topo.size} "
                               f"ints, the kernel expects {want}")
        hit = (torch.as_tensor(topo, device=device), ncol, nsteps)
        cache[str(device)] = hit
    return hit


def shard_launch_shape(sim, device) -> dict:
    """The shard kernel's launch shape for this sim's model on the current
    card: lanes an env, envs, threads and dynamic shared memory bytes a
    block, blocks resident on an SM, registers and local memory bytes
    (stack and spills) a thread."""
    _, ncol, nsteps = _shard_topology(sim, device)
    fn = _build.load(SOURCE, kernel(sim.model.nj).defines).substep_shard_shape
    ref = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int] * 3 + [ref] * 7
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(7)]
    err = fn(sim.model.nj, ncol, nsteps, *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"substep_shard_shape: CUDA error {err}")
    keys = ("team", "envs", "threads", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, (x.value for x in out)), columns=ncol,
                steps=nsteps)


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


class SubstepArgs(ctypes.Structure):
    """``SubstepArgs`` of csrc/substep.cu: the five state tensors and the
    five DR parameters as (pointer, batch stride, column stride), in
    elements, and the four outputs."""
    _fields_ = [("inp", ctypes.c_void_p * 5),
                ("in_sb", ctypes.c_int64 * 5),
                ("in_sc", ctypes.c_int64 * 5),
                ("dr", ctypes.c_void_p * 5),
                ("dr_sb", ctypes.c_int64 * 5),
                ("dr_sc", ctypes.c_int64 * 5),
                ("out", ctypes.c_void_p * 4)]


def state_table(state: RobotState, tau: torch.Tensor, nj: int, B: int,
                device):
    """(pointer, batch stride, column stride) of base_pos, base_quat, q, v
    and tau, each read in place as a (B, n) view; raises for anything but
    float32 on ``device`` that broadcasts to its shape."""
    rows = []
    for name, t, n in (("base_pos", state.base_pos, 3),
                       ("base_quat", state.base_quat, 4), ("q", state.q, nj),
                       ("v", state.v, nj + 6), ("tau", tau, nj)):
        if t.dtype is not torch.float32 or t.device != device:
            raise TypeError(f"{name}: expected float32 on {device}, got "
                            f"{t.dtype} on {t.device}")
        if t.shape != (B, n):
            try:
                t = t.expand(B, n)
            except RuntimeError as err:
                raise ValueError(f"{name} of shape {tuple(t.shape)} is not "
                                 f"({B}, {n})") from err
        rows.append((t.data_ptr(), *t.stride()))
    return rows


def dr_table(sim, B: int, device):
    """(pointer, batch stride, column stride) of the DR parameters: base
    payload mass ((0, 0, 0) without one), contact stiffness, damping,
    friction and slip velocity, each a view broadcast to (B,) or (B, nc)
    (stride 0 along what is broadcast); the views, which the pointers
    point into, are returned too."""
    c = sim.contact
    nc = len(sim.model.contact_body)

    def view(p, shape):
        p = torch.as_tensor(p, dtype=torch.float32, device=device)
        if p.ndim == 3:                        # (B, 1, 1) friction
            p = p.reshape(p.shape[0], -1)
        return p.expand(shape)

    views = [None if sim.base_mass_delta is None
             else view(sim.base_mass_delta, (B,))]
    views += [view(p, (B, nc)) for p in (c.stiffness, c.damping,
                                         c.friction)]
    views.append(view(c.slip_vel, (B,)))
    rows = [(0, 0, 0) if v is None else
            (v.data_ptr(), v.stride(0), v.stride(1) if v.ndim > 1 else 0)
            for v in views]
    return rows, views


def _dr_args(sim, B: int, device):
    """An argument struct with only the DR table filled in, and the views it
    points into, kept on the sim: the substeps of one env step share one
    sim. It is rebuilt when any DR tensor object of the sim was replaced
    (the cache holds them, so their identities stay unique)."""
    c = sim.contact
    refs = (c.stiffness, c.damping, c.friction, c.slip_vel,
            sim.base_mass_delta, B, device)
    hit = sim.__dict__.get("_substep_dr")
    if hit is None or any(x is not y for x, y in zip(hit[0][:5], refs)) \
            or hit[0][5:] != refs[5:]:
        args = SubstepArgs()
        rows, views = dr_table(sim, B, device)
        args.dr[:], args.dr_sb[:], args.dr_sc[:] = zip(*rows)
        hit = (refs, args, views)
        sim.__dict__["_substep_dr"] = hit
    return hit[1], hit[2]


def substep_args(sim, state: RobotState, tau: torch.Tensor, outs):
    """The kernel's argument struct (and the DR views it points into)."""
    model, dev = sim.model, state.base_pos.device
    B = state.base_pos.shape[0]
    template, views = _dr_args(sim, B, dev)
    args = SubstepArgs.from_buffer_copy(template)
    ins = state_table(state, tau, model.nj, B, dev)
    args.inp[:], args.in_sb[:], args.in_sc[:] = zip(*ins)
    args.out[:] = [o.data_ptr() for o in outs]
    return args, views


def _call(sim, args: SubstepArgs, B: int, device, form: str):
    """(the ``_build.Kernel``, its pointers, its ints) of one launch on a
    prepared argument struct: ``form`` "team" (``substep_kernel``, K3) or
    "shard" (the shard kernel, K3s)."""
    nj, nc = sim.model.nj, len(sim.model.contact_body)
    params, topo = _model_tensors(sim, device)
    if form == "team":
        return kernel(nj), [params.data_ptr(), topo.data_ptr(),
                            ctypes.addressof(args)], [nj, nc, B]
    topo, ncol, nsteps = _shard_topology(sim, device)
    return shard_kernel(nj), [params.data_ptr(), topo.data_ptr(),
                              ctypes.addressof(args)], [nj, nc, B, ncol,
                                                        nsteps]


def launch(sim, args: SubstepArgs, B: int, device, form="team") -> None:
    """One kernel on a prepared argument struct, counted: ``form`` "team"
    or "shard" (as ``_call``)."""
    k, ptrs, ints = _call(sim, args, B, device, form)
    k(ptrs, ints, device)


def raw_launch(sim, args: SubstepArgs, B: int, device, form="team"):
    """A function that launches one kernel on a prepared argument struct
    through its bound C function, on the current stream, without the
    wrapper's checks and without counting (for timing a kernel alone):
    ``form`` "team" (what ``substep`` launches) or "shard" (what
    ``substep_shard`` launches). The caller keeps ``args`` and its views
    alive."""
    k, ptrs, ints = _call(sim, args, B, device, form)
    fn = k.function()
    raw = (*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)

    def call():
        err = fn(*raw)
        if err:
            raise RuntimeError(f"{k.symbol} launch failed: CUDA error {err}")
    return call


def substep(sim, state: RobotState, tau: torch.Tensor) -> RobotState:
    """One physics substep: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    return _substep(sim, state, tau, "team")


def substep_shard(sim, state: RobotState, tau: torch.Tensor) -> RobotState:
    """One shard's physics substep: the shard kernel (K3s) on CUDA
    tensors, equal to ``substep``'s bit for bit; the plain version on CPU
    tensors."""
    return _substep(sim, state, tau, "shard")


def _substep(sim, state, tau, form) -> RobotState:
    dev = state.base_pos.device
    if dev.type == "cpu":
        return substep_plain(sim, state, tau)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    model = sim.model
    nj, nv = model.nj, model.nv
    kernel(nj)                                  # raises outside the range
    if not supports_kernel(sim):
        raise NotImplementedError("the substep kernel takes flat terrain "
                                  "and per-robot springs only")
    B = state.base_pos.shape[0]
    outs = [torch.empty((B, n), dtype=torch.float32, device=dev)
            for n in (3, 4, nj, nv)]
    args, _views = substep_args(sim, state, tau, outs)
    launch(sim, args, B, dev, form)
    return RobotState(*outs)


def substep_sharded(sim, state, tau, mesh, axis="dp", step=None):
    """One physics substep of an env batch sharded over ``mesh``: on each
    shard ``step`` (default ``substep_shard``: the shard kernel on a CUDA
    shard, which launches or raises; the plain version on a CPU shard;
    ``substep_plain`` for the plain route on every device) on that shard's
    sim from
    ``sim.shard(mesh)``, which holds the shard's rows of every per-env DR
    field (``base_mass_delta`` (B,), contact stiffness, damping and
    friction where per env) on its device; everything else replicated.

    ``state`` and ``tau`` are ``Sharded`` (one tree per shard) or whole
    batches, which are split here; the result is ``Sharded``.
    """
    from ..parallel.mesh import Sharded, _on_device, shard_batch

    k = mesh.extent(axis)
    if isinstance(state, Sharded):
        B = sum(s.base_pos.shape[0] for s in state)
    else:
        B = state.base_pos.shape[0]
    if B % k:
        raise ValueError(f"batch {B} not divisible by mesh extent {k}")
    if not isinstance(state, Sharded):
        state = shard_batch(state, mesh, axis, batch_size=B)
    if not isinstance(tau, Sharded):
        tau = shard_batch(tau, mesh, axis, batch_size=B)
    step = step or substep_shard
    out = []
    for s, st, t in zip(sim.shard(mesh, axis), state, tau):
        if st.base_pos.device != s.device:
            raise ValueError(f"a shard's state on {st.base_pos.device}, "
                             f"its sim on {s.device}")
        with _on_device(s.device):
            out.append(step(s, st, t))
    return Sharded(out, mesh, B)
