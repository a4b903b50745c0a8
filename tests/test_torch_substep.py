"""The plain version of the physics-substep kernel (K3) against the JAX
package: its XLA path (``RobotSim.substep``) and its Pallas kernel run in
interpret mode (``pallas_substep(..., interpret=True)``), on both test
robots, with and without per-env DR (base payload mass, contact stiffness
and damping multipliers, friction). Single steps only: chained traces
diverge through contact. Tolerance rtol=atol=2e-5, the JAX package's own
bar between those two paths (tests/test_pallas_substep.py:38).

The CUDA kernel itself runs only on a card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); here the wrapper's
layout helpers and its CPU routing are checked.
"""
import ctypes

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu.ops.pallas_substep import pallas_substep
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
from tests.torch_port_cases import jax_robot_sim, jax_robot_state
from tests.torch_robot_cases import (
    DR_FORMS,
    ROBOTS,
    dr_form_sims,
    strided_state,
    substep_inputs,
    torch_sim,
    torch_state,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = ("base_pos", "base_quat", "q", "v")
CASES = [(r, dr) for r in sorted(ROBOTS) for dr in (False, True)]


def _ids(case):
    return f"{case[0]}-{'dr' if case[1] else 'nominal'}"


def _compare(out, ref):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_substep_matches_jax(case):
    robot, dr = case
    inp = substep_inputs(robot, 16, seed=3, dr=dr)
    st, tau = torch_state(inp)
    out = torch_sim(robot, "cpu", inp).substep(st, tau)
    ref = jax_robot_sim(robot, inp).substep(*jax_robot_state(inp))
    _compare(out, ref)
    # the draw exercises contact and moves every coordinate
    assert not np.allclose(out.v.numpy(), inp["v"])


# The quadruped's interpret-mode kernel takes about a minute on the CPU,
# so it is held with DR on (the richer case); the 4-joint robot both ways.
@pytest.mark.parametrize("case", [("hopper4", False), ("hopper4", True),
                                  ("quadruped", True)], ids=_ids)
def test_plain_substep_matches_pallas_interpret(case):
    robot, dr = case
    inp = substep_inputs(robot, 16, seed=3, dr=dr)
    st, tau = torch_state(inp)
    out = torch_sim(robot, "cpu", inp).substep(st, tau)
    ref = pallas_substep(jax_robot_sim(robot, inp), *jax_robot_state(inp),
                         block=16, interpret=True)
    _compare(out, ref)


def test_cpu_tensors_take_the_plain_version():
    inp = substep_inputs("hopper4", 4, seed=0)
    sim = torch_sim("hopper4", "cpu", inp)
    st, tau = torch_state(inp)
    sk.reset_launches()
    out = sk.substep(sim, st, tau)
    shard = sk.substep_shard(sim, st, tau)
    ref = sk.substep_plain(sim, st, tau)
    assert sk.launches() == {"substep": 0, "substep_sharded": 0}
    for f in FIELDS:
        torch.testing.assert_close(getattr(out, f), getattr(ref, f),
                                   rtol=0, atol=0)
        torch.testing.assert_close(getattr(shard, f), getattr(ref, f),
                                   rtol=0, atol=0)


def test_other_devices_raise():
    inp = substep_inputs("hopper4", 2, seed=0)
    sim = torch_sim("hopper4", "cpu", inp)
    st, tau = torch_state(inp)
    meta = type(st)(*(getattr(st, f).to("meta") for f in FIELDS))
    with pytest.raises(RuntimeError, match="no kernel"):
        sk.substep(sim, meta, tau.to("meta"))


def test_blown_up_env_stays_non_finite():
    """A NaN in one env's state stays NaN through the substep (the env's
    guard_finite_state relies on it) and does not leak into the others."""
    inp = substep_inputs("quadruped", 4, seed=1, dr=True)
    inp["v"][2, 9] = np.nan
    st, tau = torch_state(inp)
    out = torch_sim("quadruped", "cpu", inp).substep(st, tau)
    assert not bool(torch.isfinite(out.v[2]).all())
    assert bool(torch.isfinite(out.v[[0, 1, 3]]).all())


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_packed_model_layout(robot):
    """The all-float model struct of csrc/substep.cu: its size for this
    robot's joint count, and the fields the kernel reads by offset."""
    sim = torch_sim(robot, "cpu")
    m = sim.model
    nj, nb = m.nj, m.nb
    p = sk.pack_model(sim)
    per_joint = 1 + 1 + 3 + 9 + 3 + 7      # parent, jtype, ..., springs
    size = (nj * per_joint + nb * (1 + 1 + 3 + 9) + 3 + 1 + 4 + 1
            + sk.MAX_NC * 5)
    assert p.size == size
    np.testing.assert_array_equal(p[:nj], np.asarray(m.parent, np.float32))
    anc = p[2 * nj:2 * nj + nb].astype(int)
    assert anc[0] == 0 and all(anc[j + 1] >> j & 1 for j in range(nj))
    off = 2 * nj + nb + nj * 15 + nb * 13 + 3
    assert p[off] == np.float32(m.mass.sum())          # total mass
    off += 1 + 7 * nj
    np.testing.assert_array_equal(
        p[off:off + 4], np.asarray([sim.joint_limit_stiffness,
                                    sim.joint_limit_damping,
                                    sim.base_vel_limit, sim.dt], np.float32))
    assert p[off + 4] == len(m.contact_body)


def test_dr_rows_broadcast_as_the_tpu_kernel():
    """Scalar, (B,1) and (B,1,1) contact parameters become (nc, B) rows;
    the payload row comes first and the slip row last."""
    B = 6
    inp = substep_inputs("quadruped", B, seed=2, dr=True)
    sim = torch_sim("quadruped", "cpu", inp)
    nc = len(sim.model.contact_body)
    rows = sk.dr_rows(sim, B, torch.device("cpu"))
    assert rows.shape == (1 + 3 * nc + 1, B)
    np.testing.assert_allclose(rows[0].numpy(), inp["base_mass"])
    np.testing.assert_allclose(rows[1].numpy(),
                               5000.0 * inp["stiff_mult"][:, 0], rtol=1e-6)
    np.testing.assert_allclose(rows[1 + 2 * nc + nc - 1].numpy(),
                               inp["friction"][:, 0, 0])
    np.testing.assert_allclose(rows[-1].numpy(), np.full(B, 0.1, np.float32))


def _gather(row, shape, tensors):
    """The (B, n) or (B,) values a table row (pointer, batch stride, column
    stride) points at, read through the storage of one of ``tensors``."""
    p, sb, sc = row
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() <= p < st.data_ptr() + st.nbytes():
            base = torch.tensor([], dtype=torch.float32).set_(st)
            return torch.as_strided(base, shape, (sb, sc)[:len(shape)],
                                    (p - st.data_ptr()) // 4)
    raise AssertionError(f"pointer {p:#x} is in no tensor")


STATE_FORMS = [(r, f) for r in sorted(ROBOTS) for f in ("contiguous",
                                                          "strided")]
DR_CASES = [(f, bmd) for f in DR_FORMS for bmd in (False, True)]


@pytest.mark.parametrize(
    "case", [("state",) + c for c in STATE_FORMS]
    + [("dr", "quadruped") + c for c in DR_CASES],
    ids=lambda c: "-".join(str(x) for x in c))
def test_substep_tables_gather_the_tpu_rows(case):
    """The kernel reads the state and the DR parameters in place, through
    (pointer, batch stride, column stride). Gathered through those strides
    on CPU tensors, the state table gives the TPU kernel's ``xs`` rows
    (base_pos, base_quat, q, v, tau) and the DR table ``dr_rows`` (payload
    mass, stiffness, damping and friction per sphere, slip), for state
    tensors handed as the env hands them (strided views, a quaternion
    broadcast over envs) and each DR broadcast form."""
    B = 6
    robot = case[1]
    inp = substep_inputs(robot, B, seed=4)
    sim = torch_sim(robot, "cpu", inp)
    nj, nv = sim.model.nj, sim.model.nv
    st, tau = torch_state(inp)
    cpu = torch.device("cpu")
    if case[0] == "state":
        if case[2] == "strided":
            st = strided_state(st)
            assert not st.q.is_contiguous()
        rows = sk.state_table(st, tau, nj, B, cpu)
        xs = torch.cat([st.base_pos, st.base_quat, st.q, st.v, tau], 1).t()
        got = torch.cat([_gather(r, (B, n), [st.base_pos, st.base_quat,
                                             st.q, st.v, tau]).t()
                         for r, n in zip(rows, (3, 4, nj, nv, nj))])
        assert torch.equal(got, xs)
        return
    form, bmd = case[2], case[3]
    sim, plain_sim = dr_form_sims(sim, form, B, bmd, seed=len(form))
    nc = len(sim.model.contact_body)
    rows, views = sk.dr_table(sim, B, cpu)
    ref = sk.dr_rows(sim, B, cpu)
    assert torch.equal(ref, sk.dr_rows(plain_sim, B, cpu))
    live = [v for v in views if v is not None]
    got = []
    if bmd:
        got.append(_gather(rows[0], (B,), live)[None])
    else:
        assert rows[0] == (0, 0, 0)
    for r in rows[1:4]:
        got.append(_gather(r, (B, nc), live).t())
    got.append(_gather(rows[4], (B,), live)[None])
    assert torch.equal(torch.cat(got), ref)
    if form in ("scalar", "per_sphere"):
        assert rows[1][1] == 0                   # broadcast over envs


@pytest.mark.parametrize("robot,team", [("quadruped", 8), ("quadruped", 4),
                                        ("hopper4", 4), ("hopper4", 8)])
def test_pack_topology_schedules(robot, team):
    """The team's schedules the kernel reads (``Topo<NJ>``): every joint in
    exactly one lane's FK list, after its parent joint in the same list;
    each body's Jacobian columns the base rotation dofs and the joints on
    its path; and each body's entries of M exactly those the one-thread
    kernel adds to for that body (pairs of its columns, and each column
    against the three base translation dofs), with the rotational term
    where both columns are rotational."""
    from legged_gym_dev_tpu_torch.sim.kinematics import _ancestor_dofs

    m = torch_sim(robot, "cpu").model
    nj, nb = m.nj, m.nb
    na = nj + 3
    ne_max = na * (na + 1) // 2 + 3 * na
    t = sk.pack_topology(m, team)
    sizes = [team, team * nj, nb, nb * na, 1, nb, nb * ne_max]
    assert t.size == sum(sizes)
    slen, sched, alen, adof, prism, elen, ent = np.split(
        t, np.cumsum(sizes)[:-1])
    sched, adof, ent = (sched.reshape(team, nj), adof.reshape(nb, na),
                        ent.reshape(nb, ne_max))
    lanes = [list(sched[ln, :slen[ln]]) for ln in range(team)]
    assert sorted(j for js in lanes for j in js) == list(range(nj))
    for js in lanes:
        for i, j in enumerate(js):
            assert m.parent[j] == 0 or m.parent[j] - 1 in js[:i]
    prismatic = {j for j in range(nj) if m.jtype[j] != 0}
    assert int(prism[0]) == sum(1 << j for j in prismatic)

    def lo(i, j):
        return i * (i + 1) // 2 + j

    for n, path in enumerate(_ancestor_dofs(m.parent, nj)):
        cols = [3, 4, 5] + sorted(6 + j for j in path)
        assert list(adof[n, :alen[n]]) == cols
        got = {}
        for w in ent[n, :elen[n]]:
            e, a, b, kind = w & 0xff, w >> 8 & 31, w >> 13 & 31, w >> 18
            got[int(e)] = (int(kind), cols[a], b if kind == 2 else cols[b])
        rot = {k for k in cols if k - 6 not in prismatic}
        want = {lo(l, k): (int(l in rot and k in rot), l, k)
                for l in cols for k in cols if k <= l}
        want.update({lo(l, i): (2, l, i) for l in cols for i in range(3)})
        assert got == want and len(got) == elen[n]


def _per_body_terms(m):
    """K3's schedule (``pack_topology``) as {target: [(body, kind, column
    dofs)]} in body order, read body by body as the kernel's body loop
    adds the terms: each body's entries of M (kinds 0-2) and its columns'
    bias terms (kind 3 rotational, 4 prismatic), and the base translation
    dofs' force terms (kind 5)."""
    nj, nb = m.nj, m.nb
    na = nj + 3
    ne_max = na * (na + 1) // 2 + 3 * na
    t = sk.pack_topology(m, 8)
    sizes = [8, 8 * nj, nb, nb * na, 1, nb, nb * ne_max]
    _, _, alen, adof, prism, elen, ent = np.split(t, np.cumsum(sizes)[:-1])
    adof, ent = adof.reshape(nb, na), ent.reshape(nb, ne_max)
    S = sk.ent_shift(nj)
    out = {}
    for n in range(nb):
        cols = [int(k) for k in adof[n, :alen[n]]]
        for w in ent[n, :elen[n]]:
            e, a, b, kind = (int(w) & (1 << S) - 1, int(w) >> S & 31,
                             int(w) >> S + 5 & 31, int(w) >> S + 10)
            out.setdefault(("M", e), []).append(
                (n, kind, cols[a], b if kind == 2 else cols[b]))
        for k in cols:
            rot = k < 6 or not int(prism[0]) >> (k - 6) & 1
            out.setdefault(("bias", k), []).append((n, 3 if rot else 4, k))
        for i in range(3):
            out.setdefault(("bias", i), []).append((n, 5))
    return out


def _unpack_shard(m, team):
    """``pack_shard_topology`` read back: the lanes' item lists, nsteps, the
    FK schedules, the column list (body, dof) and the number of
    columns."""
    nj, nb = m.nj, m.nb
    na = nj + 3
    t, ncol, nsteps = sk.pack_shard_topology(m, team)
    assert t.size == sk.shard_topo_ints(nj, team)
    head = 2 + team + team * nj + nb * na
    item = t[head + head % 2:].reshape(-1, 2)
    assert int(t[0]) == nsteps and not t[head:head + head % 2].any()
    prism = int(t[1])
    slen = t[2:2 + team]
    sched = t[2 + team:2 + team + team * nj].reshape(team, nj)
    col = t[2 + team + team * nj:head]
    assert prism == sum(1 << j for j in range(nj) if m.jtype[j] != 0)
    assert not item[nsteps * team:, 1].max(initial=-1) >= 0
    lanes = [[tuple(int(v) for v in item[s * team + ln])
              for s in range(nsteps)] for ln in range(team)]
    cols = [(int(c) & 31, int(c) >> 5) for c in col[:ncol]]
    assert not col[ncol:].any()
    return lanes, nsteps, slen, sched, cols, ncol


SCHEDULE_ROBOTS = ["quadruped", "hopper4", "biped10", "chain10", "chain16",
                   "chain24"]


@pytest.mark.parametrize("team", [32, 16])
@pytest.mark.parametrize("robot", SCHEDULE_ROBOTS)
def test_pack_shard_topology_inverts_the_schedules(robot, team):
    """The shard kernel's schedules (``ShardTopo<NJ>``) read back target by
    target give exactly K3's per-body terms: every (body, entry, column
    pair, kind) of ``pack_topology``'s per-body lists once, in its entry's
    list and nowhere else; each target's bodies ascending; each dof's bias
    terms from exactly the bodies whose columns hold it; a target's terms
    on one lane, ending with its last flag; the columns numbered body by
    body in K3's column order; the FK schedules K3's at this team."""
    from legged_gym_dev_tpu_torch.sim.kinematics import _ancestor_dofs

    m = torch_sim(robot, "cpu").model
    lanes, nsteps, slen, sched, cols, ncol = _unpack_shard(m, team)
    paths = _ancestor_dofs(m.parent, m.nj)
    body_cols = [[3, 4, 5] + sorted(6 + j for j in p) for p in paths]
    assert cols == [(n, k) for n, c in enumerate(body_cols) for k in c]
    assert ncol == sum(len(c) for c in body_cols)
    got = {}
    for items in lanes:
        open_target = None
        for x, y in items:
            if y < 0:
                assert open_target is None     # padding only between
                continue                       # targets, at the end
            a, b, n, kind = x & 1023, x >> 10 & 1023, x >> 20 & 31, \
                x >> 25 & 7
            key = ("M" if kind < 3 else "bias", y)
            assert open_target in (None, key)
            assert key not in got or open_target == key   # one lane
            assert kind == 5 or cols[a][0] == n
            if kind < 3:
                assert cols[b][0] == n if kind != 2 else b < 3
                term = (n, kind, cols[a][1], b if kind == 2 else cols[b][1])
            elif kind == 5:
                assert y < 3
                term = (n, 5)
            else:
                assert cols[a][1] == y
                term = (n, kind, y)
            got.setdefault(key, []).append(term)
            open_target = None if x >> 28 & 1 else key
        assert open_target is None
    want = _per_body_terms(m)
    assert got == want
    for key, terms in got.items():
        assert [t[0] for t in terms] == sorted(t[0] for t in terms)
        if key[0] == "bias" and key[1] >= 3:
            assert [t[0] for t in terms] == [
                n for n, c in enumerate(body_cols) if key[1] in c]
    # balanced: no lane walks more than the mean plus the longest target
    total = sum(len(t) for t in got.values())
    assert nsteps <= -(-total // team) + max(len(t) for t in got.values())
    k3 = sk.pack_topology(m, team)
    assert np.array_equal(slen, k3[:team])
    assert np.array_equal(sched.ravel(), k3[team:team + team * m.nj])


@pytest.mark.parametrize("robot", ["biped10", "chain10"])
def test_launch_forms_take_their_tables(robot, monkeypatch):
    """At nj=10 (the Adam stand-in's joint count) K3's launch ("team",
    what ``substep`` launches) takes the team kernel's model, schedules
    (``pack_topology`` at 8 lanes) and ``SubstepArgs``; the shard kernel's
    ("shard", what ``substep_shard`` launches) the same model and
    ``SubstepArgs`` with ``pack_shard_topology``'s schedules at a warp,
    its columns and steps; each launch counts under its own kernel. The
    library's queries are answered as csrc/substep.cu's are."""
    sim = torch_sim(robot, "cpu")
    m, B, cpu = sim.model, 7, torch.device("cpu")
    nc = len(m.contact_body)
    answers = {"substep_model_floats": sk.pack_model(sim).size,
               "substep_ent_shift": sk.ent_shift(10), "substep_team": 8,
               "substep_topo_ints": sk.pack_topology(m, 8).size,
               "substep_shard_team": 32,
               "substep_shard_topo_ints": sk.shard_topo_ints(10, 32)}
    monkeypatch.setattr(sk, "_query", lambda symbol, nj: answers[symbol])
    assert m.nj == 10
    inp = substep_inputs(robot, B, seed=1, dr=True)
    st, tau = torch_state(inp)
    outs = [torch.empty((B, n)) for n in (3, 4, m.nj, m.nv)]
    args, _ = sk.substep_args(sim, st, tau, outs)
    params, k3_topo = sk._model_tensors(sim, cpu)
    k3, ptrs, ints = sk._call(sim, args, B, cpu, "team")
    assert k3 is sk.kernel(10) and k3.symbol == "substep"
    assert ints == [10, nc, B]
    assert ptrs == [params.data_ptr(), k3_topo.data_ptr(),
                    ctypes.addressof(args)]
    assert np.array_equal(k3_topo.numpy(), sk.pack_topology(m, 8))
    k, ptrs, ints = sk._call(sim, args, B, cpu, "shard")
    topo, ncol, nsteps = sk.pack_shard_topology(m, 32)
    assert k is sk.shard_kernel(10) and k.symbol == "substep_shard"
    assert k.defines == k3.defines and len(k.argtypes) == 9
    assert ints == [10, nc, B, ncol, nsteps]
    shard_topo = sk._shard_topology(sim, cpu)[0]
    assert ptrs == [params.data_ptr(), shard_topo.data_ptr(),
                    ctypes.addressof(args)]
    assert np.array_equal(shard_topo.numpy(), topo)
    sk.reset_launches()
    k.launches, k3.launches = 3, 2
    assert sk.launches_by_nj() == {10: 2}
    assert sk.launches() == {"substep": 2, "substep_sharded": 3}
    sk.reset_launches()
    assert sk.launches() == {"substep": 0, "substep_sharded": 0}


@pytest.mark.parametrize("robot", ["chain1", "chain6", "chain16",
                                   "chain24"])
@pytest.mark.parametrize("dr", [False, True])
def test_plain_substep_matches_jax_at_new_joint_counts(robot, dr):
    """The plain version at joint counts the kernel gained (synthetic
    chains of tests/torch_robot_cases.py: one joint; one chain of six with
    a prismatic joint; two and three chains of eight) against JAX's XLA
    path."""
    inp = substep_inputs(robot, 16, seed=3, dr=dr)
    st, tau = torch_state(inp)
    out = torch_sim(robot, "cpu", inp).substep(st, tau)
    ref = jax_robot_sim(robot, inp).substep(*jax_robot_state(inp))
    _compare(out, ref)
    assert not np.allclose(out.v.numpy(), inp["v"])


def test_kernel_instances_span_one_to_max_nj():
    """One instance per joint count in 1..MAX_NJ (built with its
    ``-DSUBSTEP_NJ``), none outside; the packed model and schedules of
    every chain have the sizes of csrc/substep.cu's ``Model<NJ>``,
    ``Topo<NJ>`` (team of 8) and ``ShardTopo<NJ>`` (team of 32, items
    8-byte aligned), with a 10-bit entry index from nj = 17."""
    from legged_gym_dev_tpu_torch.sim.kinematics import _ancestor_dofs

    assert sk.MAX_NJ >= 24
    for nj in (0, sk.MAX_NJ + 1):
        with pytest.raises(ValueError, match="joints"):
            sk.kernel(nj)
    for nj in range(1, sk.MAX_NJ + 1):
        assert sk.kernel(nj).defines == (f"SUBSTEP_NJ={nj}",)
        sim = torch_sim(f"chain{nj}")
        nb, nv, na, nc = nj + 1, nj + 6, nj + 3, 32
        ne = na * (na + 1) // 2 + 3 * na
        model = (2 * nj + nb + 3 * nj + 9 * nj + 3 * nj + nb + 3 * nb
                 + 9 * nb + 3 + 1 + 7 * nj + 4 + 1 + nc + 3 * nc + nc)
        assert sk.pack_model(sim).size == model
        topo = sk.pack_topology(sim.model, 8)
        assert topo.size == 8 + 8 * nj + nb + nb * na + 1 + nb + nb * ne
        head = 2 + 32 + 32 * nj + nb * na
        shard, ncol, nsteps = sk.pack_shard_topology(sim.model, 32)
        assert shard.size == head + head % 2 + 2 * (nb * (ne + na + 3)
                                                    + 32 * nb)
        assert 0 < nsteps * 32 <= nb * (ne + na + 3) + 32 * nb
        assert ncol == sum(3 + len(p) for p in _ancestor_dofs(
            sim.model.parent, nj))
        shift = sk.ent_shift(nj)
        assert shift == (10 if nv * (nv + 1) // 2 > 256 else 8) == (
            10 if nj >= 17 else 8)
        ents = topo[-nb * ne:].reshape(nb, ne)
        lens = topo[-nb * ne - nb:-nb * ne]
        e = np.concatenate([r[:n] for r, n in zip(ents, lens)])
        assert (e & ((1 << shift) - 1)).max() < nv * (nv + 1) // 2
        assert ((e >> shift) & 31).max() < na
        assert (e >> (shift + 10)).max() == 2
