"""The port's CUDA kernels (csrc/block_tridiag.cu, csrc/substep.cu) on the
card against their plain PyTorch versions, at small shapes, at the main
path's shapes and at a batch that is not a multiple of the thread block
(the ragged edge). Tolerance: max |kernel - plain| / max |plain| <= 1e-4
(fp32; the two sum in different orders, nvcc contracts into FMA, and the
block-tridiagonal kernels multiply by reciprocal pivots where the plain
versions divide).

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone (``--noconftest`` skips tests/conftest.py,
which sets JAX up):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

Without a card every test skips (the kernels have no CPU mode). The SPD
system builders here are shared with the CPU parity tests.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

SMALL = [(8, 12, 5), (16, 51, 5), (4, 6, 3)]


def make_systems(B, S, b, R=1, seed=0):
    """numpy SPD block-tridiagonal systems: D = A A^T + (2+b) I."""
    rng = np.random.default_rng(seed)
    L = (rng.normal(size=(B, S - 1, b, b)) * 0.3).astype(np.float32)
    A = rng.normal(size=(B, S, b, b)).astype(np.float32)
    D = (np.einsum("bsij,bskj->bsik", A, A)
         + (2.0 + b) * np.eye(b, dtype=np.float32)).astype(np.float32)
    rhs = rng.normal(size=(B, S, b, R)).astype(np.float32)
    return D, L, rhs


def entry_lists(D, L, conv):
    b = D.shape[-1]
    return ([[conv(D[:, :, i, j]) for j in range(b)] for i in range(b)],
            [[conv(L[:, :, i, j]) for j in range(b)] for i in range(b)])


def special_entries(B, S, b, R=1, seed=0, device="cpu"):
    """Entry lists in the shapes the staged solver hands over, with every
    case the entry table must read: a structural zero (0.0) in D, L and
    the right-hand side, one tensor shared between D[1][0] and D[0][1], a
    D entry expanded along the batch and an L entry expanded along the
    stages (stride 0). Returns (D_full, L_full, rhs) and the dense numpy
    system (D, L, rhs) they stand for."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, S, b, b)).astype(np.float32)
    D = (0.2 * np.einsum("bsij,bskj->bsik", A, A)
         + (2.0 + b) * np.eye(b, dtype=np.float32)).astype(np.float32)
    L = (rng.normal(size=(B, S - 1, b, b)) * 0.3).astype(np.float32)
    rhs = rng.normal(size=(B, S, b, R)).astype(np.float32)
    D[:, :, 2, 0] = D[:, :, 0, 2] = 0.0          # structural zero
    D[:, :, 3, 3] = D[:1, :, 3, 3]               # expanded along the batch
    L[:, :, 0, 1] = 0.0                          # structural zeros
    L[:, :, 2, 2] = 0.0
    L[:, :, 1, 0] = L[:, :1, 1, 0]               # expanded along the stages
    rhs[:, :, 1] = 0.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    D_full = [[t(D[:, :, i, j]) for j in range(b)] for i in range(b)]
    D_full[0][1] = D_full[1][0]
    D_full[2][0] = D_full[0][2] = 0.0
    D_full[3][3] = t(D[:1, :, 3, 3]).expand(B, S)
    L_full = [[t(L[:, :, i, j]) for j in range(b)] for i in range(b)]
    L_full[0][1] = L_full[2][2] = 0.0
    L_full[1][0] = t(L[:, :1, 1, 0])             # broadcasts to (B, S-1)
    if R == 1:
        r = [t(rhs[:, :, i, 0]) for i in range(b)]
    else:
        r = [t(rhs[:, :, i, :]) for i in range(b)]
    r[1] = 0.0
    return (D_full, L_full, r), (D, L, rhs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,b", SMALL + [(2048, 51, 5), (1000, 51, 5),
                                     (1024, 201, 5), (100, 201, 10)])
def test_bt_solve_matches_plain_on_card(card, B, S, b):
    """bt_solve through the entry-form and the array-form wrappers."""
    D, L, rhs = make_systems(B, S, b, seed=B)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    r = [torch.as_tensor(rhs[:, :, i, 0], device=card) for i in range(b)]
    x = torch.stack(btk.block_tridiag_solve_entries(Dt, Lt, r, b), -1)
    x_pl = torch.stack(btk.block_tridiag_solve_entries_plain(Dt, Lt, r, b),
                       -1)
    assert rel(x, x_pl) <= 1e-4
    xb = btk.block_tridiag_solve(torch.as_tensor(D, device=card),
                                 torch.as_tensor(L, device=card),
                                 torch.as_tensor(rhs[..., 0], device=card))
    assert rel(xb, x_pl) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,b,R", [(8, 12, 5, 7), (1024, 51, 5, 50),
                                     (2048, 51, 5, 51), (1000, 51, 5, 3),
                                     (40, 400, 8, 3)])
def test_bt_factor_msolve_match_plain_on_card(card, B, S, b, R):
    """bt_factor + bt_msolve through the multi-RHS wrapper (the last case:
    a long horizon at the largest block, where one scenario's rows take
    most of a block's shared memory)."""
    D, L, rhs = make_systems(B, S, b, R, seed=B + R)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    cols = [torch.as_tensor(rhs[:, :, i, :], device=card) for i in range(b)]
    x = torch.stack(btk.block_tridiag_multirhs_entries(Dt, Lt, cols, b))
    x_pl = torch.stack(
        btk.block_tridiag_multirhs_entries_plain(Dt, Lt, cols, b))
    assert rel(x, x_pl) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b", btk.SUPPORTED_B)
@pytest.mark.parametrize("B", [2048, 1000])
def test_bt_solve_every_block_size_on_card(card, b, B):
    """bt_solve at S=51 for every instantiated block size, at the l1 batch
    and a ragged one, through both wrappers."""
    test_bt_solve_matches_plain_on_card(card, B, 51, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b", btk.SUPPORTED_B)
@pytest.mark.parametrize("B", [1024, 1000])
def test_bt_msolve_every_block_size_on_card(card, b, B):
    """bt_factor + bt_msolve at S=51, R=50 for every instantiated block
    size, at the NN batch and a ragged one."""
    test_bt_factor_msolve_match_plain_on_card(card, B, 51, b, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12, 51])
@pytest.mark.parametrize("B", [1024, 1000, 2048])
@pytest.mark.parametrize("b", btk.SUPPORTED_B)
def test_bt_factor_records_match_plain_on_card(card, b, B, S):
    """bt_factor alone, entries read in place: its (B, S, REC) stage
    records (factor, L_k, 1 / c_jj, zero padding) against the plain
    version's, and the factor part against ``_factor_plain`` directly."""
    D, L, _ = make_systems(B, S, b, seed=B + S + b)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    cols = [torch.zeros(B, S, 1, device=card)] * b
    fargs, rec, _, _ = btk.prepare_multirhs_entries(Dt, Lt, cols, b)
    btk.reset_launches()
    btk._launch_factor(fargs, S, B, b, card)
    ref = btk.factor_records_plain(Dt, Lt, b, B, S)
    chol = torch.stack(btk._factor_plain(torch.as_tensor(D, device=card),
                                         torch.as_tensor(L, device=card)), 1)
    il, jl = torch.tril_indices(b, b, device=card)
    torch.cuda.synchronize()
    assert btk.launches()["bt_factor"] == 1
    assert rel(rec, ref) <= 1e-4
    assert rel(rec[..., :b * (b + 1) // 2], chol[:, :, il, jl]) <= 1e-4
    nlp, bbp, bp, rec_n = btk.record_layout(b)
    pad = torch.ones(rec_n, dtype=torch.bool, device=card)
    pad[:b * (b + 1) // 2] = pad[nlp:nlp + b * b] = False
    pad[nlp + bbp:nlp + bbp + b] = False
    assert not bool(rec[..., pad].any())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 5, 8, 10])
def test_bt_factor_entry_table_cases_on_card(card, b):
    """bt_factor's records from entry lists with structural zeros (null
    pointers), a tensor shared between D[1][0] and D[0][1], and entries
    expanded along the batch and along the stages (stride 0), against the
    plain version of the dense system."""
    B, S = 1000, 51
    (Df, Lf, r), (D, L, _) = special_entries(B, S, b, 3, seed=b,
                                             device=card)
    fargs, rec, _, _ = btk.prepare_multirhs_entries(Df, Lf, r, b)
    btk._launch_factor(fargs, S, B, b, card)
    Dd, Ld = (torch.as_tensor(a, device=card) for a in (D, L))
    chol = torch.stack(btk._factor_plain(Dd, Ld), 1)
    il, jl = torch.tril_indices(b, b, device=card)
    nlp = btk.record_layout(b)[0]
    torch.cuda.synchronize()
    assert rel(rec[..., :b * (b + 1) // 2], chol[:, :, il, jl]) <= 1e-4
    assert torch.equal(rec[:, :S - 1, nlp:nlp + b * b],
                       Ld.reshape(B, S - 1, b * b))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 50])
def test_entry_table_cases_on_card(card, R):
    """Structural zeros (null pointers), a tensor shared between D[1][0]
    and D[0][1], stride-0 entries, and the array form with non-contiguous
    strides: the kernels against the plain version of the dense system."""
    entry_table_cases(card, 5, R)


def entry_table_cases(card, b, R):
    B, S = 300, 51
    (Df, Lf, r), (D, L, rhs) = special_entries(B, S, b, R, seed=R,
                                               device=card)
    Dd, Ld, rd = (torch.as_tensor(a, device=card) for a in (D, L, rhs))
    ref = btk._substitute_plain(btk._factor_plain(Dd, Ld), Ld, rd)
    if R == 1:
        x = torch.stack(btk.block_tridiag_solve_entries(Df, Lf, r, b), -1)
        assert rel(x, ref[..., 0]) <= 1e-4
        # array form: D with column-major blocks, L a slice of a wider
        # tensor
        Dt = Dd.transpose(-1, -2).contiguous().transpose(-1, -2)
        Lw = torch.zeros(B, S - 1, b, b + 2, device=card)
        Lw[..., :b] = Ld
        xb = btk.block_tridiag_solve(Dt, Lw[..., :b], rd[..., 0])
        assert rel(xb, ref[..., 0]) <= 1e-4
    else:
        x = torch.stack(btk.block_tridiag_multirhs_entries(Df, Lf, r, b), 2)
        assert rel(x, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 50])
def test_entry_table_cases_b10_on_card(card, R):
    """The entry-table cases at b=10, where the streamed kernels copy each
    entry 4 bytes at a time: null pointers, a shared tensor, stride-0
    entries and the array form's strides."""
    entry_table_cases(card, 10, R)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1000, 2047])
def test_b10_ragged_batches_on_card(card, B):
    """b=10 at S=51 on batches that leave the last block's second team
    without a scenario (1, 2047) or fill it (1000): bt_solve through both
    wrappers, bt_factor's records, bt_factor + bt_msolve."""
    test_bt_solve_matches_plain_on_card(card, B, 51, 10)
    test_bt_factor_records_match_plain_on_card(card, 10, B, 51)
    test_bt_factor_msolve_match_plain_on_card(card, B, 51, 10, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 2048])
def test_b10_long_horizon_on_card(card, B):
    """b=10 at S=201, where the rows of one scenario no longer fit the
    team kernels' layout: bt_solve, bt_factor's records, bt_factor +
    bt_msolve."""
    test_bt_solve_matches_plain_on_card(card, B, 201, 10)
    test_bt_factor_records_match_plain_on_card(card, 10, B, 201)
    test_bt_factor_msolve_match_plain_on_card(card, B, 201, 10, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2047, 1024])
def test_b10_ring_kernels_repeat_bit_for_bit_on_card(card, B):
    """The cp.async ring kernels at b=10 (``bt_solve_kernel_wide``,
    ``bt_factor_kernel_wide``, ``bt_msolve_kernel_wide``; S=51, R=50),
    launched 8 times on the same inputs into outputs set to NaN before
    each launch, on a ragged batch (2047: the last block's second team
    repeats scenario 2046) and a full one: every launch's x, records and
    multi-RHS x equal the first launch's bit for bit (a read racing a
    refill of a ring would differ from launch to launch), and the first
    is within 1e-4 of the plain versions."""
    S, b, R = 51, 10, 50
    D, L, rhs = make_systems(B, S, b, R, seed=B + 3)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    r = [torch.as_tensor(rhs[:, :, i, 0], device=card) for i in range(b)]
    cols = [torch.as_tensor(rhs[:, :, i, :], device=card) for i in range(b)]
    args, x = btk.prepare_solve_entries(Dt, Lt, r, b)
    fargs, recs, rargs, xo = btk.prepare_multirhs_entries(Dt, Lt, cols, b)
    first = None
    for _ in range(8):
        for t in (x, recs, xo):
            t.fill_(float("nan"))
        btk._launch_solve(args, S, B, b, card)
        btk._launch_factor(fargs, S, B, b, card)
        btk._launch_msolve(recs, rargs, xo, S, B, R, b, card)
        got = [t.clone() for t in (x, recs, xo)]
        if first is None:
            first = got
        for g, f, name in zip(got, first, ("x", "records", "multi-RHS x")):
            assert torch.equal(g, f), name
    x_pl = torch.stack(btk.block_tridiag_solve_entries_plain(Dt, Lt, r, b))
    xo_pl = torch.stack(
        btk.block_tridiag_multirhs_entries_plain(Dt, Lt, cols, b))
    rec_pl = btk.factor_records_plain(Dt, Lt, b, B, S)
    assert rel(first[0], x_pl) <= 1e-4
    assert rel(first[1], rec_pl) <= 1e-4
    assert rel(first[2], xo_pl) <= 1e-4


@pytest.mark.cuda
def test_b10_nan_pivot_stays_nan_on_card(card):
    """A NaN on one scenario's diagonal at stage 20 stays NaN: that
    scenario's x and its records from stage 20 on are NaN as the plain
    version's are, its teammate in the warp and every other scenario stay
    finite and within 1e-4 of the plain version."""
    B, S, b = 64, 51, 10
    D, L, rhs = make_systems(B, S, b, R=3, seed=5)
    D[5, 20, 3, 3] = np.nan
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    r = [torch.as_tensor(rhs[:, :, i, 0], device=card) for i in range(b)]
    x = torch.stack(btk.block_tridiag_solve_entries(Dt, Lt, r, b))
    x_pl = torch.stack(btk.block_tridiag_solve_entries_plain(Dt, Lt, r, b))
    cols = [torch.as_tensor(rhs[:, :, i, :], device=card) for i in range(b)]
    fargs, rec, _, _ = btk.prepare_multirhs_entries(Dt, Lt, cols, b)
    btk._launch_factor(fargs, S, B, b, card)
    rec_pl = btk.factor_records_plain(Dt, Lt, b, B, S)
    torch.cuda.synchronize()
    nl = b * (b + 1) // 2
    for got, ref in ((x, x_pl), (rec[..., :nl], rec_pl[..., :nl])):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert bool(torch.isnan(x[:, 5]).all())
    assert bool(torch.isnan(rec[5, 20:, :nl]).any(-1).all())
    ok = torch.ones(B, dtype=torch.bool, device=card)
    ok[5] = False
    assert bool(torch.isfinite(x[:, ok]).all())
    assert rel(x[:, ok], x_pl[:, ok]) <= 1e-4
    assert rel(rec[ok], rec_pl[ok]) <= 1e-4


@pytest.mark.cuda
def test_b10_launch_shape_on_card(card):
    """At b=10 a scenario takes the same shared memory at S=51 as at
    S=201 (the stages stream), a team is 16 lanes, and the blocks the card
    keeps resident hold B=2048 scenarios in one wave; the team kernels'
    shape says 8 lanes a scenario."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for kernel in ("bt_solve", "bt_factor"):
        short, long_ = (btk.launch_shape(kernel, S, 10) for S in (51, 201))
        for sh in (short, long_):
            assert sh["smem_bytes"] > 0 and sh["threads"] == 16 * sh["teams"]
        assert (short["smem_bytes"] / short["teams"]
                == long_["smem_bytes"] / long_["teams"])
        blocks = -(-2048 // short["teams"])
        assert blocks <= short["blocks_per_sm"] * sms, (short, sms)
        team = btk.launch_shape(kernel, 51, 5)
        assert team["threads"] == 8 * team["teams"]
        assert team["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_kernels_raise_on_card(card):
    """No fallback on the card: an unsupported block size, a float64 entry
    or an entry on another device raises."""
    D, L, rhs = make_systems(16, 6, 5, seed=2)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    r = [torch.as_tensor(rhs[:, :, i, 0], device=card) for i in range(5)]
    with pytest.raises(TypeError):
        btk.block_tridiag_solve_entries(Dt, Lt, r[:4] + [r[4].double()], 5)
    with pytest.raises(TypeError):
        btk.block_tridiag_solve_entries(Dt, Lt, r[:4] + [r[4].cpu()], 5)
    with pytest.raises(ValueError, match="block size"):
        btk.block_tridiag_solve_entries(Dt, Lt, r, 9)


@pytest.mark.cuda
def test_launch_counts(card):
    """Each wrapper call adds one launch to the kernels it runs, and the
    plain versions add none."""
    D, L, rhs = make_systems(64, 6, 5, 3, seed=1)
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    cols = [torch.as_tensor(rhs[:, :, i, :], device=card) for i in range(5)]
    btk.reset_launches()
    btk.block_tridiag_solve_entries(Dt, Lt, [c[:, :, 0] for c in cols], 5)
    btk.block_tridiag_multirhs_entries(Dt, Lt, cols, 5)
    btk.block_tridiag_multirhs_entries_plain(Dt, Lt, cols, 5)
    torch.cuda.synchronize()
    assert btk.launches() == {"bt_solve": 1, "bt_factor": 1, "bt_msolve": 1}


def robot_cases():
    """tests/torch_robot_cases.py loaded by path (another installed package
    may own the name ``tests``)."""
    name = "torch_robot_cases"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).resolve().parent / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["quadruped", "hopper4", "hopper"])
@pytest.mark.parametrize("B,dr", [(4096, True), (1000, False), (5, True)])
def test_substep_matches_plain_on_card(card, robot, B, dr):
    """K3 against its plain version on both test robots, with and without
    per-env DR rows, at the rollout's width and ragged widths."""
    rc = robot_cases()
    inp = rc.substep_inputs(robot, B, seed=B, dr=dr)
    sim = rc.torch_sim(robot, card, inp)
    st, tau = rc.torch_state(inp, card)
    sk.reset_launches()
    out = sk.substep(sim, st, tau)
    ref = sk.substep_plain(sim, st, tau)
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 1, "substep_sharded": 0}
    for name in ("base_pos", "base_quat", "q", "v"):
        assert rel(getattr(out, name), getattr(ref, name)) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["quadruped", "hopper"])
def test_plain_route_launches_no_substep_kernel_on_card(card, robot):
    """``use_pallas_substep=False`` takes the plain version on the card:
    no launch of K3 or of the shard kernel, whole or under a 2-shard mesh
    of the card, and the step of ``substep_plain``; ``True`` launches K3
    once."""
    from legged_gym_dev_tpu_torch.parallel.mesh import make_mesh

    rc = robot_cases()
    inp = rc.substep_inputs(robot, 1000, seed=3, dr=True)
    sim = rc.torch_sim(robot, card, inp).replace(use_pallas_substep=False)
    st, tau = rc.torch_state(inp, card)
    mesh = make_mesh(2, devices=[card, card])
    ref = sk.substep_plain(sim, st, tau)
    sk.reset_launches()
    out = sim.substep(st, tau)
    out_mesh = sim.replace(shard_mesh=(mesh, "dp")).substep(st, tau)
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 0, "substep_sharded": 0}
    for name in ("base_pos", "base_quat", "q", "v"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
        assert rel(getattr(out_mesh, name), getattr(ref, name)) <= 1e-5, name
    out_k = sim.replace(use_pallas_substep=True).substep(st, tau)
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 1, "substep_sharded": 0}
    for name in ("base_pos", "base_quat", "q", "v"):
        assert rel(getattr(out_k, name), getattr(ref, name)) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("form", ["scalar", "per_sphere", "B1", "B11",
                                  "Bnc"])
@pytest.mark.parametrize("robot", ["quadruped", "hopper4", "hopper"])
def test_substep_views_and_dr_forms_on_card(card, robot, form, payload):
    """K3 reading its inputs in place: the state handed as strided views
    (rows of one (n, B) tensor, a quaternion broadcast over the envs) and
    the contact parameters in each broadcast form, with and without a base
    payload mass, against the plain version on the same values."""
    rc = robot_cases()
    B = 1000
    inp = rc.substep_inputs(robot, B, seed=len(form) + 3 * payload)
    sim, plain_sim = rc.dr_form_sims(rc.torch_sim(robot, card), form, B,
                                     payload, seed=11)
    st, tau = rc.torch_state(inp, card)
    views = rc.strided_state(st)
    out = sk.substep(sim, views, tau)
    ref = sk.substep_plain(plain_sim, st, tau)
    torch.cuda.synchronize()
    for name in ("base_pos", "base_quat", "q", "v"):
        got = getattr(out, name)
        assert got.is_contiguous() and bool(torch.isfinite(got).all())
        assert rel(got, getattr(ref, name)) <= 1e-4, name


@pytest.mark.cuda
def test_substep_keeps_nan_on_card(card):
    """A NaN env stays NaN through the kernel (clamps and the contact
    force keep it), and the other envs stay finite."""
    rc = robot_cases()
    inp = rc.substep_inputs("quadruped", 64, seed=0, dr=True)
    inp["v"][5, 9] = np.nan
    sim = rc.torch_sim("quadruped", card, inp)
    out = sk.substep(sim, *rc.torch_state(inp, card))
    finite = torch.isfinite(out.v).all(-1).cpu()
    assert not bool(finite[5]) and int(finite.sum()) == 63


@pytest.mark.cuda
@pytest.mark.parametrize("nj", range(1, sk.MAX_NJ + 1))
def test_substep_every_joint_count_on_card(card, nj):
    """K3 at every joint count it is built for, each instance built at
    first use, on the synthetic chain of that many joints
    (``torch_robot_cases.chain_urdf``), with per-env DR rows, at a ragged
    batch; one launch of that instance and no other."""
    rc = robot_cases()
    robot = f"chain{nj}"
    inp = rc.substep_inputs(robot, 1000, seed=nj, dr=True)
    sim = rc.torch_sim(robot, card, inp)
    st, tau = rc.torch_state(inp, card)
    sk.reset_launches()
    out = sk.substep(sim, st, tau)
    ref = sk.substep_plain(sim, st, tau)
    torch.cuda.synchronize()
    assert sk.launches_by_nj() == {nj: 1}
    for name in ("base_pos", "base_quat", "q", "v"):
        got = getattr(out, name)
        assert bool(torch.isfinite(got).all())
        assert rel(got, getattr(ref, name)) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["a1", "cassie", "biped10"])
@pytest.mark.parametrize("B", [4096, 5])
def test_substep_robot_presets_on_card(card, robot, B):
    """K3 on the A1 and Cassie stand-ins (nj=12, two and four subtrees of
    the base) and the 10-joint biped, with per-env DR rows."""
    rc = robot_cases()
    inp = rc.substep_inputs(robot, B, seed=B, dr=True)
    sim = rc.torch_sim(robot, card, inp)
    st, tau = rc.torch_state(inp, card)
    out = sk.substep(sim, st, tau)
    ref = sk.substep_plain(sim, st, tau)
    torch.cuda.synchronize()
    for name in ("base_pos", "base_quat", "q", "v"):
        assert rel(getattr(out, name), getattr(ref, name)) <= 1e-4, name


@pytest.mark.cuda
def test_substep_raises_on_card_outside_its_range(card):
    """25 joints: no instance, a ValueError before any build; a heightfield
    sim: the kernel raises (``RobotSim.substep`` sends it to the plain
    version)."""
    rc = robot_cases()
    from legged_gym_dev_tpu_torch.sim.contact import ContactParams
    from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel
    from legged_gym_dev_tpu_torch.sim.robot_sim import RobotSim
    from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf

    model = RobotModel.from_spec(parse_urdf(rc.chain_urdf(sk.MAX_NJ + 1)))
    sim = RobotSim.create(model, contact=ContactParams.create(device=card),
                          device=card)
    st = sim.default_state(4)
    tau = torch.zeros((4, model.nj), device=card)
    with pytest.raises(ValueError, match="joints"):
        sk.substep(sim, st, tau)
    inp = rc.substep_inputs("quadruped", 8, seed=0)
    rough = rc.torch_sim("quadruped", card).replace(
        terrain_fn=lambda xy: 0.1 * xy[..., 0])
    st, tau = rc.torch_state(inp, card)
    with pytest.raises(NotImplementedError):
        sk.substep(rough, st, tau)
    sk.reset_launches()
    out = rough.substep(st, tau)
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 0, "substep_sharded": 0}
    assert bool(torch.isfinite(out.v).all())


@pytest.mark.cuda
def test_play_exports_match_the_policy_on_card(card, tmp_path):
    """``cli play``'s exports loaded back on the card give the inference
    policy's actions (TorchScript, the ``torch.export`` program on a batch
    other than its trace's, and the stateful LSTM module over 10 calls)
    within 1e-5."""
    from legged_gym_dev_tpu_torch.rl.networks import (
        ActorCritic,
        ActorCriticRecurrent,
    )
    from legged_gym_dev_tpu_torch.utils import export
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    gen = torch.Generator().manual_seed(0)
    ff = ActorCritic(65, 12, generator=gen).to(card)
    obs = torch.randn(4096, 65, device=card)
    with torch.no_grad(), fp32_matmul():
        want = ff(obs)[0]
        ts = torch.jit.load(export.export_policy_torchscript(
            ff, str(tmp_path / "p.pt")), map_location=card)
        ep = export.load_policy_exported(export.export_policy_exported(
            ff, 65, str(tmp_path / "p.pt2")))
        for f in (ts, ep):
            assert float((f(obs) - want).abs().max()) <= 1e-5
        rec = ActorCriticRecurrent(38, 4, generator=gen).to(card)
        lstm = torch.jit.load(export.export_policy_lstm_torchscript(
            rec, str(tmp_path / "l.pt")), map_location=card)
        carry = rec.initial_carry(1)
        for i in range(10):
            x = obs[i:i + 1, :38]
            mean, _, _, carry = rec(x, carry)
            assert float((lstm(x) - mean).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_play_launches_the_substep_kernel_on_card(card, tmp_path):
    """``cli.play`` on the quadruped trajectory task (test robot, B=64):
    exactly steps x decimation K3 launches, finite signals."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs import task_registry

    rc = robot_cases()
    urdf = tmp_path / "quadruped.urdf"
    urdf.write_text(rc.QUADRUPED_URDF)
    env = task_registry.make_env("anymal_c_trajectory", urdf_path=str(urdf),
                                 num_envs=64, add_noise=False, device=card)
    runner = task_registry.make_alg_runner(env, "anymal_c_trajectory",
                                           log_root=str(tmp_path / "logs"))
    sk.reset_launches()
    out = cli.play(env, runner, 5, mat=str(tmp_path / "play.mat"))
    torch.cuda.synchronize()
    assert sum(sk.launches_by_nj().values()) == 5 * env.sim.decimation
    log = out["logger"].state_log
    assert len(log["dof_pos"]) == 5
    assert all(np.isfinite(np.stack(v)).all() for v in log.values())


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["quadruped", "hopper"])
def test_substep_sharded_on_card(card, robot):
    """K3s, the sharded route, on a 2-shard mesh of the card (the one card
    listed twice): one launch of the shard kernel per shard and none of
    K3, each on its shard's rows of the per-env DR values, within 1e-6 of
    one unsharded K3 launch (both work env by env in the same order, so
    it is 0)."""
    from legged_gym_dev_tpu_torch.parallel.mesh import gather, make_mesh

    rc = robot_cases()
    inp = rc.substep_inputs(robot, 4096, seed=11, dr=True)
    sim = rc.torch_sim(robot, card, inp)
    st, tau = rc.torch_state(inp, card)
    mesh = make_mesh(2, devices=[card, card])
    ref = sk.substep(sim, st, tau)
    sk.reset_launches()
    out = sk.substep_sharded(sim, st, tau, mesh, "dp")
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 0, "substep_sharded": 2}
    assert [s.base_pos.device for s in out] == list(mesh.devices.flat)
    got = gather(out)
    for name in ("base_pos", "base_quat", "q", "v"):
        assert rel(getattr(got, name), getattr(ref, name)) <= 1e-6, name
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


FIELDS = ("base_pos", "base_quat", "q", "v")


def shard_against_k3(sim, st, tau, plain_sim=None, plain_state=None):
    """The shard kernel and K3 on the same inputs: one launch each, outputs
    equal bit for bit (NaN where K3 has NaN), finite where K3 is, and
    within 1e-4 of the plain version on the finite envs."""
    sk.reset_launches()
    out = sk.substep_shard(sim, st, tau)
    k3 = sk.substep(sim, st, tau)
    ref = sk.substep_plain(sim if plain_sim is None else plain_sim,
                           st if plain_state is None else plain_state,
                           tau)
    torch.cuda.synchronize()
    assert sk.launches() == {"substep": 1, "substep_sharded": 1}
    for name in FIELDS:
        got, want = getattr(out, name), getattr(k3, name)
        assert got.is_contiguous()
        assert torch.equal(got.isnan(), want.isnan()), name
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), name
        ok = torch.isfinite(want).all(-1)
        assert rel(got[ok], getattr(ref, name)[ok]) <= 1e-4, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nj", range(1, sk.MAX_NJ + 1))
def test_substep_shard_equals_k3_every_joint_count_on_card(card, nj):
    """The shard kernel at every joint count, on the chain of that many
    joints with per-env DR rows at a ragged batch: K3's outputs bit for
    bit."""
    rc = robot_cases()
    inp = rc.substep_inputs(f"chain{nj}", 1000, seed=nj, dr=True)
    sim = rc.torch_sim(f"chain{nj}", card, inp)
    shard_against_k3(sim, *rc.torch_state(inp, card))


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["quadruped", "hopper4", "hopper",
                                   "biped10"])
@pytest.mark.parametrize("B", [1, 1000, 1023, 1024, 4096])
def test_substep_shard_equals_k3_on_card(card, robot, B):
    """The shard kernel on the test robots (biped10: the Adam stand-in's
    nj=10) with per-env DR rows, at the mesh's shard batch (1024), the
    whole batch and ragged batches: K3's outputs bit for bit."""
    rc = robot_cases()
    inp = rc.substep_inputs(robot, B, seed=B + 1, dr=True)
    sim = rc.torch_sim(robot, card, inp)
    shard_against_k3(sim, *rc.torch_state(inp, card))


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("form", ["scalar", "per_sphere", "B1", "B11",
                                  "Bnc"])
@pytest.mark.parametrize("robot", ["quadruped", "hopper4", "biped10"])
def test_substep_shard_views_and_dr_forms_on_card(card, robot, form,
                                                  payload):
    """The shard kernel reading strided state views and each DR broadcast
    form in place, with and without a base payload mass: K3's outputs on
    the same views bit for bit."""
    rc = robot_cases()
    B = 1000
    inp = rc.substep_inputs(robot, B, seed=len(form) + 3 * payload)
    sim, plain_sim = rc.dr_form_sims(rc.torch_sim(robot, card), form, B,
                                     payload, seed=11)
    st, tau = rc.torch_state(inp, card)
    shard_against_k3(sim, rc.strided_state(st), tau, plain_sim, st)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["quadruped", "hopper4", "biped10"])
def test_substep_shard_keeps_nan_on_card(card, robot):
    """A NaN env stays NaN through the shard kernel, as through K3, and
    the other envs stay finite."""
    rc = robot_cases()
    inp = rc.substep_inputs(robot, 1024, seed=0, dr=True)
    inp["v"][5, 6] = np.nan
    sim = rc.torch_sim(robot, card, inp)
    out = shard_against_k3(sim, *rc.torch_state(inp, card))
    finite = torch.isfinite(out.v).all(-1).cpu()
    assert not bool(finite[5]) and int(finite.sum()) == 1023


# ---------------------------------------------------------------------------
# K2s at b=10: bt_msolve_kernel_wide (what bt_msolve launches there)
# ---------------------------------------------------------------------------

def msolve_b10(card, B, S, R, seed, nan_at=None):
    """bt_factor + bt_msolve at b=10 through the multi-RHS wrapper and the
    plain version on the same systems: (x, x_plain), each (b, B, S, R)."""
    D, L, rhs = make_systems(B, S, 10, R, seed=seed)
    if nan_at is not None:
        D[nan_at] = np.nan
    Dt, Lt = entry_lists(D, L, lambda a: torch.as_tensor(a, device=card))
    cols = [torch.as_tensor(rhs[:, :, i, :], device=card) for i in range(10)]
    btk.reset_launches()
    x = torch.stack(btk.block_tridiag_multirhs_entries(Dt, Lt, cols, 10))
    x_pl = torch.stack(
        btk.block_tridiag_multirhs_entries_plain(Dt, Lt, cols, 10))
    torch.cuda.synchronize()
    assert btk.launches_by_b()["bt_msolve"] == {10: 1}
    return x, x_pl


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,B", [(12, 1, 64), (12, 300, 16), (51, 7, 64),
                                   (51, 50, 100), (400, 1, 16),
                                   (400, 7, 16), (400, 300, 4)])
def test_bt_msolve_wide_horizons_and_columns_on_card(card, S, R, B):
    """bt_msolve_kernel_wide at short, the main path's and long horizons
    (its ring streams any S), one to more than a block's 256 columns:
    within 1e-4 of the plain version."""
    x, x_pl = msolve_b10(card, B, S, R, seed=S + R)
    assert rel(x, x_pl) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1000, 1024, 2048])
def test_bt_msolve_wide_batches_on_card(card, B):
    """bt_msolve_kernel_wide at S=51, R=50 on batches that fill the last
    block of 5 scenarios or leave it partly empty: within 1e-4 of the
    plain version."""
    x, x_pl = msolve_b10(card, B, 51, 50, seed=B)
    assert rel(x, x_pl) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("R", [7, 300])
def test_bt_msolve_wide_structural_zero_columns_on_card(card, R):
    """Structural-zero right-hand-side columns (null pointers), shared and
    stride-0 entries at b=10 through bt_msolve_kernel_wide, against the
    plain version of the dense system."""
    entry_table_cases(card, 10, R)


@pytest.mark.cuda
def test_bt_msolve_wide_nan_pivot_stays_nan_on_card(card):
    """A NaN on one scenario's diagonal at stage 20 makes that scenario's
    multi-RHS solution NaN wherever the plain version's is, and leaves the
    other scenarios, its neighbours in the block included, finite and
    within 1e-4 of the plain version."""
    B = 12
    x, x_pl = msolve_b10(card, B, 51, 50, seed=9, nan_at=(5, 20, 3, 3))
    assert torch.equal(torch.isnan(x), torch.isnan(x_pl))
    assert bool(torch.isnan(x[:, 5]).any())
    ok = torch.ones(B, dtype=torch.bool, device=card)
    ok[5] = False
    assert bool(torch.isfinite(x[:, ok]).all())
    assert rel(x[:, ok], x_pl[:, ok]) <= 1e-4


@pytest.mark.cuda
def test_bt_msolve_wide_launch_shape_on_card(card):
    """At b=10 bt_msolve streams a ring of records a scenario and a ring of
    values a column (8 stage slots each): the same shared memory at S=51
    and S=201, R=50 columns a scenario and 2 scenarios a block (2 when the
    columns are few), and enough resident blocks that B=1024 runs in one
    wave; at b=5 it keeps a scenario's S records."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    short, long_ = (btk.launch_shape("bt_msolve", S, 10, R=50)
                    for S in (51, 201))
    assert short == long_
    assert (short["RC"], short["teams"], short["threads"]) == (50, 2, 100)
    assert short["smem_bytes"] == (2 * 1360 + 8 * 10 * 100) * 4
    assert -(-1024 // short["teams"]) <= short["blocks_per_sm"] * sms, short
    few = btk.launch_shape("bt_msolve", 51, 10, R=7)
    assert (few["RC"], few["teams"]) == (7, 2)
    team = btk.launch_shape("bt_msolve", 51, 5, R=50)
    assert team["smem_bytes"] == (team["teams"] * 51
                                  * btk.record_layout(5)[3] * 4)
    assert team["blocks_per_sm"] >= 1
