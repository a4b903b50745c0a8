"""Batched SPD block-tridiagonal solves: CUDA kernels and plain versions.

Counterpart of ``legged_gym_dev_tpu/ops/pallas_block_tridiag.py``. The
system per scenario has diagonal blocks ``D_k`` (b x b, symmetric) and
sub-diagonal blocks ``L_k`` coupling stage k+1 (rows) to stage k (columns);
it is solved by the block-Thomas recursion: Cholesky factors of the Schur
complements ``S_k = D_k - L_k S_{k-1}^{-1} L_k^T`` (pivots floored at
1e-12), then forward and backward substitution.

Wrappers keep the JAX package's public layouts:

- ``block_tridiag_solve_entries``: entry lists of (B, S) tensors, one
  right-hand side (kernel ``bt_solve``; the TPU's ``_bt_kernel``).
- ``block_tridiag_solve``: array form (B, S, b, b); a second wrapper over
  the same ``bt_solve`` kernel.
- ``block_tridiag_multirhs_entries``: entry lists with (B, S, R) right-hand
  sides; factor once (kernel ``bt_factor``, which writes one record per
  stage: packed factor, L_k, 1 / c_jj), then substitute R columns against
  the records (kernel ``bt_msolve``).

An entry is a float32 tensor broadcastable to its (B, T) shape (an
expanded view is read in place, stride 0), or the float ``0.0``, the
solver's structural zero. The kernels read ``bt_solve``'s and
``bt_factor``'s entries and ``bt_msolve``'s right-hand-side columns in
place, through a table of (pointer, batch stride, stage stride) that goes
to the kernel by value in its launch parameters (a null pointer reads as
0). Only the lower triangle of D is read, so an entry shared between
D[i][j] and D[j][i] is read once.

On CUDA tensors a wrapper launches its kernel (``csrc/block_tridiag.cu``,
built at first use) or raises; on CPU tensors, and only there, it runs the
plain PyTorch version beside it. Each kernel counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# block sizes the CUDA source instantiates: the ROM zoo's staged layouts
# b = n + 1 + m (5, 6, 7, 8, 10), and 3, 4
SUPPORTED_B = (3, 4, 5, 6, 7, 8, 10)
TEAM = 8        # kTeam: above it bt_solve and bt_factor stream the stages
MAX_B = 10                         # kMaxB of the CUDA source
MAX_FACTOR_ENTRIES = 55 + 100     # kMaxFactorEntries: bt_factor's table
MAX_ENTRIES = MAX_FACTOR_ENTRIES + MAX_B   # kMaxEntries: bt_solve's table
_F32 = torch.float32


SOURCE = "block_tridiag.cu"
BT_SOLVE = _build.Kernel(SOURCE, "bt_solve", n_ptr=1, n_int=3)
BT_FACTOR = _build.Kernel(SOURCE, "bt_factor", n_ptr=1, n_int=3)
BT_MSOLVE = _build.Kernel(SOURCE, "bt_msolve", n_ptr=3, n_int=4)
KERNELS = {"bt_solve": BT_SOLVE, "bt_factor": BT_FACTOR,
           "bt_msolve": BT_MSOLVE}


# launches per (kernel, block size), beside each kernel's total
_BY_B: dict = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
    _BY_B.clear()


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def launches_by_b() -> dict:
    """{kernel: {b: launches}} since the last ``reset_launches``."""
    out = {name: {} for name in KERNELS}
    for (name, b), n in sorted(_BY_B.items()):
        out[name][b] = n
    return out


def _count(kernel: "_build.Kernel", b: int) -> None:
    _BY_B[kernel.symbol, b] = _BY_B.get((kernel.symbol, b), 0) + 1


# ---------------------------------------------------------------------------
# plain PyTorch versions: block-Thomas over (B, b, b) blocks
# ---------------------------------------------------------------------------

def _bmm(A, Bm):
    """Exact-fp32 small-block product (no TF32 whatever the global flags)."""
    return (A.unsqueeze(-1) * Bm.unsqueeze(-3)).sum(-2)


def _chol_plain(M):
    """Lower Cholesky of (B, b, b) blocks (lower triangle read), column by
    column with pivots floored at 1e-12, as the kernels do."""
    b = M.shape[-1]
    c = torch.zeros_like(M)
    for j in range(b):
        acc = M[:, j:, j]
        for k in range(j):
            acc = acc - c[:, j:, k] * c[:, j:j + 1, k]
        d = torch.sqrt(torch.clamp_min(acc[:, :1], 1e-12))
        c[:, j:, j] = acc * (1.0 / d)
    return c


def _cho_solve_plain(c, r):
    """Solves (c c^T) x = r for (B, b, b) lower c and (B, b, R) r."""
    b = c.shape[-1]
    y = [None] * b
    for i in range(b):
        acc = r[:, i]
        for k in range(i):
            acc = acc - c[:, i, k, None] * y[k]
        y[i] = acc / c[:, i, i, None]
    x = [None] * b
    for i in reversed(range(b)):
        acc = y[i]
        for k in range(i + 1, b):
            acc = acc - c[:, k, i, None] * x[k]
        x[i] = acc / c[:, i, i, None]
    return torch.stack(x, dim=1)


def _factor_plain(D, L):
    """Per-stage factors of D (B, S, b, b), L (B, S-1, b, b): list of S."""
    c = _chol_plain(D[:, 0])
    chol = [c]
    for k in range(1, D.shape[1]):
        Lk = L[:, k - 1]
        W = _cho_solve_plain(c, Lk.transpose(-1, -2))
        c = _chol_plain(D[:, k] - _bmm(Lk, W))
        chol.append(c)
    return chol


def _substitute_plain(chol, L, rhs):
    """Forward + backward substitution of rhs (B, S, b, R)."""
    S = rhs.shape[1]
    y = [_cho_solve_plain(chol[0], rhs[:, 0])]
    for k in range(1, S):
        y.append(_cho_solve_plain(chol[k],
                                  rhs[:, k] - _bmm(L[:, k - 1], y[k - 1])))
    x = [None] * S
    x[S - 1] = y[S - 1]
    for k in range(S - 2, -1, -1):
        r = _bmm(L[:, k].transpose(-1, -2), x[k + 1])
        x[k] = y[k] - _cho_solve_plain(chol[k], r)
    return torch.stack(x, dim=1)


def _is_zero(e) -> bool:
    """The solver's structural zero (a Python 0.0 in an entry list)."""
    return not isinstance(e, torch.Tensor) and e == 0.0


def _dense(e, shape, like):
    """Entry e as a tensor of ``shape`` (a view where it can be)."""
    if _is_zero(e):
        return like.new_zeros(()).expand(shape)
    if not isinstance(e, torch.Tensor):
        raise TypeError(f"an entry is a tensor or 0.0, not {e!r}")
    return e.expand(shape)


def _blocks(E, shape, like):
    """b x b nested list of entries -> (*shape, b, b)."""
    return torch.stack([torch.stack([_dense(e, shape, like) for e in row],
                                    dim=-1) for row in E], dim=-2)


def _full_lower(D_full, b):
    """D_full with its upper triangle taken from the lower one (the only
    triangle the kernels read)."""
    return [[D_full[max(i, j)][min(i, j)] for j in range(b)]
            for i in range(b)]


def _like(entries):
    """The first tensor of an entry list (fixes device, B and T)."""
    for e in entries:
        if isinstance(e, torch.Tensor):
            return e
    raise ValueError("an entry list of structural zeros only")


def block_tridiag_solve_entries_plain(D_full, L_full, rhs, b: int):
    like = _like(rhs)
    B, S = like.shape
    x = _substitute_plain(
        _factor_plain(_blocks(_full_lower(D_full, b), (B, S), like),
                      _blocks(L_full, (B, S - 1), like)),
        _blocks(L_full, (B, S - 1), like),
        torch.stack([_dense(r, (B, S), like) for r in rhs], dim=-1)[..., None])
    return list(x[..., 0].unbind(-1))


def block_tridiag_solve_plain(D, L, rhs):
    return _substitute_plain(_factor_plain(D, L), L, rhs[..., None])[..., 0]


def block_tridiag_multirhs_entries_plain(D_full, L_full, rhs_cols, b: int):
    like = _like(rhs_cols)
    B, S, R = like.shape
    Lb = _blocks(L_full, (B, S - 1), like)
    x = _substitute_plain(
        _factor_plain(_blocks(_full_lower(D_full, b), (B, S), like), Lb), Lb,
        torch.stack([_dense(r, (B, S, R), like) for r in rhs_cols], dim=2))
    return list(x.unbind(2))


def record_layout(b: int):
    """(NLp, BBp, Bp, REC) of ``Dim<b>`` in csrc/block_tridiag.cu: a stage
    record is the packed lower factor (NL floats, padded to NLp), then L_k
    row-major (b*b, padded to BBp), then 1 / c_jj (b, padded to Bp)."""
    def pad(n):
        return (n + 3) & ~3
    nlp, bbp, bp = pad(b * (b + 1) // 2), pad(b * b), pad(b)
    return nlp, bbp, bp, nlp + bbp + bp


def scratch_record(b: int) -> int:
    """Floats a stage and scenario of ``bt_solve``'s scratch above b =
    ``TEAM`` (``Ring<b>::SREC``): the factor, 1 / c_jj and y, each padded
    to whole float4s; 0 at and below it (no scratch)."""
    if b <= TEAM:
        return 0
    nlp, _, bp, _ = record_layout(b)
    return nlp + 2 * bp


def factor_records_plain(D_full, L_full, b: int, B: int, S: int):
    """``bt_factor``'s output from the plain version: (B, S, REC) stage
    records, zeros in the padding and in the last stage's L."""
    like = _like([e for row in D_full for e in row])
    nl = b * (b + 1) // 2
    nlp, bbp, _, rec_n = record_layout(b)
    Lb = _blocks(L_full, (B, S - 1), like)
    chol = torch.stack(_factor_plain(
        _blocks(_full_lower(D_full, b), (B, S), like), Lb), 1)
    il, jl = torch.tril_indices(b, b, device=like.device)
    rec = like.new_zeros((B, S, rec_n))
    rec[..., :nl] = chol[..., il, jl]
    rec[:, :S - 1, nlp:nlp + b * b] = Lb.reshape(B, S - 1, b * b)
    rec[..., nlp + bbp:nlp + bbp + b] = 1.0 / torch.diagonal(chol, 0, -2,
                                                             -1)
    return rec


# ---------------------------------------------------------------------------
# entry tables
# ---------------------------------------------------------------------------

class SolveArgs(ctypes.Structure):
    """``BtSolveCall`` of csrc/block_tridiag.cu: bt_solve's entry table
    (``BtSolveArgs``: D's lower triangle, L row-major, rhs), the output
    view, then the scratch records above b = ``TEAM`` (null below)."""
    _fields_ = [("ptr", ctypes.c_void_p * MAX_ENTRIES),
                ("sb", ctypes.c_int64 * MAX_ENTRIES),
                ("ss", ctypes.c_int64 * MAX_ENTRIES),
                ("out", ctypes.c_void_p),
                ("out_se", ctypes.c_int64),
                ("out_sb", ctypes.c_int64),
                ("out_ss", ctypes.c_int64),
                ("scratch", ctypes.c_void_p)]


class FactorArgs(ctypes.Structure):
    """``BtFactorArgs`` of csrc/block_tridiag.cu: bt_factor's entry table
    (D's lower triangle, L row-major) and its record output."""
    _fields_ = [("ptr", ctypes.c_void_p * MAX_FACTOR_ENTRIES),
                ("sb", ctypes.c_int64 * MAX_FACTOR_ENTRIES),
                ("ss", ctypes.c_int64 * MAX_FACTOR_ENTRIES),
                ("rec", ctypes.c_void_p)]


class RhsArgs(ctypes.Structure):
    """``BtRhsArgs`` of csrc/block_tridiag.cu: bt_msolve's b right-hand-side
    columns."""
    _fields_ = [("ptr", ctypes.c_void_p * MAX_B),
                ("sb", ctypes.c_int64 * MAX_B),
                ("ss", ctypes.c_int64 * MAX_B),
                ("sr", ctypes.c_int64 * MAX_B)]


def entry_views(entries, shape, device, out=None):
    """Appends to ``out`` (pointer, *strides) of each entry broadcast to
    ``shape``, in elements; all zeros for a structural zero. Raises for
    anything that is not a float32 tensor on ``device`` broadcastable to
    ``shape``. (It runs once for every entry of every launch, so it keeps
    to the fewest tensor queries.)"""
    out = [] if out is None else out
    zero = (0,) * (len(shape) + 1)
    for e in entries:
        if not isinstance(e, torch.Tensor):
            if e != 0.0:
                raise TypeError(f"an entry is a tensor or 0.0, not {e!r}")
            out.append(zero)
            continue
        if e.dtype is not _F32 or e.device != device:
            raise TypeError(f"expected float32 on {device}, got {e.dtype} "
                            f"on {e.device}")
        if e.shape != shape:
            try:
                e = e.expand(shape)
            except RuntimeError as err:
                raise ValueError(f"entry of shape {tuple(e.shape)} does not "
                                 f"broadcast to {tuple(shape)}") from err
        out.append((e.data_ptr(), *e.stride()))
    return out


def factor_entry_table(D_full, L_full, b: int, B: int, S: int, device):
    """bt_factor's table from entry lists: (pointer, batch stride, stage
    stride) for D's lower triangle (lo(i, j) = i (i + 1) / 2 + j), then L
    row-major."""
    out = entry_views([D_full[i][j] for i in range(b) for j in range(i + 1)],
                      torch.Size((B, S)), device)
    return entry_views([e for row in L_full[:b] for e in row[:b]],
                       torch.Size((B, S - 1)), device, out)


def solve_entry_table(D_full, L_full, rhs, b: int, B: int, S: int, device):
    """bt_solve's table from entry lists: bt_factor's, then rhs."""
    return entry_views(rhs[:b], torch.Size((B, S)), device,
                       factor_entry_table(D_full, L_full, b, B, S, device))


def _array_entries(A, pairs):
    """Table rows of a (B, T, b, b) or (B, T, b) tensor's (i, j) or (i,)
    entries: each is a strided view at an offset."""
    p, st = A.data_ptr(), A.stride()
    return [(p + 4 * sum(i * s for i, s in zip(ij, st[2:])), st[0], st[1])
            for ij in pairs]


def _solve_args(table, out: torch.Tensor, out_strides, b: int, B: int,
                S: int) -> SolveArgs:
    """The launch arguments; above b = ``TEAM`` with the (B, S,
    ``scratch_record(b)``) scratch, which lives as long as they do."""
    args = SolveArgs()
    n = len(table)
    args.ptr[:n], args.sb[:n], args.ss[:n] = zip(*table)
    args.out = out.data_ptr()
    args.out_se, args.out_sb, args.out_ss = out_strides
    if b > TEAM:
        args.scratch_tensor = torch.empty((B, S, scratch_record(b)),
                                          dtype=_F32, device=out.device)
        args.scratch = args.scratch_tensor.data_ptr()
    return args


def _factor_args(table, rec: torch.Tensor) -> FactorArgs:
    args = FactorArgs()
    n = len(table)
    args.ptr[:n], args.sb[:n], args.ss[:n] = zip(*table)
    args.rec = rec.data_ptr()
    return args


def launch_shape(kernel: str, S: int, b: int, R: int = 1) -> dict:
    """The launch shape the CUDA source picks at these shapes: scenarios
    a block, threads a block and shared memory a block in bytes (-1 if
    they do not fit on the current card), the kernel's blocks resident on
    a multiprocessor of the current card, and bt_solve's and bt_factor's
    entry stride ES (0 above b = ``TEAM``: the stages stream) or
    bt_msolve's columns a block RC (above b = ``TEAM`` its records stream
    through a ring of a few stages a scenario)."""
    lib = _build.load(SOURCE)
    x, y = ctypes.c_int(0), ctypes.c_int(0)
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    ref = ctypes.POINTER(ctypes.c_int)
    if kernel == "bt_msolve":
        fn = lib.bt_msolve_shape
        fn.argtypes = [ctypes.c_int] * 3 + [ref] * 3
        fn.restype = ctypes.c_int
        nbytes = fn(S, R, b, ctypes.byref(x), ctypes.byref(y),
                    ctypes.byref(blocks))
        return dict(teams=y.value, threads=y.value * x.value, RC=x.value,
                    smem_bytes=nbytes, blocks_per_sm=blocks.value)
    fn = lib.bt_team_shape
    fn.argtypes = [ctypes.c_int] * 3 + [ref] * 4
    fn.restype = ctypes.c_int
    nbytes = fn(S, b, int(kernel == "bt_factor"), ctypes.byref(x),
                ctypes.byref(y), ctypes.byref(threads), ctypes.byref(blocks))
    return dict(teams=x.value, threads=threads.value, ES=y.value,
                smem_bytes=nbytes, blocks_per_sm=blocks.value)


def _launch_solve(args: SolveArgs, S: int, B: int, b: int, device):
    """bt_solve on a prepared table; the output view is in ``args``."""
    BT_SOLVE([ctypes.addressof(args)], [S, B, b], device)
    _count(BT_SOLVE, b)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor, b: int) -> bool:
    """True for CUDA tensors (kernel), False for CPU ones (plain version);
    raises for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    if b not in SUPPORTED_B:
        raise ValueError(f"block size {b} is not one of {SUPPORTED_B}")
    return True


def _check(x: torch.Tensor, shape, device):
    if x.dtype != torch.float32 or x.device != device:
        raise TypeError(f"expected float32 on {device}, got {x.dtype} on "
                        f"{x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _ptr(t: torch.Tensor):
    return t.data_ptr() or None


def prepare_solve_entries(D_full, L_full, rhs, b: int):
    """bt_solve's launch arguments and output for the entry form: the
    table and x (b, B, S), which unbinds into the b (B, S) outputs."""
    like = _like(rhs)
    B, S = like.shape
    table = solve_entry_table(D_full, L_full, rhs, b, B, S, like.device)
    x = torch.empty((b, B, S), dtype=torch.float32, device=like.device)
    return _solve_args(table, x, (B * S, S, 1), b, B, S), x


def block_tridiag_solve_entries(D_full, L_full, rhs, b: int):
    """Batched solve from entry form (the staged solver's layout).

    D_full: b x b nested list of entries broadcastable to (B, S) (the
    kernel reads the lower triangle); L_full: b x b nested list of entries
    broadcastable to (B, S-1); rhs: list b of entries broadcastable to
    (B, S), the first tensor among them of shape (B, S). Returns list b of
    (B, S).
    """
    like = _like(rhs)
    if not _on_cuda(like, b):
        return block_tridiag_solve_entries_plain(D_full, L_full, rhs, b)
    B, S = like.shape
    args, x = prepare_solve_entries(D_full, L_full, rhs, b)
    _launch_solve(args, S, B, b, like.device)
    return list(x.unbind(0))


def block_tridiag_solve(D, L, rhs):
    """Batched solve from array form: D (B, S, b, b), L (B, S-1, b, b),
    rhs (B, S, b) -> x (B, S, b)."""
    B, S, b, _ = D.shape
    if not _on_cuda(rhs, b):
        return block_tridiag_solve_plain(D, L, rhs)
    _check(D, (B, S, b, b), rhs.device)
    _check(L, (B, S - 1, b, b), rhs.device)
    _check(rhs, (B, S, b), rhs.device)
    table = (_array_entries(D, [(i, j) for i in range(b)
                                for j in range(i + 1)])
             + _array_entries(L, [(i, j) for i in range(b)
                                  for j in range(b)])
             + _array_entries(rhs, [(i,) for i in range(b)]))
    x = torch.empty((B, S, b), dtype=torch.float32, device=rhs.device)
    _launch_solve(_solve_args(table, x, (1, S * b, b), b, B, S), S, B, b,
                  rhs.device)
    return x


def rhs_table(rhs_cols, b: int, B: int, S: int, R: int, device) -> RhsArgs:
    """bt_msolve's right-hand-side columns, read in place."""
    args = RhsArgs()
    rows = entry_views(rhs_cols[:b], torch.Size((B, S, R)), device)
    args.ptr[:b], args.sb[:b], args.ss[:b], args.sr[:b] = zip(*rows)
    return args


def prepare_multirhs_entries(D_full, L_full, rhs_cols, b: int):
    """bt_factor's table (entries read in place) with its record output
    (B, S, REC), bt_msolve's right-hand-side table and x (b, B, S, R)."""
    like = _like(rhs_cols)
    B, S, R = like.shape
    dev = like.device
    rec = torch.empty((B, S, record_layout(b)[3]), dtype=torch.float32,
                      device=dev)
    fargs = _factor_args(factor_entry_table(D_full, L_full, b, B, S, dev),
                         rec)
    x = torch.empty((b, B, S, R), dtype=torch.float32, device=dev)
    return fargs, rec, rhs_table(rhs_cols, b, B, S, R, dev), x


def _launch_factor(fargs: FactorArgs, S, B, b, device):
    BT_FACTOR([ctypes.addressof(fargs)], [S, B, b], device)
    _count(BT_FACTOR, b)


def _launch_msolve(rec, rargs: RhsArgs, x, S, B, R, b, device):
    BT_MSOLVE([_ptr(rec), ctypes.addressof(rargs), _ptr(x)], [S, B, R, b],
              device)
    _count(BT_MSOLVE, b)


def block_tridiag_multirhs_entries(D_full, L_full, rhs_cols, b: int):
    """Batched multi-RHS solve from entry form: factor once, then
    substitute every column.

    D_full/L_full as in ``block_tridiag_solve_entries``; rhs_cols: list b
    of entries broadcastable to (B, S, R), the first tensor among them of
    shape (B, S, R). Returns list b of (B, S, R).
    """
    like = _like(rhs_cols)
    if not _on_cuda(like, b):
        return block_tridiag_multirhs_entries_plain(D_full, L_full,
                                                    rhs_cols, b)
    B, S, R = like.shape
    dev = like.device
    fargs, rec, rargs, x = prepare_multirhs_entries(D_full, L_full,
                                                    rhs_cols, b)
    _launch_factor(fargs, S, B, b, dev)
    _launch_msolve(rec, rargs, x, S, B, R, b, dev)
    return list(x.unbind(0))
