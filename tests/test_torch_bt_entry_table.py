"""The entry tables through which the block-tridiagonal kernels read the
solver's tensors in place (``ops/block_tridiag_kernels.py``), checked on
the CPU: each table row (pointer, batch stride, stage stride), rebuilt with
``torch.as_strided`` over the storage it points into (zero where the
pointer is null), must give exactly the stage-major stack the wrappers
used to build before the kernels read in place: dense (B, T) entries,
structural zeros materialised, D's upper triangle mirrored from the lower.
Cases: structural zeros, a tensor shared between D[1][0] and D[0][1],
stride-0 entries along the batch and along the stages, the array form
with non-contiguous strides, bt_msolve's right-hand-side columns, and
bt_factor's table and the stage records it hands bt_msolve."""
import pytest
import torch

from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from tests.test_torch_kernels_cuda import special_entries

CPU = torch.device("cpu")


def rebuild(rows, shape, tensors):
    """Stage-major (T, len(rows), B) stack of the views the table rows
    describe; ``tensors`` holds every tensor the pointers may point into."""
    B, T = shape
    out = []
    for p, sb, ss in rows:
        if p == 0:
            out.append(torch.zeros(T, B))
            continue
        for t in tensors:
            st = t.untyped_storage()
            if st.data_ptr() <= p < st.data_ptr() + st.nbytes():
                base = torch.tensor([], dtype=torch.float32).set_(st)
                view = torch.as_strided(base, (B, T), (sb, ss),
                                        (p - st.data_ptr()) // 4)
                out.append(view.t())
                break
        else:
            raise AssertionError(f"pointer {p:#x} is in no input tensor")
    return torch.stack(out, dim=1)


def dense_entry(e, shape):
    """What the solver's routing materialised for the kernels before they
    read entries in place."""
    if not isinstance(e, torch.Tensor):
        return torch.zeros(shape)
    return e.expand(shape)


def stage_major_stack(entries, shape):
    return torch.stack([dense_entry(e, shape).t() for e in entries], dim=1)


def tensors_of(*lists):
    out = []
    for x in lists:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += tensors_of(*x)
    return out


@pytest.mark.parametrize("b", [3, 5, 8, 10])
@pytest.mark.parametrize("B,S", [(6, 7), (3, 1), (5, 51)])
def test_solve_table_matches_stage_major_stack(b, B, S):
    """special_entries needs b >= 4; b = 3 takes dense entries."""
    if b >= 4:
        Df, Lf, r = special_entries(B, S, b, seed=b)[0]
    else:
        Df, Lf, r = _plain_entries(B, S, b)
    table = btk.solve_entry_table(Df, Lf, r, b, B, S, CPU)
    nl, bb = b * (b + 1) // 2, b * b
    assert len(table) == nl + bb + b <= btk.MAX_ENTRIES
    ts = tensors_of(Df, Lf, r)
    D_sym = [[Df[i][j] if i >= j else Df[j][i] for j in range(b)]
             for i in range(b)]
    lower = [D_sym[i][j] for i in range(b) for j in range(i + 1)]
    assert torch.equal(rebuild(table[:nl], (B, S), ts),
                       stage_major_stack(lower, (B, S)))
    if S > 1:
        flat = [Lf[i][j] for i in range(b) for j in range(b)]
        assert torch.equal(rebuild(table[nl:nl + bb], (B, S - 1), ts),
                           stage_major_stack(flat, (B, S - 1)))
    assert torch.equal(rebuild(table[nl + bb:], (B, S), ts),
                       stage_major_stack(r, (B, S)))


def _plain_entries(B, S, b):
    """Dense contiguous entries with one structural zero in L and rhs."""
    g = torch.Generator().manual_seed(B * 100 + S)
    Df = [[torch.randn(B, S, generator=g) for _ in range(b)]
          for _ in range(b)]
    Lf = [[torch.randn(B, S - 1, generator=g) for _ in range(b)]
          for _ in range(b)]
    Lf[0][1] = 0.0
    r = [torch.randn(B, S, generator=g) for _ in range(b)]
    r[-1] = 0.0
    return Df, Lf, r


def test_shared_and_expanded_entries_point_into_one_storage():
    """A tensor shared between D[1][0] and D[0][1] is read once (the lower
    one); an expanded entry has stride 0 where it was broadcast."""
    (Df, Lf, r), _ = special_entries(4, 6, 5, seed=1)
    table = btk.solve_entry_table(Df, Lf, r, 5, 4, 6, CPU)
    lo = {(i, j): n for n, (i, j) in enumerate(
        (i, j) for i in range(5) for j in range(i + 1))}
    assert table[lo[1, 0]][0] == Df[1][0].data_ptr()
    assert table[lo[2, 0]] == (0, 0, 0)
    assert table[lo[3, 3]][1] == 0                  # batch stride 0
    assert table[15 + 5][2] == 0                    # L[1][0]: stage stride 0
    assert table[15 + 1] == (0, 0, 0)               # L[0][1]: zero
    assert table[15 + 25 + 1] == (0, 0, 0)          # rhs[1]: zero


@pytest.mark.parametrize("b", [3, 5, 8, 10])
def test_array_table_matches_stage_major_stack(b):
    """The array form's table over (B, S, b, b) strides, here column-major
    blocks and a slice of a wider tensor, against the permuted copies the
    wrapper used to make."""
    B, S = 4, 9
    g = torch.Generator().manual_seed(b)
    D = torch.randn(B, S, b, b, generator=g).transpose(-1, -2)
    Lw = torch.randn(B, S - 1, b, b + 3, generator=g)
    L = Lw[..., 1:b + 1]
    rhs = torch.randn(B, S, 2 * b, generator=g)[..., ::2]
    il, jl = torch.tril_indices(b, b)
    rows = btk._array_entries(D, [(i, j) for i in range(b)
                                  for j in range(i + 1)])
    assert torch.equal(rebuild(rows, (B, S), [D]),
                       D[:, :, il, jl].permute(1, 2, 0))
    rows = btk._array_entries(L, [(i, j) for i in range(b)
                                  for j in range(b)])
    assert torch.equal(rebuild(rows, (B, S - 1), [Lw]),
                       L.reshape(B, S - 1, b * b).permute(1, 2, 0))
    rows = btk._array_entries(rhs, [(i,) for i in range(b)])
    assert torch.equal(rebuild(rows, (B, S), [rhs]), rhs.permute(1, 2, 0))


def test_rhs_table_matches_stacked_columns():
    """bt_msolve's right-hand-side table against the stacked (b, B, S, R)
    copy the wrapper used to make; a structural-zero column reads as zeros."""
    B, S, R, b = 3, 5, 4, 5
    (Df, Lf, cols), _ = special_entries(B, S, b, R, seed=4)
    args = btk.rhs_table(cols, b, B, S, R, CPU)
    for i, c in enumerate(cols):
        if not isinstance(c, torch.Tensor):
            assert args.ptr[i] is None
            continue
        st = c.untyped_storage()
        base = torch.tensor([], dtype=torch.float32).set_(st)
        view = torch.as_strided(base, (B, S, R),
                                (args.sb[i], args.ss[i], args.sr[i]),
                                (args.ptr[i] - st.data_ptr()) // 4)
        assert torch.equal(view, c)


def test_msolve_tables_at_b10_stream_whole_float4_records():
    """What bt_msolve_kernel_wide reads at b=10: bt_factor's stage records
    whole float4s a part (the factor 55 padded to 56, L_k 100, 1 / c_jj 10
    padded to 12: 42 float4s a record, which its ring copies 16 bytes at a
    time, a forward slot taking L_{k-1} from the record before), and the
    right-hand-side table of R=50 columns at S=51 read in place, as at
    b=5."""
    assert btk.record_layout(10) == (56, 100, 12, 168)
    B, S, R, b = 2, 51, 50, 10
    (Df, Lf, cols), _ = special_entries(B, S, b, R, seed=6)
    args = btk.rhs_table(cols, b, B, S, R, CPU)
    assert any(not isinstance(c, torch.Tensor) for c in cols)
    for i, c in enumerate(cols):
        if not isinstance(c, torch.Tensor):
            assert args.ptr[i] is None
            continue
        st = c.untyped_storage()
        base = torch.tensor([], dtype=torch.float32).set_(st)
        view = torch.as_strided(base, (B, S, R),
                                (args.sb[i], args.ss[i], args.sr[i]),
                                (args.ptr[i] - st.data_ptr()) // 4)
        assert torch.equal(view, c.expand(B, S, R))
    rec = btk.factor_records_plain(Df, Lf, b, B, S)
    assert rec.shape == (B, S, 168) and rec.stride() == (S * 168, 168, 1)
    assert not rec[..., 55:56].any() and not rec[..., 166:].any()
    assert not rec[:, S - 1, 56:156].any()


def test_solve_args_pack_the_table_and_output_view():
    """The ctypes struct the kernel takes by value: pointers (None where
    null), strides, and the (b, B, S) output view the entry form unbinds."""
    (Df, Lf, r), _ = special_entries(2, 4, 5, seed=2)
    args, x = btk.prepare_solve_entries(Df, Lf, r, 5)
    table = btk.solve_entry_table(Df, Lf, r, 5, 2, 4, CPU)
    assert x.shape == (5, 2, 4) and x.is_contiguous()
    for n, (p, sb, ss) in enumerate(table):
        assert (args.ptr[n] or 0, args.sb[n], args.ss[n]) == (p, sb, ss)
    assert all(args.ptr[n] is None for n in range(len(table),
                                                  btk.MAX_ENTRIES))
    assert (args.out, args.out_se, args.out_sb, args.out_ss) == (
        x.data_ptr(), 8, 4, 1)


@pytest.mark.parametrize("b", [5, 10])
def test_solve_args_carry_the_scratch_above_the_team(b):
    """``BtSolveCall``'s layout: the table, then the scratch pointer. Up to
    b = TEAM it is null; above, it points at a (B, S, 80) float32 tensor the
    arguments keep alive, 16-byte aligned: the factor (55 padded to 56),
    1 / c_jj and y (10 each, padded to 12), as the streamed kernels'
    ``Ring<b>::SREC``."""
    B, S = 3, 6
    (Df, Lf, r), _ = special_entries(B, S, b, seed=b)
    args, x = btk.prepare_solve_entries(Df, Lf, r, b)
    assert btk.SolveArgs.scratch.offset == 3 * 8 * btk.MAX_ENTRIES + 32
    assert btk.scratch_record(b) == (0 if b <= btk.TEAM else 80)
    if b <= btk.TEAM:
        assert args.scratch is None
        return
    scratch = args.scratch_tensor
    assert scratch.shape == (B, S, 80) and scratch.dtype == torch.float32
    assert args.scratch == scratch.data_ptr() and args.scratch % 16 == 0
    nlp, _, bp, _ = btk.record_layout(b)
    assert (nlp, bp) == (56, 12)


def test_entry_views_reject_what_the_kernel_cannot_read():
    shape = torch.Size((2, 3))
    with pytest.raises(TypeError):
        btk.entry_views([1.5], shape, CPU)
    with pytest.raises(TypeError):
        btk.entry_views([torch.zeros(2, 3, dtype=torch.float64)], shape, CPU)
    with pytest.raises(ValueError):
        btk.entry_views([torch.zeros(3, 3)], shape, CPU)


@pytest.mark.parametrize("b", [3, 5, 8, 10])
@pytest.mark.parametrize("part", ["factor_table", "records"])
def test_factor_tables_match_the_stage_major_stack(part, b):
    """bt_factor reads D and L in place and writes per-stage records that
    bt_msolve copies whole. ``factor_table``: its table rows rebuilt over
    their storage against the stage-major (S, NL, B) and (S-1, b*b, B)
    stacks of D and L the multi-RHS wrapper used to build. ``records``:
    the (B, S, REC) records of the plain version, unpacked by
    ``record_layout``, against the stage-major factor the kernel used to
    write, that L stack, the reciprocals of the factor's diagonal and zero
    padding."""
    B, S = 5, 7
    if b >= 4:
        (Df, Lf, _), _ = special_entries(B, S, b, seed=b)
    else:
        Df, Lf, _ = _plain_entries(B, S, b)
    nl = b * (b + 1) // 2
    D_sym = [[Df[i][j] if i >= j else Df[j][i] for j in range(b)]
             for i in range(b)]
    lower = stage_major_stack([D_sym[i][j] for i in range(b)
                               for j in range(i + 1)], (B, S))
    flat = stage_major_stack([Lf[i][j] for i in range(b) for j in range(b)],
                             (B, S - 1))
    if part == "factor_table":
        table = btk.factor_entry_table(Df, Lf, b, B, S, CPU)
        assert len(table) == nl + b * b <= btk.MAX_FACTOR_ENTRIES
        ts = tensors_of(Df, Lf)
        assert torch.equal(rebuild(table[:nl], (B, S), ts), lower)
        assert torch.equal(rebuild(table[nl:], (B, S - 1), ts), flat)
        return
    nlp, bbp, bp, rec_n = btk.record_layout(b)
    assert rec_n % 4 == 0 and (nlp, bbp, bp) == tuple(
        (n + 3) // 4 * 4 for n in (nl, b * b, b))
    rec = btk.factor_records_plain(Df, Lf, b, B, S)
    assert rec.shape == (B, S, rec_n)
    blocks = torch.stack([torch.stack([dense_entry(D_sym[i][j], (B, S))
                                       for j in range(b)], -1)
                          for i in range(b)], -2)
    Lb = torch.stack([torch.stack([dense_entry(Lf[i][j], (B, S - 1))
                                   for j in range(b)], -1)
                      for i in range(b)], -2)
    chol = torch.stack(btk._factor_plain(blocks, Lb), 1)
    il, jl = torch.tril_indices(b, b)
    assert torch.equal(rec[..., :nl].permute(1, 2, 0),
                       chol[:, :, il, jl].permute(1, 2, 0))
    assert torch.equal(rec[:, :S - 1, nlp:nlp + b * b].permute(1, 2, 0),
                       flat)
    assert torch.equal(rec[..., nlp + bbp:nlp + bbp + b],
                       1.0 / torch.diagonal(chol, 0, -2, -1))
    pad = torch.ones(rec_n, dtype=torch.bool)
    pad[:nl] = pad[nlp:nlp + b * b] = pad[nlp + bbp:nlp + bbp + b] = False
    assert not rec[..., pad].any() and not rec[:, S - 1, nlp:nlp + bbp].any()
