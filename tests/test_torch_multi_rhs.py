"""The k-column forms of K2 and K5: one launch reads the operator once for
k vectors (the coupled multi-component solve).

On the CPU a batch runs the single plain version column by column, so the
k-column plain forms of K2 (padded and row-pointer, every update form) and
K5 equal the single plain forms per column bit for bit, and so do
``spmv``, ``spmv_update`` and ``ilu_apply`` on a batch, on every layout,
past ``MAX_COLS`` columns too, and one V-cycle of the structured and the
algebraic hierarchy.  K5's k-column step plans fit a block: at most
``xl_step_rows`` rows a step, and its shared memory; the cover its steps
stage (``kernels/bdia.py:step_cover``) is the union of each step's
windows, packed as its tables say, and the plain version read through it
gives the span panels' bits.  K2's packed batch (``pack_columns``) is its
definition, and the plain version on it the batch's bits.
On a card (marked ``cuda``; no JAX, no conftest fixture) each column of a
k-column launch of K2 and K5, k in {1, 3, 8}, equals the single-vector
kernel on that column by ``torch.equal`` and the plain version to 1e-5
(f32) and 1e-12 (f64) relative (the plain version sums in another order);
K2 on an x packed beforehand gives the same bits, and so do its bf16
values over k columns; a batch through ``spmv`` is one launch.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.ilu.ilu import ilu_apply
from tpusolve_torch.kernels import bdia, ell
from tpusolve_torch.kernels.ell import ell_spmv, ell_spmv_plain
from tpusolve_torch.matrix.spmv import MAX_COLS, spmv, spmv_update
from test_torch_xl_segments import _port_factors

CPU = torch.device("cpu")
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# update forms as keyword arguments (vector names), as tests/test_torch_ell
FORMS = {
    "Ax": {},
    "residual": dict(b="b"),
    "jacobi": dict(b="b", s="s", c="c", w=0.8),
    "chebyshev first": dict(b="b", s="s"),
    "chebyshev next": dict(s="s", c="c"),
    "prolongation": dict(c="c", w=-1.0),
}


def ragged_ell(rng, rows, ncols, K, dtype):
    """Padded-ELL (vals, cols) of ragged rows (1 to K entries), as numpy."""
    counts = rng.integers(1, K + 1, size=rows)
    vals = np.zeros((rows, K), dtype)
    cols = np.zeros((rows, K), np.int32)
    for i, c in enumerate(counts):
        vals[i, :c] = rng.standard_normal(c)
        cols[i, :c] = rng.choice(ncols, size=c, replace=False)
    return vals, cols


def vectors(rng, k, n, rows, dtype, device, form):
    """x (k, n) and the form's b, c (k, rows) and s (rows,)."""
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(dtype)).to(device)
    vecs = {"b": t(k, rows), "s": t(rows), "c": t(k, rows)}
    kw = {name: (vecs[v] if isinstance(v, str) else v)
          for name, v in FORMS[form].items()}
    return t(k, n), kw


def column(kw, j):
    return {n: (v[j] if torch.is_tensor(v) and v.dim() == 2 else v)
            for n, v in kw.items()}


@pytest.fixture
def gen():
    return np.random.default_rng(2024)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["padded", "rowptr"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_k2_plain_columns_equal_single(gen, dtype, storage, form):
    vals, cols = ragged_ell(gen, 300, 250, 9, dtype)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    rowptr = None
    if storage == "rowptr":
        rowptr, v, c = ell.padded_to_rowptr(v, c)
    x, kw = vectors(gen, 3, 250, 300, dtype, CPU, form)
    y = ell_spmv(v, c, x, rowptr=rowptr, **kw)
    assert y.shape == (3, 300)
    for j in range(3):
        if rowptr is None:
            want = ell_spmv_plain(v, c, x[j], **column(kw, j))
        else:
            want = ell.ell_rowptr_plain(rowptr, v, c, x[j], **column(kw, j))
        assert torch.equal(y[j], want)


def test_k2_plain_in_place_batch(gen):
    """The prolongation ``x + P e`` written into x: a batch in place."""
    vals, cols = ragged_ell(gen, 200, 90, 6, np.float64)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    e = torch.from_numpy(gen.standard_normal((4, 90)))
    x = torch.from_numpy(gen.standard_normal((4, 200)))
    want = torch.stack([x[j] + ell_spmv_plain(v, c, e[j]) for j in range(4)])
    got = ell_spmv(v, c, e, c=x, w=-1.0, out=x)
    assert got is x and torch.equal(x, want)


def _layouts(monkeypatch):
    """{name: ShardedMatrix} of one operator (the momentum ILU factor L) in
    K5's, K4's and K2's layouts, and the stencil in box DIA."""
    from tpusolve_torch.stencil import laplace27
    out = {}
    for lay in ("xl", "bdia", "ell"):
        with monkeypatch.context() as m:
            out[lay] = _port_factors(lay, m)[0]
    out["dia"] = laplace27(6, 6, 6, device=CPU, dtype=np.float64)[0]
    return out


@pytest.mark.parametrize("k", [1, 3, MAX_COLS + 2])
def test_spmv_batch_equals_columns(gen, monkeypatch, k):
    for name, A in _layouts(monkeypatch).items():
        x = torch.from_numpy(gen.standard_normal((k, A.col_pad)))
        y = spmv(A, x)
        assert y.shape == (k, A.row_pad), name
        for j in range(k):
            assert torch.equal(y[j], spmv(A, x[j])), (name, j)


@pytest.mark.parametrize("form", ["residual", "jacobi", "chebyshev next"])
def test_spmv_update_batch_equals_columns(gen, monkeypatch, form):
    for name, A in _layouts(monkeypatch).items():
        x, kw = vectors(gen, 3, A.col_pad, A.row_pad, np.float64, CPU, form)
        y = spmv_update(A, x, **kw)
        for j in range(3):
            assert torch.equal(y[j], spmv_update(A, x[j], **column(kw, j))), \
                (name, form, j)


@pytest.mark.parametrize("layout", ["xl", "bdia", "ell"])
def test_ilu_apply_batch_equals_columns(gen, monkeypatch, layout):
    L, U, dinv = _port_factors(layout, monkeypatch)
    r = torch.from_numpy(gen.standard_normal((3, L.row_pad)))
    z = ilu_apply(L, U, dinv, r, 5, 5)
    for j in range(3):
        assert torch.equal(z[j], ilu_apply(L, U, dinv, r[j], 5, 5))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_k5_column_plans_fit(monkeypatch, itemsize, k):
    """K5's k-column plan on the momentum factor: steps of at most
    ``xl_step_rows`` rows, its overflow chunk (and for one column its x
    panel) inside a block's shared memory; one column keeps the 8192-row
    steps."""
    from tpusolve_torch import runtime
    from tpusolve_torch.matrix import sharded
    L = _port_factors("xl", monkeypatch)[0]
    _, B, D, R = L.bdia_vals.shape
    rows = bdia.xl_step_rows(itemsize, k)
    assert rows == (8192 if k == 1 else
                    512 * (16 // itemsize) * bdia.xl_passes(itemsize, k))
    xl = sharded.plan_xl(L.bdia_starts.numpy(), R, L.bdia_xpad, itemsize,
                         L.bdia_nbytes, L.bdia_live, L.xl_work(), cols=k)
    assert xl is not None
    gb, step_lo, panel, step_b0, stage = xl[:5]
    assert gb * R <= rows
    assert np.diff(step_b0, axis=1).max() == gb
    assert bdia.xl_smem_bytes(panel, gb, D, itemsize, R, stage,
                              k) <= runtime.SMEM_PER_BLOCK


def _far_band(monkeypatch):
    """A BDIA layout (one part, 32 blocks of 128 rows) whose windows lie in
    three bands (near the diagonal, 1,000 and 2,000 below it, the last
    with a ragged start), so that a step's cover is several segments;
    random values, a third of the 32-row segments zero, and an overflow
    list of a few entries; K2 priced out, as for the factors."""
    from test_torch_sharded import k2_priced_out
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    k2_priced_out(monkeypatch)
    rng = np.random.default_rng(7)
    n, R = 32 * 128, 128
    rows, cols = [], []
    for d in (0, -1, 1, -2, 2, -1000, -1001, -2003, -2004):
        r = np.arange(max(0, -d), min(n, n - d))
        rows.append(r)
        cols.append(r + d)
    rows.append(np.arange(0, n, 97))
    cols.append((np.arange(0, n, 97) * 7) % n)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    vals[(rows // 32) % 3 == 0] = 0.0
    A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=CPU,
                               dtype=np.float64, allow_dia=False,
                               allow_bell=False)
    assert A.uses_bdia and A.bdia_block == R, A.layout
    return A


def _cover_case(monkeypatch, k, op="L"):
    """(operator, its k-column step plan, the plan's cover tables): the
    momentum factor L, or :func:`_far_band`."""
    from tpusolve_torch.matrix import sharded
    L = _port_factors("xl", monkeypatch)[0] if op == "L" else \
        _far_band(monkeypatch)
    _, B, D, R = L.bdia_vals.shape
    starts = L.bdia_starts.numpy()
    xl = sharded.plan_xl(starts, R, L.bdia_xpad, 8, L.bdia_nbytes,
                         L.bdia_live, L.xl_work(), cols=k)
    return L, xl, bdia.step_cover(starts, R, L.bdia_xpad, xl[3])


@pytest.mark.parametrize("op", ["L", "far band"])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_k5_step_cover_is_the_windows_union(monkeypatch, k, op):
    """Each step's segments are its windows' union, widened to
    ``XL_ALIGN`` and merged across gaps under ``XL_COVER_GAP``: disjoint,
    in order, aligned and packed from panel entry 0; every window reads
    its own x entries at its ``xoff``; the plan's panel is the most a step
    stages."""
    L, xl, (seg_ptr, segs, xoff, cover) = _cover_case(monkeypatch, k, op)
    _, B, D, R = L.bdia_vals.shape
    assert op == "L" or np.diff(seg_ptr).max() > 1
    s = L.bdia_starts.numpy()[0].astype(np.int64) - L.bdia_xpad
    step_b0 = xl[3][0]
    A = bdia.XL_ALIGN
    assert xl[2] == cover and cover % A == 0
    assert seg_ptr[0] == 0 and seg_ptr[-1] == segs.shape[0]
    for i in range(step_b0.size - 1):
        mine = segs[seg_ptr[i]:seg_ptr[i + 1]].astype(np.int64)
        blocks = range(step_b0[i], step_b0[i + 1])
        if not len(blocks):
            assert mine.size == 0
            continue
        lo, length, off = mine.T
        assert (lo % A == 0).all() and (length % A == 0).all()
        assert (off == np.concatenate([[0], np.cumsum(length)[:-1]])).all()
        assert (lo[1:] > lo[:-1] + length[:-1] + bdia.XL_COVER_GAP).all()
        assert length.sum() <= cover
        # the union of the step's aligned windows, as a set of entries
        want = set()
        for b in blocks:
            for d in range(D):
                want.update(range(s[b, d] // A * A, -(-(s[b, d] + R) // A)
                                  * A))
        got = set()
        for g0, n in zip(lo, length):
            got.update(range(g0, g0 + n))
        assert want <= got
        # entries the gaps add lie between windows, never past the ends
        assert min(got) == min(want) and max(got) == max(want)
        # panel entry -> x entry, and each window at its offset
        entry = np.concatenate([np.arange(g0, g0 + n) for g0, n in
                                zip(lo, length)])
        for b in blocks:
            for d in range(D):
                q = xoff[0, b, d]
                assert (entry[q:q + R] == s[b, d] + np.arange(R)).all()


@pytest.mark.parametrize("op", ["L", "far band"])
def test_k5_cover_overflow_is_its_definition(monkeypatch, op):
    """Each overflow entry's code for the k-column launch: the offset in
    its step's staged panel of its column, exactly where a segment of that
    step holds the column, else -(column + 1)."""
    L, xl, (seg_ptr, segs, xoff, cover) = _cover_case(monkeypatch, 3, op)
    ptr, cols, _ = (t.numpy() for t in L.bdia_ovf)
    step_b0, R = xl[3][0], L.bdia_block
    code = bdia.cover_overflow(ptr, cols, R, xl[3], seg_ptr, segs)
    assert code.shape == cols.shape and code.dtype == np.int32
    n = int(ptr[0, -1])
    held = 0
    for i in range(ptr.shape[1] - 1):
        st = np.searchsorted(step_b0, i // R, side="right") - 1
        mine = segs[seg_ptr[st]:seg_ptr[st + 1]].astype(np.int64)
        for j in range(ptr[0, i], ptr[0, i + 1]):
            g = int(cols[0, j])
            hit = [o + g - g0 for g0, ln, o in mine if g0 <= g < g0 + ln]
            want = hit[0] if hit else -(g + 1)
            assert code[0, j] == want, (i, j)
            held += bool(hit)
    assert (code[0, n:] == -(cols[0, n:].astype(np.int64) + 1)).all()
    assert held > 0 and (op == "L" or held < n)


@pytest.mark.parametrize("op", ["L", "far band"])
@pytest.mark.parametrize("form", ["Ax", "jacobi"])
def test_k5_plain_through_cover_is_span_bits(monkeypatch, gen, form, op):
    """The plain version reading its windows from the staged cover panels
    (``cover_panels``) gives the span panels' bits, in both update
    forms."""
    L, xl, (seg_ptr, segs, xoff, cover) = _cover_case(monkeypatch, 3, op)
    gb, step_lo, panel, step_b0, _ = xl[:5]
    x, kw = vectors(gen, 1, L.col_pad, L.row_pad, np.float64, CPU, form)
    kw = column(kw, 0)
    args = (L.bdia_vals, L.bdia_starts, x[0], L.bdia_xpad, L.row_pad, gb)
    # the span panels of the same steps: from each step's lowest window
    blocks = np.arange(L.bdia_vals.shape[1])
    step = np.searchsorted(step_b0[0], blocks, side="right") - 1
    off = (L.bdia_starts.numpy()[0] - L.bdia_xpad
           - step_lo[0, step][:, None])
    span = -(-(int(off.max()) + L.bdia_block) // bdia.XL_ALIGN) \
        * bdia.XL_ALIGN
    assert off.min() >= 0 and cover <= span
    assert op == "L" or cover < span
    want = bdia.bdia_spmv_xl_plain(
        *args, torch.from_numpy(step_lo), span, L.bdia_ovf,
        mask=L.bdia_mask, step_b0=torch.from_numpy(step_b0), **kw)
    got = bdia.bdia_spmv_xl_plain(
        *args, torch.from_numpy(step_lo), panel, L.bdia_ovf,
        mask=L.bdia_mask, step_b0=torch.from_numpy(step_b0), **kw,
        cover=tuple(torch.from_numpy(t) for t in (seg_ptr, segs, xoff)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", range(2, MAX_COLS + 1))
def test_k2_pack_columns_is_its_definition(gen, dtype, k):
    x = torch.from_numpy(gen.standard_normal((k, 37)).astype(dtype))
    xp = ell.pack_columns(x)
    want = np.empty((37, k), dtype)
    for i in range(37):
        for j in range(k):
            want[i, j] = x[j, i]
    assert xp.is_contiguous() and (xp.numpy() == want).all()


@pytest.mark.parametrize("storage", ["padded", "rowptr"])
@pytest.mark.parametrize("form", ["Ax", "jacobi", "prolongation"])
def test_k2_plain_packed_is_the_batch(gen, storage, form):
    vals, cols = ragged_ell(gen, 50, 40, 9, np.float32)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    rowptr = None
    if storage == "rowptr":
        rowptr, v, c = ell.padded_to_rowptr(v, c)
    x, kw = vectors(gen, 3, 40, 50, np.float32, CPU, form)
    want = ell_spmv(v, c, x, rowptr=rowptr,
                    **{n: (t.clone() if torch.is_tensor(t) else t)
                       for n, t in kw.items()})
    got = ell_spmv(v, c, ell.pack_columns(x), rowptr=rowptr, packed=True,
                   **kw)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["padded", "rowptr"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_k2_columns_bit_for_bit_on_cuda(cuda, dtype, storage, k):
    rng = np.random.default_rng(31)
    for K, rows, ncols in ((9, 5000, 4000), (40, 700, 900), (131, 300, 300)):
        vals, cols = ragged_ell(rng, rows, ncols, K, dtype)
        v, c = (torch.from_numpy(a).to(cuda) for a in (vals, cols))
        rowptr = None
        if storage == "rowptr":
            rowptr, v, c = ell.padded_to_rowptr(v, c)
        for form in FORMS:
            x, kw = vectors(rng, k, ncols, rows, dtype, cuda, form)
            for g in ell.GROUPS:
                y = ell_spmv(v, c, x, rowptr=rowptr, groups=g,
                             **{n: (t.clone() if torch.is_tensor(t) else t)
                                for n, t in kw.items()})
                if k > 1:
                    packed = ell_spmv(v, c, ell.pack_columns(x),
                                      rowptr=rowptr, groups=g, packed=True,
                                      **{n: (t.clone() if torch.is_tensor(t)
                                             else t) for n, t in kw.items()})
                    torch.cuda.synchronize()
                    assert torch.equal(packed, y), (K, form, g)
                for j in range(k):
                    one = ell_spmv(v, c, x[j], rowptr=rowptr, groups=g,
                                   **column(kw, j))
                    assert torch.equal(y[j], one), (K, form, g, j)
            want = ell._plain(v.cpu(), c.cpu(), x.cpu(), *(
                None if kw.get(n) is None else kw[n].cpu()
                for n in ("b", "s", "c")), kw.get("w", 1.0), None,
                None if rowptr is None else rowptr.cpu())
            assert rel(y.cpu(), want) <= RTOL[y.dtype], (K, form)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["padded", "rowptr"])
@pytest.mark.parametrize("k", [3, 8])
def test_k2_bf16_columns_bit_for_bit_on_cuda(cuda, dtype, storage, k):
    """bf16 values (the smoother twin) over k columns: each column the
    single bf16 launch's bits."""
    rng = np.random.default_rng(33)
    vals, cols = ragged_ell(rng, 3000, 2500, 27, dtype)
    v = torch.from_numpy(vals).to(cuda).to(torch.bfloat16)
    c = torch.from_numpy(cols).to(cuda)
    rowptr = None
    if storage == "rowptr":
        rowptr, v, c = ell.padded_to_rowptr(v, c)
    for form in ("Ax", "jacobi"):
        x, kw = vectors(rng, k, 2500, 3000, dtype, cuda, form)
        y = ell_spmv(v, c, x, rowptr=rowptr, **kw)
        torch.cuda.synchronize()
        for j in range(k):
            assert torch.equal(y[j], ell_spmv(v, c, x[j], rowptr=rowptr,
                                              **column(kw, j))), (form, j)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_k5_columns_bit_for_bit_on_cuda(cuda, monkeypatch, dtype, k):
    L, U, dinv = _port_factors("xl", monkeypatch, dtype=dtype, device=cuda)
    rng = np.random.default_rng(32)
    for A in (L, U):
        assert A.uses_bdia_xl and A.bdia_xl_op is not None
        op = A.xl_cols_op(k)
        assert op.cols == k
        for form in FORMS:
            x, kw = vectors(rng, k, A.col_pad, A.row_pad, dtype, cuda, form)
            if "s" in kw:
                kw["s"] = dinv
            y = bdia.bdia_spmv_xl_run(op, x, **kw)
            torch.cuda.synchronize()
            for j in range(k):
                one = spmv(A, x[j]) if not kw else spmv_update(
                    A, x[j], **column(kw, j))
                assert torch.equal(y[j], one), (form, j)
            plain = torch.stack([bdia.bdia_spmv_xl_plain(
                A.bdia_vals.cpu(), A.bdia_starts.cpu(), x[j].cpu(),
                A.bdia_xpad, A.row_pad, A.bdia_gb, A.bdia_step_lo.cpu(),
                A.bdia_panel, tuple(t.cpu() for t in A.bdia_ovf),
                mask=A.bdia_mask.cpu(), step_b0=A.bdia_step_b0.cpu(),
                **{n: (t.cpu() if torch.is_tensor(t) else t)
                   for n, t in column(kw, j).items()}) for j in range(k)])
            assert rel(y.cpu(), plain) <= RTOL[y.dtype], form


@pytest.mark.cuda
def test_batch_is_one_launch_on_cuda(cuda, monkeypatch):
    """A batch of 3 through ``spmv`` and ``ilu_apply`` launches K2 or K5
    once an application, its k-column form."""
    for layout, kern in (("xl", bdia.bdia_spmv_xl), ("ell", ell_spmv)):
        with monkeypatch.context() as m:
            L, U, dinv = _port_factors(layout, m, device=cuda)
        x = torch.ones((3, L.col_pad), dtype=L.dtype, device=cuda)
        kern.launches = 0
        kern.launches_by_cols = {}
        spmv(L, x)
        ilu_apply(L, U, dinv, x, 5, 5)
        assert kern.launches == 11 and kern.launches_by_cols == {3: 11}


def test_amg_cycle_batch_equals_columns(gen):
    """One V-cycle on a batch: the structured cycle runs each column in
    turn (its bits), the algebraic cycle the whole batch (each SpMV one
    k-column launch; the dense coarse solve a matrix product, so 1e-12)."""
    from tpusolve_torch.amg import builder, structured
    from tpusolve_torch.config import BoomerAMGConfig
    from tpusolve_torch.stencil import laplace27
    A, _, _, hp = laplace27(8, 8, 8, device=CPU, dtype=np.float64,
                            with_parts=True)
    pre_s = structured.structured_mg_setup_fast(A, BoomerAMGConfig(),
                                                host_parts=hp)
    pre_a = builder.boomeramg_setup(A, BoomerAMGConfig(max_coarse_size=32),
                                    device_min_n=None)
    r = torch.from_numpy(gen.standard_normal((3, A.row_pad)))
    z = pre_s.apply(r)
    for j in range(3):
        assert torch.equal(z[j], pre_s.apply(r[j]))
    z = pre_a.apply(r)
    for j in range(3):
        one = pre_a.apply(r[j])
        assert float((z[j] - one).abs().max()) <= 1e-12 * float(
            one.abs().max())
