"""K2's row-pointer form (``kernels/ell.py``) and the choice of K2's form
and of K2 among the layouts (``matrix/sharded.py``).

The same numpy inputs (a seed) go through both packages: ragged operators
in the row-pointer form (empty rows, the last rows all padding, square and
rectangular like P and R), against ``tpusolve``'s ``ell_spmv_local`` on
their padded form, plain and in every update form, to 1e-12 relative in f64
and 1e-5 in f32 (only the summation order may differ).  The padded form
turns into the row-pointer form and back exactly, and the row-pointer plain
version gives the padded one's bits.  The form helper (``ell_form``) stores
a prolongation row-pointer and keeps the model's pricing; the assembly,
``from_arrays`` and the card's level-0 setup keep one form; the width notes
of ILU and the AMG setup read ``row_width``.  On gate 3's fixture at 32^3
and the weak-scaling YAML at 64^3 the layouts that K2 now takes are printed
and the counts are ``tpusolve``'s.  The CUDA cases hold the row-pointer
kernel, at every G and update form, against the plain version and the
padded kernel bit for bit; they skip without a card.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from test_torch_ell import FORMS, kwargs, tp, tp_form  # noqa: F401 (fixture)
from tpusolve_torch.kernels import ell
from tpusolve_torch.kernels.ell import (
    ell_rowptr_plain, ell_spmv, ell_spmv_plain, padded_to_rowptr,
    rowptr_to_padded)
from tpusolve_torch.matrix import sharded
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
# (rows, x length, K, mean entries a row): P-like (short rows, many more
# rows than columns), R-like, a square level and one slot a row
SHAPES = [(400, 90, 8, 2.2), (90, 400, 27, 20.0), (257, 257, 40, 26.0),
          (300, 300, 1, 0.7)]


def ragged(rows, ncols, K, mean, dtype, seed):
    """A padded operator whose rows hold 0 to K entries (mean about
    ``mean``) at their first slots, some rows empty and the last rows all
    padding; and vectors x (ncols,), b, s, c (rows,)."""
    rng = np.random.default_rng(seed)
    counts = rng.binomial(K, min(1.0, mean / K), rows)
    counts[rng.random(rows) < 0.05] = 0
    counts[-max(1, rows // 16):] = 0
    cols = rng.integers(0, ncols, (rows, K)).astype(np.int32)
    vals = rng.standard_normal((rows, K)).astype(dtype)
    pad = np.arange(K)[None] >= counts[:, None]
    cols[pad] = 0
    vals[pad] = 0
    vecs = dict(x=rng.standard_normal(ncols).astype(dtype),
                **{k: rng.standard_normal(rows).astype(dtype)
                   for k in ("b", "s", "c")})
    return vals, cols, vecs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("rows, ncols, K, mean", SHAPES)
def test_rowptr_plain_equals_tpusolve(tp, rows, ncols, K, mean, form, dtype):
    vals, cols, v = ragged(rows, ncols, K, mean, dtype, seed=rows + K)
    rp, rv, rc = padded_to_rowptr(torch.from_numpy(vals),
                                  torch.from_numpy(cols))
    got = ell_rowptr_plain(rp, rv, rc, torch.from_numpy(v["x"]),
                           **kwargs(form, v)).numpy()
    ref = tp_form(tp, vals, cols, v, form)
    assert got.dtype == ref.dtype == dtype
    assert np.abs(got - ref).max() <= RTOL[dtype] * np.abs(ref).max()
    if not FORMS[form]:
        assert not got[-max(1, rows // 16):].any()  # padded rows stay zero


@pytest.mark.parametrize("rows, ncols, K, mean", SHAPES)
def test_round_trip_and_plain_bits(rows, ncols, K, mean):
    """Padded -> row-pointer -> padded gives the same arrays; the
    row-pointer plain version gives the padded one's bits in every form."""
    vals, cols, v = ragged(rows, ncols, K, mean, np.float64, seed=K)
    V, C = torch.from_numpy(vals), torch.from_numpy(cols)
    rp, rv, rc = padded_to_rowptr(V, C)
    assert rp.dtype == torch.int32 and rp.shape == (rows + 1,)
    assert int(rp[-1]) == rv.numel() == int((vals != 0).sum())
    pv, pc = rowptr_to_padded(rp, rv, rc, width=K)
    assert torch.equal(pv, V) and torch.equal(pc, C)
    x = torch.from_numpy(v["x"])
    for form in FORMS:
        kw = kwargs(form, v)
        assert torch.equal(ell_rowptr_plain(rp, rv, rc, x, **kw, width=K),
                           ell_spmv_plain(V, C, x, **kw))
        assert torch.equal(ell_spmv(rv, rc, x, **kw, rowptr=rp),
                           ell_rowptr_plain(rp, rv, rc, x, **kw))


def test_form_choice_on_p_and_r():
    """The weak-scaling level-0 P (2.17 entries in K = 8 slots a row) is
    stored row-pointer; the form helper keeps the form of least modelled
    time, padded on a tie (the row-pointer form priced within
    ``K2_FORM_TIE`` of it), and so does R at 26.6 entries in K = 27."""
    nnz = 4_550_000
    for rows, ncols, K in ((2_097_152, 170_854, 8), (170_854, 2_097_152, 27),
                           (262_144, 21_588, 21)):
        for itemsize in (4, 8):
            t = {f: sharded.ell_model_s(f, rows, ncols, K, nnz, itemsize)
                 for f in ell.FORMS}
            form, sec = sharded.ell_form(rows, ncols, K, nnz, itemsize)
            assert sec == t[form]
            assert form == ("rowptr" if t["rowptr"] * (1 + ell.K2_FORM_TIE)
                            < t["padded"] else "padded")
            if K == 8:
                assert form == "rowptr"
            print(f"rows={rows} K={K} nnz={nnz} f{8 * itemsize}: {form} "
                  f"(padded {t['padded'] * 1e3:.5f} ms, row-pointer "
                  f"{t['rowptr'] * 1e3:.5f} ms)")
    # bytes: the row pointer replaces the padding
    assert ell.ell_bytes("padded", 10, 5, 8, 20, 4) == 8 * 80 + 15 * 4
    assert ell.ell_bytes("rowptr", 10, 5, 8, 20, 4) == 8 * 20 + 4 * 11 + 60


# operators of the BoomerAMG paths on which the card timed K2 in both
# forms (PERF.md section 6): (rows, x length, K, nnz, item size, the
# faster form); the first two are a few hundred rows, where both forms take
# about a launch's floor and the row pointer's one more round of loads
# makes the row-pointer form the slower
MEASURED_FORMS = [
    (397, 397, 89, 14_191, 4, "padded"),          # weak-scaling level 5 A
    (435, 937, 68, 13_788, 8, "padded"),          # gate 3 RS level 3 R
    (41_639, 9_900, 8, 61_041, 4, "rowptr"),      # weak-scaling level 2 P
    (9_900, 41_639, 24, 61_041, 4, "rowptr"),     # weak-scaling level 2 R
    (2_097_152, 170_854, 8, 4_553_759, 4, "rowptr"),   # level 0 P
    (170_854, 170_854, 38, 4_507_720, 4, "rowptr"),    # level 1 A
    (262_144, 21_588, 21, 2_332_657, 8, "rowptr"),     # gate 3 level 0 P
    (262_144, 262_144, 27, 6_859_000, 8, "padded"),    # gate 3 level 0 A
    (170_854, 2_097_152, 27, 4_553_759, 4, "padded")]  # weak-scaling 0 R


@pytest.mark.parametrize("rows, ncols, K, nnz, itemsize, want",
                         MEASURED_FORMS)
def test_form_choice_follows_the_card(rows, ncols, K, nnz, itemsize, want):
    """K2's model (a launch's floor, then the longer of the bytes at the
    form's rate and the longest lane's rounds of loads) keeps the form the
    card measured faster, on small operators near the floor as on large
    ones."""
    form, sec = sharded.ell_form(rows, ncols, K, nnz, itemsize)
    assert form == want, (form, sec)
    floor = sharded.SPMV_MODEL["ell"][form][itemsize][1]
    assert sec >= floor


# gate 3's level-2 P and R at 64^3 (f64): (rows, x length, K, nnz); on the
# card the two forms measured within 1 % of each other, and which was faster
# differed between two cards
FORM_TIES = [(1_507, 131, 71, 46_500), (131, 1_507, 638, 46_500)]


@pytest.mark.parametrize("rows, ncols, K, nnz", FORM_TIES)
def test_form_ties_stay_padded(rows, ncols, K, nnz):
    """Where the model prices the two forms within ``K2_FORM_TIE`` of each
    other, the operator keeps the padded form, ``tpusolve``'s: the model
    cannot tell the forms apart there, and a move must not run slower."""
    t = {f: sharded.ell_model_s(f, rows, ncols, K, nnz, 8) for f in ell.FORMS}
    assert t["rowptr"] * (1 + ell.K2_FORM_TIE) >= t["padded"]
    assert sharded.ell_form(rows, ncols, K, nnz, 8) == ("padded",
                                                        t["padded"])


@pytest.mark.parametrize("rows, nnz, g", [
    (2_097_152, 4_551_468, 1), (170_854, 4_544_672, 8),
    (170_854, 4_509_589, 8), (262_144, 2_332_837, 4), (21_588, 2_331_073, 32),
    (1_507, 279_319, 32), (131, 41_820, 32), (100, 50, 1), (300_000, 100, 1),
    (40_000, 200_000, 4)])
def test_k2_rowptr_plan(rows, nnz, g):
    """G grows until the launch fills K2_FILL_THREADS threads and a lane
    holds at most K2_ROWPTR_LANE_ENTRIES of the mean row's entries, never
    to the mean or past it; on the measured shapes of ``calibrate --k2`` it
    is the fastest G but at 21,588 rows (32, where 16 is 5 % faster).  The
    model's rounds of a lane follow the plan's G."""
    assert ell.k2_rowptr_plan(rows, nnz) == g
    lane = -(-40 // g)      # entries of the longest lane of a 40-entry row
    assert ell.ell_stages("rowptr", rows, 64, nnz, width=40) == \
        -(-lane // ell.K2_STAGE) + 1


def p_like(n, nc, seed, per_row=2.2, width=8):
    """A host CSR like an AMG prolongation: 1 to ``width`` entries a row,
    ``per_row`` on average, columns near i * nc / n."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(1 + rng.poisson(per_row - 1, n), width)
    rows = np.repeat(np.arange(n), counts)
    cols = np.clip(rows * nc // n + rng.integers(-3, 4, rows.size), 0,
                   nc - 1)
    H = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, nc))
    H.sum_duplicates()
    return H


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_rowptr_operator(dtype):
    """A prolongation assembled on the CPU: row-pointer ELL, its entries,
    layout name and width; ``to_scipy``, ``astype``, ``spmv`` and every
    update form, and the prolongation in place, give the padded form's
    bits."""
    from tpusolve_torch.amg import builder
    n, nc = 200_000, 20_000     # enough rows to fill the card either way
    H = p_like(n, nc, seed=2)
    kw = dict(device=CPU, dtype=dtype, row_offsets=np.array([0, n]),
              col_offsets=np.array([0, nc]), allow_bdia=False,
              allow_bell=False)
    A = ShardedMatrix.from_csr_host(H, **kw)
    width = int(np.diff(H.indptr).max())
    assert A.uses_ell and A.uses_ell_rowptr and A.row_width == width
    assert A.layout == f"ELL-RP nnz={H.nnz} W={width}"
    assert A.diag_vals.shape == (1, n, 1)
    assert abs(A.to_scipy() - H.astype(dtype)).max() == 0.0
    # the padded form of the same entries
    pv, pc = rowptr_to_padded(A.ell_rowptr[0], A.ell_vals[0], A.ell_cols[0])
    assert pv.shape == (n, width)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(nc).astype(dtype))
    vec = lambda: torch.from_numpy(rng.standard_normal(n).astype(dtype))
    assert torch.equal(spmv(A, x), ell_spmv_plain(pv, pc, x))
    b, s, c = vec(), vec(), vec()
    for upd in (dict(b=b), dict(b=b, s=s, c=c, w=0.8), dict(s=s, c=c)):
        assert torch.equal(spmv_update(A, x, **upd),
                           ell_spmv_plain(pv, pc, x, **upd))
    prolong, _ = builder._sparse_transfers(A, A)
    ref = torch.add(c, ell_spmv_plain(pv, pc, x))
    assert torch.equal(prolong(x, c, out=c), ref) and torch.equal(c, ref)
    A2 = A.astype(np.float32 if dtype == np.float64 else np.float64)
    assert A2.uses_ell_rowptr and A2.ell_rowptr is A.ell_rowptr
    assert A2.ell_cols is A.ell_cols and A2.row_width == width


def test_rowptr_fields_follow_the_padded_slot_order():
    """Entries given in any order: after the assembly's combining of
    duplicates, each row keeps them in the order the padded form puts them
    in its slots."""
    rng = np.random.default_rng(6)
    n, nc = 150_000, 20_000
    rows = rng.integers(0, n, 330_000)
    cols = rng.integers(0, nc, 330_000)
    key = np.unique(rows * nc + cols)
    rng.shuffle(key)
    rows, cols = key // nc, key % nc
    vals = rng.standard_normal(rows.size)
    kw = dict(device=CPU, row_offsets=np.array([0, n]),
              col_offsets=np.array([0, nc]), allow_bdia=False,
              allow_bell=False)
    A = ShardedMatrix.from_coo((n, nc), rows, cols, vals, **kw)
    assert A.uses_ell_rowptr
    from tpusolve_torch.matrix.coo import dedup_coo
    pad = sharded._ell_compact(A.row_width,
                               *dedup_coo(rows, cols, vals, mode="add"))
    pv = np.zeros(n * A.row_width)
    pv[pad[0]] = pad[1]
    pc = np.zeros(n * A.row_width, np.int32)
    pc[pad[0]] = pad[2]
    rp, rv, rc = padded_to_rowptr(torch.from_numpy(pv.reshape(n, -1)),
                                  torch.from_numpy(pc.reshape(n, -1)))
    assert torch.equal(A.ell_rowptr[0], rp)
    assert torch.equal(A.ell_vals[0], rv) and torch.equal(A.ell_cols[0], rc)


def test_from_arrays_takes_the_cheaper_form(tp):
    """tpusolve's padded ELL of a prolongation, carried over: the port
    keeps its entries in the row-pointer form, and its SpMV equals
    tpusolve's."""
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.mesh import make_mesh
    from test_torch_sharded import tpusolve_fields
    H = p_like(150_000, 12_000, seed=7)
    ro, co = np.array([0, 150_000]), np.array([0, 12_000])
    At = TpMatrix.from_csr_host(make_mesh(1), H, dtype=np.float64,
                                row_offsets=ro, col_offsets=co,
                                allow_bell=False, allow_bdia=False)
    A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
    assert A.uses_ell_rowptr and A.layout.startswith("ELL-RP")
    assert A.row_width == int(np.diff(H.indptr).max())
    assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0
    x = np.random.default_rng(1).standard_normal(12_000)
    ref = np.asarray(tp["spmv"].spmv(At, tp["jnp"].asarray(x)))
    got = spmv(A, torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("width", [9, 128, 129])
def test_width_notes_read_row_width(width):
    """ILU's device path and the AMG generic-ELL device setup's eligibility
    read ``row_width``, the largest count of entries a row has: on an
    operator in either form they decide what they decided on the padded
    width."""
    from tpusolve_torch.amg import device_setup_ell
    from tpusolve_torch.config import BoomerAMGConfig, ILUConfig
    from tpusolve_torch.ilu.device_setup import MAX_ELL_K, device_path
    n = device_setup_ell.MIN_DEVICE_N
    rng = np.random.default_rng(width)
    counts = np.full(n, 3)
    counts[rng.integers(0, n)] = width
    rows = np.repeat(np.arange(n), counts)
    cols = (rows + np.concatenate([np.arange(c) for c in counts])) % n
    vals = rng.standard_normal(rows.size)
    seen = set()
    for allow_ell in (True, False):
        # from BDIA_MIN_NNZ up ELL is the fallback with nothing else allowed
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=CPU,
                                   allow_dia=False, allow_bdia=False,
                                   allow_bell=False, allow_ell=allow_ell)
        assert A.uses_ell and A.row_width == width
        seen.add(A.uses_ell_rowptr)
        assert (device_path(A, ILUConfig()) == "ell") == (
            width <= MAX_ELL_K)
        assert device_setup_ell.eligible(A, BoomerAMGConfig()) == (
            width <= device_setup_ell.MAX_ELL_K)
    assert seen == {True}     # the model stores this operator row-pointer
    if width == 9:
        # the same on the padded form of the same entries
        Ap = dataclass_padded(A)
        assert not Ap.uses_ell_rowptr and Ap.diag_vals.shape[-1] == width
        assert device_path(Ap, ILUConfig()) == device_path(A, ILUConfig())
        assert device_setup_ell.eligible(Ap, BoomerAMGConfig())


def test_width_notes_follow_tpusolves_layout():
    """The gate-4 fixture at 41^3 (68,921 rows, past ILU's device row floor)
    takes K2, but tpusolve lays it out BDIA: ILU's device path and the
    AMG generic-ELL device setup's eligibility decide what they decide on
    the BDIA layout tpusolve gives it (no ELL device path; the AMG setup's
    ELL source then is the host CSR), as before K2 was priced."""
    from tpusolve_torch.amg import device_setup_ell
    from tpusolve_torch.config import BoomerAMGConfig, ILUConfig
    from tpusolve_torch.ilu.device_setup import MAX_ELL_K, MIN_DEVICE_N, \
        device_path
    n, (r, c, v) = _gate4_parts(41)
    kw = dict(device=CPU, dtype=np.float64)
    A = ShardedMatrix.from_coo((n, n), r, c, v, **kw)
    old = ShardedMatrix.from_coo((n, n), r, c, v, allow_ell=False, **kw)
    assert n >= MIN_DEVICE_N and A.row_width <= MAX_ELL_K
    assert A.uses_ell and A.priced_over == "bdia" and old.uses_bdia
    assert device_path(A, ILUConfig()) is device_path(old, ILUConfig()) \
        is None
    cfg = BoomerAMGConfig()
    assert device_setup_ell.eligible(A, cfg) == \
        device_setup_ell.eligible(old, cfg) is False
    H = A.to_scipy()
    assert device_setup_ell.eligible(A, cfg, H) == \
        device_setup_ell.eligible(old, cfg, H)


def dataclass_padded(A):
    """The padded form of row-pointer ELL operator ``A``."""
    import dataclasses
    pv, pc = rowptr_to_padded(A.ell_rowptr[0], A.ell_vals[0], A.ell_cols[0])
    return dataclasses.replace(A, diag_vals=pv[None], diag_cols=pc[None],
                               ell_rowptr=None, ell_vals=None, ell_cols=None)


def test_device_setup_keeps_one_form():
    """Level 0 of the 32^3 stencil set up on the device path (on the CPU):
    P, R and the coarse A each in the form K2's model prices cheaper, with
    their widths, equal to the host pipeline's operators."""
    from tpusolve_torch.amg import builder, device_setup
    from tpusolve_torch.config import BoomerAMGConfig
    from tpusolve_torch.stencil import laplace27
    A, _, _ = laplace27(32, 32, 32, device=CPU, dtype=np.float64)
    cfg = BoomerAMGConfig(max_coarse_size=64, relax_order=1)
    res = device_setup.device_level0(A, cfg)
    pre = builder.boomeramg_setup(A, cfg, device_min_n=None)
    for key, M_h in (("P", pre.levels[0].P), ("R", pre.levels[0].R),
                     ("Ac", pre.levels[1].A)):
        M = res[key]
        H = M.to_scipy()
        nr, nc = M.shape
        K = int(np.diff(H.indptr).max())
        assert M.row_width == K
        want = sharded.ell_form(nr, nc, max(8, -(-K // 8) * 8), M.nnz, 8)[0]
        if key == "Ac":
            assert M.uses_ell
        assert M.uses_ell_rowptr == (want == "rowptr"), (key, M.layout)
        d = abs(H - M_h.to_scipy())
        assert (d.max() if d.nnz else 0.0) <= 1e-12 * abs(H).max()
        print(f"{key}: {M.layout}")
    Ah = res["Ah_c_fn"]()
    assert abs(Ah - res["Ac"].to_scipy()).max() <= 1e-14 * abs(Ah).max()
    assert Ah.has_sorted_indices


def _layout_moves(pre):
    """(level, operator, old layout, new layout) of the hierarchy's
    operators whose layout the assembly's choice without K2 would differ
    from (``allow_ell=False``; P and R were padded ELL)."""
    moves = []
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is None or M.uses_dia:
                continue
            H = M.to_scipy()
            if key == "A":
                old = ShardedMatrix.from_csr_host(
                    H, device=CPU, dtype=np.float64, allow_dia=False,
                    allow_ell=False).layout
            else:
                old = f"ELL K={int(np.diff(H.indptr).max())}"
            if old.split()[0] != M.layout.split()[0]:
                moves.append((i, key, old, M.layout))
    return moves


@pytest.mark.parametrize("case", ["gate3 32", "weakscale 64"])
def test_layout_moves_keep_the_counts(case, tmp_path, capsys):
    """Gate 3's fixture at 32^3 and the weak-scaling YAML at 64^3 through
    the port's CLI with K2 priced among the layouts: the operators that
    moved are printed, and the counts are tpusolve's (12 and 15, as
    tests/test_torch_gate3.py and test_torch_stencil_amg.py hold both CLIs
    to)."""
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import cli
    if case.startswith("gate3"):
        path, want = fixtures.write_gate3(str(tmp_path), 32), 12
    else:
        path, want = str(tmp_path / "ws.yaml"), 15
        shutil.copy(os.path.join(
            REPO, "examples", "weakscale_pcg_boomeramg_devsetup.yaml"), path)
        with open(path) as fh:
            text = fh.read()
        with open(path, "w") as fh:
            fh.write(text.replace(": 128\n", ": 64\n"))
    keep = []
    assert cli.main([path, "--device", "cpu"], keep=keep) == 0
    out = capsys.readouterr().out
    system = keep[0]
    assert "Check solution: PASSED" in out
    assert system.solve_results[0].iters == want
    pre = system._precond
    with capsys.disabled():
        for line in pre.layouts():
            print(f"{case}: {line}")
        for move in _layout_moves(pre):
            print(f"{case}: level {move[0]} {move[1]}: {move[2]} -> "
                  f"{move[3]}")
    for lev in pre.levels:
        if lev.P is not None and not lev.P.uses_dia:
            assert lev.P.uses_ell and lev.R.uses_ell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rows, ncols, K, mean", [
    (20_000, 3_000, 8, 2.2), (3_000, 20_000, 27, 24.0),
    (5_000, 5_000, 40, 26.0), (700, 3000, 131, 60.0),
    (257, 4000, 638, 300.0), (9_000, 9_000, 1, 0.8)])
def test_rowptr_kernels_every_plan_and_form_on_cuda(cuda, rows, ncols, K,
                                                    mean, dtype):
    """The row-pointer kernel at every G and update form against the plain
    version, the same bits on a rerun and as the padded kernel at the same
    G, in place into c too; an int64 row pointer; a view whose entries are
    not 16-byte aligned."""
    vals, cols, v = ragged(rows, ncols, K, mean, dtype, seed=K + 1)
    to = lambda a: torch.from_numpy(a).to(cuda)
    V, C = to(vals), to(cols)
    rp, rv, rc = padded_to_rowptr(V, C)
    x = to(v["x"])
    for form in FORMS:
        kw = kwargs(form, v, to)
        ref = ell_spmv_plain(V, C, x, **kw)
        scale = max(float(ref.abs().max()), 1e-30)
        for g in ell.GROUPS:
            pad = ell_spmv(V, C, x, **kw, groups=g)
            n0 = dict(ell_spmv.launches_by_layout)
            got = ell_spmv(rv, rc, x, **kw, rowptr=rp, groups=g)
            torch.cuda.synchronize()
            assert ell_spmv.launches_by_layout["rowptr"] == \
                n0.get("rowptr", 0) + 1
            err = float((got - ref).abs().max())
            assert err <= RTOL[dtype] * scale, (form, g, err)
            assert torch.equal(got, pad), (form, g)
            assert torch.equal(got, ell_spmv(rv, rc, x, **kw, rowptr=rp,
                                              groups=g))
        if "c" in kw:
            out = kw["c"].clone()
            assert ell_spmv(rv, rc, x, **dict(kw, c=out), rowptr=rp,
                            out=out) is out
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= RTOL[dtype] * scale
    y = ell_spmv(rv, rc, x, rowptr=rp)
    assert torch.equal(ell_spmv(rv, rc, x, rowptr=rp.long()), y)
    # entries shifted by one: their loads are not 16-byte aligned
    rv1 = torch.cat([rv.new_zeros(1), rv])[1:]
    rc1 = torch.cat([rc.new_zeros(1), rc])[1:]
    assert torch.equal(ell_spmv(rv1, rc1, x, rowptr=rp), y)


def _gate4_parts(side):
    """The gate-4 momentum fixture at side^3 after RCM, as one part."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from tpusolve_torch.fixtures import make_system
    from tpusolve_torch.matrix import coo
    rows, cols, vals, _, n = make_system(side, side, side, seed=11,
                                         nonsym=0.35)
    pat = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                        shape=(n, n))
    perm = reverse_cuthill_mckee(pat + pat.T, symmetric_mode=True)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return n, coo.dedup_coo(inv[rows], inv[cols], vals, mode="add")


@pytest.mark.parametrize("case", ["bell", "bdia", "gate4"])
@pytest.mark.parametrize("itemsize", [8, 4])
def test_k2_priced_beside_k4_and_k6(case, itemsize):
    """From BDIA_MIN_NNZ up, K2 in its cheaper form competes with K4 and K6
    on modelled time: the choice is ELL exactly where K2's time is below
    the best of BDIA's and BELL's, and ``allow_ell=False`` gives the choice
    without it (tpusolve's candidates, caps and tie rule).  The gate-4
    fixture's A takes K2 (its rows hold 26.4 of 27 slots)."""
    from test_torch_bell import blocky
    from test_torch_sharded import clustered
    rng = np.random.default_rng(3)
    if case == "gate4":
        n, (r, c, v) = _gate4_parts(24)
    else:
        n = 1500 if case == "bell" else 6000
        r, c, v = (blocky(rng, n, nblk=8, width=40) if case == "bell"
                   else clustered(rng, n))
    parts = [(r, c, v)]
    assert r.size >= sharded.BDIA_MIN_NNZ
    old, plan = sharded.choose_layout(parts, n, n, itemsize, r.size,
                                      allow_ell=False)
    assert old == ("bell" if case == "bell" else "bdia")
    if old == "bdia":
        R, D, nbytes = plan[:3]
        t_old = sharded.spmv_model_s(sharded.SPMV_MODEL["bdia"], nbytes,
                                     sharded.bdia_threads(-(-n // R), R))
    else:
        t_old = sharded.spmv_model_s(
            sharded.SPMV_MODEL["bell"], plan[1],
            sharded.bell_threads(sharded.bell_mod._ngroups(n), plan[0]))
    K = sharded.row_counts_max(parts, [n])
    t_ell = sharded.ell_form(n, n, K, r.size, itemsize)[1]
    kind = sharded.choose_layout(parts, n, n, itemsize, r.size)[0]
    assert kind == ("ell" if t_ell < t_old else old)
    if case == "gate4":
        assert kind == "ell"
    small = sharded.choose_layout([(r[:100], c[:100], v[:100])], n, n,
                                  itemsize, 100)
    assert small == ("ell", None)       # below BDIA_MIN_NNZ: ELL


@pytest.mark.cuda
def test_cli_on_cuda_runs_k2_in_both_forms(cuda, tmp_path):
    """Needs only the card: the 24^3 gate-3 run on CUDA with K2 priced
    among the layouts passes, its levels above the DIA coarsest run K2,
    in both storage forms, and no K4 or K6 launches."""
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels.bdia import bdia_spmv
    from tpusolve_torch.kernels.bell import bell_spmv
    path = fixtures.write_gate3(str(tmp_path), 24)
    for fn in (bdia_spmv, bell_spmv, ell_spmv):
        fn.launches = 0
    ell_spmv.launches_by_layout = {}
    keep = []
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[0].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    pre = keep[0]._precond
    assert all(lev.A.uses_ell or lev.A.uses_dia for lev in pre.levels)
    assert bdia_spmv.launches == bell_spmv.launches == 0
    assert min(ell_spmv.launches_by_layout.get(f, 0)
               for f in ell.FORMS) > 0
