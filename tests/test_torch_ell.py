"""K2, the padded-ELL SpMV (``kernels/ell.py``), against tpusolve's
``ell_spmv_local`` and against the eager expressions it replaces.

The same numpy inputs (a seed) go through both packages: random padded-ELL
blocks, square and rectangular, in f32 and f64, plain and in every update
form ``c + w * s * (b - A x)``, and tpusolve's ``_offd_add`` ghost term
``y + ell(ov, oc, ghosts)`` as the accumulate form (``c = y``, ``w = -1``),
to 1e-12 relative in f64 and 1e-5 in f32 (the row sums are taken in
another order).  tpusolve's own AMG transfers, carried over by
``hierarchy_from_arrays``, give its products and its prolongation
``x + P e``.  On the CPU the wrapper runs the plain version and counts no
launch, and ``spmv``, ``spmv_update`` and the AMG prolongation give the
bits of the eager code they replace.  The launch plan ``k2_plan`` is pure
Python.  The CUDA cases hold K2 at every threads-a-row count and every
form, in place too, against the plain version; they skip without a card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import builder
from tpusolve_torch.kernels import ell
from tpusolve_torch.kernels.dia import epilogue_plain
from tpusolve_torch.kernels.ell import ell_spmv, ell_spmv_plain, k2_plan
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update

CPU = torch.device("cpu")
RTOL = {np.float32: 1e-5, np.float64: 1e-12}

# form: keyword arguments of the update, as names of the vectors
FORMS = {
    "Ax": {},
    "residual": dict(b="b"),
    "jacobi": dict(b="b", s="s", c="c", w=1.0),
    "weighted jacobi": dict(b="b", s="s", c="c", w=0.8),
    "chebyshev first": dict(b="b", s="s"),
    "chebyshev next": dict(s="s", c="c"),
    "accumulate": dict(c="c", w=-1.0),
}


def block(rows, ncols, K, dtype, seed, fill=0.7):
    """A random padded-ELL block: each row holds up to K entries (about
    ``fill`` of the slots, the rest padded: value 0, column 0), the last
    rows fully padded; and vectors x (ncols,), b, s, c (rows,)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, ncols, (rows, K)).astype(np.int32)
    vals = rng.standard_normal((rows, K)).astype(dtype)
    pad = rng.random((rows, K)) > fill
    pad[-max(1, rows // 16):] = True
    cols[pad] = 0
    vals[pad] = 0
    vecs = dict(x=rng.standard_normal(ncols).astype(dtype),
                **{k: rng.standard_normal(rows).astype(dtype)
                   for k in ("b", "s", "c")})
    return vals, cols, vecs


def kwargs(form, vecs, to=torch.from_numpy):
    return {k: (v if k == "w" else to(vecs[v]))
            for k, v in FORMS[form].items()}


@pytest.fixture(scope="module")
def tp():
    import importlib
    jax = pytest.importorskip("jax")
    return dict(jax=jax, jnp=jax.numpy,
                spmv=importlib.import_module("tpusolve.matrix.spmv"))


def tp_form(tp, vals, cols, vecs, form):
    """tpusolve's ``ell_spmv_local``, then the update in jnp in the order
    of ``epilogue_plain``."""
    jnp = tp["jnp"]
    y = tp["spmv"].ell_spmv_local(jnp.asarray(vals), jnp.asarray(cols),
                                  jnp.asarray(vecs["x"]))
    kw = FORMS[form]
    if not kw:
        return np.asarray(y)
    b = None if "b" not in kw else jnp.asarray(vecs["b"])
    s = None if "s" not in kw else jnp.asarray(vecs["s"])
    c = None if "c" not in kw else jnp.asarray(vecs["c"])
    w = kw.get("w", 1.0)
    t = y if b is None else b - y
    t = (s if w == 1.0 else w * s) * t if s is not None else (
        w * t if w != 1.0 else t)
    if c is None:
        return np.asarray(t if b is not None else -t)
    return np.asarray(c + t if b is not None else c - t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("rows, ncols, K", [(300, 300, 1), (257, 257, 27),
                                            (400, 90, 5), (60, 500, 40)])
def test_plain_equals_tpusolve(tp, rows, ncols, K, form, dtype):
    vals, cols, v = block(rows, ncols, K, dtype, seed=rows + K)
    got = ell_spmv_plain(torch.from_numpy(vals), torch.from_numpy(cols),
                         torch.from_numpy(v["x"]), **kwargs(form, v)).numpy()
    ref = tp_form(tp, vals, cols, v, form)
    assert got.dtype == ref.dtype == dtype
    assert np.abs(got - ref).max() <= RTOL[dtype] * np.abs(ref).max()
    pad = max(1, rows // 16)
    if not FORMS[form]:
        assert not got[-pad:].any()     # padded rows stay zero


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_offd_ghost_term_is_the_accumulate_form(tp, dtype):
    """tpusolve's ``_offd_add`` adds ``ell_spmv_local(ov, oc, ghosts)`` to
    the interior product: K2's form ``c - w * (A g)`` with ``c = y``,
    ``w = -1``."""
    ov, oc, v = block(200, 37, 6, dtype, seed=3, fill=0.3)
    jnp = tp["jnp"]
    ref = np.asarray(jnp.asarray(v["c"]) + tp["spmv"].ell_spmv_local(
        jnp.asarray(ov), jnp.asarray(oc), jnp.asarray(v["x"])))
    y = torch.from_numpy(v["c"].copy())
    got = ell_spmv(torch.from_numpy(ov), torch.from_numpy(oc),
                   torch.from_numpy(v["x"]), c=y, w=-1.0, out=y)
    assert got is y
    assert np.abs(y.numpy() - ref).max() <= RTOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_wrapper_is_the_eager_chain(form):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; ``spmv``/``spmv_update`` on an ELL operator give the bits of
    the eager ``spmv`` + ``epilogue_plain`` chain they replaced."""
    vals, cols, v = block(128, 128, 9, np.float64, seed=5)
    H = sp.csr_matrix((vals.ravel(), cols.ravel(),
                       np.arange(0, vals.size + 1, 9)), shape=(128, 128))
    H.sum_duplicates()
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                    allow_dia=False, allow_bdia=False,
                                    allow_bell=False)
    assert A.uses_ell and A.layout.startswith("ELL")
    x = torch.from_numpy(v["x"])
    dv, dc = A.diag_vals[0], A.diag_cols[0]
    eager = (dv * x.index_select(0, dc.reshape(-1)).reshape(dc.shape)
             ).sum(dim=-1)
    n0 = ell_spmv.launches
    assert torch.equal(spmv(A, x), eager)
    kw = kwargs(form, v)
    ref = epilogue_plain(eager, kw.get("b"), kw.get("s"), kw.get("c"),
                         kw.get("w", 1.0)) if kw else eager
    assert torch.equal(ell_spmv(dv, dc, x, **kw), ref)
    if kw:
        assert torch.equal(spmv_update(A, x, **kw), ref)
    assert ell_spmv.launches == n0


def test_transfers_of_tpusolve_hierarchy(tp):
    """tpusolve's own AMG hierarchy (gate 3's settings on a 12^3 pressure
    fixture), carried over by ``hierarchy_from_arrays``: every P and R
    product, and the prolongation ``x + P e`` written into x in place,
    agree with tpusolve's ``spmv`` to 1e-12; the cycle's transfers run on
    the ELL layout."""
    from test_torch_amg import GATE3, carried, gate3_csr
    from tpusolve.amg import builder as tb
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.mesh import make_mesh
    A12 = gate3_csr(12)
    At = TpMatrix.from_csr_host(make_mesh(1), A12, dtype=np.float64)
    pre_t = tb.boomeramg_setup(At, TpConfig(**GATE3), A_host=A12)
    pre = carried(pre_t, GATE3)
    rng = np.random.default_rng(8)
    jnp = tp["jnp"]
    checked = 0
    for lev, lev_t in zip(pre.levels[:-1], pre_t.levels[:-1]):
        assert lev.P.uses_ell and lev.R.uses_ell
        for M, M_t in ((lev.P, lev_t.P), (lev.R, lev_t.R)):
            x = rng.standard_normal(M.col_pad)
            ref = np.asarray(tp["spmv"].spmv(M_t, jnp.asarray(x)))
            got = spmv(M, torch.from_numpy(x)).numpy()
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
        e = rng.standard_normal(lev.P.col_pad)
        xf = rng.standard_normal(lev.P.row_pad)
        ref = xf + np.asarray(tp["spmv"].spmv(lev_t.P, jnp.asarray(e)))
        x = torch.from_numpy(xf.copy())
        assert lev.prolong(torch.from_numpy(e), x, out=x) is x
        assert np.abs(x.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
        checked += 1
    assert checked >= 2


def test_prolongation_bits_unchanged():
    """The prolongation as one update form gives the bits of the eager
    ``torch.add(x, spmv(P, e), out=x)`` it replaced."""
    vals, cols, v = block(96, 40, 4, np.float64, seed=9)
    H = sp.csr_matrix((vals.ravel(), cols.ravel(),
                       np.arange(0, vals.size + 1, 4)), shape=(96, 40))
    H.sum_duplicates()
    P = ShardedMatrix.from_csr_host(
        H, device=CPU, dtype=np.float64, row_offsets=np.array([0, 96]),
        col_offsets=np.array([0, 40]), allow_bdia=False, allow_bell=False)
    prolong, restrict = builder._sparse_transfers(P, P)
    e = torch.from_numpy(v["x"])
    x = torch.from_numpy(v["c"].copy())
    ref = torch.add(x, spmv(P, e))
    assert torch.equal(prolong(e, x, out=x), ref) and torch.equal(x, ref)
    assert torch.equal(prolong(e, torch.from_numpy(v["c"])), ref)


@pytest.mark.parametrize("rows, K, g", [
    (2_097_152, 8, 2), (2_097_152, 27, 8), (170_854, 40, 8), (41_639, 9, 4),
    (397, 89, 32), (9_900, 24, 16), (100, 1, 1), (300_000, 2, 1),
    (131_072, 3, 1), (1_000, 638, 32), (21_588, 123, 32), (40_000, 5, 4)])
def test_k2_plan(rows, K, g):
    """G grows until the launch fills K2_FILL_THREADS threads and each lane
    holds at most K2_LANE_SLOTS slots, never past the power of two that
    reaches K."""
    assert k2_plan(rows, K) == g
    assert g in ell.GROUPS


def test_wrapper_checks_before_the_device():
    """Meta tensors run every check: bad inputs raise the check's error, good
    ones stop at the device."""
    meta = torch.device("meta")
    vals = torch.empty((8, 3), dtype=torch.float32, device=meta)
    cols = torch.empty((8, 3), dtype=torch.int32, device=meta)
    x = torch.empty(5, dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ell_spmv(vals, cols, x)
    with pytest.raises(TypeError, match="int32"):
        ell_spmv(vals, cols.long(), x)
    with pytest.raises(TypeError, match="dtype"):
        ell_spmv(vals.double(), cols, x)
    with pytest.raises(TypeError, match=r"\(8,\)"):
        ell_spmv(vals, cols, x, b=x)
    with pytest.raises(ValueError, match="groups"):
        ell_spmv(vals, cols, x, groups=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rows, ncols, K", [(5000, 5000, 1), (3001, 800, 8),
                                            (2000, 2000, 40),
                                            (700, 3000, 131),
                                            (257, 4000, 638)])
def test_k2_every_group_and_form_on_cuda(cuda, rows, ncols, K, dtype):
    vals, cols, v = block(rows, ncols, K, dtype, seed=K)
    to = lambda a: torch.from_numpy(a).to(cuda)
    V, C = to(vals), to(cols)
    for form in FORMS:
        kw = kwargs(form, v, to)
        ref = ell_spmv_plain(V, C, to(v["x"]), **kw)
        scale = float(ref.abs().max())
        for g in ell.GROUPS:
            n0 = ell_spmv.launches
            got = ell_spmv(V, C, to(v["x"]), **kw, groups=g)
            torch.cuda.synchronize()
            assert ell_spmv.launches == n0 + 1
            err = float((got - ref).abs().max())
            assert err <= RTOL[dtype] * scale, (form, g, err)
            assert torch.equal(got, ell_spmv(V, C, to(v["x"]), **kw,
                                             groups=g))
        if "c" in kw:
            out = kw["c"].clone()
            kw_in = dict(kw, c=out)
            assert ell_spmv(V, C, to(v["x"]), **kw_in, out=out) is out
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= RTOL[dtype] * scale
