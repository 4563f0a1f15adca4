"""tpusolve_torch BDIA-XL (kernel K5, SpMV by x panels) against tpusolve's.

The port's copy of ``plan_panels`` must equal ``tpusolve``'s; the plain
PyTorch version of K5 must equal ``tpusolve``'s Pallas XL kernel, run in
interpret mode on the same staged inputs (f32 to rtol 1e-5, f64 to 1e-12:
the summation orders differ), and ``bdia_spmv_plain`` on the same layout
exactly.  The layout takes K5 where the time model prices it faster and a
panel fits a block's shared memory, ``astype`` decides again, and
``from_arrays`` runs a ``tpusolve`` XL operator on the port's own step
plan.  On a card, K5 equals K4 bit for bit (marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from tpusolve_torch import runtime
from tpusolve_torch.kernels import bdia
from tpusolve_torch.matrix import sharded
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv
from tpusolve_torch.matrix.vectors import to_device_vector, from_device_vector

CPU = torch.device("cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def banded(rng, n, bw, per_row):
    """``tests/test_bdia.py``'s random band: per-row drifting offsets
    within ``bw`` and a dominant diagonal, unique (row, col)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=n * per_row), 0,
                   n - 1)
    vals = rng.standard_normal(n * per_row)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 4.0 * per_row)])
    _, idx = np.unique(rows * n + cols, return_index=True)
    return rows[idx], cols[idx], vals[idx]


def clustered(rng, n, centers=(-700, 0, 700), drift_amp=40):
    """Mesh-like band (``tests/test_bdia.py``'s ``_clustered``): offset
    clusters whose centers drift slowly, unique (row, col)."""
    rr = np.arange(n, dtype=np.int64)
    drift = (drift_amp * np.sin(rr / (n / 6.0))).astype(np.int64)
    rows, cols = [rr], [rr]
    for base in centers:
        for dd in (-1, 0, 1):
            c = rr + base + drift + dd
            ok = (c >= 0) & (c < n)
            rows.append(rr[ok])
            cols.append(c[ok])
    key = np.unique(np.concatenate(rows) * n + np.concatenate(cols))
    return key // n, key % n, rng.standard_normal(key.size)


def staged(r, c, v, n, R, dtype, D=None, overflow=False):
    """(vals (1, B, D, R), starts (1, B, D) int32, xpad, xlen, ovf) of one
    part, planned by the port (``tpusolve``'s planners, copied)."""
    D = D or bdia.plan_fill_profile(r, c, n, n, R).size
    out = bdia.compact(r, c, v, n, n, R, D, dtype=dtype, overflow=True)
    starts, fi, vo = out[:3]
    B = (n + R - 1) // R
    vals = np.zeros(B * D * R, dtype)
    vals[fi] = vo
    sa, xpad, xlen = bdia.finalize_starts(starts, n, R)
    ovf = None
    if overflow:
        f = sharded._ovf_fields([out[3:]], n, n, dtype, CPU)
        ovf = (f["bdia_ovf_ptr"], f["bdia_ovf_cols"], f["bdia_ovf_vals"])
    return vals.reshape(1, B, D, R), sa[None], xpad, xlen, ovf


def forced_plan(starts, R, xpad, itemsize, gb, device=CPU):
    """The port's step plan at ``gb`` blocks a step, ``((gb, step_lo,
    panel), {"step_b0": ..., "stage": ...})`` with the tables on
    ``device``, or None."""
    plan = bdia.plan_steps(starts, R, xpad, itemsize,
                           lambda g, nsteps, panel, smem: abs(g - gb))
    if plan is None or plan[0] != gb:
        return None
    return ((plan[0], torch.from_numpy(plan[1]).to(device), plan[2]),
            dict(step_b0=torch.from_numpy(plan[3]).to(device),
                 stage=plan[4]))


@pytest.fixture(scope="module")
def tpb():
    pytest.importorskip("jax")
    from tpusolve.kernels import bdia as tp_bdia
    return tp_bdia


class TestPlanner:
    @pytest.mark.parametrize("n", [5000, 3000])
    def test_plan_panels_equals_tpusolve(self, tpb, n):
        """On the banded fixtures of tests/test_bdia.py::TestBdiaXL."""
        rng = np.random.default_rng(1234)
        r, c, v = banded(rng, n, bw=300, per_row=7)
        R = 256
        D = tpb.plan_d(r, c, n, n, R)
        starts = tpb.compact(r, c, v, n, n, R, D, dtype=np.float32)[0]
        sa = tpb.finalize_starts(starts, n, R)[0]
        for gb in (8, 3):
            ours = bdia.plan_panels(sa, R, gb)
            theirs = tpb.plan_panels(sa, R, gb)
            np.testing.assert_array_equal(ours[0], theirs[0])
            assert ours[1:] == theirs[1:]

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_steps_cover_every_window(self, rng, itemsize):
        n, R = 6000, 128
        r, c, v = clustered(rng, n)
        _, starts, xpad, _, _ = staged(r, c, v, n, R, np.float64)
        B = starts.shape[1]
        for gb in (1, 5, 16, B):
            (gb_, step_lo, panel), kw = forced_plan(starts, R, xpad,
                                                    itemsize, gb)
            lo = step_lo.numpy()
            assert lo.shape == (1, -(-B // gb))
            assert kw["step_b0"].numpy().tolist() == [
                list(range(0, B, gb)) + [B]]
            assert panel % bdia.XL_ALIGN == 0
            assert not (lo % bdia.XL_ALIGN).any()
            s = starts[0].astype(np.int64) - xpad
            off = s - lo[0][np.arange(B) // gb][:, None]
            assert off.min() >= 0 and off.max() + R <= panel
            assert bdia.xl_smem_bytes(panel, gb, s.shape[1], itemsize) \
                <= runtime.SMEM_PER_BLOCK

    def test_no_plan_when_no_panel_fits(self, rng, monkeypatch):
        n, R = 6000, 128
        r, c, v = clustered(rng, n)
        _, starts, xpad, _, _ = staged(r, c, v, n, R, np.float64)
        assert bdia.plan_steps(starts, R, xpad, 8, lambda *a: 0) is not None
        monkeypatch.setattr(runtime, "SMEM_PER_BLOCK", 8 * 1024)
        assert bdia.plan_steps(starts, R, xpad, 8, lambda *a: 0) is None


class TestPlainAgainstTpusolve:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_plain_equals_pallas_xl_interpret(self, tpb, dtype):
        import jax
        import jax.numpy as jnp
        rng = np.random.default_rng(21)
        n, R = 3000, 256
        r, c, v = banded(rng, n, bw=300, per_row=7)
        vals, starts, xpad, xlen, _ = staged(r, c, v, n, R, dtype)
        x = rng.standard_normal(n).astype(dtype)
        rowstart, pxrows, xrows_min = tpb.plan_panels(starts[0], R)
        xrows = max((xlen + tpb.LANE - 1) // tpb.LANE + R // tpb.LANE + 1,
                    xrows_min)
        with jax.enable_x64(True):
            ref = np.asarray(tpb.bdia_spmv_pallas_xl(
                jnp.asarray(vals[0]), jnp.asarray(starts[0]),
                jnp.asarray(rowstart), pxrows, xrows, jnp.asarray(x), xpad,
                xlen, n, interpret=True))
        assert ref.dtype == dtype
        args = (torch.from_numpy(vals), torch.from_numpy(starts),
                torch.from_numpy(x))
        y4 = bdia.bdia_spmv_plain(*args, xpad, xlen, n)
        mask = bdia.segment_mask(args[0])
        for gb in (1, 5, 12):
            plan, kw = forced_plan(starts, R, xpad, np.dtype(dtype).itemsize,
                                   gb)
            y = bdia.bdia_spmv_xl_plain(*args, xpad, n, *plan, mask=mask,
                                        **kw)
            np.testing.assert_allclose(y.numpy(), ref, rtol=RTOL[dtype],
                                       atol=RTOL[dtype] * np.abs(ref).max())
            assert torch.equal(y, y4)

    def test_plain_with_overflow_equals_scipy(self, rng):
        import scipy.sparse as sp
        n, R = 5000, 128
        r, c, v = banded(rng, n, bw=60, per_row=9)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, np.float64,
                                               D=12, overflow=True)
        assert int(ovf[0][0, -1]) > 0
        x = torch.from_numpy(rng.standard_normal(n))
        plan, kw = forced_plan(starts, R, xpad, 8, 4)
        args = (torch.from_numpy(vals), torch.from_numpy(starts), x, xpad, n,
                *plan, ovf)
        kw["mask"] = bdia.segment_mask(args[0])
        before = bdia.bdia_spmv_xl.launches
        y = bdia.bdia_spmv_xl(*args, **kw)   # CPU tensors: the plain version
        assert bdia.bdia_spmv_xl.launches == before
        assert torch.equal(y, bdia.bdia_spmv_xl_plain(*args, **kw))
        assert torch.equal(y, bdia.bdia_spmv_plain(
            torch.from_numpy(vals), torch.from_numpy(starts), x, xpad, xlen,
            n, ovf))
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x.numpy()
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_window_outside_panel_raises(self, rng):
        n, R = 3000, 128
        r, c, v = clustered(rng, n, centers=(-300, 0, 300), drift_amp=10)
        vals, starts, xpad, _, _ = staged(r, c, v, n, R, np.float64)
        (gb, step_lo, panel), kw = forced_plan(starts, R, xpad, 8, 4)
        vt = torch.from_numpy(vals)
        with pytest.raises(ValueError, match="panel"):
            bdia.bdia_spmv_xl_plain(
                vt, torch.from_numpy(starts),
                torch.zeros(n, dtype=torch.float64), xpad, n, gb, step_lo,
                panel - bdia.XL_ALIGN, mask=bdia.segment_mask(vt), **kw)


def k4_priced_slow(monkeypatch):
    """Make the model price K4 ten times slower on a band, so that a small
    operator takes K5 where a panel fits."""
    for size in (4, 8):
        monkeypatch.setitem(sharded.BAND_RATE, ("bdia", size),
                            sharded.BAND_RATE["bdia", size] / 10)


class TestLayout:
    @pytest.mark.parametrize("slow_k4", [False, True])
    def test_xl_taken_where_the_model_prices_it_faster(self, rng,
                                                       monkeypatch, slow_k4):
        if slow_k4:
            k4_priced_slow(monkeypatch)
        n = 60_000
        r, c, v = clustered(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        _, B, D, R = A.bdia_vals.shape
        k = 0 if A.bdia_ovf_ptr is None else int(A.bdia_ovf_ptr[0, -1])
        nbytes = sharded.bdia_bytes(B, D, R, k, 8)
        xl = sharded.plan_xl(A.bdia_starts.numpy(), R, A.bdia_xpad, 8,
                             nbytes, A.bdia_live, A.xl_work())
        t4 = sharded.k4_model_s(8, nbytes, 1, B, D, R)
        assert xl is not None
        assert A.uses_bdia_xl == (xl[5] < t4) == slow_k4, A.layout
        if not slow_k4:
            assert A.layout.startswith("BDIA R=")
            return
        assert A.layout.startswith("BDIA-XL")
        assert (A.bdia_gb, A.bdia_panel) == (xl[0], xl[2])
        np.testing.assert_array_equal(A.bdia_step_lo.numpy(), xl[1])
        S = A.to_scipy()
        x = rng.standard_normal(n)
        y = from_device_vector(spmv(A, to_device_vector(
            x, A.col_offsets, A.col_pad, CPU)), A.row_offsets, A.row_pad)
        np.testing.assert_allclose(y, S @ x, rtol=1e-12,
                                   atol=1e-12 * np.abs(S @ x).max())

    def test_panel_too_large_stays_k4_and_astype_decides_again(self, rng):
        """A band 40,000 wide: no f64 panel fits 232,448 bytes, so K4; the
        f32 twin's panels fit and it decides by the model again."""
        n = 100_000
        r, c, v = clustered(rng, n, centers=(-20_000, 0, 20_000),
                            drift_amp=20)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        _, B, D, R = A.bdia_vals.shape
        k = 0 if A.bdia_ovf_ptr is None else int(A.bdia_ovf_ptr[0, -1])
        starts = A.bdia_starts.numpy()
        assert A.uses_bdia and not A.uses_bdia_xl
        assert sharded.plan_xl(starts, R, A.bdia_xpad, 8, sharded.bdia_bytes(
            B, D, R, k, 8)) is None
        A32 = A.astype(np.float32)
        want = sharded.choose_xl(starts, R, A.bdia_xpad, 4,
                                 sharded.bdia_bytes(B, D, R, k, 4),
                                 A32.bdia_live, A32.xl_work())
        assert sharded.plan_xl(starts, R, A.bdia_xpad, 4, sharded.bdia_bytes(
            B, D, R, k, 4)) is not None
        assert A32.uses_bdia_xl == (want is not None)
        if want is not None:
            assert (A32.bdia_gb, A32.bdia_panel) == (want[0], want[2])
        assert A32.bdia_starts is A.bdia_starts
        # and back: the f64 operator of an XL f32 one runs K4
        assert not A32.astype(np.float64).uses_bdia_xl


def _tpusolve_arrays(A):
    """(arrays, meta) of a one-part tpusolve ShardedMatrix, XL fields
    included, for ``ShardedMatrix.from_arrays``."""
    keys = ("bdia_vals", "bdia_starts", "bdia_ovf_rows", "bdia_ovf_cols",
            "bdia_ovf_vals", "bell_vals", "bell_ids", "diag_vals",
            "diag_cols", "diag", "bdia_rowstart")
    arrays = {k: (None if getattr(A, k) is None else np.asarray(getattr(A, k)))
              for k in keys}
    meta = dict(shape=A.shape, row_offsets=A.row_offsets,
                col_offsets=A.col_offsets, row_pad=A.row_pad,
                col_pad=A.col_pad, nnz=A.nnz, bdia_block=A.bdia_block,
                bdia_xpad=A.bdia_xpad, bdia_xlen=A.bdia_xlen,
                bell_nwin=A.bell_nwin, has_offd=A.has_offd,
                uses_dia=A.uses_dia)
    return arrays, meta


def test_from_arrays_runs_a_tpusolve_xl_operator(rng, monkeypatch):
    """tpusolve's XL layout (x over its shrunk VMEM budget, as
    tests/test_bdia.py:262 builds it) through both packages' spmv."""
    pytest.importorskip("jax")
    from tpusolve.mesh import make_mesh
    from tpusolve.matrix import sharded as tp_sharded, vectors as tp_vectors
    from tpusolve.matrix.spmv import spmv as tp_spmv
    monkeypatch.setattr(tp_sharded, "BDIA_VMEM_BUDGET", 1 << 19)
    n = 80_000
    r, c, v = clustered(rng, n)
    mesh = make_mesh(1)
    At = tp_sharded.ShardedMatrix.from_coo(mesh, (n, n), r, c, v,
                                           dtype=np.float64, allow_dia=False,
                                           allow_bell=False)
    assert At.uses_bdia and At.bdia_rowstart is not None, "XL plan expected"
    A = ShardedMatrix.from_arrays(*_tpusolve_arrays(At), device=CPU)
    assert A.uses_bdia_xl and A.layout.startswith("BDIA-XL")
    assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0
    x = rng.standard_normal(n)
    xt = tp_vectors.to_device_vector(mesh, x, At.col_offsets, At.col_pad,
                                     dtype=np.float64)
    y_tp = tp_vectors.from_device_vector(np.asarray(tp_spmv(At, xt)),
                                         At.row_offsets, At.row_pad)
    y = from_device_vector(spmv(A, to_device_vector(
        x, A.col_offsets, A.col_pad, CPU)), A.row_offsets, A.row_pad)
    np.testing.assert_allclose(y, y_tp, rtol=1e-12,
                               atol=1e-12 * np.abs(y_tp).max())


def test_gate4_factors_take_xl_from_62(monkeypatch):
    """The slice: gate 4's ILU factors, as its ``mixed`` run builds them (f32
    twin of the RCM-ordered fixture, host Chow-Patel ILU(0)), at 62^3, the
    smallest side where they took BDIA-XL with the previous K4 and its
    constants.  A K5 step plan fits their shared memory, and the model
    prices K5 on the bytes it reads (the segments its mask keeps: a third of
    the factors' segments are all zero) below K4 on every slot value, so
    they run K5 (the choice is the same on the CPU and the card); in f64
    too, and A, on the bytes its own mask keeps, where the model says so.
    A CLI run at that side takes too long on a CPU: the CLI comparison with
    tpusolve runs at 16^3 (tests/test_torch_slice.py).  K2 is priced out of
    the layout choice here, which holds the K4 and K5 planners
    (tests/test_torch_ell_rowptr.py holds the choice with it)."""
    from test_torch_sharded import k2_priced_out
    k2_priced_out(monkeypatch)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from tpusolve_torch.fixtures import make_system
    from tpusolve_torch.ilu.ilu import ilu_setup
    side = 62
    rows, cols, vals, _, n = make_system(side, side, side, seed=11,
                                         nonsym=0.35)
    pat = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                        shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(pat + pat.T,
                                            symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    r, c = inv[rows], inv[cols]
    A = ShardedMatrix.from_coo((n, n), r, c, vals, device=CPU)
    pre = ilu_setup(A.astype(np.float32),
                    A_host=sp.csr_matrix((vals, (r, c)), shape=(n, n)))
    for M in (pre.L, pre.U):
        assert M.uses_bdia_xl and M.layout.startswith("BDIA-XL R="), \
            M.layout
        _, B, D, R = M.bdia_vals.shape
        k = int(M.bdia_ovf_ptr[0, -1])
        starts = M.bdia_starts.numpy()
        assert M.bdia_live < 0.7 * B * D * R // 32
        nbytes = sharded.bdia_bytes(B, D, R, k, 4)
        xl = sharded.plan_xl(starts, R, M.bdia_xpad, 4, nbytes, M.bdia_live,
                             M.xl_work())
        assert xl is not None
        assert xl[5] < sharded.k4_model_s(4, nbytes, 1, B, D, R)
        assert (M.bdia_gb, M.bdia_panel, M.bdia_stage) == \
            (xl[0], xl[2], xl[4])
        M64 = M.astype(np.float64)
        assert M64.uses_bdia_xl == (sharded.choose_xl(
            starts, R, M.bdia_xpad, 8, sharded.bdia_bytes(B, D, R, k, 8),
            M64.bdia_live, M64.xl_work()) is not None) is True
    assert A.uses_bdia_xl == (A.with_kernel().bdia_step_lo is not None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
class TestCudaKernel:
    """Needs only the card: no JAX and no conftest fixture (the card's
    machine runs these with ``--noconftest``)."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("gb", [1, 7, 32])
    def test_kernel_equals_plain_and_k4(self, cuda, dtype, gb):
        rng = np.random.default_rng(7)
        n, R = 40_000, 128
        r, c, v = banded(rng, n, bw=400, per_row=9)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, dtype, D=24,
                                               overflow=True)
        assert int(ovf[0][0, -1]) > 0
        (gb, step_lo, panel), kw = forced_plan(
            starts, R, xpad, np.dtype(dtype).itemsize, gb, cuda)
        ovf = tuple(t.to(cuda) for t in ovf)
        vt, st = torch.from_numpy(vals).to(cuda), torch.from_numpy(
            starts).to(cuda)
        kw["mask"] = bdia.segment_mask(vt)
        x = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(cuda)
        buf = torch.empty(n + 1, dtype=x.dtype, device=cuda)
        buf[1:] = x
        args = (vt, st, x, xpad, n, gb, step_lo, panel, ovf)
        before = bdia.bdia_spmv_xl.launches
        y = bdia.bdia_spmv_xl(*args, **kw)
        y_u = bdia.bdia_spmv_xl(vt, st, buf[1:], xpad, n, gb, step_lo, panel,
                                ovf, **kw)
        torch.cuda.synchronize()
        assert bdia.bdia_spmv_xl.launches == before + 2
        ref = bdia.bdia_spmv_xl_plain(*args, **kw)
        assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]
        y4 = bdia.bdia_spmv(vt, st, x, xpad, xlen, n, ovf)
        assert torch.equal(y, y4) and torch.equal(y_u, y4)

    def test_spmv_on_xl_layout_matches_scipy(self, cuda, monkeypatch):
        k4_priced_slow(monkeypatch)
        rng = np.random.default_rng(8)
        n = 60_000
        r, c, v = clustered(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=cuda)
        assert A.uses_bdia_xl, A.layout
        x = rng.standard_normal(n)
        y = spmv(A, torch.from_numpy(x).to(cuda)).cpu().numpy()
        ref = A.to_scipy() @ x
        np.testing.assert_allclose(y, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_bad_arguments_raise(self, cuda):
        vals = torch.zeros((1, 2, 1, 128), dtype=torch.float32, device=cuda)
        starts = torch.zeros((1, 2, 1), dtype=torch.int32, device=cuda)
        x = torch.zeros(256, dtype=torch.float32, device=cuda)
        lo = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
        mask = bdia.segment_mask(vals)
        b0 = lambda *s: torch.tensor([s], dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError, match="step_lo"):
            bdia.bdia_spmv_xl(vals, starts, x, 0, 256, 1, lo, 256, mask=mask,
                              step_b0=b0(0, 1, 2))
        with pytest.raises(ValueError, match="does not fit"):
            bdia.bdia_spmv_xl(vals, starts, x, 0, 256, 2, lo, 1 << 20,
                              mask=mask, step_b0=b0(0, 2))
