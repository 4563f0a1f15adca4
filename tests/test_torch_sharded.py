"""tpusolve_torch ShardedMatrix and SpMV against scipy and against tpusolve.

Same numpy inputs through both packages on one part: BDIA selection, the
overflow list, the ELL fallback, SpMV values (f64 to 1e-12 relative) and
the layout carried over from tpusolve by ``ShardedMatrix.from_arrays``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.matrix.sharded import ShardedMatrix, plan_bdia, bdia_bytes
from tpusolve_torch.matrix.spmv import spmv
from tpusolve_torch.matrix.vectors import (
    from_device_vector, pad_vector, to_device_vector, unpad_vector)

CPU = torch.device("cpu")
FIELDS = ("bdia_vals", "bdia_starts", "bdia_ovf_rows", "bdia_ovf_cols",
          "bdia_ovf_vals", "bell_vals", "bell_ids", "diag_vals", "diag_cols",
          "diag", "dia_vals")


def tpusolve_fields(A):
    """(arrays, meta) of a one-part tpusolve ShardedMatrix, fetched as numpy
    for ``tpusolve_torch.ShardedMatrix.from_arrays``."""
    arrays = {k: (None if getattr(A, k) is None else np.asarray(getattr(A, k)))
              for k in FIELDS}
    meta = dict(shape=A.shape, row_offsets=A.row_offsets,
                col_offsets=A.col_offsets, row_pad=A.row_pad,
                col_pad=A.col_pad, nnz=A.nnz, bdia_block=A.bdia_block,
                bdia_xpad=A.bdia_xpad, bdia_xlen=A.bdia_xlen,
                bell_nwin=A.bell_nwin, has_offd=A.has_offd,
                uses_dia=A.uses_dia, dia_offsets=A.dia_offsets,
                dia_shape=A.dia_shape)
    return arrays, meta


def clustered(rng, n, centers=(-300, 0, 300), drift_amp=20):
    """Mesh-like band: a few offset clusters drifting slowly (post-RCM
    shape), unique (row, col)."""
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


def clipped(rng, n):
    """Band clipped at the boundary: the first and last blocks fan out to
    many offsets, which the overflow list takes."""
    rr = np.arange(n, dtype=np.int64)
    cols = [np.clip(rr + base + dd, 0, n - 1)
            for base in (-400, 0, 400) for dd in (-1, 0, 1)]
    key = np.unique(np.tile(rr, 10) * n + np.concatenate(cols + [rr]))
    return key // n, key % n, rng.standard_normal(key.size)


@pytest.fixture(scope="module")
def tp():
    """tpusolve's matrix modules and a one-device mesh (skips without jax)."""
    pytest.importorskip("jax")
    from tpusolve.mesh import make_mesh
    from tpusolve.matrix import sharded, vectors
    from tpusolve.matrix.spmv import spmv as tp_spmv
    return dict(mesh=make_mesh(1), ShardedMatrix=sharded.ShardedMatrix,
                spmv=tp_spmv, vectors=vectors)


def _spmv_np(A, x):
    xd = to_device_vector(x, A.col_offsets, A.col_pad, CPU, dtype=np.float64)
    return from_device_vector(spmv(A, xd), A.row_offsets, A.row_pad)


class TestLayoutSelection:
    def test_bdia_selected_for_band_and_matches_scipy(self, rng):
        n = 6000
        r, c, v = clustered(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        assert A.uses_bdia and A.bdia_block in (128, 256, 512, 1024, 2048)
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(_spmv_np(A, x), S @ x, rtol=1e-12,
                                   atol=1e-12)
        assert abs(A.to_scipy() - S).max() == 0.0

    def test_overflow_list_spills_and_matches_scipy(self, rng):
        n = 20_000
        r, c, v = clipped(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        assert A.uses_bdia and A.bdia_ovf_vals is not None
        ptr = A.bdia_ovf_ptr[0]
        k = int(ptr[-1])
        assert 0 < k <= max(4096, r.size // 8)
        assert ptr.shape == (A.row_pad + 1,) and int(ptr[0]) == 0
        assert bool((ptr[1:] >= ptr[:-1]).all())
        assert A.bdia_ovf_cols.shape == A.bdia_ovf_vals.shape == (1, k)
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(_spmv_np(A, x), S @ x, rtol=1e-12,
                                   atol=1e-12)
        assert abs(A.to_scipy() - S).max() == 0.0

    @pytest.mark.parametrize("case", ["small", "disabled"])
    def test_ell_fallback(self, rng, case):
        n = 1000 if case == "small" else 6000
        r, c, v = clustered(rng, n, centers=(-30, 0, 30), drift_amp=3)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU,
                                   allow_bdia=case != "disabled",
                                   allow_bell=case != "disabled")
        assert not A.uses_bdia
        assert A.diag_vals.shape[-1] == np.bincount(r).max()
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        x = rng.standard_normal(n)
        np.testing.assert_allclose(_spmv_np(A, x), S @ x, rtol=1e-12,
                                   atol=1e-12)

    def test_plan_minimises_modelled_bytes(self, rng):
        """The chosen (R, D) moves no more bytes than any other admissible
        pair with the same overflow cap."""
        from tpusolve_torch.kernels import bdia
        n = 8000
        r, c, v = clustered(rng, n)
        parts = [(r, c, v)]
        R, D, nbytes = plan_bdia(parts, n, n, 8, r.size)
        best = None
        for R2 in bdia.BLOCK_SIZES:
            prof = bdia.plan_fill_profile(r, c, n, n, R2)
            B2 = (n + R2 - 1) // R2
            for D2 in range(1, len(prof) + 1):
                k = int(prof[D2:].sum())
                if k <= max(4096, r.size // 8):
                    b = bdia_bytes(B2, D2, R2, k, 8)
                    best = b if best is None else min(best, b)
        prof = bdia.plan_fill_profile(r, c, n, n, R)
        assert bdia_bytes((n + R - 1) // R, D, R, int(prof[D:].sum()),
                          8) == best == nbytes

    def test_multipart_not_ported(self, rng):
        r, c, v = clustered(rng, 100, centers=(0,))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ShardedMatrix.from_coo((100, 100), r, c, v, device=CPU,
                                   row_offsets=[0, 50, 100])


class TestAgainstTpusolve:
    def test_spmv_equals_tpusolve(self, tp, rng):
        n = 20_000
        r, c, v = clipped(rng, n)
        At = tp["ShardedMatrix"].from_coo(tp["mesh"], (n, n), r, c, v,
                                          dtype=np.float64, allow_dia=False,
                                          allow_bell=False)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        x = rng.standard_normal(n)
        xt = tp["vectors"].to_device_vector(tp["mesh"], x, At.col_offsets,
                                            At.col_pad)
        y_tp = tp["vectors"].from_device_vector(tp["spmv"](At, xt),
                                                At.row_offsets, At.row_pad)
        np.testing.assert_allclose(_spmv_np(A, x), y_tp, rtol=1e-12,
                                   atol=1e-12)

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_from_arrays_same_layout(self, tp, rng, dtype):
        n = 20_000
        r, c, v = clipped(rng, n)
        At = tp["ShardedMatrix"].from_coo(tp["mesh"], (n, n), r, c, v,
                                          dtype=dtype, allow_dia=False,
                                          allow_bell=False)
        assert At.uses_bdia and At.bdia_ovf_vals is not None
        A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
        assert A.uses_bdia and A.bdia_vals.dtype == torch.from_numpy(
            np.zeros(0, dtype)).dtype
        assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0
        x = rng.standard_normal(n).astype(dtype)
        xt = tp["vectors"].to_device_vector(tp["mesh"], x, At.col_offsets,
                                            At.col_pad, dtype=dtype)
        y_tp = np.asarray(tp["spmv"](At, xt))
        y = spmv(A, to_device_vector(x, A.col_offsets, A.col_pad, CPU))
        tol = 1e-12 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(y.numpy(), y_tp, rtol=tol,
                                   atol=tol * np.abs(y_tp).max())

    def test_from_arrays_refuses_other_layouts(self, tp, rng):
        """An offd layout is refused; tpusolve's 1-D DIA layout (no
        dia_shape) now comes across as the port's DIA, (0, 0, offset)
        triples, with the same SpMV."""
        n = 600
        r, c, v = clustered(rng, n, centers=(0,), drift_amp=0)
        At = tp["ShardedMatrix"].from_coo(tp["mesh"], (n, n), r, c, v,
                                          dtype=np.float64)
        assert At.uses_dia and At.dia_shape is None
        arrays, meta = tpusolve_fields(At)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ShardedMatrix.from_arrays(arrays, dict(meta, has_offd=True),
                                      device=CPU)
        A = ShardedMatrix.from_arrays(arrays, meta, device=CPU)
        assert A.uses_dia and A.dia_shape is None
        assert A.dia_offsets == tuple((0, 0, o) for o in At.dia_offsets)
        assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0
        x = rng.standard_normal(n)
        y_tp = np.asarray(tp["spmv"](At, tp["vectors"].to_device_vector(
            tp["mesh"], x, At.col_offsets, At.col_pad)))
        np.testing.assert_allclose(spmv(A, torch.from_numpy(x)).numpy(),
                                   y_tp, rtol=0,
                                   atol=1e-14 * np.abs(y_tp).max())


class TestVectorsAndCast:
    def test_pad_roundtrip_and_zero_padding(self, rng):
        x = rng.standard_normal(10)
        offs = np.array([0, 10])
        xp = pad_vector(x, offs, 13)
        assert xp.shape == (13,) and np.all(xp[10:] == 0)
        np.testing.assert_array_equal(unpad_vector(xp, offs, 13), x)

    def test_astype_shares_layout(self, rng):
        n = 6000
        r, c, v = clustered(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        A32 = A.astype(np.float32)
        assert A32.dtype == torch.float32 and A.dtype == torch.float64
        assert A32.bdia_starts is A.bdia_starts
        assert A32.bdia_vals.dtype == torch.float32
        assert A.astype(torch.float64) is A
