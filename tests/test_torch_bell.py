"""tpusolve_torch BELL kernel module and layout choice against tpusolve's.

The host planners must produce tpusolve's layout exactly; the plain PyTorch
SpMV must equal tpusolve's Pallas kernel (run in interpret mode, as
tpusolve's own tests run it on the CPU) and its XLA form on one identical
layout (f64 to rtol 1e-12, f32 to rtol 1e-5: only the summation order
differs).  The layout choice puts BELL on a small clustered matrix and BDIA
on the gate-4 fixture.  The CUDA kernel is held against the plain version
on a card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.kernels import bell
from tpusolve_torch.matrix.sharded import ShardedMatrix, choose_layout
from test_torch_sharded import clustered, tpusolve_fields

CPU = torch.device("cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def blocky(rng, n, nblk=6, width=60):
    """A few dense-ish column clusters per row: a coarse-level shape."""
    rows = np.repeat(np.arange(n, dtype=np.int64), nblk * 4)
    base = (rng.integers(0, max(1, n - width), size=(n, nblk))
            .repeat(4, axis=1).reshape(-1))
    cols = base + rng.integers(0, width, size=rows.size)
    key = np.unique(np.concatenate([rows, np.arange(n)]) * n
                    + np.concatenate([cols, np.arange(n)]))
    return key // n, key % n, rng.standard_normal(key.size)


def staged(r, c, v, n, m, dtype):
    """Port-planned (vals, ids, nwin) for one part of an n x m block."""
    K = bell.bell_plan_k(r, c, n)
    vals, ids = bell.bell_from_entries(r, c, v, n, m, K, dtype=dtype)
    return vals[None], ids[None], (m + bell.TN - 1) // bell.TN


@pytest.fixture(scope="module")
def tpb():
    pytest.importorskip("jax")
    from tpusolve.kernels import bell as tp_bell
    return tp_bell


class TestPlanners:
    @pytest.mark.parametrize("n, m", [(700, 700), (533, 1201)])
    def test_planners_equal_tpusolve(self, tpb, rng, n, m):
        r, c, v = blocky(rng, min(n, m))
        K = bell.bell_plan_k(r, c, n)
        assert K == tpb.bell_plan_k(r, c, n) and K > 1
        assert bell._ngroups(n) == tpb._ngroups(n)
        for a, b in zip(bell.bell_compact(r, c, v, n, m, K, np.float64),
                        tpb.bell_compact(r, c, v, n, m, K, np.float64)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(bell.bell_from_entries(r, c, v, n, m, K, np.float32),
                        tpb.bell_from_entries(r, c, v, n, m, K, np.float32)):
            np.testing.assert_array_equal(a, b)
        key = np.sort(rng.integers(0, 50, 300))
        for a, b in zip(bell._sorted_unique_inverse(key),
                        tpb._sorted_unique_inverse(key)):
            np.testing.assert_array_equal(a, b)

    def test_compact_strict_raises(self, rng):
        r, c, v = blocky(rng, 300)
        with pytest.raises(ValueError, match="kmax"):
            bell.bell_compact(r, c, v, 300, 300, 1)


class TestPlainAgainstTpusolve:
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    @pytest.mark.parametrize("n, m", [(700, 700), (533, 1201)])
    def test_plain_equals_pallas_interpret_and_xla(self, tpb, rng, dtype,
                                                   n, m):
        import jax.numpy as jnp
        r, c, v = blocky(rng, min(n, m))
        vals, ids, nwin = staged(r, c, v, n, m, dtype)
        x = rng.standard_normal(m).astype(dtype)
        y = bell.bell_spmv_plain(torch.from_numpy(vals),
                                 torch.from_numpy(ids), torch.from_numpy(x),
                                 nwin, n).numpy()
        args = (jnp.asarray(vals[0]), jnp.asarray(ids[0]), jnp.asarray(x),
                nwin, n)
        refs = (np.asarray(tpb.bell_spmv_local(*args)),
                np.asarray(tpb.bell_spmv_pallas(*args, interpret=True)))
        ref_sp = sp.csr_matrix((v, (r, c)), shape=(n, m)) @ x.astype(
            np.float64)
        assert y.shape == (n,)
        for ref in refs + (ref_sp,):
            np.testing.assert_allclose(y, ref, rtol=RTOL[dtype],
                                       atol=RTOL[dtype] * np.abs(ref).max())

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_from_arrays_takes_tpusolve_bell(self, rng, dtype):
        """tpusolve's BELL layout carried over: the same operator, and the
        port's SpMV equals tpusolve's."""
        pytest.importorskip("jax")
        from tpusolve.mesh import make_mesh
        from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
        from tpusolve.matrix import vectors as tpv
        from tpusolve.matrix.spmv import spmv as tp_spmv
        from tpusolve_torch.matrix.spmv import spmv
        n = 3000
        r, c, v = blocky(rng, n, nblk=4, width=200)
        mesh = make_mesh(1)
        At = TpMatrix.from_coo(mesh, (n, n), r, c, v, dtype=dtype,
                               allow_dia=False, allow_bdia=False)
        assert At.uses_bell
        A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
        assert A.uses_bell and A.layout.startswith("BELL")
        assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0
        x = rng.standard_normal(n).astype(dtype)
        y_tp = np.asarray(tp_spmv(At, tpv.to_device_vector(
            mesh, x, At.col_offsets, At.col_pad, dtype=dtype)))
        y = spmv(A, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y, y_tp, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * np.abs(y_tp).max())


class TestLayoutChoice:
    def test_bell_on_small_clustered_matrix(self, rng):
        """A small operator with a few dense column clusters per row (an
        AMG coarse level's shape) takes BELL, assembles it, and its SpMV
        equals scipy's."""
        n = 1500
        r, c, v = blocky(rng, n, nblk=8, width=40)
        assert r.size >= 20_000
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU,
                                   allow_ell=False)
        assert A.uses_bell and not A.uses_bdia, A.layout
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        assert abs(A.to_scipy() - S).max() == 0.0
        x = rng.standard_normal(n)
        from tpusolve_torch.matrix.spmv import spmv
        np.testing.assert_allclose(spmv(A, torch.from_numpy(x)).numpy(),
                                   S @ x, rtol=1e-12,
                                   atol=1e-12 * np.abs(S @ x).max())
        A32 = A.astype(np.float32)
        assert A32.bell_ids is A.bell_ids
        assert A32.bell_vals.dtype == torch.float32

    def test_bdia_on_gate4_fixture(self):
        """The gate-4 momentum fixture at 48^3 after RCM keeps BDIA."""
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        from tpusolve_torch.fixtures import make_system
        from tpusolve_torch.matrix import coo
        rows, cols, vals, _, n = make_system(48, 48, 48, seed=11,
                                             nonsym=0.35)
        pat = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                            shape=(n, n))
        perm = reverse_cuthill_mckee(pat + pat.T, symmetric_mode=True)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        r, c, v = coo.dedup_coo(inv[rows], inv[cols], vals, mode="add")
        for itemsize in (8, 4):
            kind, plan = choose_layout([(r, c, v)], n, n, itemsize, r.size,
                                       allow_ell=False)
            assert kind == "bdia", (itemsize, plan)

    @pytest.mark.parametrize("kind", ["bdia", "bell"])
    def test_allow_flags(self, rng, kind):
        n = 1500
        r, c, v = blocky(rng, n, nblk=8, width=40)
        got, _ = choose_layout([(r, c, v)], n, n, 8, r.size,
                               allow_bdia=kind == "bdia",
                               allow_bell=kind == "bell", allow_ell=False)
        assert got == kind

    def test_below_min_nnz_is_ell(self, rng):
        r, c, v = clustered(rng, 1000, centers=(-30, 0, 30), drift_amp=3)
        assert choose_layout([(r, c, v)], 1000, 1000, 8, r.size)[0] == "ell"


def one_window(rng, n, per_row=20):
    """Every row's columns inside its own 128-column window: K = 1."""
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    base = rows // bell.TN * bell.TN
    cols = np.minimum(base + rng.integers(0, bell.TN, size=rows.size), n - 1)
    key = np.unique(rows * n + cols)
    return key // n, key % n, rng.standard_normal(key.size)


class TestK6Launch:
    @pytest.mark.parametrize("K", [1, 2, 12, 16, 17, 32, 40])
    def test_warps_take_every_tile_once(self, K):
        """K6's block has ``bell_warps(K)`` warps, warp w takes tiles w,
        w + warps, ...: every tile once, at most ``MAX_WARPS`` warps."""
        W = bell.bell_warps(K)
        assert W == min(K, bell.MAX_WARPS) and 32 * W <= 1024
        took = sorted(k for w in range(W) for k in range(w, K, W))
        assert took == list(range(K))
        assert max(len(range(w, K, W)) for w in range(W)) == -(-K // W)

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_tile_loads_are_16_byte_aligned(self, itemsize):
        """K6's lane loads 4 values of each tile row as 16-byte loads (two
        in f64): from a 16-byte aligned vals, every (group, tile, row,
        lane) offset is a multiple of 16 bytes."""
        G, K = 5, 3
        off = ((np.arange(G * K)[:, None, None] * bell.TM
                + np.arange(bell.TM)[None, :, None]) * bell.TN
               + 4 * np.arange(32)[None, None, :]) * itemsize
        assert not (off % 16).any()
        assert (4 * itemsize) % 16 == 0

    def test_one_window_operator_has_k1(self, rng):
        n = 1000
        r, c, v = one_window(rng, n)
        assert bell.bell_plan_k(r, c, n) == 1
        vals, ids, nwin = staged(r, c, v, n, n, np.float64)
        x = rng.standard_normal(n)
        y = bell.bell_spmv(torch.from_numpy(vals), torch.from_numpy(ids),
                           torch.from_numpy(x), nwin, n).numpy()
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


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
    @pytest.mark.parametrize("n, m, offset", [(1507, 1507, 0),
                                              (533, 1201, 1),
                                              (4099, 4099, 0)])
    def test_kernel_equals_plain(self, cuda, dtype, n, m, offset):
        """Ragged groups and windows, and (offset 1) an x that is not
        16-byte aligned."""
        rng = np.random.default_rng(7)
        r, c, v = blocky(rng, min(n, m))
        vals, ids, nwin = staged(r, c, v, n, m, dtype)
        buf = torch.from_numpy(rng.standard_normal(m + offset).astype(dtype))
        x = buf.to(cuda)[offset:]
        args = (torch.from_numpy(vals).to(cuda),
                torch.from_numpy(ids).to(cuda), x, nwin, n)
        before = bell.bell_spmv.launches
        y = bell.bell_spmv(*args)
        torch.cuda.synchronize()
        assert bell.bell_spmv.launches == before + 1
        assert y.shape == (n,)
        ref = bell.bell_spmv_plain(*args)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= RTOL[dtype]

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("case", ["K=1", "K>warps"])
    def test_kernel_k_against_warps(self, cuda, dtype, case):
        """One tile a group (one warp a block), and more tiles than a block
        has warps (warps take several tiles each)."""
        rng = np.random.default_rng(9)
        if case == "K=1":
            n = 3001
            r, c, v = one_window(rng, n)
        else:
            n = 4099
            r, c, v = blocky(rng, n)
        vals, ids, nwin = staged(r, c, v, n, n, dtype)
        K = ids.shape[-1]
        assert K == 1 if case == "K=1" else K > bell.MAX_WARPS
        x = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(cuda)
        args = (torch.from_numpy(vals).to(cuda),
                torch.from_numpy(ids).to(cuda), x, nwin, n)
        y = bell.bell_spmv(*args)
        torch.cuda.synchronize()
        ref = bell.bell_spmv_plain(*args)
        assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]
        assert torch.equal(y, bell.bell_spmv(*args))     # deterministic

    def test_spmv_matches_scipy(self, cuda):
        from tpusolve_torch.matrix.spmv import spmv
        rng = np.random.default_rng(8)
        n = 1500
        r, c, v = blocky(rng, n, nblk=8, width=40)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=cuda,
                                   allow_ell=False)
        assert A.uses_bell
        x = rng.standard_normal(n)
        y = spmv(A, torch.from_numpy(x).to(cuda)).cpu().numpy()
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_wrong_dtype_raises(self, cuda):
        vals = torch.zeros((1, 1, 1, 8, 128), dtype=torch.float16,
                           device=cuda)
        ids = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError):
            bell.bell_spmv(vals, ids, torch.zeros(8, dtype=torch.float16,
                                                  device=cuda), 1, 8)
