"""tpusolve_torch BDIA kernel module against tpusolve's.

The host planners must produce tpusolve's layout exactly; the plain PyTorch
SpMV must equal tpusolve's Pallas kernel (run in interpret mode, as tpusolve's
own tests run it on the CPU) and its XLA form on one identical layout (f64
to rtol 1e-12, f32 to rtol 1e-5: only the summation order differs).  The
CUDA kernel is held against the plain version on a card.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch import runtime
from tpusolve_torch.kernels import bdia
from tpusolve_torch.matrix.sharded import ShardedMatrix, _ovf_fields
from test_torch_sharded import clipped, tpusolve_fields

CPU = torch.device("cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def banded(rng, n, bw=25, per_row=9):
    """Random band with per-row drifting offsets (unique (row, col))."""
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=rows.size), 0, n - 1)
    key = np.unique(np.concatenate([rows, np.arange(n)]) * n
                    + np.concatenate([cols, np.arange(n)]))
    return key // n, key % n, rng.standard_normal(key.size)


def wide(rng, n, R, noffs=900, per_row=12, width=2000):
    """Each R-row block draws ``noffs`` offsets within ``width`` of the
    diagonal and each row ``per_row`` of them: about ``noffs`` slots a
    block, the shape of an AMG coarse level; unique (row, col)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    offs = rng.integers(-width, width + 1, size=(-(-n // R), noffs))
    pick = rng.integers(0, noffs, size=rows.size)
    cols = np.clip(rows + offs[rows // R, pick], 0, n - 1)
    key = np.unique(np.concatenate([rows, np.arange(n)]) * n
                    + np.concatenate([cols, np.arange(n)]))
    return key // n, key % n, rng.standard_normal(key.size)


def staged(r, c, v, n, R, D, dtype):
    """Port-planned (vals, starts, xpad, xlen, ovf) for one part; ``ovf`` is
    the overflow list as ``bdia_spmv`` takes it, or None."""
    starts, fi, vo, o_r, o_c, o_v = bdia.compact(r, c, v, n, n, R, D,
                                                 dtype=dtype, overflow=True)
    B = (n + R - 1) // R
    vals = np.zeros(B * D * R, dtype)
    vals[fi] = vo
    sa, xpad, xlen = bdia.finalize_starts(starts, n, R)
    f = _ovf_fields([(o_r, o_c, o_v)], n, n, dtype, CPU)
    ovf = (f["bdia_ovf_ptr"], f["bdia_ovf_cols"], f["bdia_ovf_vals"]) \
        if f else None
    return vals.reshape(1, B, D, R), sa[None], xpad, xlen, ovf


def to(ovf, device):
    return None if ovf is None else tuple(t.to(device) for t in ovf)


@pytest.fixture(scope="module")
def tpb():
    pytest.importorskip("jax")
    from tpusolve.kernels import bdia as tp_bdia
    return tp_bdia


class TestPlanners:
    @pytest.mark.parametrize("R", [128, 256])
    def test_planners_equal_tpusolve(self, tpb, rng, R):
        n = 1500
        r, c, v = banded(rng, n)
        prof = bdia.plan_fill_profile(r, c, n, n, R)
        np.testing.assert_array_equal(
            prof, tpb.plan_fill_profile(r, c, n, n, R))
        D = max(1, len(prof) // 2)     # forces an overflow list
        ours = bdia.compact(r, c, v, n, n, R, D, dtype=np.float64,
                            overflow=True)
        theirs = tpb.compact(r, c, v, n, n, R, D, dtype=np.float64,
                             overflow=True)
        assert ours[3].size > 0
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(bdia.finalize_starts(ours[0], n, R),
                        tpb.finalize_starts(theirs[0], n, R)):
            np.testing.assert_array_equal(a, b)

    def test_compact_strict_raises(self, rng):
        r, c, v = banded(rng, 256, bw=30)
        with pytest.raises(ValueError):
            bdia.compact(r, c, v, 256, 256, 128, 1)


class TestPlainAgainstTpusolve:
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_plain_equals_pallas_interpret_and_xla(self, tpb, rng, dtype):
        import jax.numpy as jnp
        n, R = 700, 128
        r, c, v = banded(rng, n, bw=20, per_row=5)
        D = bdia.plan_fill_profile(r, c, n, n, R).size
        vals, starts, xpad, xlen, _ = staged(r, c, v, n, R, D, dtype)
        x = rng.standard_normal(n).astype(dtype)
        y = bdia.bdia_spmv_plain(torch.from_numpy(vals),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(x), xpad, xlen, n).numpy()
        args = (jnp.asarray(vals[0]), jnp.asarray(starts[0]), jnp.asarray(x),
                xpad, xlen, n)
        y_xla = np.asarray(tpb.bdia_spmv_local(*args))
        y_pl = np.asarray(tpb.bdia_spmv_pallas(*args, interpret=True))
        for ref in (y_xla, y_pl):
            np.testing.assert_allclose(y, ref, rtol=RTOL[dtype],
                                       atol=RTOL[dtype] * np.abs(ref).max())

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_plain_on_tpusolve_layout(self, tpb, rng, dtype):
        """The layout tpusolve assembled, carried over by from_arrays: the
        port's plain SpMV equals tpusolve's BDIA local product."""
        import jax.numpy as jnp
        from tpusolve.mesh import make_mesh
        from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
        n = 20_000
        r, c, v = clipped(rng, n)
        At = TpMatrix.from_coo(make_mesh(1), (n, n), r, c, v, dtype=dtype,
                               allow_dia=False, allow_bell=False)
        A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
        x = rng.standard_normal(n).astype(dtype)
        y = bdia.bdia_spmv(A.bdia_vals, A.bdia_starts, torch.from_numpy(x),
                           A.bdia_xpad, A.bdia_xlen, A.row_pad).numpy()
        ref = np.asarray(tpb.bdia_spmv_local(
            At.bdia_vals[0], At.bdia_starts[0], jnp.asarray(x),
            At.bdia_xpad, At.bdia_xlen, At.row_pad))
        np.testing.assert_allclose(y, ref, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * np.abs(ref).max())


class TestWrapper:
    def test_cpu_tensor_takes_plain_without_launch(self, rng):
        import scipy.sparse as sp
        n, R = 700, 128
        r, c, v = banded(rng, n, per_row=5)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, 20,
                                               np.float64)
        assert ovf is not None
        before = bdia.bdia_spmv.launches
        x = torch.from_numpy(rng.standard_normal(n))
        args = (torch.from_numpy(vals), torch.from_numpy(starts), x, xpad,
                xlen, n, ovf)
        y = bdia.bdia_spmv(*args)
        torch.testing.assert_close(y, bdia.bdia_spmv_plain(*args))
        assert bdia.bdia_spmv.launches == before
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x.numpy()
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_wide_operator_with_overflow_equals_scipy(self, rng):
        """The D=640 operator of the card's test (``wide``), on the CPU."""
        import scipy.sparse as sp
        n, R = 5000, 128
        r, c, v = wide(rng, n, R)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, 640,
                                               np.float64)
        assert ovf is not None and int(ovf[0][0, -1]) > 0
        x = rng.standard_normal(n)
        y = bdia.bdia_spmv(torch.from_numpy(vals), torch.from_numpy(starts),
                           torch.from_numpy(x), xpad, xlen, n, ovf).numpy()
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_window_outside_x_raises(self, rng):
        vals = torch.zeros((1, 2, 1, 128), dtype=torch.float64)
        starts = torch.tensor([[[0], [200]]], dtype=torch.int32)
        with pytest.raises(ValueError, match="window"):
            bdia.bdia_spmv_plain(vals, starts, torch.zeros(256), 0, 256, 256)


# (P, B, D, R) of the main path's K4 operators and of small launches:
# gate 4's A at 96^3, gate 3's 64^3 levels 0 and 1 and level 2's BDIA
# twin, a small operator, and wide blocks
K4_SHAPES = [(1, 6912, 46, 128), (1, 2048, 56, 128), (1, 169, 688, 128),
             (1, 12, 927, 128), (1, 40, 23, 128), (2, 3, 9, 256),
             (1, 5, 300, 2048), (1, 10, 12, 512)]


class TestK4Plan:
    """K4's launch plan (``kernels/bdia.py:k4_plan``), on the host: what the
    kernel (``csrc/bdia_spmv.cu``) needs of it."""

    @pytest.mark.parametrize("itemsize", [4, 8])
    @pytest.mark.parametrize("shape", K4_SHAPES)
    def test_units_cover_every_row_once(self, shape, itemsize):
        P, B, D, R = shape
        rc, S, blocks, _ = bdia.k4_plan(P, B, D, R, itemsize)
        assert R % rc == 0 and rc <= bdia.K4_MAX_CHUNK
        assert blocks == P * B * (R // rc)
        # the kernel's unit -> rows map: blockIdx.x = b * (R / Rc) + chunk
        rows = np.zeros(P * B * R, np.int64)
        for p in range(P):
            for u in range(B * (R // rc)):
                b, c = divmod(u, R // rc)
                rows[p * B * R + b * R + c * rc + np.arange(rc)] += 1
        assert (rows == 1).all()

    @pytest.mark.parametrize("itemsize", [4, 8])
    @pytest.mark.parametrize("shape", K4_SHAPES)
    def test_stages_and_shared_memory(self, shape, itemsize):
        """Deep register stages on a launch of few warps an SM; the starts
        in shared memory."""
        P, B, D, R = shape
        _, S, _, smem = bdia.k4_plan(P, B, D, R, itemsize)
        assert S in bdia.K4_SLOTS
        deep = P * B * R // 32 < bdia.K4_DEEP_WARPS * runtime.SM_COUNT
        assert S == (bdia.K4_SLOTS_DEEP if deep else bdia.K4_SLOTS_FULL)
        assert smem == D * 4 <= runtime.SMEM_PER_BLOCK

    def test_rejects_what_does_not_fit(self):
        with pytest.raises(ValueError, match="multiple"):
            bdia.k4_plan(1, 4, 8, 384, 8)
        with pytest.raises(ValueError, match="shared memory"):
            bdia.k4_plan(1, 4, 60_000, 128, 8)


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
    def test_kernel_equals_plain(self, cuda, dtype):
        rng = np.random.default_rng(7)
        n, R = 20_000, 256
        r, c, v = clipped(rng, n)
        prof = bdia.plan_fill_profile(r, c, n, n, R)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, len(prof) // 3,
                                               dtype)
        assert ovf is not None
        args = (torch.from_numpy(vals).to(cuda),
                torch.from_numpy(starts).to(cuda),
                torch.from_numpy(rng.standard_normal(n).astype(dtype))
                .to(cuda), xpad, xlen, n, to(ovf, cuda))
        before = bdia.bdia_spmv.launches
        y = bdia.bdia_spmv(*args)
        torch.cuda.synchronize()
        assert bdia.bdia_spmv.launches == before + 1
        ref = bdia.bdia_spmv_plain(*args)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= RTOL[dtype]

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("case", ["small", "large_d"])
    def test_kernel_equals_plain_and_k5(self, cuda, dtype, case):
        """K4 on a small launch (10 blocks of 512 rows, run as chunks of
        256) and on an operator of D=640 slots (gate 3's 64^3 level 1 has
        688), overflow list included: equal to its plain version, and to
        K5 on the same layout bit for bit."""
        rng = np.random.default_rng(12)
        n = 5000
        if case == "small":
            R, D = 512, 12
            r, c, v = banded(rng, n, bw=40, per_row=9)
        else:
            R, D = 128, 640
            r, c, v = wide(rng, n, R)
        vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, D, dtype)
        assert ovf is not None
        itemsize = np.dtype(dtype).itemsize
        rc, S, _, _ = bdia.k4_plan(1, vals.shape[1], D, R, itemsize)
        assert S == bdia.K4_SLOTS_DEEP and (rc < R if case == "small"
                                            else rc == R)
        gb, step_lo, panel, step_b0, stage = bdia.plan_steps(
            starts, R, xpad, itemsize,
            lambda g, nsteps, panel, smem: abs(g - 4))
        ovf = to(ovf, cuda)
        vt, st = (torch.from_numpy(vals).to(cuda),
                  torch.from_numpy(starts).to(cuda))
        x = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(cuda)
        args = (vt, st, x, xpad, xlen, n, ovf)
        before = bdia.bdia_spmv.launches
        y = bdia.bdia_spmv(*args)
        torch.cuda.synchronize()
        assert bdia.bdia_spmv.launches == before + 1
        ref = bdia.bdia_spmv_plain(*args)
        assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]
        y5 = bdia.bdia_spmv_xl(vt, st, x, xpad, n, gb,
                               torch.from_numpy(step_lo).to(cuda), panel, ovf,
                               mask=bdia.segment_mask(vt),
                               step_b0=torch.from_numpy(step_b0).to(cuda),
                               stage=stage)
        assert torch.equal(y, y5)

    def test_spmv_with_overflow_matches_scipy(self, cuda):
        import scipy.sparse as sp
        from tpusolve_torch.matrix.spmv import spmv
        rng = np.random.default_rng(8)
        n = 20_000
        r, c, v = clipped(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=cuda)
        assert A.uses_bdia and A.bdia_ovf_vals is not None
        x = rng.standard_normal(n)
        y = spmv(A, torch.from_numpy(x).to(cuda)).cpu().numpy()
        ref = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())

    def test_wrong_dtype_raises(self, cuda):
        vals = torch.zeros((1, 1, 1, 128), dtype=torch.float16, device=cuda)
        starts = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
        with pytest.raises(TypeError):
            bdia.bdia_spmv(vals, starts, torch.zeros(128, dtype=torch.float16,
                                                     device=cuda), 0, 128, 128)
