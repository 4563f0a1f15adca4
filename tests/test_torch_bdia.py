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

    def test_window_outside_x_raises(self, rng):
        vals = torch.zeros((1, 2, 1, 128), dtype=torch.float64)
        starts = torch.tensor([[[0], [200]]], dtype=torch.int32)
        with pytest.raises(ValueError, match="window"):
            bdia.bdia_spmv_plain(vals, starts, torch.zeros(256), 0, 256, 256)


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
