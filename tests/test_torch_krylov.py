"""tpusolve_torch BiCGSTAB and iterative refinement against tpusolve's.

Both packages run on one identical BDIA layout (tpusolve's, carried over by
``ShardedMatrix.from_arrays``) with the same right-hand side: in f64 the
iteration counts are equal and the solutions agree to 1e-10 relative; the
residual histories agree to 1e-6 relative (the reductions sum in another
order, and BiCGSTAB amplifies that difference over the iterations).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.krylov.bicgstab import bicgstab_setup
from tpusolve_torch.krylov.common import safe_div, stop_target
from tpusolve_torch.krylov.refine import refined_solve_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import to_device_vector, from_device_vector
from test_torch_sharded import tpusolve_fields

CPU = torch.device("cpu")


def advection(n=3000, band=200, seed=3):
    """Non-symmetric, diagonally dominant banded operator (momentum-like),
    large enough for BDIA."""
    rng = np.random.default_rng(seed)
    rr = np.arange(n, dtype=np.int64)
    rows, cols, vals = [rr], [rr], [np.full(n, 12.0)]
    for off, w in ((-1, -1.6), (1, -0.4), (-band, -1.3), (band, -0.7),
                   (-band - 1, -0.5), (band + 1, -0.5), (-7, -0.3),
                   (7, -0.2)):
        c = rr + off
        ok = (c >= 0) & (c < n)
        rows.append(rr[ok])
        cols.append(c[ok])
        vals.append(w * (1.0 + 0.2 * rng.random(int(ok.sum()))))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    b = sp.csr_matrix((v, (r, c)), shape=(n, n)) @ rng.standard_normal(n)
    return r, c, v, b, n


@pytest.fixture(scope="module")
def system():
    """(tpusolve modules, tpusolve f64 matrix, port f64 matrix, b)."""
    pytest.importorskip("jax")
    from tpusolve.mesh import make_mesh
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix import vectors as tpv
    from tpusolve.krylov.bicgstab import bicgstab_setup as tp_bicgstab
    from tpusolve.krylov.refine import refined_solve_setup as tp_refine
    mesh = make_mesh(1)
    r, c, v, b, n = advection()
    At = TpMatrix.from_coo(mesh, (n, n), r, c, v, dtype=np.float64,
                           allow_dia=False, allow_bell=False)
    assert At.uses_bdia
    A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
    tp = dict(mesh=mesh, vec=tpv, bicgstab=tp_bicgstab, refine=tp_refine)
    return tp, At, A, b


def _tp_vec(tp, At, x, dtype=np.float64):
    return tp["vec"].to_device_vector(tp["mesh"], x, At.row_offsets,
                                      At.row_pad, dtype=dtype)


class TestBicgstab:
    @pytest.mark.parametrize("precond", ["none", "jacobi"])
    def test_f64_equal_iterations_and_solution(self, system, precond):
        tp, At, A, b = system
        Mt = M = None
        if precond == "jacobi":
            dinv = 1.0 / np.asarray(At.diag).reshape(-1)
            dt = _tp_vec(tp, At, dinv)
            Mt = lambda r: dt * r
            d = torch.from_numpy(dinv)
            M = lambda r: d * r
        res_t = tp["bicgstab"](At, Mt, tol=1e-10, maxiter=300)(
            _tp_vec(tp, At, b))
        res = bicgstab_setup(A, M, tol=1e-10, maxiter=300)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU))
        assert bool(res.converged) and bool(res_t.converged)
        assert res.iters == int(res_t.iters)
        xt = np.asarray(res_t.x)
        np.testing.assert_allclose(res.x.numpy(), xt, rtol=0,
                                   atol=1e-10 * np.abs(xt).max())
        ht = np.asarray(res_t.history)
        assert res.history.shape == ht.shape == (301,)
        assert np.all(res.history.numpy()[res.iters + 1:] == -1.0)
        live = slice(0, res.iters + 1)
        np.testing.assert_allclose(res.history.numpy()[live], ht[live],
                                   rtol=1e-6)

    def test_f32_within_one_iteration(self, system):
        tp, At, A, b = system
        At32 = At.astype(np.float32)
        A32 = A.astype(np.float32)
        res_t = tp["bicgstab"](At32, None, tol=1e-5, maxiter=300)(
            _tp_vec(tp, At, b, np.float32))
        res = bicgstab_setup(A32, None, tol=1e-5, maxiter=300)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU, np.float32))
        assert bool(res.converged)
        assert abs(res.iters - int(res_t.iters)) <= 1

    def test_maxiter_stops_unconverged(self, system):
        _, _, A, b = system
        res = bicgstab_setup(A, None, tol=1e-14, maxiter=3)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU))
        assert res.iters == 3 and not bool(res.converged)
        assert res.history.shape == (4,) and bool((res.history > 0).all())


class TestRefine:
    def test_mixed_matches_tpusolve(self, system):
        """f32 BiCGSTAB inside f64 refinement: both reach tol 1e-10, with
        total inner iterations within one per refinement pass."""
        tp, At, A, b = system
        At32, A32 = At.astype(np.float32), A.astype(np.float32)
        inner_t = tp["bicgstab"](At32, None, tol=1e-5, maxiter=300)
        res_t = tp["refine"](At, inner_t, tol=1e-10, max_refine=6)(
            _tp_vec(tp, At, b))
        inner = bicgstab_setup(A32, None, tol=1e-5, maxiter=300)
        res = refined_solve_setup(A, inner, tol=1e-10, max_refine=6)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU))
        assert bool(res.converged) and bool(res_t.converged)
        assert res.x.dtype == torch.float64
        assert float(res.relres) <= 1e-10
        assert res.iters == sum(res.passes)
        assert abs(res.iters - int(res_t.iters)) <= len(res.passes)
        xt = np.asarray(res_t.x)
        np.testing.assert_allclose(res.x.numpy(), xt, rtol=0,
                                   atol=1e-9 * np.abs(xt).max())

    def test_max_refine_caps_passes(self, system):
        _, _, A, b = system
        inner = bicgstab_setup(A.astype(np.float32), None, tol=1e-2,
                               maxiter=300)
        res = refined_solve_setup(A, inner, tol=1e-14, max_refine=2)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU))
        assert len(res.passes) == 2 and not bool(res.converged)


class TestHelpers:
    def test_safe_div_and_target(self):
        z = torch.tensor(0.0, dtype=torch.float64)
        assert float(safe_div(torch.tensor(1.0, dtype=torch.float64), z)) == 0
        assert float(safe_div(torch.tensor(6.0), torch.tensor(3.0))) == 2.0
        t = stop_target(torch.tensor(2.0), 1e-3, 0.5)
        assert float(t) == 0.5

    def test_solution_unpads(self, system):
        _, _, A, b = system
        res = bicgstab_setup(A, None, tol=1e-10, maxiter=300)(
            to_device_vector(b, A.row_offsets, A.row_pad, CPU))
        x = from_device_vector(res.x, A.row_offsets, A.row_pad)
        S = A.to_scipy()
        assert np.abs(S @ x - b).max() <= 1e-8 * np.abs(b).max()
