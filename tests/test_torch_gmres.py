"""tpusolve_torch GMRES, COGMRES and FlexGMRES against tpusolve's.

Both packages run on one identical BDIA layout (tpusolve's, carried over by
``ShardedMatrix.from_arrays``) with the same right-hand side.  In f64 the
iteration counts are equal, the Givens residual histories agree to 1e-8
relative (the Gram-Schmidt reductions sum in another order) and the
solutions to 1e-10; in f32 the counts are within one.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.krylov.gmres import (
    cogmres_setup, fgmres_setup, gmres_setup)
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import to_device_vector
from test_torch_krylov import advection
from test_torch_sharded import tpusolve_fields

CPU = torch.device("cpu")
METHODS = {"gmres": dict(), "cogmres": dict(cgs=2), "fgmres": dict()}


@pytest.fixture(scope="module")
def system():
    """(tpusolve modules, tpusolve f64 matrix, port f64 matrix, b)."""
    pytest.importorskip("jax")
    import importlib
    # the module, not the function tpusolve.krylov exports under its name
    tp_gmres = importlib.import_module("tpusolve.krylov.gmres")
    from tpusolve.matrix import vectors as tpv
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.mesh import make_mesh
    mesh = make_mesh(1)
    r, c, v, b, n = advection()
    At = TpMatrix.from_coo(mesh, (n, n), r, c, v, dtype=np.float64,
                           allow_dia=False, allow_bell=False)
    A = ShardedMatrix.from_arrays(*tpusolve_fields(At), device=CPU)
    return dict(mesh=mesh, vec=tpv, gmres=tp_gmres), At, A, b


def _setups(tp, name):
    ours = {"gmres": gmres_setup, "cogmres": cogmres_setup,
            "fgmres": fgmres_setup}[name]
    theirs = {"gmres": tp["gmres"].gmres_setup,
              "cogmres": tp["gmres"].cogmres_setup,
              "fgmres": tp["gmres"].fgmres_setup}[name]
    return ours, theirs


def _jacobi(tp, At):
    dinv = 1.0 / np.asarray(At.diag).reshape(-1)
    dt = tp["vec"].to_device_vector(tp["mesh"], dinv, At.row_offsets,
                                    At.row_pad)
    d = torch.from_numpy(dinv)
    return (lambda r: d * r), (lambda r: dt * r)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("name", sorted(METHODS))
def test_f64_equal_iterations_and_history(system, name, precond):
    tp, At, A, b = system
    M = Mt = None
    if precond == "jacobi":
        M, Mt = _jacobi(tp, At)
    ours, theirs = _setups(tp, name)
    kw = dict(tol=1e-10, maxiter=300, restart=10, **METHODS[name])
    res_t = theirs(At, Mt, **kw)(tp["vec"].to_device_vector(
        tp["mesh"], b, At.row_offsets, At.row_pad))
    res = ours(A, M, **kw)(to_device_vector(b, A.row_offsets, A.row_pad,
                                            CPU))
    assert bool(res.converged) and bool(res_t.converged)
    assert res.iters == int(res_t.iters) > 10      # at least one restart
    xt = np.asarray(res_t.x)
    np.testing.assert_allclose(res.x.numpy(), xt, rtol=0,
                               atol=1e-10 * np.abs(xt).max())
    ht = np.asarray(res_t.history)
    assert res.history.shape == ht.shape == (300 + 10 + 1,)
    assert np.all(res.history.numpy()[res.iters + 1:] == -1.0)
    live = slice(0, res.iters + 1)
    np.testing.assert_allclose(res.history.numpy()[live], ht[live],
                               rtol=1e-8)
    assert float(res.relres) == pytest.approx(float(res_t.relres), rel=1e-8)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_f32_within_one_iteration(system, name):
    tp, At, A, b = system
    ours, theirs = _setups(tp, name)
    kw = dict(tol=1e-5, maxiter=300, restart=10, **METHODS[name])
    res_t = theirs(At.astype(np.float32), None, **kw)(
        tp["vec"].to_device_vector(tp["mesh"], b, At.row_offsets,
                                   At.row_pad, dtype=np.float32))
    res = ours(A.astype(np.float32), None, **kw)(
        to_device_vector(b, A.row_offsets, A.row_pad, CPU, np.float32))
    assert bool(res.converged) and res.x.dtype == torch.float32
    assert res.history.dtype == torch.float32
    assert abs(res.iters - int(res_t.iters)) <= 1


def test_maxiter_stops_after_the_cycle(system):
    """maxiter is checked between restart cycles, as in tpusolve: a cycle
    that starts runs to its restart length."""
    tp, At, A, b = system
    res = gmres_setup(A, None, tol=1e-14, maxiter=3, restart=10)(
        to_device_vector(b, A.row_offsets, A.row_pad, CPU))
    res_t = tp["gmres"].gmres_setup(At, None, tol=1e-14, maxiter=3,
                                    restart=10)(
        tp["vec"].to_device_vector(tp["mesh"], b, At.row_offsets,
                                   At.row_pad))
    assert res.iters == int(res_t.iters) == 10 and not bool(res.converged)
    assert res.history.shape == (3 + 10 + 1,)


def test_zero_rhs_returns_zero(system):
    _, _, A, _ = system
    b = torch.zeros(A.row_pad, dtype=torch.float64)
    res = gmres_setup(A, None, tol=1e-10, maxiter=20)(b)
    assert res.iters == 0 and bool(res.converged)
    assert not res.x.any()
