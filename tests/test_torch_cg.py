"""tpusolve_torch's PCG against tpusolve's, fused and stepped.

The 27-point Laplacian at 10^3 and 8 x 6 x 12 (the stencil generator's
system of both packages), without a preconditioner and with Jacobi
(z = D^-1 r): in f64 the iteration counts equal those of tpusolve's fused
and stepped forms, and x agrees to 1e-10 relative.  The port's one loop
keeps the fused form's history contract, a (maxiter + 1) buffer in b's dtype
padded with -1, which tpusolve's stepped form does not (ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil
from tpusolve_torch.krylov.cg import pcg, pcg_setup

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve import stencil as ts
    from tpusolve.krylov import cg as tcg
    from tpusolve.mesh import make_mesh
    return dict(stencil=ts, cg=tcg, mesh=make_mesh(1))


@pytest.mark.parametrize("box", [(10, 10, 10), (8, 6, 12)])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_pcg_equals_tpusolve(tp, box, jacobi, fused):
    A, b, _ = stencil.laplace27(*box, device=CPU)
    At, bt, _ = tp["stencil"].laplace27(tp["mesh"], *box)
    M = (lambda r: r / A.diag[0]) if jacobi else None
    M_t = (lambda r: r / At.diag[0]) if jacobi else None
    kw = dict(tol=1e-10, maxiter=200)
    res = pcg_setup(A, M, **kw)(b)
    res_t = tp["cg"].pcg_setup(At, M_t, fused=fused, **kw)(bt)
    x_t = np.asarray(res_t.x)
    assert res.iters == int(res_t.iters) > 3
    assert bool(res.converged) and bool(res_t.converged)
    np.testing.assert_allclose(res.x.numpy(), x_t, rtol=0,
                               atol=1e-10 * np.abs(x_t).max())
    h, h_t = res.history.numpy(), np.asarray(res_t.history)
    h_t = h_t[h_t >= 0]
    np.testing.assert_allclose(h[:res.iters + 1], h_t, rtol=1e-8)
    np.testing.assert_allclose(float(res.relres), float(res_t.relres),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("jacobi", [False, True])
def test_history_contract(dtype, jacobi):
    A, b, x_ref = stencil.laplace27(6, 6, 6, device=CPU, dtype=dtype)
    M = (lambda r: r / A.diag[0]) if jacobi else None
    maxiter = 40
    res = pcg_setup(A, M, tol=1e-4, maxiter=maxiter)(b)
    h = res.history
    assert h.shape == (maxiter + 1,) and h.dtype == b.dtype
    assert bool((h[:res.iters + 1] > 0).all())
    assert bool((h[res.iters + 1:] == -1).all())
    assert 0 < res.iters < maxiter and bool(res.converged)
    assert float(h[res.iters]) <= 1e-4 * float(torch.linalg.norm(b))


def test_maxiter_and_initial_guess():
    A, b, x_ref = stencil.laplace27(6, 6, 6, device=CPU)
    res = pcg(A, b, tol=1e-14, maxiter=3)
    assert res.iters == 3 and not bool(res.converged)
    assert bool((res.history >= 0).all())
    res = pcg(A, b, x0=x_ref.clone(), tol=1e-8)
    assert res.iters == 0 and bool(res.converged)
    assert torch.equal(res.x, x_ref)
