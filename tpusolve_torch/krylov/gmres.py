"""Restarted GMRES family: GMRES, COGMRES, FlexGMRES (the port of
``tpusolve/krylov/gmres.py``).

Replacements for ``HYPRE_ParCSRGMRES*`` (+``SetKDim`` restart, ref:
src/HypreSystem.cpp:390-404), ``HYPRE_ParCSRCOGMRES*`` (+``SetCGS``, ref:
:372-388) and ``HYPRE_ParCSRFlexGMRES*`` (ref: :406-421).

* Orthogonalization is batched classical Gram-Schmidt: the projection
  ``h = V w`` is one (m+1, n) x (n,) product per iteration (``cgs=2``
  re-orthogonalizes once).  The Krylov basis ``V`` is a dense (m+1, n)
  tensor whose rows are zero until filled, so the projection needs no mask.
* Right preconditioning throughout; FlexGMRES also stores the
  preconditioned vectors ``Z`` so the preconditioner may change per
  iteration.
* ``tpusolve``'s ``lax.while_loop`` becomes a host loop with one host read
  per inner iteration: the projection column and ``||w||``.  The Givens
  rotations, the Hessenberg matrix and the triangular solve live on the
  host in b's dtype, so ``single`` rounds as ``tpusolve`` does.
* The inner loop stops on the Givens estimate ``|g[j+1]|`` and the restart
  loop on the estimate the cycle returns, as in ``tpusolve``; no true
  residual is recomputed between cycles beyond the cycle's own first one.
  The history keeps ``tpusolve``'s ``(maxiter + m + 1)`` buffer padded
  with -1.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from tpusolve_torch.krylov.common import (
    SolveResult, as_matvec, as_precond, norm, safe_div, stop_target)
from tpusolve_torch.matrix.vectors import numpy_dtype


def _givens(a, b):
    """Givens rotation zeroing b: returns (c, s, r) with c*a + s*b = r, in
    the dtype of the numpy scalars a and b."""
    rho = np.sqrt(a * a + b * b)
    one, zero = a.dtype.type(1), a.dtype.type(0)
    if rho != 0:
        return a / rho, b / rho, rho
    return one, zero, rho


def _gmres_cycle(matvec, precond, m, cgs, flexible, b, x, target, hist,
                 it0):
    """One restart cycle of at most m inner iterations.

    Returns (x_new, estimated residual norm, inner iterations)."""
    dtype = numpy_dtype(b.dtype)
    n = b.shape[0]
    r = b - matvec(x)
    beta = norm(r)
    beta_h = beta.cpu().numpy().astype(dtype)

    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    if beta_h != 0:
        V[0] = r / beta
    Z = (torch.zeros((m, n), dtype=b.dtype, device=b.device)
         if flexible else None)
    H = np.zeros((m + 1, m), dtype)
    cs = np.zeros(m, dtype)
    sn = np.zeros(m, dtype)
    g = np.zeros(m + 1, dtype)
    g[0] = beta_h

    j, res = 0, beta_h
    while j < m and res > target:
        z = precond(V[j])
        w = matvec(z)
        if flexible:
            Z[j] = z
        # batched classical Gram-Schmidt (rows > j of V are zero, so
        # h[k > j] = 0)
        h = torch.mv(V, w)
        w = w - torch.mv(V.T, h)
        if cgs >= 2:                    # CGS2 re-orthogonalization
            h2 = torch.mv(V, w)
            w = w - torch.mv(V.T, h2)
            h = h + h2
        hj1_t = norm(w)
        # the one host read of the iteration: h and ||w||
        hcol = torch.cat([h, hj1_t.reshape(1)]).cpu().numpy()
        hj1 = hcol[m + 1]
        hcol = hcol[:m + 1].copy()
        if hj1 != 0:
            V[j + 1] = w / hj1_t
        hcol[j + 1] = hj1
        # apply the previous Givens rotations to the new column
        for i in range(j):
            t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i], hcol[i + 1] = t1, t2
        c, s, rho = _givens(hcol[j], hcol[j + 1])
        hcol[j], hcol[j + 1] = rho, 0
        cs[j], sn[j] = c, s
        gj = g[j]
        g[j], g[j + 1] = c * gj, -s * gj
        H[:, j] = hcol
        res = abs(g[j + 1])
        hist[it0 + j + 1] = res
        j += 1

    # solve the j x j least-squares system, padded to m with identity
    k = j
    cols = np.arange(m)
    R = np.where(cols[None, :] < k, H[:m, :], np.eye(m, dtype=dtype))
    R = np.triu(R)
    R = np.where(np.diag(R)[:, None] == 0, np.eye(m, dtype=dtype),
                 R).astype(dtype)                     # happy-breakdown guard
    gk = np.where(cols < k, g[:m], 0).astype(dtype)
    y = scipy.linalg.solve_triangular(R, gk, lower=False).astype(dtype)
    yt = torch.from_numpy(y).to(b.device)
    if flexible:
        dx = torch.mv(Z.T, yt)
    else:
        dx = precond(torch.mv(V[:m].T, yt))
    return x + dx, res, k


def gmres_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
                maxiter: int = 1000, restart: int = 10, cgs: int = 1,
                flexible: bool = False):
    """Restarted GMRES: returns ``solve(b, x0=None) -> SolveResult``.

    ``restart`` is the Krylov dimension (reference key ``kspace``,
    src/HypreSystem.cpp:396); ``cgs=2`` enables two-step classical
    Gram-Schmidt; ``flexible=True`` gives FlexGMRES."""
    matvec = as_matvec(A)
    precond = as_precond(M)
    m = int(restart)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        dtype = numpy_dtype(b.dtype)
        x = torch.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol).cpu().numpy().astype(dtype)
        rnorm0 = norm(b - matvec(x)).cpu().numpy().astype(dtype)
        hist = np.full(maxiter + m + 1, -1, dtype)
        hist[0] = rnorm0
        rnorm, it = rnorm0, 0
        while it < maxiter and rnorm > target:
            x, rnorm, k = _gmres_cycle(matvec, precond, m, cgs, flexible, b,
                                       x, target, hist, it)
            it += k
        rn = torch.tensor(rnorm, device=b.device)
        return SolveResult(x=x, iters=it, relres=safe_div(rn, bnorm),
                           converged=rn <= torch.tensor(target,
                                                        device=b.device),
                           history=torch.from_numpy(hist).to(b.device))

    return solve


def cogmres_setup(A, M=None, *, cgs: int = 1, **kw):
    """Communication-optimized GMRES (ref: src/HypreSystem.cpp:372-388):
    the batched-CGS GMRES above already performs one fused reduction per
    iteration, so this shares it; ``cgs`` selects 1- or 2-step classical
    Gram-Schmidt (``HYPRE_COGMRESSetCGS``)."""
    return gmres_setup(A, M, cgs=cgs, **kw)


def fgmres_setup(A, M=None, **kw):
    """Flexible GMRES (ref: src/HypreSystem.cpp:406-421): stores the
    preconditioned basis so M may vary per iteration."""
    return gmres_setup(A, M, flexible=True, **kw)
