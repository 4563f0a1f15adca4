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
    Mask, SolveResult, as_matvec, as_precond, norm, norm_cols, safe_div,
    stop_target)
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


def _rotate(hcol, j, cs, sn, g, H):
    """The Givens step of inner iteration ``j`` on the new Hessenberg
    column ``hcol`` (its entry j + 1 set), as :func:`_gmres_cycle` takes it:
    the previous rotations, a new one zeroing entry j + 1, the rotated
    right-hand side; returns the residual estimate ``|g[j + 1]|``."""
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
    return abs(g[j + 1])


def _least_squares(H, g, k, m, dtype):
    """y of the k x k least-squares system of a cycle, padded to m with the
    identity, as :func:`_gmres_cycle` solves it."""
    cols = np.arange(m)
    R = np.where(cols[None, :] < k, H[:m, :], np.eye(m, dtype=dtype))
    R = np.triu(R)
    R = np.where(np.diag(R)[:, None] == 0, np.eye(m, dtype=dtype),
                 R).astype(dtype)                     # happy-breakdown guard
    gk = np.where(cols < k, g[:m], 0).astype(dtype)
    return scipy.linalg.solve_triangular(R, gk, lower=False).astype(dtype)


def _gmres_cycle_batch(matvec, precond, m, cgs, flexible, b, x, target,
                       hist, it0, outer):
    """One restart cycle on the k columns of ``b`` (k, n) whose ``outer``
    (numpy bool (k,)) loop still runs; each column keeps its own Hessenberg
    matrix, rotations and count and stops its inner loop on its own
    estimate.  Returns (x_new, estimates, inner iterations), numpy (k,)
    the latter two."""
    dtype = numpy_dtype(b.dtype)
    k, n = b.shape
    r = b - matvec(x)
    beta = norm_cols(r)
    beta_h = beta.cpu().numpy().astype(dtype)
    V = torch.zeros((k, m + 1, n), dtype=b.dtype, device=b.device)
    V[:, 0] = torch.where((beta != 0)[:, None], r / beta[:, None],
                          torch.zeros((), dtype=b.dtype, device=b.device))
    Z = (torch.zeros((k, m, n), dtype=b.dtype, device=b.device)
         if flexible else None)
    H = np.zeros((k, m + 1, m), dtype)
    cs = np.zeros((k, m), dtype)
    sn = np.zeros((k, m), dtype)
    g = np.zeros((k, m + 1), dtype)
    g[:, 0] = beta_h
    res = beta_h.copy()
    steps = np.zeros(k, np.int64)
    j = 0                      # a running column's inner iteration
    run = outer & (res > target)
    while j < m and run.any():
        mask = Mask(run, b.device)
        z = precond(V[:, j])
        w = matvec(z)
        if flexible:
            Z[:, j] = mask.keep(z, Z[:, j])
        # batched classical Gram-Schmidt, a column's own basis each
        h = torch.bmm(V, w[:, :, None])[:, :, 0]
        w = w - torch.bmm(V.transpose(1, 2), h[:, :, None])[:, :, 0]
        if cgs >= 2:
            h2 = torch.bmm(V, w[:, :, None])[:, :, 0]
            w = w - torch.bmm(V.transpose(1, 2), h2[:, :, None])[:, :, 0]
            h = h + h2
        hj1_t = norm_cols(w)
        # the one host read of the iteration: every column's h and ||w||
        hcols = torch.cat([h, hj1_t[:, None]], dim=1).cpu().numpy()
        grow = run & (hcols[:, m + 1] != 0)
        V[:, j + 1] = Mask(grow, b.device).keep(w / hj1_t[:, None],
                                                V[:, j + 1])
        for c in np.flatnonzero(run):
            hcol = hcols[c, :m + 1].copy()
            hcol[j + 1] = hcols[c, m + 1]
            res[c] = _rotate(hcol, j, cs[c], sn[c], g[c], H[c])
            hist[c, it0[c] + j + 1] = res[c]
        steps[run] += 1
        j += 1
        run = run & (res > target)
    Y = np.zeros((k, m), dtype)
    for c in np.flatnonzero(outer):
        Y[c] = _least_squares(H[c], g[c], int(steps[c]), m, dtype)
    yt = torch.from_numpy(Y).to(b.device)
    if flexible:
        dx = torch.bmm(Z.transpose(1, 2), yt[:, :, None])[:, :, 0]
    else:
        dx = precond(torch.bmm(V[:, :m].transpose(1, 2),
                               yt[:, :, None])[:, :, 0])
    return x + dx, res, steps


def _gmres_batch(matvec, precond, m, cgs, flexible, b, x0, tol, atol,
                 maxiter) -> SolveResult:
    """Restarted GMRES on the k columns of ``b`` (k, n) at once: a column's
    restart loop, like its inner loop, stops on its own estimate."""
    dtype = numpy_dtype(b.dtype)
    k = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = norm_cols(b)
    target = stop_target(bnorm, tol, atol).cpu().numpy().astype(dtype)
    rnorm = norm_cols(b - matvec(x)).cpu().numpy().astype(dtype)
    hist = np.full((k, maxiter + m + 1), -1, dtype)
    hist[:, 0] = rnorm
    it = np.zeros(k, np.int64)
    outer = (it < maxiter) & (rnorm > target)
    while outer.any():
        x_n, res, steps = _gmres_cycle_batch(matvec, precond, m, cgs,
                                             flexible, b, x, target, hist,
                                             it, outer)
        x = Mask(outer, b.device).keep(x_n, x)
        rnorm = np.where(outer, res, rnorm).astype(dtype)
        it = it + np.where(outer, steps, 0)
        outer = (it < maxiter) & (rnorm > target)
    rn = torch.from_numpy(rnorm).to(b.device)
    return SolveResult(x=x, iters=it.tolist(), relres=safe_div(rn, bnorm),
                       converged=rn <= torch.from_numpy(target).to(b.device),
                       history=torch.from_numpy(hist).to(b.device))


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
        if b.dim() == 2:
            return _gmres_batch(matvec, precond, m, cgs, flexible, b, x0,
                                tol, atol, maxiter)
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
