"""Preconditioned BiCGSTAB for non-symmetric systems (the port of
``tpusolve/krylov/bicgstab.py``).

Replacement for ``HYPRE_ParCSRBiCGSTAB*`` (ref: src/HypreSystem.cpp:423-438).
Right-preconditioned van der Vorst BiCGSTAB: two matvecs and two
preconditioner applications per iteration.  ``tpusolve``'s
``lax.while_loop`` becomes a host loop that reads ``||r||`` once per
iteration; the history keeps its fixed ``(maxiter+1)`` buffer padded with
-1.
"""

from __future__ import annotations

import torch

import numpy as np

from tpusolve_torch.krylov.common import (
    Mask, SolveResult, as_matvec, as_precond, dot, dot_cols, norm,
    norm_cols, safe_div, scale, stop_target, history_buffer)
from tpusolve_torch.matrix.vectors import numpy_dtype


def bicgstab_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
                   maxiter: int = 1000):
    matvec = as_matvec(A)
    precond = as_precond(M)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        if b.dim() == 2:
            return _bicgstab_batch(matvec, precond, b, x0, tol, atol,
                                   maxiter)
        x = torch.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = float(stop_target(bnorm, tol, atol))
        r = b - matvec(x)
        r0 = r  # shadow residual
        rho = dot(r0, r)
        p = r
        rnorm = norm(r)
        hist = history_buffer(maxiter, rnorm)
        it = 0
        while it < maxiter and float(rnorm) > target:
            phat = precond(p)
            v = matvec(phat)
            alpha = safe_div(rho, dot(r0, v))
            s = r - alpha * v
            shat = precond(s)
            t = matvec(shat)
            omega = safe_div(dot(t, s), dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho_new = dot(r0, r)
            beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
            p = r + beta * (p - omega * v)
            rho = rho_new
            rnorm = norm(r)
            hist[it + 1] = rnorm
            it += 1
        return SolveResult(x=x, iters=it, relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target, history=hist)

    return solve


def _bicgstab_batch(matvec, precond, b, x0, tol, atol,
                    maxiter) -> SolveResult:
    """BiCGSTAB on the k columns of ``b`` (k, n) at once: each column the
    single solve's recurrences, its breakdown guards its own, frozen once
    its stop test holds."""
    k = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = norm_cols(b)
    target = stop_target(bnorm, tol, atol).cpu().numpy()
    r = b - matvec(x)
    r0 = r  # shadow residual
    rho = dot_cols(r0, r)
    p = r
    rnorm = norm_cols(r)
    rn = rnorm.cpu().numpy()
    hist = np.full((k, maxiter + 1), -1, numpy_dtype(b.dtype))
    hist[:, 0] = rn
    its = np.zeros(k, np.int64)
    run = (its < maxiter) & (rn > target)
    while run.any():
        m = Mask(run, b.device)
        phat = precond(p)
        v = matvec(phat)
        alpha = safe_div(rho, dot_cols(r0, v))
        s = r - scale(alpha, v)
        shat = precond(s)
        t = matvec(shat)
        omega = safe_div(dot_cols(t, s), dot_cols(t, t))
        x_n = x + scale(alpha, phat) + scale(omega, shat)
        r_n = s - scale(omega, t)
        rho_new = dot_cols(r0, r_n)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p_n = r_n + scale(beta, p - scale(omega, v))
        x, r, p = m.keep(x_n, x), m.keep(r_n, r), m.keep(p_n, p)
        rho, rnorm = m.keep(rho_new, rho), m.keep(norm_cols(r_n), rnorm)
        rn = rnorm.cpu().numpy()        # the iteration's one host read
        its[run] += 1
        hist[run, its[run]] = rn[run]
        run = (its < maxiter) & (rn > target)
    return SolveResult(x=x, iters=its.tolist(),
                       relres=safe_div(rnorm, bnorm),
                       converged=rnorm <= torch.from_numpy(target).to(
                           rnorm.device),
                       history=torch.from_numpy(hist).to(b.device))
