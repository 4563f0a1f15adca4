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

from tpusolve_torch.krylov.common import (
    SolveResult, as_matvec, as_precond, dot, norm, safe_div, stop_target,
    history_buffer)


def bicgstab_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
                   maxiter: int = 1000):
    matvec = as_matvec(A)
    precond = as_precond(M)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
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
