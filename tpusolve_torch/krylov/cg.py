"""Preconditioned conjugate gradients (the port of ``tpusolve/krylov/cg.py``).

Replacement for ``HYPRE_ParCSRPCG*`` (consumed by the reference at
src/HypreSystem.cpp:440-455).  ``tpusolve`` runs PCG either as one
``lax.while_loop`` program (``fused=True``) or as one jitted step per
iteration (``fused=False``); the port has one host loop, which reads
``||r||`` once per iteration, as the port's BiCGSTAB does.  It keeps the
fused form's contract: the history is a fixed ``(maxiter+1)`` buffer in
``b.dtype``, padded with -1 (``tpusolve``'s stepped form returns a
variable-length f64 list; ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from tpusolve_torch.krylov.common import (
    SolveResult, as_matvec, as_precond, dot, norm, safe_div, stop_target,
    history_buffer)


def pcg_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
              maxiter: int = 1000):
    """Build a PCG solver closure ``solve(b, x0=None) -> SolveResult`` for
    operator ``A`` and preconditioner ``M`` (z = M(r)), with ``tpusolve``'s
    update formulas (``cg.py:59-71``)."""
    matvec = as_matvec(A)
    precond = as_precond(M)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        x = torch.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = float(stop_target(bnorm, tol, atol))
        r = b - matvec(x)
        z = precond(r)
        p = z
        rz = dot(r, z)
        rnorm = norm(r)
        hist = history_buffer(maxiter, rnorm)
        it = 0
        while it < maxiter and float(rnorm) > target:
            Ap = matvec(p)
            alpha = safe_div(rz, dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = dot(r, z)
            beta = safe_div(rz_new, rz)
            p = z + beta * p
            rz = rz_new
            rnorm = norm(r)
            hist[it + 1] = rnorm
            it += 1
        return SolveResult(x=x, iters=it, relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target, history=hist)

    return solve


def pcg(A, b, x0=None, M=None, *, tol: float = 1e-5, atol: float = 0.0,
        maxiter: int = 1000) -> SolveResult:
    """One-shot convenience wrapper around :func:`pcg_setup`."""
    return pcg_setup(A, M, tol=tol, atol=atol, maxiter=maxiter)(b, x0)
