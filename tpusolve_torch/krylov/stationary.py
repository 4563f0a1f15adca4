"""Stationary (fixed-point) iteration x <- x + M(b - A x) (the port of
``tpusolve/krylov/stationary.py``).

Used for AMG as the solver (ref: setup_boomeramg_solver,
src/HypreSystem.cpp:91-117) and ILU as the solver (ref: setup_ilu,
src/HypreSystem.cpp:457-497).  ``tpusolve`` runs one ``lax.while_loop``;
here the loop runs on the host and reads ``||r||`` once per iteration, as
``krylov/cg.py`` does.
"""

from __future__ import annotations

import torch

import numpy as np

from tpusolve_torch.krylov.common import (
    Mask, SolveResult, as_matvec, as_precond, norm, norm_cols, safe_div,
    stop_target)


def stationary_solve_setup(A, M, *, tol: float = 0.0, atol: float = 0.0,
                           maxiter: int = 1):
    """Build ``solve(b, x0=None) -> SolveResult`` for operator ``A`` and
    preconditioner ``M`` (z = M(r)): each iteration one preconditioner
    application and one matvec, whose residual serves both the next update
    and the convergence norm."""
    matvec = as_matvec(A)
    precond = as_precond(M)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        if b.dim() == 2:
            return _stationary_batch(matvec, precond, b, x0, tol, atol,
                                     maxiter)
        x = torch.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = float(stop_target(bnorm, tol, atol))
        r = b - matvec(x)
        rnorm = norm(r)
        it = 0
        while it < maxiter and float(rnorm) > target:
            x = x + precond(r)
            r = b - matvec(x)
            rnorm = norm(r)
            it += 1
        return SolveResult(x=x, iters=it, relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target)

    return solve


def _stationary_batch(matvec, precond, b, x0, tol, atol,
                      maxiter) -> SolveResult:
    """The iteration on the k columns of ``b`` (k, n) at once, a column
    frozen once its stop test holds."""
    k = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = norm_cols(b)
    target = stop_target(bnorm, tol, atol).cpu().numpy()
    r = b - matvec(x)
    rnorm = norm_cols(r)
    rn = rnorm.cpu().numpy()
    its = np.zeros(k, np.int64)
    run = (its < maxiter) & (rn > target)
    while run.any():
        m = Mask(run, b.device)
        x_n = x + precond(r)
        r_n = b - matvec(x_n)
        x, r = m.keep(x_n, x), m.keep(r_n, r)
        rnorm = m.keep(norm_cols(r_n), rnorm)
        rn = rnorm.cpu().numpy()
        its[run] += 1
        run = (its < maxiter) & (rn > target)
    return SolveResult(x=x, iters=its.tolist(),
                       relres=safe_div(rnorm, bnorm),
                       converged=rnorm <= torch.from_numpy(target).to(
                           rnorm.device))
