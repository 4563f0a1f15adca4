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

from tpusolve_torch.krylov.common import (
    SolveResult, as_matvec, as_precond, norm, safe_div, stop_target)


def stationary_solve_setup(A, M, *, tol: float = 0.0, atol: float = 0.0,
                           maxiter: int = 1):
    """Build ``solve(b, x0=None) -> SolveResult`` for operator ``A`` and
    preconditioner ``M`` (z = M(r)): each iteration one preconditioner
    application and one matvec, whose residual serves both the next update
    and the convergence norm."""
    matvec = as_matvec(A)
    precond = as_precond(M)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
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
