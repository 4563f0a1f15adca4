"""Mixed-precision iterative refinement (the port of
``tpusolve/krylov/refine.py``).

Classical IR around a low-precision solver::

    repeat:  r = b - A x        (high precision)
             solve A d = r      (f32 Krylov + preconditioner)
             x <- x + d         (high-precision accumulation)

The inner solver reduces the residual by its own tolerance (~1e-5); the
outer loop compounds that per pass.  Plain callables replace ``tpusolve``'s
``_fn``/``_state`` protocol.
"""

from __future__ import annotations

import torch

from tpusolve_torch.krylov.common import (
    SolveResult, as_matvec, norm, safe_div, stop_target)


def refined_solve_setup(A_hi, inner_solve, *, tol: float = 1e-8,
                        atol: float = 0.0, max_refine: int = 6,
                        lo_dtype=torch.float32):
    """Wrap a low-precision ``inner_solve(b_lo, x0=None) -> SolveResult``
    with IR against ``A_hi`` (ShardedMatrix or callable).  The returned
    ``solve(b_hi, x0=None)`` reports in ``iters`` the total inner
    iterations and in ``passes`` the inner iterations of each pass."""
    matvec_hi = as_matvec(A_hi)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
        bnorm = norm(b)
        target = float(stop_target(bnorm, tol, atol))
        r = b - matvec_hi(x)
        rnorm = norm(r)
        passes: list[int] = []
        while len(passes) < max_refine and float(rnorm) > target:
            res = inner_solve(r.to(lo_dtype), None)
            x = x + res.x.to(b.dtype)
            r = b - matvec_hi(x)
            rnorm = norm(r)
            passes.append(int(res.iters))
        return SolveResult(x=x, iters=sum(passes),
                           relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target, passes=passes)

    return solve
