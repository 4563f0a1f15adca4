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

import numpy as np

from tpusolve_torch.krylov.common import (
    Mask, SolveResult, as_matvec, norm, norm_cols, safe_div, stop_target)


def refined_solve_setup(A_hi, inner_solve, *, tol: float = 1e-8,
                        atol: float = 0.0, max_refine: int = 6,
                        lo_dtype=torch.float32):
    """Wrap a low-precision ``inner_solve(b_lo, x0=None) -> SolveResult``
    with IR against ``A_hi`` (ShardedMatrix or callable).  The returned
    ``solve(b_hi, x0=None)`` reports in ``iters`` the total inner
    iterations and in ``passes`` the inner iterations of each pass."""
    matvec_hi = as_matvec(A_hi)

    def solve(b: torch.Tensor, x0: torch.Tensor | None = None) -> SolveResult:
        if b.dim() == 2:
            return _refine_batch(matvec_hi, inner_solve, b, x0, tol, atol,
                                 max_refine, lo_dtype)
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


def _refine_batch(matvec_hi, inner_solve, b, x0, tol, atol, max_refine,
                  lo_dtype) -> SolveResult:
    """Refinement of the k columns of ``b`` (k, n), the outer loop a
    column's own: each pass solves the running columns' residuals as one
    batch, and a column stops once its own test holds."""
    k = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    bnorm = norm_cols(b)
    target = stop_target(bnorm, tol, atol).cpu().numpy()
    r = b - matvec_hi(x)
    rnorm = norm_cols(r)
    rn = rnorm.cpu().numpy()
    passes: list[list[int]] = [[] for _ in range(k)]
    npass = np.zeros(k, np.int64)
    run = (npass < max_refine) & (rn > target)
    while run.any():
        cols = np.flatnonzero(run)
        idx = torch.from_numpy(cols).to(b.device)
        res = inner_solve(r.index_select(0, idx).to(lo_dtype), None)
        x = x.index_add(0, idx, res.x.to(b.dtype))
        m = Mask(run, b.device)
        r = m.keep(b - matvec_hi(x), r)
        rnorm = m.keep(norm_cols(r), rnorm)
        rn = rnorm.cpu().numpy()
        for c, it in zip(cols, res.iters):
            passes[c].append(int(it))
        npass[run] += 1
        run = (npass < max_refine) & (rn > target)
    return SolveResult(x=x, iters=[sum(p) for p in passes],
                       relres=safe_div(rnorm, bnorm),
                       converged=rnorm <= torch.from_numpy(target).to(
                           rnorm.device),
                       passes=passes)
