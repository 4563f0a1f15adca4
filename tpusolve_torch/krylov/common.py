"""Shared Krylov machinery (the port of ``tpusolve/krylov/common.py``).

Solvers work on padded vectors; the padding invariant (padded entries
exactly 0) makes dot products and norms mask-free.  Each solver follows the
reference's setup/solve split (ref: src/HypreSystem.h:265-277):
``*_setup(A, M, ...)`` returns ``solve(b, x0=None) -> SolveResult``.
``tpusolve`` runs its loops as ``lax.while_loop`` on the device; here the
loop runs on the host and reads one scalar (the residual norm) per
iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv


@dataclass
class SolveResult:
    x: torch.Tensor
    iters: int                 # iterations (refinement: total inner ones)
    relres: torch.Tensor       # final ||r|| / ||b||, 0-d
    converged: torch.Tensor    # 0-d bool
    history: torch.Tensor | None = None  # per-iteration ||r|| (padded with -1)
    passes: list[int] | None = None      # refinement: inner iters per pass


def history_buffer(maxiter: int, r0: torch.Tensor) -> torch.Tensor:
    """(maxiter+1,) residual-norm trace: slot 0 = initial residual, unused
    slots = -1."""
    buf = torch.full((maxiter + 1,), -1.0, dtype=r0.dtype, device=r0.device)
    buf[0] = r0
    return buf


def as_matvec(A) -> Callable:
    """Accept a ShardedMatrix or a callable y = A(x)."""
    if isinstance(A, ShardedMatrix):
        return lambda x: spmv(A, x)
    if callable(A):
        return A
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def as_precond(M) -> Callable:
    """Preconditioner contract: z = M(r); None is the identity."""
    if M is None:
        return lambda r: r
    return as_matvec(M)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a))


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0/0 -> 0 (breakdown guards)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def stop_target(bnorm: torch.Tensor, tol: float, atol: float) -> torch.Tensor:
    """Convergence target: ||r|| <= max(tol * ||b||, atol)."""
    return torch.clamp(tol * bnorm, min=atol)
