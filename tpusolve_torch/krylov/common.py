"""Shared Krylov machinery (the port of ``tpusolve/krylov/common.py``).

Solvers work on padded vectors; the padding invariant (padded entries
exactly 0) makes dot products and norms mask-free.  Each solver follows the
reference's setup/solve split (ref: src/HypreSystem.h:265-277):
``*_setup(A, M, ...)`` returns ``solve(b, x0=None) -> SolveResult``.
``tpusolve`` runs its loops as ``lax.while_loop`` on the device; here the
loop runs on the host and reads one scalar (the residual norm) per
iteration.

Every ``solve`` also takes a batch ``b`` (k, n) of k right-hand sides (the
coupled multi-component solve), with ``tpusolve``'s ``vmap`` semantics:
each column runs the single solve's recurrences; a column whose stop test
holds is frozen (its carry kept, as ``vmap`` of a ``lax.while_loop``
selects the old carry) while it stays in the batch, masked; the loop ends
when every column has stopped; the host reads the k residual norms in one
transfer an iteration.  The result carries per-column fields
(:meth:`SolveResult.column` takes one out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv


@dataclass
class SolveResult:
    """One solve's result, or a batch's: then ``x`` is (k, n), ``iters``
    a list of k counts, ``relres`` and ``converged`` (k,), ``history`` (k,
    maxiter + 1) and ``passes`` a list of k lists."""
    x: torch.Tensor
    iters: int                 # iterations (refinement: total inner ones)
    relres: torch.Tensor       # final ||r|| / ||b||, 0-d
    converged: torch.Tensor    # 0-d bool
    history: torch.Tensor | None = None  # per-iteration ||r|| (padded with -1)
    passes: list[int] | None = None      # refinement: inner iters per pass

    def column(self, j: int) -> "SolveResult":
        """Column ``j`` of a batch's result, as a single solve's."""
        return SolveResult(
            x=self.x[j], iters=int(self.iters[j]), relres=self.relres[j],
            converged=self.converged[j],
            history=None if self.history is None else self.history[j],
            passes=None if self.passes is None else self.passes[j])


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


# --- batches of k vectors (k, n): the coupled multi-component solve


def dot_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(k,) dot products of the rows of two (k, n) batches."""
    return torch.sum(a * b, dim=-1)


def norm_cols(a: torch.Tensor) -> torch.Tensor:
    """(k,) 2-norms of the rows of a (k, n) batch."""
    return torch.sqrt(torch.sum(a * a, dim=-1))


def scale(alpha: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Each row of batch ``v`` times its entry of the (k,) ``alpha``."""
    return alpha[:, None] * v


class Mask:
    """The running columns of a batched loop, kept on the host (numpy bool
    (k,)) and on the device: ``keep(new, old)`` is the carry a ``vmap`` of
    a ``lax.while_loop`` keeps, ``new`` in running columns and ``old`` in
    frozen ones."""

    def __init__(self, running, device):
        self.host = running
        self.dev = torch.from_numpy(running).to(device)

    def keep(self, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        m = self.dev if new.dim() == 1 else self.dev[:, None]
        return torch.where(m, new, old)
