"""SpMV for one part: box DIA, BDIA (+ overflow), BELL or padded ELL (the
port of ``tpusolve/matrix/spmv.py``).

The hot operation of every Krylov iteration and preconditioner sweep.  A
box-DIA diag block (the stencil and the structured multigrid levels) runs
the hand-written kernel K1 through ``kernels.dia``.  A BDIA diag block runs
K4 through ``kernels.bdia``, or K5 where it carries a step plan (BDIA-XL,
as ``tpusolve`` dispatches to its XL kernel), each of which also adds the
spilled entries of its overflow list, each row its own; a BELL diag block
runs K6 through ``kernels.bell``.  ``spmv_update`` computes the update
form ``c + w * s * (b - A x)`` of the V-cycle's residuals and smoothers: one
K1 launch on a box-DIA operator.  Multi-part operators
(offd ELL block and halo exchange, ``tpusolve``'s ``halo_exchange`` and
``_offd_add``) are not ported yet: ``ShardedMatrix`` refuses to build them.
"""

from __future__ import annotations

import torch

from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
from tpusolve_torch.kernels.bell import bell_spmv
from tpusolve_torch.kernels.dia import dia_spmv, epilogue_plain


def ell_spmv_local(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Padded-ELL block SpMV: y_i = sum_k vals[i,k] * x[cols[i,k]]."""
    return (vals * x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
            ).sum(dim=-1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a one-part ``ShardedMatrix``: ``x`` is a padded vector
    over A's columns ``(col_pad,)``; returns one over its rows
    ``(row_pad,)``."""
    if A.uses_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets, x)
    if A.uses_bdia_xl:
        return bdia_spmv_xl(A.bdia_vals, A.bdia_starts, x, A.bdia_xpad,
                            A.row_pad, A.bdia_gb, A.bdia_step_lo,
                            A.bdia_panel, A.bdia_ovf)
    if A.uses_bdia:
        return bdia_spmv(A.bdia_vals, A.bdia_starts, x, A.bdia_xpad,
                         A.bdia_xlen, A.row_pad, A.bdia_ovf)
    if A.uses_bell:
        return bell_spmv(A.bell_vals, A.bell_ids, x, A.bell_nwin, A.row_pad)
    return ell_spmv_local(A.diag_vals[0], A.diag_cols[0], x)


def spmv_update(A, x: torch.Tensor, *, b=None, s=None, c=None,
                w: float = 1.0) -> torch.Tensor:
    """``y = c + w * s * (b - A x)`` over A's padded rows, each of ``b``,
    ``s``, ``c`` (padded vectors) possibly None (b = 0, s = 1, c = 0), at
    least one given: the residual ``b - A x``, the Jacobi sweep
    ``x + w * dinv * (b - A x)``, Chebyshev's ``dinv * (b - A x)`` and
    ``r - dinv * A d``.

    On a box-DIA operator it is one K1 launch, the update fused into the
    kernel.  On BDIA, BDIA-XL, BELL and ELL it is ``spmv`` followed by the
    same update in eager PyTorch (``kernels.dia.epilogue_plain``): those
    layouts have no fused kernel yet.  On the CPU both are the eager
    expressions the callers computed before, bit for bit."""
    if b is None and s is None and c is None:
        raise ValueError("spmv_update: give b, s or c (spmv computes A x)")
    if A.uses_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets, x, b, s, c, w)
    return epilogue_plain(spmv(A, x), b, s, c, w)
