"""SpMV: box DIA, BDIA (+ overflow), BELL or ELL diag blocks, and the offd
block and halo exchange of a multi-part operator (the port of
``tpusolve/matrix/spmv.py``).

The hot operation of every Krylov iteration and preconditioner sweep.  A
box-DIA diag block (the stencil, the structured multigrid levels and the
banded operators the assembly stores as DIA) runs the hand-written kernel
K1 through ``kernels.dia``.  A BDIA diag block runs
K4 through ``kernels.bdia``, or K5 where it carries a step plan (BDIA-XL,
as ``tpusolve`` dispatches to its XL kernel), each of which also adds the
spilled entries of its overflow list, each row its own; a BELL diag block
runs K6 through ``kernels.bell``, and an ELL one (the AMG transfers and
the AMG levels K2's model prices fastest), padded or row-pointer, K2
through ``kernels.ell``.  ``spmv_update`` computes the update form ``c + w
* s * (b - A x)`` of the V-cycle's residuals and smoothers, the
prolongation's add and the ILU apply's Jacobi sweeps: one K1 launch on a
box-DIA operator, one K2 launch on ELL, one K5 launch on BDIA-XL.
A batch of k vectors, ``x`` (k, col_pad) (the coupled multi-component
solve, ``tpusolve``'s ``vmap`` over the stacked right-hand sides, in its
(k, n) layout), reads the operator once a launch where its kernel has a
k-column form: K2 (ELL, on the bfloat16 smoother twin too) and K5
(BDIA-XL), up to 8 columns a launch (``MAX_COLS``).  K1 (DIA), K4 (BDIA)
and K6 (BELL) launch once a column, each launch counted by its kernel's
counter (ROADMAP.md Queue 2 holds their k-column forms).  Column j of a
batch is the single-vector call on column j bit for bit.

A multi-part operator keeps its parts stacked on one device.  The diag
blocks of all parts run as one launch of their layout's kernel (each kernel
takes the parts axis; K2 on the rows of all parts, ``ShardedMatrix.
ell_arrays``).  The halo exchange, ``tpusolve``'s gather of the send lists
and ``all_to_all`` (:func:`halo_exchange`, kept as the plan's reference),
is one index gather of the stacked x (:func:`halo_gather`, by the flat
sources ``ShardedMatrix.halo_src``), and the offd block over the gathered
ghosts is one K2 launch (``ShardedMatrix.offd_k2``).  ``spmv`` adds it to
the diag product in that launch's update form (``tpusolve``'s ``interior +
offd``, ``_offd_add``); the update forms fold it into b first, ``b' = b -
A_offd g``, and then run the diag block's fused update on b', so a fused
kernel (K1, K2, K5, and the cycle's fused transfers) keeps its one launch.
The sum is ordered differently from ``tpusolve``'s there, which differs in
the last bit.

Across ranks (``dist.py``) an operator is a rank's slice of its parts
(``ShardedMatrix.rank_slice``): :func:`halo_gather` gathers the entries its
peers need from its x (``RankHalo.send_idx``), hands them over in one
``all_to_all_single`` (``dist.exchange``) and reads each ghost from x or
from what it received (``RankHalo.src``), the whole operator's ghosts bit
for bit; the K2 launches on the diag and offd blocks are unchanged, each
over the rank's parts.
"""

from __future__ import annotations

import torch

from tpusolve_torch import dist
from tpusolve_torch.kernels.bdia import (bdia_spmv, bdia_spmv_xl,
                                         bdia_spmv_xl_run)
from tpusolve_torch.kernels.bell import bell_spmv
from tpusolve_torch.kernels.dia import dia_spmv, epilogue_plain
from tpusolve_torch.kernels.ell import ell_spmv


MAX_COLS = 8   # columns of one k-column launch (K2's and K5's forms)


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor,
                  ghost_slot: torch.Tensor) -> torch.Tensor:
    """Every part's ghosts (P, G) by ``tpusolve``'s plan in its two steps
    (``tpusolve/matrix/spmv.py:60``): each part gathers what it sends each
    peer (``send_idx`` (P, P, S) into its padded slice of ``x`` (P *
    col_pad,)), the ``all_to_all`` hands part q the buffers addressed to
    it, and q reads its ghosts at ``ghost_slot`` (P, G) in the flat
    receive buffer.  The plan's reference: :func:`halo_gather` is the same
    in one gather."""
    P, _, S = send_idx.shape
    xs = x.reshape(P, -1)
    send = torch.stack([xs[p][send_idx[p].long()] for p in range(P)])
    recv = send.transpose(0, 1).reshape(P, P * S)    # recv[q] from each p
    return torch.gather(recv, 1, ghost_slot.long())


def halo_gather(A, x: torch.Tensor) -> torch.Tensor:
    """The ghosts of every part of multi-part operator ``A``, stacked (P *
    G,), or (k, P * G) for a batch ``x`` (k, P * col_pad): one index
    gather of x at ``A.halo_src``, the exchange of :func:`halo_exchange`.
    On a rank's slice, its parts' ghosts: the entries its peers read
    gathered, one ``all_to_all_single``, and each ghost read from x or
    from what came in (:class:`~tpusolve_torch.matrix.sharded.RankHalo`)."""
    axis = x.dim() - 1
    h = A.rank_halo
    if h is None:
        return x.index_select(axis, A.halo_src)
    recv = dist.exchange(x.index_select(axis, h.send_idx), h.send_splits,
                         h.recv_splits)
    return torch.cat([x, recv], axis).index_select(axis, h.src)


def offd_spmv(A, g: torch.Tensor, **update) -> torch.Tensor:
    """One K2 launch on A's offd block over ghosts ``g`` (P * G,) (or a
    batch (k, P * G)), with K2's ``update`` arguments: ``b=b`` gives ``b -
    A_offd g``."""
    vals, cols, rowptr = A.offd_k2
    return ell_spmv(vals, cols, g, rowptr=rowptr, offd=True,
                    width=A.plain_widths[1], **update)


def _offd(A, x: torch.Tensor, **update) -> torch.Tensor:
    """:func:`offd_spmv` over the ghosts of ``x`` (a vector or a batch)."""
    return offd_spmv(A, halo_gather(A, x), **update)


def _add_offd(A, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y += A_offd g`` in place: K2's update form ``c - w A g`` at ``c =
    y``, ``w = -1``."""
    return _offd(A, x, c=y, w=-1.0, out=y)


def _fold_offd(A, x: torch.Tensor, b):
    """``b - A_offd g`` (``-A_offd g`` without b): the right-hand side the
    diag block's update forms take on a multi-part operator."""
    if b is not None:
        return _offd(A, x, b=b)
    return torch.neg(_offd(A, x))


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``ShardedMatrix``: ``x`` is a padded vector over A's
    columns ``(P * col_pad,)``, or a batch ``(k, P * col_pad)`` of them;
    returns one over its rows ``(P * row_pad,)``, or ``(k, P * row_pad)``.
    On a multi-part operator, the diag blocks' product plus the offd
    block's over the gathered ghosts."""
    if x.dim() == 2:
        return _batch(A, x, {})
    y = _diag_spmv(A, x)
    return _add_offd(A, x, y) if A.has_offd else y


def _diag_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """The diag blocks' product, one launch of the layout's kernel."""
    if A.uses_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets, x)
    if A.uses_bdia_xl:
        return _xl(A, x)
    if A.uses_bdia:
        return bdia_spmv(A.bdia_vals, A.bdia_starts, x, A.bdia_xpad,
                         A.bdia_xlen, A.row_pad, A.bdia_ovf)
    if A.uses_bell:
        return bell_spmv(A.bell_vals, A.bell_ids, x, A.bell_nwin, A.row_pad)
    vals, cols, rowptr = A.ell_arrays
    return ell_spmv(vals, cols, x, rowptr=rowptr, width=A.plain_widths[0])


def spmv_update(A, x: torch.Tensor, *, b=None, s=None, c=None,
                w: float = 1.0, out=None) -> torch.Tensor:
    """``y = c + w * s * (b - A x)`` over A's padded rows, each of ``b``,
    ``s``, ``c`` (padded vectors) possibly None (b = 0, s = 1, c = 0), at
    least one given (on a batch ``x`` (k, col_pad), ``b``, ``c`` and ``out``
    are (k, row_pad) and ``s`` one vector for all columns): the residual
    ``b - A x``, the Jacobi sweep
    ``x + w * dinv * (b - A x)``, Chebyshev's ``dinv * (b - A x)`` and
    ``r - dinv * A d``; with ``out`` (which may be ``c``) the result is
    written there: the prolongation ``x + P e`` is ``c = x``, ``w = -1``.

    On a box-DIA operator it is one K1 launch, on ELL (either form) one K2
    launch and on BDIA-XL one K5 launch, the update fused into the kernel
    and written into ``out`` when given.
    On BDIA (K4) and BELL it is ``spmv`` followed by the same update in
    eager PyTorch (``kernels.dia.epilogue_plain``, its last step writing
    into ``out``): those layouts have no fused kernel.  ``out`` must not
    be x.  On the CPU all are the eager expressions the callers computed
    before, bit for bit.  On a multi-part operator one K2 launch on the
    offd block first gives ``b' = b - A_offd g`` (:func:`_fold_offd`),
    which the diag block's update takes for b."""
    if b is None and s is None and c is None:
        raise ValueError("spmv_update: give b, s or c (spmv computes A x)")
    if x.dim() == 2:
        return _batch(A, x, dict(b=b, s=s, c=c, w=w, out=out))
    if A.has_offd:
        b = _fold_offd(A, x, b)
    if A.uses_ell:
        vals, cols, rowptr = A.ell_arrays
        return ell_spmv(vals, cols, x, b, s, c, w, out=out, rowptr=rowptr,
                        width=A.plain_widths[0])
    if A.uses_bdia_xl:
        return _xl(A, x, b=b, s=s, c=c, w=w, out=out)
    if A.uses_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets, x, b, s, c, w, out=out)
    return epilogue_plain(_diag_spmv(A, x), b, s, c, w, out=out)


def _xl(A, x: torch.Tensor, **update) -> torch.Tensor:
    """K5 on BDIA-XL operator ``A``, with its segment mask and, given,
    the update form's arguments: on the card from the launch arguments the
    operator checked once (``A.bdia_xl_op``)."""
    if A.bdia_xl_op is not None and x.device.type == "cuda":
        return bdia_spmv_xl_run(A.bdia_xl_op, x, **update)
    return bdia_spmv_xl(A.bdia_vals, A.bdia_starts, x, A.bdia_xpad,
                        A.row_pad, A.bdia_gb, A.bdia_step_lo, A.bdia_panel,
                        A.bdia_ovf, mask=A.bdia_mask, step_b0=A.bdia_step_b0,
                        stage=A.bdia_stage, **update)


def _batch(A, x: torch.Tensor, update: dict) -> torch.Tensor:
    """``spmv`` (``update`` empty) or ``spmv_update`` (its arguments) on a
    batch ``x`` (k, col_pad): one k-column launch of K2 or K5 for up to
    ``MAX_COLS`` columns, else one launch a column.  On a multi-part
    operator the ghosts of the k columns are gathered at once and the offd
    block is one k-column K2 launch too."""
    k = x.shape[0]
    out = update.get("out")
    if k > MAX_COLS:
        part = lambda t, i: t if t is None or t.dim() == 1 else \
            t[i:i + MAX_COLS]
        ys = [_batch(A, x[i:i + MAX_COLS],
                     {n: part(t, i) if n != "w" else t
                      for n, t in update.items()})
              for i in range(0, k, MAX_COLS)]
        return out if out is not None else torch.cat(ys)
    one = (A.uses_ell or A.uses_dia
           or (A.uses_bdia_xl and A.bdia_xl_op is not None
               and x.device.type == "cuda"))
    if one and A.has_offd:
        if not update:
            return _add_offd(A, x, _diag_batch(A, x, {}))
        update = dict(update, b=_fold_offd(A, x, update.get("b")))
    if one:
        return _diag_batch(A, x, update)
    col = lambda t, j: t if t is None or t.dim() == 1 else t[j]
    if not update:
        return torch.stack([spmv(A, x[j]) for j in range(k)])
    ys = [spmv_update(A, x[j], **{n: col(t, j) if n != "w" else t
                                   for n, t in update.items()})
          for j in range(k)]
    return out if out is not None else torch.stack(ys)


def _diag_batch(A, x: torch.Tensor, update: dict) -> torch.Tensor:
    """The diag blocks' one k-column launch on a batch (K2, K5) or K1's
    launch, which runs each column itself."""
    if A.uses_ell:
        vals, cols, rowptr = A.ell_arrays
        return ell_spmv(vals, cols, x, rowptr=rowptr,
                        width=A.plain_widths[0], **update)
    if A.uses_dia:
        # K1 runs each column itself (kernels/dia.py)
        return dia_spmv(A.dia_vals, A.dia_offsets, x, **update)
    return bdia_spmv_xl_run(A.xl_cols_op(x.shape[0]), x, **update)
