"""BDIA (blocked-DIA) SpMV: host planners, plain PyTorch version, CUDA kernel.

Rows are cut into blocks of ``R``; each block stores the union of its own
(col - row) offsets as ``D`` slots:

* ``vals``:   (P, B, D, R) coefficient rows per (part, block, slot), zeros in
              padding;
* ``starts``: (P, B, D) int32, where each slot's x window begins in the
              zero-padded x of length ``xlen`` (start = xpad_lo + b*R + offset).

SpMV is then one contiguous (R,)-window read of x and one (R,)-wide
multiply-add per (block, slot)::

    y[b*R : (b+1)*R] = sum_d vals[b, d] * x_pad[starts[b, d] : +R]

Entries that do not fit a block's ``D`` slots go to an overflow list, given
as ``ovf = (ptr, cols, vals)``: ``ptr`` (P, row_pad + 1) int32 is a CSR row
pointer, ``cols`` (P, k) int32 columns of the unpadded x, ``vals`` (P, k).
Row i then adds ``sum_j vals[j] * x[cols[j]]`` over ``j`` in
``[ptr[i], ptr[i + 1])``.

The host planners (``plan_fill_profile``, ``compact``, ``finalize_starts``,
``plan_panels``) are numpy copies of ``tpusolve/kernels/bdia.py`` so that
both packages lay out a matrix identically.  ``bdia_spmv`` launches the
hand-written Hopper kernel K4, ``csrc/bdia_spmv.cu`` (the port of
``tpusolve``'s Pallas ``_bdia_kernel``), on CUDA tensors and runs
``bdia_spmv_plain`` on CPU tensors.

**Panel steps (BDIA-XL).**  ``bdia_spmv_xl`` computes the same function with
K5, ``csrc/bdia_spmv_xl.cu`` (the port of ``_bdia_kernel_xl``): one thread
block per *step* of consecutive R-row blocks copies the step's x panel,
every x entry its windows read, into shared memory, and reads the windows
from there; it stages the step's overflow entries in shared memory too.
``plan_steps`` is the port's own step plan: ``gb`` (the most blocks a step
holds), each step's panel start ``step_lo`` (P, nsteps) int32 in the
unpadded x (negative where the panel begins before x; entries outside
``[0, col_pad)`` read as 0), one panel length for all steps, in elements,
each step's first block ``step_b0`` (steps balanced by the bytes K5 reads,
or steps of ``gb`` blocks where those are not known) and the overflow
entries a block stages at once, ``stage``.  Starts and lengths are
multiples of ``XL_ALIGN`` elements, so the kernel's bulk copy moves whole
16-byte units in f32 and f64 alike.

**Segment mask.**  ``segment_mask`` marks, for each (block, slot), which
32-row segments of its values hold a nonzero: K5 skips the others, whose
products are exact zeros (a warp's row group is one segment, so the skip
never diverges); every K5 operator has one (:func:`full_mask` where its
values are not known).  ``bdia_spmv_xl`` also computes the update form
``c + w * s * (b - A x)`` of ``kernels.dia.epilogue_plain`` in the same
launch (the Jacobi sweeps of the ILU apply).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tpusolve_torch import runtime
from tpusolve_torch.kernels import build

BLOCK_SIZES = (2048, 1024, 512, 256, 128)  # candidate R values

# tpusolve's TPU panel geometry, for the verbatim copy of plan_panels
LANE = 128
_PALLAS_GB = 8

# BDIA-XL step plans: candidate blocks per step; K5's threads per block at
# most, and the bytes of rows a thread owns per pass (4 rows in f32, 2 in
# f64) (csrc/bdia_spmv_xl.cu: kMaxThreads, kRowBytes); the panel's
# alignment in elements; and the shared memory a block holds besides its
# panel: two mbarriers (16 bytes), the step's window offsets (gb * D int32)
# and mask rows, and its staged overflow entries
XL_GB = tuple(range(1, 65))
XL_THREADS = 1024
XL_ROW_BYTES = 16
XL_ALIGN = 4
XL_BARRIER_BYTES = 16
# rows of one bit of the segment mask: a warp's 32 lanes, one row each
# (csrc/bdia_spmv_xl.cu: kSegRows)
SEG_ROWS = 32
# rows a K5 thread sums at once (kAccRows): a step holds at most
# XL_THREADS * XL_ACC_ROWS rows; and the overflow entries a K5 block stages
# in shared memory at once, at most, and at least where its step has that
# many
XL_ACC_ROWS = 8
# the k-column form (csrc/bdia_spmv_xl.cu: kMaxCols, kColThreads): at most
# XL_MAX_COLS columns a launch, and XL_COL_THREADS threads a block for k > 1
# (xl_passes, xl_step_rows), which stage the x entries a step's windows
# cover (step_cover), windows closer than XL_COVER_GAP entries in one
# segment
XL_MAX_COLS = 8
XL_COL_THREADS = 512
XL_COVER_GAP = 64
XL_STAGE_MAX = 16384
XL_STAGE_MIN = 256
# the weight of an overflow byte against a value byte when plan_steps
# balances steps: K5 reads the overflow at a lower rate (its chunks follow
# the slots).  Measured on gate 4's L and U at 96^3 on an H100 80GB HBM3
# at 700 W, weights 1, 1.5, 2, 3, 4: 4 fastest (PERF.md)
XL_OVF_WEIGHT = 4.0
# plan_steps balances the step counts of its XL_BALANCE_TRIES cheapest
# candidates of at most XL_BALANCE_STEPS steps (four rounds of one block an
# SM; beyond, each SM runs many steps one after another and equal steps
# are balanced enough)
XL_BALANCE_STEPS = 4 * runtime.SM_COUNT
XL_BALANCE_TRIES = 4

# K4's launch plan (csrc/bdia_spmv.cu): a thread block per chunk of
# Rc = min(R, K4_MAX_CHUNK) rows of an R-row block, one thread a row; the
# slots run in register stages of S: K4_SLOTS_FULL where the launch has at
# least K4_DEEP_WARPS warps an SM, else K4_SLOTS_DEEP; S is one of the
# kernel's instantiations K4_SLOTS
K4_MAX_CHUNK = 256
K4_DEEP_WARPS = 16
K4_SLOTS_FULL = 8
K4_SLOTS_DEEP = 32
K4_SLOTS = (8, 16, 32)


def plan_fill_profile(lr, lc, row_pad: int, col_pad: int,
                      R: int) -> np.ndarray:
    """Per-rank slot-fill profile at block size R: ``out[r]`` = total
    entries landing in each block's r-th *most-populated* offset slot,
    summed over the shard's blocks.  Capping the layout at D slots per
    block therefore overflows exactly ``out[D:].sum()`` entries."""
    if len(lr) == 0:
        return np.zeros(0, np.int64)
    lr = np.asarray(lr, np.int64)
    d = np.asarray(lc, np.int64) - lr
    b = lr // R
    W = row_pad + col_pad + 1
    uniq, counts = np.unique(b * W + (d + row_pad), return_counts=True)
    key_b = uniq // W
    # rank slots within each block by descending count (stable: offset
    # order breaks ties) — same ordering compact() assigns slots in
    order_u = np.lexsort((-counts, key_b))
    B = (row_pad + R - 1) // R
    blk_starts = np.searchsorted(key_b, np.arange(B + 1))
    rank_sorted = np.arange(uniq.size) - blk_starts[key_b[order_u]]
    maxrank = int(rank_sorted.max()) + 1
    return np.bincount(rank_sorted, weights=counts[order_u],
                       minlength=maxrank).astype(np.int64)


_SENTINEL = np.iinfo(np.int64).min // 2


def compact(lr, lc, v, row_pad: int, col_pad: int, R: int, dmax: int,
            dtype=np.float32, overflow: bool = False):
    """Build one shard's BDIA staging.

    Returns (starts (B, dmax) int64 *relative to unpadded x* (may be
    negative), flat_idx, vals_ordered) — flat indices into the (B, dmax, R)
    value array.  Slots are assigned within each block by descending fill,
    so when a block has more distinct offsets than ``dmax`` the entries that
    don't fit are the fewest possible.  With ``overflow=False`` that
    condition raises; with ``overflow=True`` the spilled entries are
    returned as three extra arrays (local rows, local cols, vals)."""
    B = (row_pad + R - 1) // R
    dmax = max(dmax, 1)
    starts = np.full((B, dmax), _SENTINEL, np.int64)
    lr = np.asarray(lr, np.int64)
    if lr.size == 0:
        starts[:] = np.clip(np.arange(B, dtype=np.int64) * R, 0,
                            max(0, col_pad - R))[:, None]
        empty = (starts, np.zeros(0, np.int64), np.zeros(0, dtype))
        if overflow:
            return empty + (np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, dtype))
        return empty
    lc = np.asarray(lc, np.int64)
    d = lc - lr
    v = np.asarray(v, dtype)
    b = lr // R
    W = row_pad + col_pad + 1
    key = b * W + (d + row_pad)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    flag = np.empty(key_s.size, bool)
    flag[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=flag[1:])
    uniq = key_s[flag]
    slot_of_key = np.cumsum(flag) - 1
    counts_u = np.diff(np.append(np.flatnonzero(flag), key_s.size))
    key_b = uniq // W
    blk_starts = np.searchsorted(key_b, np.arange(B + 1))
    order_u = np.lexsort((-counts_u, key_b))
    rank_sorted = np.arange(uniq.size) - blk_starts[key_b[order_u]]
    rank_u = np.empty(uniq.size, np.int64)
    rank_u[order_u] = rank_sorted
    over_u = rank_u >= dmax
    if over_u.any() and not overflow:
        raise ValueError("dmax too small for this shard")
    keep_u = ~over_u
    starts[key_b[keep_u], rank_u[keep_u]] = \
        key_b[keep_u] * R + (uniq[keep_u] % W) - row_pad
    slot = rank_u[slot_of_key]
    lro, lco, vo = lr[order], lc[order], v[order]
    keep = slot < dmax
    flat_idx = (lro[keep] // R * dmax + slot[keep]) * R + lro[keep] % R
    # unused slots: park them on a window near the block's own diagonal
    # (vals are zero there, so any in-range window works)
    park = np.clip(np.arange(B, dtype=np.int64) * R, 0,
                   max(0, col_pad - R))
    parked = starts == _SENTINEL
    starts = np.where(parked, park[:, None], starts)
    if overflow:
        spill = ~keep
        return (starts, flat_idx, vo[keep],
                lro[spill], lco[spill], vo[spill])
    return starts, flat_idx, vo


def finalize_starts(starts: np.ndarray, col_pad: int, R: int):
    """Shift per-shard window starts into the zero-padded x coordinate
    system.  Returns (starts_adj int32, xpad_lo, xlen)."""
    lo = int(min(0, starts.min()))
    hi = int(max(col_pad, starts.max() + R))
    xpad_lo = -lo
    xlen = xpad_lo + hi
    return (starts + xpad_lo).astype(np.int32), xpad_lo, xlen


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def plan_panels(starts_adj: np.ndarray, R: int, gb: int = _PALLAS_GB):
    """Panel plan for the XL (x-streaming) kernel.

    For each grid step (``gb`` consecutive R-row blocks) the kernel DMAs one
    contiguous panel of the lane-matrix view of x from HBM into VMEM; this
    works because banded (RCM-ordered) matrices keep every block's window
    starts within a narrow span.  Returns ``(rowstart, pxrows, xrows_min)``:
    per-step first panel row (int32, one per step plus a trailing repeat for
    the prefetch lookahead), the pow2-padded panel height, and the minimum
    padded row count of the x lane-matrix.
    """
    B, D = starts_adj.shape
    rr = R // LANE
    Bp = ((B + gb - 1) // gb) * gb
    if Bp != B:  # pad with the last block's starts (keeps spans tight)
        starts_adj = np.concatenate(
            [starts_adj, np.repeat(starts_adj[-1:], Bp - B, axis=0)])
    rows = (starts_adj // LANE).reshape(-1, gb, D)
    min_r = rows.min(axis=(1, 2))
    max_r = rows.max(axis=(1, 2))
    span = int((max_r - min_r).max()) + rr + 1
    pxrows = max(8, _pow2ceil(span))
    rowstart = np.concatenate([min_r, min_r[-1:]]).astype(np.int32)
    xrows_min = int(rowstart.max()) + pxrows
    return rowstart, pxrows, xrows_min


def mask_bytes(R: int) -> int:
    """Bytes of the segment mask per (block, slot): one bit per
    ``SEG_ROWS`` rows of R."""
    return -(-(R // SEG_ROWS) // 8)


def xl_smem_bytes(panel: int, gb: int, D: int, itemsize: int,
                  R: int = 128, stage: int = 0, cols: int = 1) -> int:
    """Shared memory of one K5 block of at most ``gb`` R-row blocks:
    barriers, the x panels (``panel`` entries of each of ``cols``
    columns: one column's span, or the k columns' covers,
    :func:`step_cover`), window offsets and the step's rows of the segment
    mask (to 16 bytes), and ``stage`` staged overflow entries (column and
    value)."""
    fixed = (XL_BARRIER_BYTES + cols * panel * itemsize
             + gb * D * (4 + mask_bytes(R)))
    return -(-fixed // 16) * 16 + stage * (4 + itemsize)


def xl_passes(itemsize: int, k: int = 1) -> int:
    """Passes of ``XL_ROW_BYTES`` rows a K5 thread makes on a k-column
    launch: ``XL_ACC_ROWS`` rows in all for one column, one pass (two in
    f64 at k = 2) for more, so that its k sums a row stay in registers
    (``csrc/bdia_spmv_xl.cu``: passes)."""
    base = XL_ACC_ROWS // (XL_ROW_BYTES // itemsize)
    return base if k == 1 else max(1, base // k)


def xl_step_rows(itemsize: int, k: int = 1) -> int:
    """Rows a K5 step of a k-column launch holds at most: its block's
    threads at most (``XL_THREADS``, ``XL_COL_THREADS`` for k > 1) times
    the rows a thread sums."""
    threads = XL_THREADS if k == 1 else XL_COL_THREADS
    return threads * (XL_ROW_BYTES // itemsize) * xl_passes(itemsize, k)


def xl_stage(panel: int, gb: int, D: int, itemsize: int, R: int,
             need: int, cols: int = 1) -> int | None:
    """Overflow entries a K5 block stages at once, where its steps hold at
    most ``need``: ``need`` and the aligned head (a multiple of 8), at most
    ``XL_STAGE_MAX`` and what fits beside the rest of the block's shared
    memory; 0 without an overflow list, None where fewer than
    ``min(need, XL_STAGE_MIN)`` fit (the chunks would be too many)."""
    if need <= 0:
        return 0
    room = (runtime.SMEM_PER_BLOCK - xl_smem_bytes(
        panel, gb, D, itemsize, R, cols=cols)) // (4 + itemsize)
    want = min(-(-(need + 3) // 8) * 8, XL_STAGE_MAX)
    stage = min(want, room // 8 * 8)
    return stage if stage >= min(want, XL_STAGE_MIN) else None


def segment_mask(vals: torch.Tensor) -> torch.Tensor:
    """The segment mask of BDIA values ``vals`` (P, B, D, R), on their
    device: uint8 (P, B, D, ``mask_bytes(R)``), bit ``q % 8`` of byte ``q //
    8`` set where rows ``[32 q, 32 q + 32)`` of the slot hold a nonzero
    value."""
    P, B, D, R = vals.shape
    nseg = R // SEG_ROWS
    live = (vals.reshape(P, B, D, nseg, SEG_ROWS) != 0).any(dim=-1)
    W = mask_bytes(R)
    live = torch.nn.functional.pad(live.to(torch.uint8), (0, 8 * W - nseg))
    bits = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=vals.device)
    return (live.reshape(P, B, D, W, 8) * bits).sum(dim=-1,
                                                    dtype=torch.uint8)


def full_mask(P: int, B: int, D: int, R: int, device=None) -> torch.Tensor:
    """The segment mask of a (P, B, D, R) layout with every segment set: K5
    reads every value, as where they are not known."""
    one = segment_mask(torch.ones((1, 1, 1, R), dtype=torch.uint8,
                                  device=device))
    return one.expand(P, B, D, -1).contiguous()


def live_segments(mask: torch.Tensor) -> int:
    """The number of bits set in segment mask ``mask``: the 32-row segments
    K5 reads."""
    bits = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return int(((mask.unsqueeze(-1) >> bits) & 1).sum())


def _segments_live(mask: torch.Tensor, R: int) -> torch.Tensor:
    """Segment mask (P, B, D, W) as bool (P, B, D, R // SEG_ROWS)."""
    bits = torch.arange(8, dtype=torch.uint8, device=mask.device)
    live = ((mask.unsqueeze(-1) >> bits) & 1).bool()
    return live.reshape(*mask.shape[:3], -1)[..., :R // SEG_ROWS]


def xl_threads(gb: int, R: int, itemsize: int, k: int = 1) -> int:
    """Threads of one K5 block: one per ``XL_ROW_BYTES`` of the step's rows
    (4 rows in f32, 2 in f64), rounded up to whole warps, at most
    ``XL_THREADS`` (``XL_COL_THREADS`` for k > 1 columns;
    ``csrc/bdia_spmv_xl.cu``)."""
    groups = gb * R * itemsize // XL_ROW_BYTES
    return min(XL_THREADS if k == 1 else XL_COL_THREADS,
               -(-groups // 32) * 32)


@functools.lru_cache(maxsize=256)
def k4_plan(nparts: int, B: int, D: int, R: int, itemsize: int) -> tuple:
    """K4's launch on a (nparts, B, D, R) layout: ``(Rc, S, blocks,
    smem)``, the rows of a thread block's chunk (its threads), the slots of
    a register stage, the thread blocks, and the block's dynamic shared
    memory in bytes (the window starts).  Every (block, chunk) unit is one
    thread block and covers rows ``[c*Rc, (c+1)*Rc)`` of its R-row block,
    so each row has one thread.  Raises where ``K4_MAX_CHUNK`` neither
    holds nor divides R, or the starts do not fit
    ``runtime.SMEM_PER_BLOCK``: K4 has no other launch."""
    rc = min(R, K4_MAX_CHUNK)
    if R % rc:
        raise ValueError(f"bdia_spmv: R={R} is not a multiple of "
                         f"{K4_MAX_CHUNK}")
    warps = nparts * B * R // 32
    S = (K4_SLOTS_FULL if warps >= K4_DEEP_WARPS * runtime.SM_COUNT
         else K4_SLOTS_DEEP)
    smem = D * 4
    if smem > runtime.SMEM_PER_BLOCK:
        raise ValueError(f"bdia_spmv: {D} slots do not fit one block's "
                         "shared memory")
    return rc, S, nparts * B * (R // rc), smem


def balanced_starts(work: np.ndarray, nsteps: int, cap: int):
    """The first block of each step, and the block count last, of the
    partition of blocks into at most ``nsteps`` steps of at most ``cap``
    consecutive blocks whose heaviest step by ``work`` (per block) is the
    least, to a thousandth; None when no such partition exists."""
    B = work.size
    cum = np.concatenate([[0], np.cumsum(work, dtype=np.int64)])

    def cut(T):
        b0 = [0]
        while b0[-1] < B:
            if len(b0) > nsteps:
                return None
            i = b0[-1]
            j = int(np.searchsorted(cum, cum[i] + T, side="right")) - 1
            b0.append(min(max(j, i + 1), i + cap, B))
        return b0

    lo = max(int(work.max(initial=0)), -(-int(cum[-1]) // nsteps))
    hi = max(lo, int(cum[-1]))
    if cut(hi) is None:
        return None
    while hi - lo > lo // 1000:
        mid = (lo + hi) // 2
        if cut(mid) is None:
            lo = mid + 1
        else:
            hi = mid
    return np.asarray(cut(hi), np.int64)


def plan_steps(starts: np.ndarray, R: int, xpad_lo: int, itemsize: int,
               price, work=None, cols: int = 1):
    """The BDIA-XL step plan ``(gb, step_lo, panel, step_b0, stage)`` of
    least ``price(gb, nsteps, panel, smem)`` (seconds, the caller's time
    model; ``smem`` a block's shared memory), or None when no candidate's
    block fits ``runtime.SMEM_PER_BLOCK``.

    ``starts`` (P, B, D) are the padded-x window starts.  The candidates
    are steps of ``gb`` blocks for each ``gb`` of ``XL_GB``: step i of part
    p holds blocks ``[i*gb, min((i+1)*gb, B))``.  With ``work =
    (block_bytes, block_ovf)`` ((P, B) each: the bytes of the values K5
    reads for each block, its overflow entries), the ``XL_BALANCE_TRIES``
    step counts of least price, of at most ``XL_BALANCE_STEPS`` steps, are
    cut again into steps of balanced work, the overflow's bytes weighted
    by ``XL_OVF_WEIGHT`` (:func:`balanced_starts`), and the plan is the best
    of those: step i of part p holds blocks ``[step_b0[p, i], step_b0[p, i
    + 1])`` (int32 (P, nsteps + 1); a part with fewer steps ends in empty
    ones), ``gb`` is the most a step holds.  Without ``work``,
    the plan is the cheapest of the steps of ``gb`` blocks (``step_b0``
    their table).  A step's panel ``[step_lo[p, i], step_lo[p, i] +
    panel)`` of the unpadded x covers every window of its blocks;
    ``step_lo`` is int32 (P, nsteps).  ``stage`` is :func:`xl_stage` for
    the most overflow entries a step holds (as many as fit, up to
    ``XL_STAGE_MAX``, without ``work``).  ``cols``: a plan for K5's
    k-column form of ``cols`` columns (steps of at most
    :func:`xl_step_rows` rows; for more than one column ``panel`` is the
    most entries a step's windows cover, :func:`step_cover`, the panel
    each column stages)."""
    s = np.asarray(starts, np.int64) - xpad_lo
    P, B, D = s.shape
    first = s.min(axis=2)                     # (P, B) window starts
    last = s.max(axis=2) + R                  # (P, B) window ends
    cap = min(XL_GB[-1], xl_step_rows(itemsize, cols) // R)
    if cap < 1:
        return None
    if work is not None:
        ovf = np.concatenate([np.zeros((P, 1), np.int64), np.cumsum(
            np.asarray(work[1], np.int64), axis=1)], axis=1)

    def candidate(b0):
        """(price, plan) of the steps starting at ``b0`` (P, nsteps + 1),
        or None where a block does not fit."""
        nsteps = b0.shape[1] - 1
        lo = np.zeros((P, nsteps), np.int64)
        hi = np.zeros((P, nsteps), np.int64)
        for p in range(P):
            full = b0[p, :-1] < b0[p, 1:]
            lo[p, full] = np.minimum.reduceat(first[p], b0[p, :-1][full])
            hi[p, full] = np.maximum.reduceat(last[p], b0[p, :-1][full])
        lo = lo // XL_ALIGN * XL_ALIGN
        panel = int(-(-int((hi - lo).max()) // XL_ALIGN) * XL_ALIGN)
        if cols > 1:
            panel = step_cover(starts, R, xpad_lo, b0, tables=False)[3]
        gb = int(np.diff(b0, axis=1).max())
        need = XL_STAGE_MAX if work is None else int(
            (np.take_along_axis(ovf, b0[:, 1:], 1)
             - np.take_along_axis(ovf, b0[:, :-1], 1)).max())
        stage = xl_stage(panel, gb, D, itemsize, R, need, cols)
        if stage is None:
            return None
        smem = xl_smem_bytes(panel, gb, D, itemsize, R, stage, cols)
        if smem > runtime.SMEM_PER_BLOCK:
            return None
        return price(gb, nsteps, panel, smem), (
            gb, lo.astype(np.int32), panel, b0.astype(np.int32), stage)

    found = []
    for g in XL_GB[:cap]:
        got = candidate(np.repeat(np.append(np.arange(0, B, g), B)[None], P,
                                  0))
        if got is not None:
            found.append(got)
        if g >= B:
            break       # one step already: larger gb plans the same
    if not found:
        return None
    if work is None:
        return min(found, key=lambda f: f[0])[1]
    weighted = [np.asarray(vb + XL_OVF_WEIGHT * ob * (4 + itemsize),
                           np.int64) for vb, ob in zip(*work)]
    tries = sorted({f[1][1].shape[1] for f in sorted(
        found, key=lambda f: f[0]) if f[1][1].shape[1] <= XL_BALANCE_STEPS},
        key=lambda n: min(f[0] for f in found if f[1][1].shape[1] == n))
    balanced = []
    for nsteps in tries[:XL_BALANCE_TRIES]:
        cuts = [balanced_starts(w, nsteps, cap) for w in weighted]
        if any(c is None for c in cuts):
            continue
        got = candidate(np.stack([np.pad(c, (0, nsteps + 1 - c.size),
                                         constant_values=B) for c in cuts]))
        if got is not None:
            balanced.append(got)
    return min(balanced or found, key=lambda f: f[0])[1]


def step_cover(starts: np.ndarray, R: int, xpad_lo: int,
               step_b0: np.ndarray, tables: bool = True):
    """The x entries each K5 step's windows cover, as the k-column form
    stages them: the union of the step's windows ``[starts[p, b, d] -
    xpad_lo, + R)`` of the unpadded x, each widened to ``XL_ALIGN``
    elements, as merged segments (windows closer than ``XL_COVER_GAP``
    entries share a segment), packed one after another into the step's
    staged panel.

    Returns ``(seg_ptr, segs, xoff, cover)``: step i of part p stages
    segments ``segs[seg_ptr[p * nsteps + i] : seg_ptr[p * nsteps + i +
    1]]`` (int32 (P * nsteps + 1,)), each a row ``(x_lo, length,
    panel_offset)`` of int32 (``x_lo``, ``length`` and ``panel_offset``
    multiples of ``XL_ALIGN``; the segments of a step in increasing
    ``x_lo``, apart and in panel order); ``xoff`` (P, B, D) int32 is the
    offset of each window's first entry in its step's panel; ``cover`` the
    most entries a step stages.  With ``tables=False`` only ``cover``
    (``(None, None, None, cover)``), for pricing plans."""
    s = np.asarray(starts, np.int64) - xpad_lo
    P, B, D = s.shape
    b0 = np.asarray(step_b0, np.int64)
    nsteps = b0.shape[1] - 1
    step = np.stack([np.searchsorted(b0[p], np.arange(B), side="right") - 1
                     for p in range(P)])
    key = np.broadcast_to((np.arange(P)[:, None] * nsteps + step)[..., None],
                          s.shape).ravel()
    lo = s.ravel() // XL_ALIGN * XL_ALIGN
    hi = -(-(s.ravel() + R) // XL_ALIGN) * XL_ALIGN
    order = np.lexsort((lo, key))
    # segmented merge: shift each step's coordinates apart so that one
    # running maximum serves every step
    span = int(hi.max() - lo.min()) + XL_COVER_GAP + 1
    base = key[order] * span - lo.min()
    lo_s, hi_s = lo[order] + base, hi[order] + base
    reach = np.maximum.accumulate(hi_s)
    new = np.ones(lo_s.size, bool)
    new[1:] = lo_s[1:] > reach[:-1] + XL_COVER_GAP
    first = np.flatnonzero(new)
    seg_key = key[order][first]
    seg_lo = lo_s[first] - base[first]
    seg_hi = np.maximum.reduceat(hi_s, first) - base[first]
    length = seg_hi - seg_lo
    per_step = np.bincount(seg_key, weights=length, minlength=P * nsteps)
    cover = int(per_step.max(initial=0))
    if not tables:
        return None, None, None, cover
    seg_ptr = np.zeros(P * nsteps + 1, np.int64)
    seg_ptr[1:] = np.cumsum(np.bincount(seg_key, minlength=P * nsteps))
    ends = np.cumsum(length)
    offset = ends - length - np.repeat(
        np.concatenate([[0], ends])[seg_ptr[:-1]], np.diff(seg_ptr))
    seg_of = np.cumsum(new) - 1                 # each sorted window's segment
    xoff = np.empty(s.size, np.int64)
    xoff[order] = offset[seg_of] + s.ravel()[order] - seg_lo[seg_of]
    segs = np.stack([seg_lo, length, offset], axis=1)
    return (seg_ptr.astype(np.int32), segs.astype(np.int32),
            xoff.reshape(P, B, D).astype(np.int32), cover)


def cover_overflow(ptr, cols, R: int, step_b0, seg_ptr, segs) -> np.ndarray:
    """The overflow list's columns as a k-column K5 launch reads them
    (int32, ``cols``' shape (P, n)): entry j of row i, whose block is in
    step s of its part, as the offset of its column in the panel s stages
    (:func:`step_cover`) where a segment of s holds it, else as ``-(column
    + 1)`` (read from x).  ``ptr`` (P, row_pad + 1) and ``cols`` (P, n) are
    the list's row pointer and columns; entries past a part's last are
    kept as columns."""
    ptr, cols = np.asarray(ptr, np.int64), np.asarray(cols, np.int64)
    b0 = np.asarray(step_b0, np.int64)
    P, nsteps = b0.shape[0], b0.shape[1] - 1
    lo, length, off = (np.asarray(segs, np.int64)[:, i] for i in range(3))
    key_of = np.repeat(np.arange(P * nsteps), np.diff(seg_ptr))
    base = min(int(lo.min(initial=0)), 0)
    width = max(int((lo + length).max(initial=0)),
                int(cols.max(initial=0)) + 1) - base + 1
    seg_at = key_of * width + lo - base        # increasing
    code = -(cols + 1)
    for p in range(P):
        n = int(ptr[p, -1])
        rows = np.repeat(np.arange(ptr.shape[1] - 1), np.diff(ptr[p]))
        key = p * nsteps + np.searchsorted(b0[p], rows // R,
                                           side="right") - 1
        g = cols[p, :n]
        q = np.searchsorted(seg_at, key * width + g - base, side="right") - 1
        qc = np.maximum(q, 0)
        held = (q >= 0) & (key_of[qc] == key) & (g < lo[qc] + length[qc])
        code[p, :n][held] = (off[qc] + g - lo[qc])[held]
    return code.astype(np.int32)


def cover_panels(x: torch.Tensor, seg_ptr: torch.Tensor, segs: torch.Tensor,
                 nparts: int, col_pad: int, panel: int) -> torch.Tensor:
    """Every step's staged panel of a k-column K5 launch (plain PyTorch),
    ``(P * nsteps, panel)`` of one column ``x`` (P * col_pad,): step i of
    part p holds its segments (:func:`step_cover`) packed from 0, x entries
    outside ``[0, col_pad)`` as 0, the rest of the panel 0."""
    dev = x.device
    n = seg_ptr.numel() - 1
    seg_ptr, segs = seg_ptr.to(torch.int64), segs.to(torch.int64)
    step = torch.repeat_interleave(torch.arange(n, device=dev),
                                   seg_ptr[1:] - seg_ptr[:-1])
    length = segs[:, 1]
    entry = torch.repeat_interleave(torch.arange(segs.shape[0], device=dev),
                                    length)
    within = torch.arange(entry.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(length, 0) - length, length)
    g = segs[entry, 0] + within                       # column of the part
    part = step[entry] // (n // nparts)
    inside = (g >= 0) & (g < col_pad)
    vals = torch.where(inside, x[(part * col_pad + g.clamp(0, col_pad - 1))],
                       torch.zeros((), dtype=x.dtype, device=dev))
    pan = torch.zeros(n * panel, dtype=x.dtype, device=dev)
    pan[step[entry] * panel + segs[entry, 2] + within] = vals
    return pan.reshape(n, panel)


def _add_overflow(y: torch.Tensor, xs: torch.Tensor, ovf,
                  row_pad: int) -> None:
    """``y[p, :row_pad]`` += each part's overflow list (module docstring),
    on every part at once: one gather and one ``index_add_`` into the
    contiguous (P, W) ``y`` (W >= row_pad), each row's entries added in
    their order, as part by part."""
    ptr, ocols, ovals = ovf
    P, W = y.shape
    counts = (ptr[:, 1:] - ptr[:, :-1]).to(torch.int64).reshape(-1)
    rows = torch.repeat_interleave(
        torch.arange(P * row_pad, device=y.device), counts)
    rows = rows // row_pad * W + rows % row_pad
    keep = (torch.arange(ocols.shape[1], device=y.device)[None]
            < ptr[:, -1:].to(torch.int64))
    vals = (ovals * torch.gather(xs, 1, ocols.to(torch.int64)))[keep]
    y.view(-1).index_add_(0, rows, vals)


def bdia_spmv_plain(vals: torch.Tensor, starts: torch.Tensor,
                    x: torch.Tensor, xpad_lo: int, xlen: int,
                    row_pad: int, ovf=None) -> torch.Tensor:
    """Plain PyTorch BDIA SpMV: a gather of every (block, slot) window of
    the zero-padded x, a sum over slots, then the overflow list (module
    docstring) by one gather and one ``index_add_`` per part.

    ``vals`` (P, B, D, R), ``starts`` (P, B, D) int32, ``x`` (P * col_pad,)
    -> y (P * row_pad,).  Every window must lie inside ``[0, xlen)``: this
    is checked, not clamped (``tpusolve``'s ``dynamic_slice`` form clamps)."""
    P, B, D, R = vals.shape
    xs = x.reshape(P, -1)
    col_pad = xs.shape[1]
    if int(starts.min()) < 0 or int(starts.max()) + R > xlen:
        raise ValueError("BDIA window outside [0, xlen)")
    xp = torch.nn.functional.pad(xs, (xpad_lo, max(0, xlen - xpad_lo
                                                   - col_pad)))
    idx = (starts.to(torch.int64).reshape(P, B * D, 1)
           + torch.arange(R, device=x.device))
    win = torch.gather(xp, 1, idx.reshape(P, -1)).reshape(P, B, D, R)
    y = (vals * win).sum(dim=2).reshape(P, B * R)
    if ovf is not None:
        _add_overflow(y, xs, ovf, row_pad)
    return y[:, :row_pad].reshape(-1)


def bdia_spmv_xl_plain(vals: torch.Tensor, starts: torch.Tensor,
                       x: torch.Tensor, xpad_lo: int, row_pad: int, gb: int,
                       step_lo: torch.Tensor, panel: int, ovf=None, *,
                       mask: torch.Tensor, step_b0: torch.Tensor,
                       stage=None, b=None, s=None, c=None, w: float = 1.0,
                       out=None, cover=None) -> torch.Tensor:
    """Plain PyTorch BDIA SpMV by panel steps (K5's function, which is
    K4's): a gather of each step's panel of x (0 outside ``[0, col_pad)``),
    a gather of every (block, slot) window out of its step's panel, a sum
    over slots, then the overflow list as in :func:`bdia_spmv_plain`.  A
    product in a segment whose bit of ``mask`` (:func:`segment_mask`) is
    clear counts as 0, as K5 skips it.  With any of ``b``, ``s``, ``c``
    given, the update form (``kernels.dia.epilogue_plain``) of that
    product, written into ``out`` when given.

    ``gb``, ``step_lo`` (P, nsteps) int32, ``panel`` and ``step_b0`` (P,
    nsteps + 1) int32 as :func:`plan_steps` gives them (``gb`` and
    ``stage``, launch details, are not used).  Every window must lie inside
    its step's panel: this is checked.  With ``cover = (seg_ptr, segs,
    xoff)`` of :func:`step_cover` the windows are read from the panels the
    k-column form stages instead (:func:`cover_panels`, ``panel`` entries
    each; ``step_lo`` unused): the same entries of x, so the same bits."""
    from tpusolve_torch.kernels.dia import epilogue_plain
    P, B, D, R = vals.shape
    xs = x.reshape(P, -1)
    col_pad = xs.shape[1]
    dev = x.device
    # each block's step (P, B)
    blocks = torch.arange(B, device=dev).expand(P, B).contiguous()
    step = torch.searchsorted(step_b0.to(torch.int64), blocks, right=True) - 1
    if cover is not None:
        # (P, nsteps, panel) staged panels, each window's offset in its own
        seg_ptr, segs, xoff = cover
        pan = cover_panels(x.reshape(-1), seg_ptr, segs, P, col_pad,
                           panel).reshape(P, -1, panel)
        off = xoff.to(torch.int64)
    else:
        # (P, nsteps, panel) panels of the unpadded x
        pidx = step_lo.to(torch.int64).unsqueeze(-1) + torch.arange(
            panel, device=dev)
        inside = (pidx >= 0) & (pidx < col_pad)
        pan = torch.where(inside, torch.gather(
            xs, 1, pidx.clamp(0, col_pad - 1).reshape(P, -1)).reshape(
                pidx.shape), torch.zeros((), dtype=x.dtype, device=dev))
        # each window's offset in its step's panel (P, B, D)
        off = (starts.to(torch.int64) - xpad_lo - torch.gather(
            step_lo.to(torch.int64), 1, step).unsqueeze(-1))
    if int(off.min()) < 0 or int(off.max()) + R > panel:
        raise ValueError("BDIA-XL window outside its step's panel")
    # windows as flat indices into the (P, nsteps * panel) panels
    widx = ((step * panel).reshape(P, B, 1, 1) + off.unsqueeze(-1)
            + torch.arange(R, device=dev))
    win = torch.gather(pan.reshape(P, -1), 1,
                       widx.reshape(P, -1)).reshape(P, B, D, R)
    live = _segments_live(mask, R).repeat_interleave(SEG_ROWS, dim=-1)
    prod = torch.where(live, vals * win, torch.zeros((), dtype=x.dtype,
                                                     device=dev))
    y = prod.sum(dim=2).reshape(P, B * R)
    if ovf is not None:
        _add_overflow(y, xs, ovf, row_pad)
    y = y[:, :row_pad].reshape(-1)
    if b is None and s is None and c is None:
        return y if out is None else out.copy_(y)
    return epilogue_plain(y, b, s, c, w, out=out)


_SMEM_MAX = 48 * 1024   # default dynamic shared memory without opt-in


@functools.cache
def _kernel_fns(name: str, nptrs: int, nints: int, ndoubles: int = 0):
    """(library, {dtype: entry point}) of ``csrc/<name>.cu``, with ctypes
    signatures declared: ``nptrs`` pointers, ``ndoubles`` doubles, ``nints``
    ints, the stream."""
    lib = build.load(name)
    fns = {torch.float32: getattr(lib, name + "_f32"),
           torch.float64: getattr(lib, name + "_f64")}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * nptrs + [ctypes.c_double] * ndoubles
                       + [ctypes.c_int] * nints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


def _check_launch(what: str, vals, starts, x, row_pad: int, ovf,
                  extra=()) -> tuple:
    """Check the arguments K4 and K5 share for an x of ``x = (dtype,
    device, col_pad)`` (``extra``: more (name, tensor) pairs that must be
    contiguous on x's device); returns (overflow pointers, overflow
    length)."""
    dtype, device, col_pad = x
    P, B, D, R = vals.shape
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    if vals.dtype != dtype:
        raise TypeError(f"{what}: vals {vals.dtype} != x {dtype}")
    if starts.dtype != torch.int32 or starts.shape != (P, B, D):
        raise TypeError(f"{what}: starts must be int32 of shape (P, B, D)")
    tensors = [("vals", vals), ("starts", starts), *extra]
    ovf_ptrs, ovf_len = (None, None, None), 0
    if ovf is not None:
        ptr, ocols, ovals = ovf
        ovf_len = ocols.shape[-1]
        if ptr.dtype != torch.int32 or ptr.shape != (P, row_pad + 1) \
                or ocols.dtype != torch.int32 or ocols.shape != (P, ovf_len) \
                or ovals.dtype != dtype or ovals.shape != (P, ovf_len):
            raise TypeError(f"{what}: ovf must be int32 ptr (P, row_pad+1), "
                            "int32 cols (P, k) and vals (P, k) of x's dtype")
        tensors += [("ovf ptr", ptr), ("ovf cols", ocols),
                    ("ovf vals", ovals)]
        ovf_ptrs = (ptr.data_ptr(), ocols.data_ptr(), ovals.data_ptr())
    for name, t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{device}")
    if max(B * R, row_pad + 1, col_pad, ovf_len) >= 2 ** 31:
        raise ValueError(f"{what}: part too large for 32-bit row indices")
    return ovf_ptrs, ovf_len


def bdia_spmv(vals: torch.Tensor, starts: torch.Tensor, x: torch.Tensor,
              xpad_lo: int, xlen: int, row_pad: int,
              ovf=None) -> torch.Tensor:
    """BDIA SpMV with its overflow list, ``y = A @ x`` (arguments as
    :func:`bdia_spmv_plain`).

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/bdia_spmv.cu`` (building it on first use) or raise; there is no
    fallback.  ``bdia_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return bdia_spmv_plain(vals, starts, x, xpad_lo, xlen, row_pad, ovf)
    if x.device.type != "cuda":
        raise ValueError(f"bdia_spmv: unsupported device {x.device}")
    P, B, D, R = vals.shape
    if x.dim() != 1 or x.numel() % P:
        raise ValueError("bdia_spmv: x must be flat (P * col_pad,)")
    col_pad = x.numel() // P
    ovf_ptrs, ovf_len = _check_launch("bdia_spmv", vals, starts,
                                      (x.dtype, x.device, col_pad), row_pad,
                                      ovf, extra=[("x", x)])
    if xlen >= 2 ** 31:
        raise ValueError("bdia_spmv: part too large for 32-bit row indices")
    rc, S, _, smem = k4_plan(P, B, D, R, x.element_size())
    if smem > _SMEM_MAX:
        runtime.require_smem(x.device.index)
    lib, fns = _kernel_fns("bdia_spmv", 7, 10)
    y = torch.empty(P * row_pad, dtype=x.dtype, device=x.device)
    build.launch(lib, fns[x.dtype], x, "bdia_spmv launch", vals.data_ptr(),
                 starts.data_ptr(), x.data_ptr(), *ovf_ptrs, y.data_ptr(), P,
                 B, D, R, row_pad, col_pad, xpad_lo, ovf_len, rc, S)
    bdia_spmv.launches += 1
    return y


bdia_spmv.launches = 0


def bdia_spmv_xl(vals: torch.Tensor, starts: torch.Tensor, x: torch.Tensor,
                 xpad_lo: int, row_pad: int, gb: int, step_lo: torch.Tensor,
                 panel: int, ovf=None, *, mask: torch.Tensor,
                 step_b0: torch.Tensor, stage=None, b=None, s=None, c=None,
                 w: float = 1.0, out=None) -> torch.Tensor:
    """BDIA SpMV by panel steps, ``y = A @ x``, or with any of ``b``, ``s``,
    ``c`` given its update form ``y = c + w * s * (b - A x)`` (arguments as
    :func:`bdia_spmv_xl_plain`); written into ``out`` when given, which may
    be ``b``, ``s`` or ``c`` but never overlaps x.  ``A @ x`` equals
    :func:`bdia_spmv`'s bit for bit (for finite x).  ``mask``: the
    operator's :func:`segment_mask`, whose clear segments K5 skips;
    ``step_b0`` and ``stage`` (None: as many as fit, :func:`xl_stage`) as
    :func:`plan_steps` gives them.

    CPU tensors take the plain version.  CUDA tensors launch K5, the kernel
    of ``csrc/bdia_spmv_xl.cu`` (building it on first use), or raise; there
    is no fallback: :func:`xl_operator` checks the operator's arguments,
    :func:`bdia_spmv_xl_run` the vectors and launches (the one launch
    route: ``matrix/spmv.py`` keeps an operator's :class:`XLOperator`).
    ``bdia_spmv_xl.launches`` counts kernel launches,
    ``bdia_spmv_xl.launches_by_form`` the same by which of (b, s, c) were
    given (``kernels.dia.epilogue_mode`` names them) and
    ``bdia_spmv_xl.launches_by_cols`` by the columns k of a launch (the
    k-column form, ``matrix/spmv.py``)."""
    if out is not None and _overlaps(out, x):
        raise ValueError("bdia_spmv_xl: out may not overlap x")
    if x.device.type == "cpu":
        return bdia_spmv_xl_plain(vals, starts, x, xpad_lo, row_pad, gb,
                                  step_lo, panel, ovf, mask=mask,
                                  step_b0=step_b0, b=b, s=s, c=c, w=w,
                                  out=out)
    if x.device.type != "cuda":
        raise ValueError(f"bdia_spmv_xl: unsupported device {x.device}")
    if x.dim() != 1 or x.numel() % vals.shape[0]:
        raise ValueError("bdia_spmv_xl: x must be flat (P * col_pad,)")
    op = xl_operator(vals, starts, xpad_lo, row_pad, x.numel() // vals.shape[0],
                     gb, step_lo, panel, ovf, mask=mask, step_b0=step_b0,
                     stage=stage)
    return bdia_spmv_xl_run(op, x, b=b, s=s, c=c, w=w, out=out)


@dataclasses.dataclass(frozen=True)
class XLOperator:
    """K5's operator arguments, checked once (:func:`xl_operator`): the
    operator's tensors (kept alive for the pointers' sake), its dtype and
    device, its parts, rows and x entries a part, and K5's launch arguments
    before x (``head``: values, starts, ``step_lo``, ``step_b0``), after x
    (``tail``: the overflow list, the mask and a k-column plan's cover)
    and after the update form (``ints``), and the columns of a launch."""
    tensors: tuple
    dtype: torch.dtype
    device: torch.device
    nparts: int
    row_pad: int
    col_pad: int
    head: tuple
    tail: tuple
    ints: tuple
    cols: int = 1      # columns a launch (the k-column form for k > 1)


def xl_operator(vals: torch.Tensor, starts: torch.Tensor, xpad_lo: int,
                row_pad: int, col_pad: int, gb: int, step_lo: torch.Tensor,
                panel: int, ovf=None, *, mask: torch.Tensor,
                step_b0: torch.Tensor, stage=None,
                cols: int = 1, cover=None) -> XLOperator:
    """Check the arguments of a K5 operator on a CUDA device (as
    :func:`bdia_spmv_xl` takes them, for an x of ``col_pad`` entries a
    part) and return them as K5's launch takes them; raises on an argument
    K5 does not take.  ``cols``: the k-column form's columns, on a plan
    made for them (:func:`plan_steps`), with its ``cover = (seg_ptr, segs,
    xoff)`` (:func:`step_cover`, as tensors on the device; ``panel`` its
    cover)."""
    P, B, D, R = vals.shape
    nsteps = step_b0.shape[-1] - 1
    ovf_ptrs, ovf_len = _check_launch(
        "bdia_spmv_xl", vals, starts, (vals.dtype, vals.device, col_pad),
        row_pad, ovf, extra=[("step_lo", step_lo), ("mask", mask),
                             ("step_b0", step_b0)])
    if step_lo.dtype != torch.int32 or step_lo.shape != (P, nsteps):
        raise TypeError("bdia_spmv_xl: step_lo must be int32 of shape "
                        f"(P, {nsteps})")
    if step_b0.dtype != torch.int32 or step_b0.shape != (P, nsteps + 1):
        raise TypeError("bdia_spmv_xl: step_b0 must be int32 of shape "
                        f"(P, {nsteps + 1})")
    if (cover is None) != (cols == 1):
        raise ValueError("bdia_spmv_xl: a k-column plan, and only one, "
                         "takes its steps' cover")
    if cover is not None:
        seg_ptr, segs, xoff = cover
        if seg_ptr.shape != (P * nsteps + 1,) or segs.dim() != 2 \
                or segs.shape[1] != 3 or xoff.shape != (P, B, D) \
                or any(t.dtype != torch.int32 or t.device != vals.device
                       or not t.is_contiguous() for t in cover):
            raise TypeError("bdia_spmv_xl: the cover must be contiguous "
                            "int32 seg_ptr (P * nsteps + 1,), segs (n, 3) "
                            "and xoff (P, B, D) on the values' device")
    if mask.dtype != torch.uint8 or mask.shape != (P, B, D, mask_bytes(R)):
        raise TypeError("bdia_spmv_xl: mask must be uint8 of shape "
                        f"(P, B, D, {mask_bytes(R)})")
    itemsize = vals.element_size()
    if not 1 <= cols <= XL_MAX_COLS:
        raise ValueError(f"bdia_spmv_xl: 1 to {XL_MAX_COLS} columns")
    rows = xl_step_rows(itemsize, cols)
    if panel % XL_ALIGN or R % 128 or gb * R > rows:
        raise ValueError(f"bdia_spmv_xl: the panel must be a multiple of "
                         f"{XL_ALIGN}, R of 128, and a step at most "
                         f"{rows} rows")
    if stage is None:
        stage = xl_stage(panel, gb, D, itemsize, R,
                         XL_STAGE_MAX if ovf is not None else 0, cols)
    if stage is None or xl_smem_bytes(panel, gb, D, itemsize, R, stage,
                                      cols) > runtime.SMEM_PER_BLOCK:
        raise ValueError(f"bdia_spmv_xl: a panel of {panel} does not fit "
                         "one block's shared memory")
    runtime.require_smem(vals.device.index)
    cover_ptrs = (None,) * 3 if cover is None else tuple(
        t.data_ptr() for t in cover)
    return XLOperator(
        tensors=(vals, starts, step_lo, step_b0, ovf, mask, cover),
        dtype=vals.dtype, device=vals.device, nparts=P, row_pad=row_pad,
        col_pad=col_pad,
        head=(vals.data_ptr(), starts.data_ptr(), step_lo.data_ptr(),
              step_b0.data_ptr()),
        tail=ovf_ptrs + (mask.data_ptr(),) + cover_ptrs,
        ints=(P, B, D, R, row_pad, col_pad, xpad_lo, ovf_len, gb, nsteps,
              panel, stage), cols=cols)


@functools.cache
def _xl_fns(defines: tuple = ()):
    """(library, {dtype: entry point}) of ``csrc/bdia_spmv_xl.cu`` built
    with ``defines`` (none: the port's; ``kernels/calibrate.py --kcols``
    compares others), with ctypes signatures declared."""
    lib = build.load("bdia_spmv_xl", defines)
    fns = {torch.float32: lib.bdia_spmv_xl_f32,
           torch.float64: lib.bdia_spmv_xl_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_double]
                       + [ctypes.c_int] * 13 + [ctypes.c_int64] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


def bdia_spmv_xl_run(op: XLOperator, x: torch.Tensor, *, b=None, s=None,
                     c=None, w: float = 1.0, out=None) -> torch.Tensor:
    """K5 on the operator ``op`` of :func:`xl_operator` (checked then),
    ``A @ x`` or its update form (as :func:`bdia_spmv_xl`): checks the
    vectors, launches K5 once, counts the launch.  On an operator of
    ``op.cols = k > 1`` columns, ``x`` is (k, P * col_pad), ``b``, ``c``
    and ``out`` (k, P * row_pad) and ``s`` one (P * row_pad,) vector for
    all columns: the k-column form, each column the single form's bits."""
    dtype, device, P = op.dtype, op.device, op.nparts
    row_pad, col_pad, k = op.row_pad, op.col_pad, op.cols
    lead = () if k == 1 and x.dim() == 1 else (k,)
    if x.dtype != dtype or x.device != device \
            or x.shape != lead + (P * col_pad,) or not x.is_contiguous():
        raise ValueError(f"bdia_spmv_xl: x must be contiguous "
                         f"{lead + (P * col_pad,)} {dtype} on {device}")
    for name, t in (("b", b), ("s", s), ("c", c), ("out", out)):
        shape = (P * row_pad,) if name == "s" else lead + (P * row_pad,)
        if t is not None and (t.dtype != dtype or t.device != device
                              or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"bdia_spmv_xl: {name} must be contiguous "
                             f"{shape} {dtype} on {device}")
    if out is not None and _overlaps(out, x):
        raise ValueError("bdia_spmv_xl: out may not overlap x")
    lib, fns = _xl_fns()
    y = torch.empty(lead + (P * row_pad,), dtype=dtype, device=device) \
        if out is None else out
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch(lib, fns[dtype], x, "bdia_spmv_xl launch", *op.head,
                 x.data_ptr(), *op.tail, ptr(b), ptr(s), ptr(c),
                 y.data_ptr(), float(w), *op.ints, k,
                 P * col_pad, P * row_pad)
    bdia_spmv_xl.launches += 1
    form = (b is not None, s is not None, c is not None)
    forms = bdia_spmv_xl.launches_by_form
    forms[form] = forms.get(form, 0) + 1
    cols = bdia_spmv_xl.launches_by_cols
    cols[k] = cols.get(k, 0) + 1
    return y


bdia_spmv_xl.launches = 0
bdia_spmv_xl.launches_by_form = {}
bdia_spmv_xl.launches_by_cols = {}


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory of tensors ``a`` and ``b`` overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())
