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
block per *step* of ``gb`` consecutive R-row blocks copies the step's x
panel, every x entry its windows read, into shared memory, and reads the
windows from there.  ``plan_steps`` is the port's own step plan: ``gb``,
each step's panel start ``step_lo`` (P, nsteps) int32 in the unpadded x
(negative where the panel begins before x; entries outside ``[0, col_pad)``
read as 0), and one panel length for all steps, in elements.  Starts and
lengths are multiples of ``XL_ALIGN`` elements, so the kernel's bulk copy
moves whole 16-byte units in f32 and f64 alike.
"""

from __future__ import annotations

import ctypes
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
# panel: an mbarrier (16 bytes) and the step's window offsets (gb * D int32)
XL_GB = tuple(range(1, 65))
XL_THREADS = 1024
XL_ROW_BYTES = 16
XL_ALIGN = 4
XL_BARRIER_BYTES = 16

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


def xl_smem_bytes(panel: int, gb: int, D: int, itemsize: int) -> int:
    """Shared memory of one K5 block: barrier, x panel, window offsets."""
    return XL_BARRIER_BYTES + panel * itemsize + gb * D * 4


def xl_threads(gb: int, R: int, itemsize: int) -> int:
    """Threads of one K5 block: one per ``XL_ROW_BYTES`` of the step's rows
    (4 rows in f32, 2 in f64), rounded up to whole warps, at most
    ``XL_THREADS`` (``csrc/bdia_spmv_xl.cu``)."""
    groups = gb * R * itemsize // XL_ROW_BYTES
    return min(XL_THREADS, -(-groups // 32) * 32)


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


def plan_steps(starts: np.ndarray, R: int, xpad_lo: int, itemsize: int,
               price):
    """The BDIA-XL step plan ``(gb, step_lo, panel)`` of least
    ``price(gb, nsteps, panel)`` (seconds, the caller's time model) over
    ``XL_GB``, or None when no candidate's block fits
    ``runtime.SMEM_PER_BLOCK``.

    ``starts`` (P, B, D) are the padded-x window starts; step i of part p
    holds blocks ``[i*gb, min((i+1)*gb, B))``, and its panel
    ``[step_lo[p, i], step_lo[p, i] + panel)`` of the unpadded x covers
    every window of those blocks.  ``step_lo`` is int32 (P, nsteps)."""
    s = np.asarray(starts, np.int64) - xpad_lo
    P, B, D = s.shape
    first = s.min(axis=2)                     # (P, B) window starts
    last = s.max(axis=2) + R                  # (P, B) window ends
    best = None
    for gb in XL_GB:
        idx = np.arange(0, B, gb)
        lo = np.minimum.reduceat(first, idx, axis=1) // XL_ALIGN * XL_ALIGN
        hi = np.maximum.reduceat(last, idx, axis=1)
        panel = int(-(-int((hi - lo).max()) // XL_ALIGN) * XL_ALIGN)
        if xl_smem_bytes(panel, gb, D, itemsize) <= runtime.SMEM_PER_BLOCK:
            t = price(gb, idx.size, panel)
            if best is None or t < best[0]:
                best = (t, gb, lo.astype(np.int32), panel)
        if gb >= B:
            break       # one step already: larger gb plans the same
    return None if best is None else best[1:]


def _add_overflow(y: torch.Tensor, xs: torch.Tensor, ovf,
                  row_pad: int) -> None:
    """``y[p]`` (P, row_pad) += each part's overflow list (module
    docstring), by one gather and one ``index_add_`` per part."""
    ptr, ocols, ovals = ovf
    for p in range(y.shape[0]):
        n = int(ptr[p, -1])
        rows = torch.repeat_interleave(
            torch.arange(row_pad, device=y.device),
            (ptr[p, 1:] - ptr[p, :-1]).to(torch.int64))
        y[p].index_add_(0, rows, ovals[p, :n]
                        * xs[p].index_select(0, ocols[p, :n]))


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
    y = (vals * win).sum(dim=2).reshape(P, B * R)[:, :row_pad]
    if ovf is not None:
        _add_overflow(y, xs, ovf, row_pad)
    return y.reshape(-1)


def bdia_spmv_xl_plain(vals: torch.Tensor, starts: torch.Tensor,
                       x: torch.Tensor, xpad_lo: int, row_pad: int, gb: int,
                       step_lo: torch.Tensor, panel: int,
                       ovf=None) -> torch.Tensor:
    """Plain PyTorch BDIA SpMV by panel steps (K5's function, which is
    K4's): a gather of each step's panel of x (0 outside ``[0, col_pad)``),
    a gather of every (block, slot) window out of its step's panel, a sum
    over slots, then the overflow list as in :func:`bdia_spmv_plain`.

    ``step_lo`` (P, nsteps) int32 and ``panel`` as :func:`plan_steps` gives
    them.  Every window must lie inside its step's panel: this is checked."""
    P, B, D, R = vals.shape
    xs = x.reshape(P, -1)
    col_pad = xs.shape[1]
    nsteps = step_lo.shape[1]
    dev = x.device
    # (P, nsteps, panel) panels of the unpadded x
    pidx = step_lo.to(torch.int64).unsqueeze(-1) + torch.arange(panel,
                                                                device=dev)
    inside = (pidx >= 0) & (pidx < col_pad)
    pan = torch.where(inside, torch.gather(
        xs, 1, pidx.clamp(0, col_pad - 1).reshape(P, -1)).reshape(pidx.shape),
        torch.zeros((), dtype=x.dtype, device=dev))
    if nsteps != -(-B // gb):
        raise ValueError(f"BDIA-XL: {nsteps} steps for {B} blocks of {gb}")
    # each window's offset in its step's panel
    step = torch.arange(B, device=dev) // gb
    off = (starts.to(torch.int64) - xpad_lo
           - step_lo.to(torch.int64)[:, step].unsqueeze(-1))     # (P, B, D)
    if int(off.min()) < 0 or int(off.max()) + R > panel:
        raise ValueError("BDIA-XL window outside its step's panel")
    # windows as flat indices into the (P, nsteps * panel) panels
    widx = ((step * panel).reshape(1, B, 1, 1) + off.unsqueeze(-1)
            + torch.arange(R, device=dev))
    win = torch.gather(pan.reshape(P, -1), 1,
                       widx.reshape(P, -1)).reshape(P, B, D, R)
    y = (vals * win).sum(dim=2).reshape(P, B * R)[:, :row_pad]
    if ovf is not None:
        _add_overflow(y, xs, ovf, row_pad)
    return y.reshape(-1)


_SMEM_MAX = 48 * 1024   # default dynamic shared memory without opt-in


@functools.cache
def _kernel_fns(name: str, nptrs: int, nints: int):
    """(library, {dtype: entry point}) of ``csrc/<name>.cu``, with ctypes
    signatures declared: ``nptrs`` pointers, ``nints`` ints, the stream."""
    lib = build.load(name)
    fns = {torch.float32: getattr(lib, name + "_f32"),
           torch.float64: getattr(lib, name + "_f64")}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * nptrs + [ctypes.c_int] * nints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


def _check_launch(what: str, vals, starts, x, row_pad: int, ovf,
                  extra=()) -> tuple:
    """Check the arguments K4 and K5 share (``extra``: more (name, tensor)
    pairs that must be contiguous on x's device); returns (col_pad, overflow
    pointers, overflow length)."""
    P, B, D, R = vals.shape
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if vals.dtype != x.dtype:
        raise TypeError(f"{what}: vals {vals.dtype} != x {x.dtype}")
    if starts.dtype != torch.int32 or starts.shape != (P, B, D):
        raise TypeError(f"{what}: starts must be int32 of shape (P, B, D)")
    tensors = [("vals", vals), ("starts", starts), ("x", x), *extra]
    ovf_ptrs, ovf_len = (None, None, None), 0
    if ovf is not None:
        ptr, ocols, ovals = ovf
        ovf_len = ocols.shape[-1]
        if ptr.dtype != torch.int32 or ptr.shape != (P, row_pad + 1) \
                or ocols.dtype != torch.int32 or ocols.shape != (P, ovf_len) \
                or ovals.dtype != x.dtype or ovals.shape != (P, ovf_len):
            raise TypeError(f"{what}: ovf must be int32 ptr (P, row_pad+1), "
                            "int32 cols (P, k) and vals (P, k) of x's dtype")
        tensors += [("ovf ptr", ptr), ("ovf cols", ocols),
                    ("ovf vals", ovals)]
        ovf_ptrs = (ptr.data_ptr(), ocols.data_ptr(), ovals.data_ptr())
    for name, t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{x.device}")
    if x.dim() != 1 or x.numel() % P:
        raise ValueError(f"{what}: x must be flat (P * col_pad,)")
    col_pad = x.numel() // P
    if max(B * R, row_pad + 1, col_pad, ovf_len) >= 2 ** 31:
        raise ValueError(f"{what}: part too large for 32-bit row indices")
    return col_pad, ovf_ptrs, ovf_len


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
    col_pad, ovf_ptrs, ovf_len = _check_launch("bdia_spmv", vals, starts, x,
                                               row_pad, ovf)
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
                 panel: int, ovf=None) -> torch.Tensor:
    """BDIA SpMV by panel steps, ``y = A @ x`` (arguments as
    :func:`bdia_spmv_xl_plain`); equal to :func:`bdia_spmv` bit for bit.

    CPU tensors take the plain version.  CUDA tensors launch K5, the kernel
    of ``csrc/bdia_spmv_xl.cu`` (building it on first use), or raise; there
    is no fallback.  ``bdia_spmv_xl.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return bdia_spmv_xl_plain(vals, starts, x, xpad_lo, row_pad, gb,
                                  step_lo, panel, ovf)
    if x.device.type != "cuda":
        raise ValueError(f"bdia_spmv_xl: unsupported device {x.device}")
    P, B, D, R = vals.shape
    nsteps = -(-B // gb)
    col_pad, ovf_ptrs, ovf_len = _check_launch(
        "bdia_spmv_xl", vals, starts, x, row_pad, ovf,
        extra=[("step_lo", step_lo)])
    if step_lo.dtype != torch.int32 or step_lo.shape != (P, nsteps):
        raise TypeError("bdia_spmv_xl: step_lo must be int32 of shape "
                        f"(P, {nsteps})")
    if panel % XL_ALIGN or R % 128:
        raise ValueError(f"bdia_spmv_xl: the panel must be a multiple of "
                         f"{XL_ALIGN} and R of 128")
    if xl_smem_bytes(panel, gb, D, x.element_size()) > runtime.SMEM_PER_BLOCK:
        raise ValueError(f"bdia_spmv_xl: a panel of {panel} does not fit "
                         "one block's shared memory")
    runtime.require_smem(x.device.index)
    lib, fns = _kernel_fns("bdia_spmv_xl", 8, 11)
    y = torch.empty(P * row_pad, dtype=x.dtype, device=x.device)
    build.launch(lib, fns[x.dtype], x, "bdia_spmv_xl launch",
                 vals.data_ptr(), starts.data_ptr(), step_lo.data_ptr(),
                 x.data_ptr(), *ovf_ptrs, y.data_ptr(), P, B, D, R, row_pad,
                 col_pad, xpad_lo, ovf_len, gb, nsteps, panel)
    bdia_spmv_xl.launches += 1
    return y


bdia_spmv_xl.launches = 0
