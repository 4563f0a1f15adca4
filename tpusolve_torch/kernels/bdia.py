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

The host planners (``plan_fill_profile``, ``compact``, ``finalize_starts``)
are numpy copies of ``tpusolve/kernels/bdia.py`` so that both packages lay
out a matrix identically.  ``bdia_spmv`` launches the hand-written Hopper
kernel ``csrc/bdia_spmv.cu`` (the port of ``tpusolve``'s Pallas
``_bdia_kernel``) on CUDA tensors and runs ``bdia_spmv_plain`` on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusolve_torch.kernels import build

BLOCK_SIZES = (2048, 1024, 512, 256, 128)  # candidate R values


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
        ptr, ocols, ovals = ovf
        for p in range(P):
            n = int(ptr[p, -1])
            rows = torch.repeat_interleave(
                torch.arange(row_pad, device=x.device),
                (ptr[p, 1:] - ptr[p, :-1]).to(torch.int64))
            y[p].index_add_(0, rows, ovals[p, :n]
                            * xs[p].index_select(0, ocols[p, :n]))
    return y.reshape(-1)


_SMEM_MAX = 48 * 1024   # default dynamic shared memory without opt-in


@functools.cache
def _kernel_fns():
    """(library, {dtype: entry point}) with ctypes signatures declared."""
    lib = build.load("bdia_spmv")
    fns = {torch.float32: lib.bdia_spmv_f32, torch.float64: lib.bdia_spmv_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


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
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bdia_spmv: unsupported dtype {x.dtype}")
    if vals.dtype != x.dtype:
        raise TypeError(f"bdia_spmv: vals {vals.dtype} != x {x.dtype}")
    if starts.dtype != torch.int32 or starts.shape != (P, B, D):
        raise TypeError("bdia_spmv: starts must be int32 of shape (P, B, D)")
    tensors = [("vals", vals), ("starts", starts), ("x", x)]
    ovf_ptrs, ovf_len = (None, None, None), 0
    if ovf is not None:
        ptr, ocols, ovals = ovf
        ovf_len = ocols.shape[-1]
        if ptr.dtype != torch.int32 or ptr.shape != (P, row_pad + 1) \
                or ocols.dtype != torch.int32 or ocols.shape != (P, ovf_len) \
                or ovals.dtype != x.dtype or ovals.shape != (P, ovf_len):
            raise TypeError("bdia_spmv: ovf must be int32 ptr (P, row_pad+1), "
                            "int32 cols (P, k) and vals (P, k) of x's dtype")
        tensors += [("ovf ptr", ptr), ("ovf cols", ocols),
                    ("ovf vals", ovals)]
        ovf_ptrs = (ptr.data_ptr(), ocols.data_ptr(), ovals.data_ptr())
    for name, t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bdia_spmv: {name} must be contiguous on "
                             f"{x.device}")
    if x.dim() != 1 or x.numel() % P:
        raise ValueError("bdia_spmv: x must be flat (P * col_pad,)")
    col_pad = x.numel() // P
    if D * 4 > _SMEM_MAX:
        raise ValueError(f"bdia_spmv: {D} slots exceed the kernel's "
                         "shared-memory staging")
    if max(B * R, row_pad + 1, col_pad, xlen, ovf_len) >= 2 ** 31:
        raise ValueError("bdia_spmv: part too large for 32-bit row indices")
    lib, fns = _kernel_fns()
    fn = fns[x.dtype]
    y = torch.empty(P * row_pad, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(vals.data_ptr(), starts.data_ptr(), x.data_ptr(),
                  *ovf_ptrs, y.data_ptr(), P, B, D, R, row_pad, col_pad,
                  xpad_lo, ovf_len, stream)
    build.check(lib, code, "bdia_spmv launch")
    bdia_spmv.launches += 1
    return y


bdia_spmv.launches = 0
