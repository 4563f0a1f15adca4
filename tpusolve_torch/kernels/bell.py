"""Block-ELL (BELL) SpMV: host planners, plain PyTorch version, CUDA kernel.

The diag block is cut into dense (8 x 128) tiles, one per nonempty
(8-row group, 128-column window) pair, padded block-ELL style to ``K``
tiles per group:

* ``vals``: (P, G, K, 8, 128) dense tile values (zeros in padding);
* ``ids``:  (P, G, K) int32 column-window index of each tile (padding
  tiles: window 0, zero values).

SpMV is then, for every group g::

    y[8g : 8g+8] = sum_k vals[g, k] (8 x 128) @ x[ids[g, k]*128 : +128]

trimmed to ``row_pad`` rows, with x read as zero past its end.

The host planners (``bell_plan_k``, ``bell_compact``, ``bell_from_entries``)
are numpy copies of ``tpusolve/kernels/bell.py`` so that both packages lay
out a matrix identically.  ``bell_spmv`` launches the hand-written Hopper
kernel ``csrc/bell_spmv.cu`` (the port of ``tpusolve``'s Pallas
``_bell_kernel``) on CUDA tensors and runs ``bell_spmv_plain`` on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusolve_torch.kernels import build

TM = 8    # tile rows
TN = 128  # tile cols
MAX_WARPS = 16   # K6's warps per thread block at most (csrc/bell_spmv.cu)


# ----------------------------------------------------------------------
# Host-side assembly
# ----------------------------------------------------------------------

def _sorted_unique_inverse(key_s: np.ndarray):
    """(uniq, inverse) of an already-sorted key array — O(n), no re-sort
    (``np.unique(..., return_inverse=True)`` re-sorts and was measured
    pathologically slow on large inputs)."""
    flag = np.empty(key_s.size, bool)
    flag[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=flag[1:])
    return key_s[flag], np.cumsum(flag) - 1


def bell_plan_k(lr: np.ndarray, lc: np.ndarray, row_pad: int) -> int:
    """Max tiles per 8-row group for one shard's entries (K before
    cross-shard padding)."""
    if lr.size == 0:
        return 0
    gid = np.asarray(lr, np.int64) // TM
    wid = np.asarray(lc, np.int64) // TN
    nwin = int(wid.max()) + 1
    keys = np.unique(gid * nwin + wid)
    return int(np.bincount(keys // nwin, minlength=_ngroups(row_pad)).max())


def _ngroups(row_pad: int) -> int:
    return max(1, (row_pad + TM - 1) // TM)


def bell_compact(lr, lc, v, row_pad: int, col_pad: int, kmax: int,
                 dtype=np.float32):
    """Plan one shard's BELL layout without materializing the dense tiles.

    Returns ``(ids, flat_idx, vals_ordered)``: ``ids`` is the small
    (G, kmax) int32 tile->column-window table; ``flat_idx``/``vals_ordered``
    are nnz-compact scatter staging for the (G, kmax, 8, 128) value array
    (``tiles.reshape(-1)[flat_idx] = vals_ordered``) — materialized on
    device (see matrix/build.py; the dense expansion can be 100x nnz).
    """
    G = _ngroups(row_pad)
    kmax = max(kmax, 1)
    ids = np.zeros((G, kmax), np.int32)
    lr = np.asarray(lr, np.int64)
    if lr.size == 0:
        return ids, np.zeros(0, np.int64), np.zeros(0, dtype)
    lc = np.asarray(lc, np.int64)
    v = np.asarray(v, dtype)
    gid = lr // TM
    wid = lc // TN
    nwin = (col_pad + TN - 1) // TN
    key = gid * nwin + wid
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, tile_of = _sorted_unique_inverse(key_s)
    # slot of each tile within its group (tiles sorted by key => by gid)
    tile_gid = uniq // nwin
    starts = np.searchsorted(tile_gid, np.arange(G + 1))
    slot_of_tile = np.arange(uniq.size) - starts[tile_gid]
    if uniq.size and slot_of_tile.max() >= kmax:
        raise ValueError("kmax too small for this shard")
    ids[tile_gid, slot_of_tile] = (uniq % nwin).astype(np.int32)
    slot = slot_of_tile[tile_of]                 # per (sorted) entry
    lro, lco, vo = lr[order], lc[order], v[order]
    flat_idx = ((lro // TM * kmax + slot) * TM + lro % TM) * TN + lco % TN
    return ids, flat_idx, vo


def bell_from_entries(lr, lc, v, row_pad: int, col_pad: int, kmax: int,
                      dtype=np.float32):
    """Host-materialized variant of :func:`bell_compact` (small shards,
    tests).  Returns (vals (G, kmax, 8, 128), ids (G, kmax) int32)."""
    ids, flat_idx, vo = bell_compact(lr, lc, v, row_pad, col_pad, kmax, dtype)
    G = _ngroups(row_pad)
    vals = np.zeros(G * max(kmax, 1) * TM * TN, dtype)
    vals[flat_idx] = vo
    return vals.reshape(G, max(kmax, 1), TM, TN), ids


# ----------------------------------------------------------------------
# SpMV
# ----------------------------------------------------------------------

def bell_spmv_plain(vals: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
                    nwin: int, row_pad: int) -> torch.Tensor:
    """Plain PyTorch BELL SpMV, the math of ``tpusolve``'s
    ``bell_spmv_local``: x as (nwin, 128) zero-padded windows, one row
    gather of each tile's window, then a batched (8, K*128) @ (K*128,)
    contraction per group.

    ``vals`` (P, G, K, 8, 128), ``ids`` (P, G, K) int32, ``x``
    (P * col_pad,) -> y (P * row_pad,)."""
    P, G, K = ids.shape
    xs = x.reshape(P, -1)
    need = nwin * TN
    if xs.shape[1] < need:
        xs = torch.nn.functional.pad(xs, (0, need - xs.shape[1]))
    x2d = xs[:, :need].reshape(P, nwin, TN)
    parts = torch.arange(P, device=x.device).reshape(P, 1, 1)
    win = x2d[parts, ids.to(torch.int64)]                # (P, G, K, 128)
    y = torch.einsum("pgkrc,pgkc->pgr", vals, win)
    return y.reshape(P, G * TM)[:, :row_pad].reshape(-1)


def bell_warps(K: int) -> int:
    """Warps of K6's thread block for a group of ``K`` tiles: one a tile, at
    most ``MAX_WARPS`` (``csrc/bell_spmv.cu``); warp w takes tiles w,
    w + warps, ..."""
    return max(1, min(K, MAX_WARPS))


@functools.cache
def _kernel_fns():
    """(library, {dtype: entry point}) with ctypes signatures declared."""
    lib = build.load("bell_spmv")
    fns = {torch.float32: lib.bell_spmv_f32, torch.float64: lib.bell_spmv_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


def bell_spmv(vals: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
              nwin: int, row_pad: int) -> torch.Tensor:
    """BELL SpMV, ``y = A @ x`` (arguments as :func:`bell_spmv_plain`).

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/bell_spmv.cu`` (building it on first use) or raise; there is no
    fallback.  ``bell_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return bell_spmv_plain(vals, ids, x, nwin, row_pad)
    if x.device.type != "cuda":
        raise ValueError(f"bell_spmv: unsupported device {x.device}")
    P, G, K = ids.shape
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bell_spmv: unsupported dtype {x.dtype}")
    if vals.dtype != x.dtype or vals.shape != (P, G, K, TM, TN):
        raise TypeError("bell_spmv: vals must be (P, G, K, 8, 128) of x's "
                        "dtype")
    if ids.dtype != torch.int32:
        raise TypeError("bell_spmv: ids must be int32")
    for name, t in (("vals", vals), ("ids", ids), ("x", x)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bell_spmv: {name} must be contiguous on "
                             f"{x.device}")
    if vals.data_ptr() % 16:
        raise ValueError("bell_spmv: vals must be 16-byte aligned")
    if x.dim() != 1 or x.numel() % P:
        raise ValueError("bell_spmv: x must be flat (P * col_pad,)")
    col_pad = x.numel() // P
    if max(nwin * TN, col_pad, row_pad, G * TM) >= 2 ** 31:
        raise ValueError("bell_spmv: part too large for 32-bit indices")
    lib, fns = _kernel_fns()
    y = torch.empty(P * row_pad, dtype=x.dtype, device=x.device)
    build.launch(lib, fns[x.dtype], x, "bell_spmv launch", vals.data_ptr(),
                 ids.data_ptr(), x.data_ptr(), y.data_ptr(), P, G, K,
                 row_pad, col_pad, bell_warps(K))
    bell_spmv.launches += 1
    return y


bell_spmv.launches = 0
