"""ShardedMatrix — the ParCSR-analog sparse matrix of the port (the port of
``tpusolve/matrix/sharded.py``).

HYPRE stores a distributed matrix as a 1-D row-block partition with a *diag*
block (owned columns) and an *offd* block (ghost columns) per rank (ref:
src/HypreSystem.cpp:552-636).  The port keeps ``tpusolve``'s stacked layout:
every tensor has a leading part axis of size ``nparts``, rows are padded per
part to ``row_pad``, padded vector entries are exact zeros and padded
diagonal entries are 1.  This slice carries one part (no offd block, no halo
plan) and these diag-block layouts:

* **DIA** (box DIA, ``kernels/dia.py``), built only by :meth:`from_dia_parts`
  (the stencil generator and the structured multigrid levels) and by
  :meth:`from_arrays`: one plane of coefficients per (dz, dy, dx) triple
  over the part's (nz, ny, nx) box, run by K1.  The triples are kept, never
  turned back from flat offsets where that is ambiguous
  (:func:`dia_triples`).

The assembly from entries (:meth:`from_local_parts`) chooses among the
others in ``tpusolve``'s decision order BDIA -> BELL -> ELL (its DIA-first
candidacy is not ported):

* **BDIA** (blocked DIA, ``kernels/bdia.py``) with an overflow list of the
  entries that do not fit a block's slots, kept row-sorted with a CSR row
  pointer so that the kernel adds each row's spilled entries itself; for
  banded matrices with enough entries (file-loaded systems after RCM).  It
  runs K4, or K5 by panel steps (BDIA-XL) where a step plan fits a block's
  shared memory and the time model prices K5 strictly faster;
* **BELL** (block ELL, ``kernels/bell.py``), run by K6;
* **padded ELL** otherwise: every row padded to a fixed width (padding
  entries carry value 0 and column 0).

The BDIA block size R and slot count D are chosen to minimise the matrix
bytes one SpMV streams (the slot values and the overflow entries' columns
and values), instead of ``tpusolve``'s v5e-calibrated nanosecond model and
VMEM budget; the kernels and the layouts then compete on a time model whose
constants were measured on the card.  Nothing is queried from the device, so
the choice is the same on the CPU and the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpusolve_torch import runtime
from tpusolve_torch.kernels import bdia as bdia_mod
from tpusolve_torch.kernels import bell as bell_mod
from tpusolve_torch.matrix import coo as coo_mod
from tpusolve_torch.matrix.build import materialize
from tpusolve_torch.matrix.vectors import to_tensor, torch_dtype, numpy_dtype
from tpusolve_torch.parts import (
    MULTIPART_ITEM, require_single_part, row_decomposition)

# BDIA and BELL are considered when the diag block holds at least this many
# entries (``tpusolve``'s BELL_MIN_NNZ: below it the ELL fallback is cheap)...
BDIA_MIN_NNZ = 20_000
# ...and their padded values may not exceed this many bytes, nor expand the
# compact nnz bytes by more than TILE_MAX_EXPANSION (plus a small-matrix
# floor): memory caps shared with ``tpusolve``
BDIA_MAX_BYTES = 4 << 30
TILE_MAX_EXPANSION = 12.0
TILE_EXPANSION_FLOOR = 256 << 20

# Time models of one diag-block SpMV, with constants measured by
# ``python -m tpusolve_torch.kernels.calibrate 3`` on an NVIDIA H100 80GB
# HBM3 with a 700.00 W power limit, from the kernels' device time (a
# ``torch.profiler`` trace): medians of three runs, on the register-stage
# K4 and the warp-per-tile K6 (PERF.md).
#
# BDIA against BELL (K4 against K6, spmv_model_s): for each kernel, the
# rate at which it streams the matrix's bytes when the launch fills the card
# (bytes/s), and the number of threads at which it does; on random windows
# and ids in f64, for every item size:
SPMV_MODEL = {"bdia": (2.922e12, 24_848), "bell": (3.164e12, 80_511)}
# K4 against K5 on a BDIA layout (band_model_s): each kernel's rate by item
# size, on one banded operator with an overflow list like the RCM-ordered
# ILU factors', in one full round of blocks (K5's bytes count its panels):
BAND_RATE = {("bdia", 4): 2.530e12, ("bdia", 8): 2.542e12,
             ("bdia_xl", 4): 2.626e12, ("bdia_xl", 8): 2.680e12}


def tile_budget(total_nnz: int, itemsize: int) -> int:
    """Bytes the padded values of a BDIA or BELL layout may take."""
    return min(BDIA_MAX_BYTES, max(TILE_EXPANSION_FLOOR,
                                   int(TILE_MAX_EXPANSION * total_nnz
                                       * itemsize)))


def spmv_model_s(constants: tuple, nbytes: int, threads: int) -> float:
    """Modelled seconds of one SpMV by a kernel with ``constants`` (rate,
    threads_full) (``SPMV_MODEL``) that streams ``nbytes``
    over a launch of ``threads`` threads: the bytes at the kernel's full
    rate, slowed in proportion where the launch exposes too few threads to
    fill the card.  Bytes alone do not bound a small operator on 132 SMs:
    its parallelism does."""
    rate, threads_full = constants
    return nbytes / (rate * min(1.0, threads / threads_full))


def bdia_threads(B: int, R: int) -> int:
    """Threads of one part's K4 launch: one per row of every R-row block
    (``kernels/bdia.py:k4_plan``)."""
    return B * R


def band_model_s(kind: str, itemsize: int, nbytes: int, blocks: int,
                 resident: int) -> float:
    """Modelled seconds of one SpMV by K4 (``"bdia"``) or K5
    (``"bdia_xl"``) on a banded BDIA layout in ``itemsize``-byte values that
    streams ``nbytes`` in ``blocks`` thread blocks, of which the card holds
    ``resident`` at once: the bytes at the kernel's ``BAND_RATE``, times
    ``ceil(blocks / resident) * resident / blocks``.  The blocks run in
    rounds; a round that is partly empty, or a launch of fewer blocks than
    the card holds, takes as long as a full round.  K5's blocks are large
    (:func:`xl_resident`); K4's are small and share their SM's bandwidth,
    so they are counted one per SM (:func:`k4_blocks`): the factor is then
    the load of the busiest SM over the mean."""
    rounds = -(-blocks // resident)
    return nbytes / BAND_RATE[kind, itemsize] * rounds * resident / blocks


def k4_blocks(nparts: int, B: int, D: int, R: int,
              itemsize: int) -> tuple:
    """``(blocks, SM_COUNT)`` of K4's launch on a (nparts, B, D, R) layout:
    its thread blocks (``kernels/bdia.py:k4_plan``), counted one per SM.
    An SM holds several K4 blocks at once, each with its own loads in
    flight, and they share the SM's bandwidth: the launch takes as long as
    its busiest SM, which runs ``ceil(blocks / SM_COUNT)``."""
    return bdia_mod.k4_plan(nparts, B, D, R, itemsize)[2], runtime.SM_COUNT


def k4_model_s(itemsize: int, nbytes: int, nparts: int, B: int, D: int,
               R: int) -> float:
    """:func:`band_model_s` of K4 on a (nparts, B, D, R) layout that
    streams ``nbytes``."""
    return band_model_s("bdia", itemsize, nbytes,
                        *k4_blocks(nparts, B, D, R, itemsize))


def xl_resident(smem: int, threads: int) -> int:
    """K5 blocks of ``smem`` bytes and ``threads`` threads that the card
    holds at once, by shared memory (``runtime``'s H100 figures) and by
    registers: K5's launch bounds of ``XL_THREADS`` threads give a thread
    the registers of an SM over ``XL_THREADS``, so an SM holds that many
    threads.  A K5 block holds up to 227 KB, so often one is all an SM
    holds."""
    per_sm = min(runtime.SM_SMEM // (smem + runtime.SM_SMEM_RESERVED),
                 bdia_mod.XL_THREADS // threads)
    return runtime.SM_COUNT * max(per_sm, 1)


def bell_threads(G: int, K: int) -> int:
    """Threads of one part's K6 launch on G groups of K tiles: a block of
    ``bell_warps(K)`` warps per group (``kernels/bell.py``)."""
    return 32 * G * bell_mod.bell_warps(K)


def bdia_bytes(B: int, D: int, R: int, k: int, itemsize: int) -> int:
    """Matrix bytes one BDIA SpMV streams: the slot values and ``k``
    overflow entries (int32 column and value).  x is left out: its entries
    are read from device memory about once whatever its size, because on a
    banded operator the windows of the blocks in flight touch only those
    blocks' rows plus twice the band, a few MB, which L2 holds.  L2 does not
    make the windows free: K4 reads one x entry from L2 beside each value.
    K5 reads them from a panel in shared memory instead and pays for the
    panels (:func:`plan_xl`)."""
    return B * D * R * itemsize + k * (4 + itemsize)


def plan_xl(starts: np.ndarray, R: int, xpad: int, itemsize: int,
            nbytes: int):
    """``(gb, step_lo, panel, seconds)`` of K5's cheapest step plan on a
    BDIA layout with padded-x window ``starts`` (P, B, D) that streams
    ``nbytes`` (:func:`bdia_bytes`), priced by :func:`band_model_s` on
    those bytes plus every step's x panel; None when no plan fits one
    block's shared memory."""
    nparts, _, D = starts.shape

    def price(gb, nsteps, panel):
        return band_model_s(
            "bdia_xl", itemsize, nbytes + nparts * nsteps * panel * itemsize,
            nparts * nsteps, xl_resident(
                bdia_mod.xl_smem_bytes(panel, gb, D, itemsize),
                bdia_mod.xl_threads(gb, R, itemsize)))

    plan = bdia_mod.plan_steps(starts, R, xpad, itemsize, price)
    if plan is None:
        return None
    gb, step_lo, panel = plan
    return gb, step_lo, panel, price(gb, step_lo.shape[1], panel)


def choose_xl(starts: np.ndarray, R: int, xpad: int, itemsize: int,
              nbytes: int):
    """K5's step plan ``(gb, step_lo, panel)`` for a BDIA layout where it is
    eligible and its modelled time is strictly below K4's on the same
    layout (:func:`band_model_s`), else None (K4)."""
    nparts, B, D = starts.shape
    t4 = k4_model_s(itemsize, nbytes, nparts, B, D, R)
    xl = plan_xl(starts, R, xpad, itemsize, nbytes)
    return xl[:3] if xl is not None and xl[3] < t4 else None


def plan_bdia(diag_parts, row_pad: int, col_pad: int, itemsize: int,
              total_nnz: int, nparts: int = 1):
    """``(R, D, bytes)`` of the (R, D) pair of least :func:`bdia_bytes`, or
    None when no layout fits the memory cap with an overflow list of at
    most ``max(4096, total_nnz // 8)`` entries (the overflow must stay a
    correction, not a layout)."""
    budget = tile_budget(total_nnz, itemsize)
    best, best_bytes = None, None
    for R in bdia_mod.BLOCK_SIZES:
        profs = [bdia_mod.plan_fill_profile(dp[0], dp[1], row_pad, col_pad, R)
                 for dp in diag_parts]
        Dfull = max((len(pr) for pr in profs), default=0)
        if Dfull <= 0:
            continue
        rank_totals = np.zeros(Dfull, np.int64)
        for pr in profs:
            rank_totals[:len(pr)] += pr
        # ovf[D] = entries spilled to the overflow list at cap D
        ovf = np.concatenate([np.cumsum(rank_totals[::-1])[::-1], [0]])
        B = (row_pad + R - 1) // R
        for D in range(1, Dfull + 1):
            if nparts * B * D * R * itemsize > budget:
                break   # grows with D: no larger D fits either
            k = int(ovf[D])
            if k > max(4096, total_nnz // 8):
                continue
            nbytes = bdia_bytes(nparts * B, D, R, k, itemsize)
            if best_bytes is None or nbytes < best_bytes:
                best, best_bytes = (R, D, nbytes), nbytes
    return best


def plan_bell(diag_parts, row_pad: int, itemsize: int, total_nnz: int,
              nparts: int = 1):
    """``(K, bytes)`` of the BELL layout (K tiles per 8-row group; bytes of
    its tiles and window ids), or None when its tiles do not fit the memory
    cap."""
    bk = max((bell_mod.bell_plan_k(dp[0], dp[1], row_pad)
              for dp in diag_parts), default=0)
    G = bell_mod._ngroups(row_pad)
    tile_bytes = nparts * G * bk * bell_mod.TM * bell_mod.TN * itemsize
    if bk <= 0 or tile_bytes > tile_budget(total_nnz, itemsize):
        return None
    return bk, tile_bytes + nparts * G * bk * 4


def choose_layout(diag_parts, row_pad: int, col_pad: int, itemsize: int,
                  total_nnz: int, nparts: int = 1, allow_bdia: bool = True,
                  allow_bell: bool = True):
    """``("bdia", (R, D, bytes, staging, xl))``, ``("bell", (K, bytes))``
    or ``("ell", None)`` for a diag block: BDIA or BELL by modelled time
    (:func:`spmv_model_s` with ``SPMV_MODEL``), BDIA on a tie; ELL below
    ``BDIA_MIN_NNZ`` or when neither fits (``tpusolve``'s order, caps and
    tie rule).  BDIA's (R, D) is :func:`plan_bdia`'s and ``staging``
    :func:`_bdia_staging`'s at (R, D); ``xl`` is K5's step plan where
    :func:`choose_xl` takes it, else None (K4)."""
    if total_nnz < BDIA_MIN_NNZ:
        return "ell", None
    best = ("ell", None, float("inf"))
    if allow_bdia:
        plan = plan_bdia(diag_parts, row_pad, col_pad, itemsize, total_nnz,
                         nparts)
        if plan is not None:
            R, D, nbytes = plan
            t = spmv_model_s(SPMV_MODEL["bdia"], nbytes, nparts * bdia_threads(
                (row_pad + R - 1) // R, R))
            best = ("bdia", (R, D, nbytes), t)
    if allow_bell:
        plan = plan_bell(diag_parts, row_pad, itemsize, total_nnz, nparts)
        if plan is not None:
            t = spmv_model_s(SPMV_MODEL["bell"], plan[1], nparts * bell_threads(
                bell_mod._ngroups(row_pad), plan[0]))
            if t < best[2]:
                best = ("bell", plan, t)
    if best[0] == "bdia":
        R, D, nbytes = best[1]
        staging = _bdia_staging(diag_parts, R, D, row_pad, col_pad)
        xl = choose_xl(staging[0], R, staging[1], itemsize, nbytes)
        return "bdia", (R, D, nbytes, staging, xl)
    return best[:2]


@dataclass(frozen=True)
class ShardedMatrix:
    # --- device data (leading axis = part) ---
    diag_vals: torch.Tensor   # (P, row_pad, Kd) ELL values (1 wide if BDIA)
    diag_cols: torch.Tensor   # (P, row_pad, Kd) int32 local column
    bdia_vals: torch.Tensor | None    # (P, B, D, R) blocked-DIA rows
    bdia_starts: torch.Tensor | None  # (P, B, D) int32 x-window starts
    bell_vals: torch.Tensor | None    # (P, G, K, 8, 128) dense tiles
    bell_ids: torch.Tensor | None     # (P, G, K) int32 column-window ids
    diag: torch.Tensor        # (P, row_pad) main diagonal, 1 on padded rows
    # --- static metadata ---
    shape: tuple
    row_offsets: tuple
    col_offsets: tuple
    row_pad: int
    col_pad: int
    nnz: int
    bdia_block: int | None = None
    bdia_xpad: int | None = None
    bdia_xlen: int | None = None
    bell_nwin: int | None = None      # 128-column windows of x per part
    # --- BDIA overflow lists: entries spilled when a block has more
    # distinct offsets than D, in CSR form (sorted by row); a part with
    # fewer than k entries is padded at the end with column 0 and value 0
    bdia_ovf_ptr: torch.Tensor | None = None   # (P, row_pad + 1) int32
    bdia_ovf_cols: torch.Tensor | None = None  # (P, k) int32 local cols
    bdia_ovf_vals: torch.Tensor | None = None  # (P, k)
    # --- BDIA-XL step plan (K5, kernels/bdia.py:plan_steps); None -> K4
    bdia_gb: int | None = None                  # R-row blocks per step
    bdia_step_lo: torch.Tensor | None = None    # (P, nsteps) int32
    bdia_panel: int | None = None               # panel length, elements
    # --- box DIA (K1, kernels/dia.py); None -> another layout
    dia_vals: torch.Tensor | None = None   # (P, D, nz, ny, nx) planes
    dia_offsets: tuple | None = None       # D (dz, dy, dx) triples
    dia_shape: tuple | None = None         # declared (nz, ny, nx); None: 1-D

    @property
    def nparts(self) -> int:
        return len(self.row_offsets) - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.diag_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.diag_vals.device

    @property
    def uses_dia(self) -> bool:
        return self.dia_vals is not None

    @property
    def uses_bdia(self) -> bool:
        return self.bdia_vals is not None

    @property
    def uses_bdia_xl(self) -> bool:
        return self.bdia_step_lo is not None

    @property
    def uses_bell(self) -> bool:
        return self.bell_vals is not None

    @property
    def bdia_ovf(self):
        """(ptr, cols, vals) of the overflow list, as ``bdia_spmv`` takes
        it, or None."""
        if self.bdia_ovf_ptr is None:
            return None
        return self.bdia_ovf_ptr, self.bdia_ovf_cols, self.bdia_ovf_vals

    @property
    def layout(self) -> str:
        """One line naming the layout, for logs."""
        if self.uses_dia:
            box = "x".join(str(d) for d in self.dia_vals.shape[2:])
            return f"DIA D={self.dia_vals.shape[1]} box={box}"
        if self.uses_bell:
            _, G, K = self.bell_ids.shape
            return f"BELL K={K} G={G}"
        if not self.uses_bdia:
            return f"ELL K={self.diag_vals.shape[-1]}"
        _, B, D, R = self.bdia_vals.shape
        k = 0 if self.bdia_ovf_ptr is None else int(
            self.bdia_ovf_ptr[:, -1].sum())
        if self.uses_bdia_xl:
            kb = self.bdia_panel * self.bdia_vals.element_size() / 1024
            return (f"BDIA-XL R={R} D={D} B={B} gb={self.bdia_gb} "
                    f"panel={kb:.1f} KB overflow={k}")
        return f"BDIA R={R} D={D} B={B} overflow={k}"

    # ------------------------------------------------------------------
    @staticmethod
    def from_coo(shape, rows, cols, vals, *, device, dtype=None,
                 dedup="add", row_offsets=None, col_offsets=None,
                 allow_bdia: bool = True, allow_bell: bool = True):
        """Assemble a global COO (any order, duplicates combined per
        ``dedup``) — the IJ ``SetValues/AddToValues + Assemble`` pipeline
        (ref: src/HypreSystem.cpp:600-636, 897-955)."""
        nrows, ncols = shape
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, 1)
        row_offsets = np.asarray(row_offsets, np.int64)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if rows.size and (rows.min() < 0 or rows.max() >= nrows):
            raise ValueError("row index out of range")
        if cols.size and (cols.min() < 0 or cols.max() >= ncols):
            raise ValueError("col index out of range")
        r, c, v = coo_mod.dedup_coo(rows, cols, vals, mode=dedup)
        parts = coo_mod.bucket_by_owner(r, c, v, row_offsets)
        return ShardedMatrix.from_local_parts(
            shape, parts, device=device, dtype=dtype,
            row_offsets=row_offsets, col_offsets=col_offsets,
            allow_bdia=allow_bdia, allow_bell=allow_bell)

    @staticmethod
    def from_csr_host(M, *, device, dtype=None, row_offsets=None,
                      col_offsets=None, allow_bdia: bool = True,
                      allow_bell: bool = True):
        """Assemble a host CSR directly: row blocks are contiguous indptr
        slices, already row-sorted, so no global COO sort (the AMG setup's
        P, R and Galerkin coarse operators arrive as CSR)."""
        M = M.tocsr()
        nrows = M.shape[0]
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, 1)
        row_offsets = np.asarray(row_offsets, np.int64)
        parts = []
        for p in range(len(row_offsets) - 1):
            lo, hi = int(row_offsets[p]), int(row_offsets[p + 1])
            s, e = M.indptr[lo], M.indptr[hi]
            counts = np.diff(M.indptr[lo:hi + 1])
            lr = np.repeat(np.arange(hi - lo, dtype=np.int64), counts)
            parts.append((lr, M.indices[s:e].astype(np.int64), M.data[s:e]))
        return ShardedMatrix.from_local_parts(
            M.shape, parts, device=device, dtype=dtype,
            row_offsets=row_offsets, col_offsets=col_offsets,
            allow_bdia=allow_bdia, allow_bell=allow_bell)

    @staticmethod
    def from_local_parts(shape, parts, *, device, dtype=None,
                         row_offsets=None, col_offsets=None,
                         allow_bdia: bool = True, allow_bell: bool = True):
        """Assemble from per-part (local_rows, global_cols, vals) triples,
        unique per (row, col), in any order."""
        nrows, ncols = shape
        nparts = len(parts)
        require_single_part(nparts)
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
        row_offsets = np.asarray(row_offsets, np.int64)
        if col_offsets is None:
            col_offsets = (row_offsets if ncols == nrows
                           else row_decomposition(ncols, nparts))
        col_offsets = np.asarray(col_offsets, np.int64)
        if dtype is None:
            dtype = parts[0][2].dtype if parts[0][2].size else np.float64
            if np.issubdtype(dtype, np.integer):
                dtype = np.float64
        dtype = numpy_dtype(dtype)
        itemsize = dtype.itemsize

        row_counts = np.diff(row_offsets)
        row_pad = max(1, int(row_counts.max()))
        col_pad = max(1, int(np.diff(col_offsets).max()))
        diag_parts = []
        for lr, gc, v in parts:
            diag_parts.append((np.asarray(lr, np.int64),
                               np.asarray(gc, np.int64) - col_offsets[0],
                               np.asarray(v, dtype)))
        total_nnz = sum(dp[0].size for dp in diag_parts)

        kind, plan = choose_layout(diag_parts, row_pad, col_pad, itemsize,
                                   total_nnz, nparts, allow_bdia, allow_bell)
        fields = {}
        if kind != "ell":
            if kind == "bdia":
                fields = _bdia_fields(plan, row_pad, col_pad, dtype, device)
            else:
                fields = _bell_fields(diag_parts, plan[0], row_pad, col_pad,
                                      dtype, device)
            dvals = torch.zeros((nparts, row_pad, 1), dtype=torch_dtype(dtype),
                                device=device)
            dcols = torch.zeros((nparts, row_pad, 1), dtype=torch.int32,
                                device=device)
        else:
            kd = 1
            for p, (dlr, _, _) in enumerate(diag_parts):
                if dlr.size:
                    kd = max(kd, int(np.bincount(
                        dlr, minlength=int(row_counts[p])).max()))
            compacted = [_ell_compact(kd, *dp) for dp in diag_parts]
            idx = [c[0] for c in compacted]
            dvals = materialize(idx, [c[1] for c in compacted],
                                (row_pad, kd), dtype, device)
            dcols = materialize(idx, [c[2] for c in compacted],
                                (row_pad, kd), np.int32, device)

        # main diagonal: only where rows and columns share one partition
        # (square operators; a rectangular P or R has none)
        same_partition = np.array_equal(row_offsets, col_offsets)
        diag_main = np.zeros((nparts, row_pad), dtype)
        for p, (dlr, dlc, dv) in enumerate(diag_parts):
            diag_main[p, int(row_counts[p]):] = 1.0  # padded rows
            if same_partition and row_offsets[p] == col_offsets[p] \
                    and dlr.size:
                on_diag = dlc == dlr
                diag_main[p, dlr[on_diag]] += dv[on_diag]
        return ShardedMatrix(
            diag_vals=dvals, diag_cols=dcols,
            bdia_vals=fields.pop("bdia_vals", None),
            bdia_starts=fields.pop("bdia_starts", None),
            bell_vals=fields.pop("bell_vals", None),
            bell_ids=fields.pop("bell_ids", None),
            diag=to_tensor(diag_main, device),
            shape=(int(nrows), int(ncols)),
            row_offsets=tuple(int(o) for o in row_offsets),
            col_offsets=tuple(int(o) for o in col_offsets),
            row_pad=row_pad, col_pad=col_pad, nnz=int(total_nnz), **fields)

    @staticmethod
    def from_dia_parts(shape, offsets, dia_vals, offd_parts, *, device,
                       dtype=None, dia_shape=None,
                       dia_nnz: int | None = None) -> "ShardedMatrix":
        """Assemble from per-part box-DIA diag blocks (``tpusolve``'s
        ``from_dia_parts``): the stencil generator's and the structured
        multigrid's operators, whose diag block is pure box geometry.

        ``offsets``: one (dz, dy, dx) triple per plane, or flat offsets,
        which :func:`dia_triples` decomposes over ``dia_shape`` where that is
        unambiguous.  ``dia_vals``: (P, D, R) or (P, D, nz, ny, nx) numpy
        array or tensor, zeros where a neighbour leaves the box.
        ``dia_shape``: the (nz, ny, nx) box of a part's R rows; None is the
        1-D form.  ``offd_parts``: per part (local rows, global cols, vals)
        of the couplings that leave the part, empty on one part.  The main
        diagonal comes from the (0, 0, 0) plane.  The caller keeps its
        input: nothing is consumed (``tpusolve`` donates a device input)."""
        nrows, ncols = shape
        nparts, D = int(dia_vals.shape[0]), int(dia_vals.shape[1])
        require_single_part(nparts)
        if any(len(o[0]) for o in offd_parts):
            raise NotImplementedError(
                f"offd couplings: not ported yet; see {MULTIPART_ITEM}")
        R = int(np.prod(dia_vals.shape[2:]))
        if dia_shape is not None and int(np.prod(dia_shape)) != R:
            raise ValueError("dia_shape does not tile the row space")
        if nrows != ncols or nrows != R:
            raise ValueError(f"DIA block of {R} rows for shape {shape}")
        triples = dia_triples(offsets, dia_shape)
        if len(triples) != D:
            raise ValueError(f"{len(triples)} offsets for {D} planes")
        dims = tuple(int(d) for d in (dia_shape or (R,)))
        box = (1,) * (3 - len(dims)) + dims
        if dtype is None:
            dtype = dia_vals.dtype
        tdt = torch_dtype(numpy_dtype(dtype))
        if isinstance(dia_vals, torch.Tensor):
            vals = dia_vals.to(device=device, dtype=tdt)
        else:
            vals = to_tensor(dia_vals, device, numpy_dtype(dtype))
        vals = vals.reshape((nparts, D) + box).contiguous()
        if (0, 0, 0) in triples:
            diag = vals[:, triples.index((0, 0, 0))].reshape(nparts, R) \
                .clone()
        else:
            diag = torch.zeros((nparts, R), dtype=tdt, device=device)
        nnz = (int(dia_nnz) if dia_nnz is not None
               else int(torch.count_nonzero(vals)))
        zeros = torch.zeros((nparts, R, 1), dtype=tdt, device=device)
        return ShardedMatrix(
            diag_vals=zeros, diag_cols=zeros.to(torch.int32),
            bdia_vals=None, bdia_starts=None, bell_vals=None, bell_ids=None,
            diag=diag, shape=(R, R), row_offsets=(0, R), col_offsets=(0, R),
            row_pad=R, col_pad=R, nnz=nnz, dia_vals=vals,
            dia_offsets=triples,
            dia_shape=(None if dia_shape is None
                       else tuple(int(d) for d in dia_shape)))

    @staticmethod
    def from_arrays(arrays: dict, meta: dict, device) -> "ShardedMatrix":
        """Build the port's matrix from ``tpusolve``'s ShardedMatrix fields
        fetched as numpy (``arrays``: ``bdia_vals``, ``bdia_starts``,
        ``bdia_ovf_rows/cols/vals``, ``bell_vals``, ``bell_ids``,
        ``diag_vals``, ``diag_cols``, ``diag``; ``meta``: ``shape``,
        ``row_offsets``, ``col_offsets``, ``row_pad``, ``col_pad``, ``nnz``,
        ``bdia_block``, ``bdia_xpad``, ``bdia_xlen``, ``bell_nwin``,
        ``has_offd``, ``uses_dia``, ``dia_offsets``, ``dia_shape``), so
        that both packages can run on one identical layout.  A DIA operator
        (``arrays``' ``dia_vals``) goes through :meth:`from_dia_parts`, its
        flat offsets decomposed by :func:`dia_triples`, which raises where
        that is ambiguous.  The overflow list (the same entries) is converted
        to the port's CSR form.  A ``tpusolve`` XL operator (``arrays``'
        ``bdia_rowstart`` set) keeps its values and starts and runs the
        port's K5 on the port's own step plan (:func:`plan_xl`), where one
        fits a block's shared memory; ``tpusolve``'s TPU panel plan
        (``bdia_rowstart``, ``bdia_pxrows``, ``bdia_xrows``) is not used."""
        require_single_part(len(meta["row_offsets"]) - 1)
        if meta.get("has_offd"):
            raise NotImplementedError(
                f"from_arrays: offd layouts are not ported yet; see "
                f"{MULTIPART_ITEM}")
        if meta.get("uses_dia"):
            empty = np.zeros(0, np.int64)
            return ShardedMatrix.from_dia_parts(
                tuple(meta["shape"]), meta["dia_offsets"],
                arrays["dia_vals"], [(empty, empty, empty)], device=device,
                dia_shape=meta.get("dia_shape"), dia_nnz=meta["nnz"])
        row_pad, col_pad = int(meta["row_pad"]), int(meta["col_pad"])
        ovf = {}
        if arrays.get("bdia_ovf_rows") is not None:
            ovf = _ovf_fields([tuple(a[0] for a in (
                arrays["bdia_ovf_rows"], arrays["bdia_ovf_cols"],
                arrays["bdia_ovf_vals"]))], row_pad, col_pad,
                arrays["bdia_ovf_vals"].dtype, device)
        t = lambda k: (to_tensor(arrays[k], device)
                       if arrays.get(k) is not None else None)
        A = ShardedMatrix(
            diag_vals=t("diag_vals"), diag_cols=t("diag_cols"),
            bdia_vals=t("bdia_vals"), bdia_starts=t("bdia_starts"),
            bell_vals=t("bell_vals"), bell_ids=t("bell_ids"),
            diag=t("diag"), shape=tuple(int(s) for s in meta["shape"]),
            row_offsets=tuple(int(o) for o in meta["row_offsets"]),
            col_offsets=tuple(int(o) for o in meta["col_offsets"]),
            row_pad=row_pad, col_pad=col_pad,
            nnz=int(meta["nnz"]), bdia_block=meta.get("bdia_block"),
            bdia_xpad=meta.get("bdia_xpad"), bdia_xlen=meta.get("bdia_xlen"),
            bell_nwin=meta.get("bell_nwin"), **ovf)
        if A.uses_bdia:
            _check_windows(arrays["bdia_starts"], A.bdia_block, A.bdia_xlen)
            if arrays.get("bdia_rowstart") is not None:
                _, B, D, R = A.bdia_vals.shape
                itemsize = A.bdia_vals.element_size()
                k = 0 if A.bdia_ovf_ptr is None else int(
                    A.bdia_ovf_ptr[:, -1].sum())
                xl = plan_xl(arrays["bdia_starts"], R, A.bdia_xpad, itemsize,
                             bdia_bytes(B, D, R, k, itemsize))
                if xl is not None:
                    A = A._with_xl(xl[:3])
        return A

    # ------------------------------------------------------------------
    def to_scipy(self):
        """The global matrix as scipy CSR (tests and host use)."""
        import scipy.sparse as sp
        nr = self.row_offsets[1] - self.row_offsets[0]
        c0 = self.col_offsets[0]
        if self.uses_dia:
            lr, lc, vals = _dia_entries(self.dia_vals[0].cpu().numpy(),
                                        self.dia_offsets)
        elif self.uses_bell:
            bv = self.bell_vals[0].cpu().numpy()        # (G, K, 8, 128)
            bi = self.bell_ids[0].cpu().numpy()         # (G, K)
            g_i, k_i, r_i, c_i = np.nonzero(bv)
            lr = g_i * bell_mod.TM + r_i
            lc = bi[g_i, k_i].astype(np.int64) * bell_mod.TN + c_i
            vals = bv[g_i, k_i, r_i, c_i]
        elif self.uses_bdia:
            bv = self.bdia_vals[0].cpu().numpy()        # (B, D, R)
            bs = self.bdia_starts[0].cpu().numpy()      # (B, D)
            R = self.bdia_block
            b_i, d_i, r_i = np.nonzero(bv)
            lr = b_i * R + r_i
            lc = bs[b_i, d_i].astype(np.int64) - self.bdia_xpad + r_i
            vals = bv[b_i, d_i, r_i]
            if self.bdia_ovf_ptr is not None:
                ptr = self.bdia_ovf_ptr[0].cpu().numpy()
                k = int(ptr[-1])
                lr = np.concatenate([lr, np.repeat(np.arange(self.row_pad),
                                                   np.diff(ptr))])
                lc = np.concatenate([lc, self.bdia_ovf_cols[0, :k].cpu()
                                     .numpy()])
                vals = np.concatenate([vals, self.bdia_ovf_vals[0, :k].cpu()
                                       .numpy()])
        else:
            ev = self.diag_vals[0].cpu().numpy()
            ec = self.diag_cols[0].cpu().numpy()
            lr, k_idx = np.nonzero(ev)
            lc = ec[lr, k_idx].astype(np.int64)
            vals = ev[lr, k_idx]
        keep = lr < nr     # drop padding rows
        return sp.csr_matrix(
            (vals[keep], (self.row_offsets[0] + lr[keep], c0 + lc[keep])),
            shape=self.shape)

    def astype(self, dtype) -> "ShardedMatrix":
        """Value-dtype cast of the same operator (layout and index tensors
        shared).  Used for the mixed-precision f32 twin.  A BDIA operator
        chooses between K4 and K5 again (:func:`choose_xl`): whether a
        panel fits, and what it costs, depend on the item size."""
        dtype = torch_dtype(dtype)
        if self.dtype == dtype:
            return self
        cast = lambda a: a.to(dtype) if a is not None else None
        A = dataclasses.replace(
            self, diag_vals=cast(self.diag_vals),
            bdia_vals=cast(self.bdia_vals), bell_vals=cast(self.bell_vals),
            bdia_ovf_vals=cast(self.bdia_ovf_vals), diag=cast(self.diag),
            dia_vals=cast(self.dia_vals))
        if A.uses_bdia:
            P, B, D, R = A.bdia_vals.shape
            itemsize = A.bdia_vals.element_size()
            k = 0 if A.bdia_ovf_ptr is None else int(
                A.bdia_ovf_ptr[:, -1].sum())
            xl = choose_xl(A.bdia_starts.cpu().numpy(), R, A.bdia_xpad,
                           itemsize, bdia_bytes(P * B, D, R, k, itemsize))
            A = A._with_xl(xl)
        return A

    def _with_xl(self, xl) -> "ShardedMatrix":
        """The same operator run by K5 on step plan ``xl`` = (gb, step_lo,
        panel), or by K4 when ``xl`` is None."""
        if xl is None:
            return dataclasses.replace(self, bdia_gb=None, bdia_step_lo=None,
                                       bdia_panel=None)
        gb, step_lo, panel = xl
        return dataclasses.replace(
            self, bdia_gb=int(gb), bdia_step_lo=to_tensor(step_lo,
                                                          self.device),
            bdia_panel=int(panel))


def _decompose_offset(off: int, dims: tuple) -> tuple:
    """Mixed-radix decomposition of a flat offset into per-dim components of
    minimal magnitude: off = ((c0*dims[1] + c1)*dims[2] + c2)... for the
    stencil this recovers (dz, dy, dx).  (``tpusolve/matrix/spmv.py``,
    verbatim.)"""
    comps = []
    rem = off
    for d in reversed(dims[1:]):
        c = rem % d
        if c > d // 2:
            c -= d
        comps.append(c)
        rem = (rem - c) // d
    comps.append(rem)
    return tuple(reversed(comps))


def dia_triples(offsets, dia_shape=None) -> tuple:
    """The (dz, dy, dx) triple of each DIA plane.  Triples (or pairs, for a
    2-D ``dia_shape``) are taken as they are, padded with leading zeros.
    Flat offsets are decomposed over ``dia_shape`` (:func:`_decompose_offset`)
    or, without one, are the 1-D form (0, 0, offset).  Raises ``ValueError``
    where a flat offset does not name one triple: two flat offsets equal, or
    a component past the leading one of magnitude at least half its extent
    (on a 4-wide box, dx = 2 and dx = -2 share their flat offsets with
    other triples)."""
    offsets = list(offsets)
    if offsets and all(np.ndim(o) == 1 for o in offsets):
        return tuple((0,) * (3 - len(o)) + tuple(int(c) for c in o)
                     for o in offsets)
    flat = [int(o) for o in offsets]
    if len(set(flat)) != len(flat):
        raise ValueError("DIA offsets: two flat offsets are equal, so their "
                         "planes' triples cannot be told apart")
    if dia_shape is None:
        return tuple((0, 0, o) for o in flat)
    dims = tuple(int(d) for d in dia_shape)
    out = []
    for o in flat:
        comps = _decompose_offset(o, dims)
        for c, d in zip(comps[1:], dims[1:]):
            if 2 * abs(c) >= d:
                raise ValueError(
                    f"DIA offset {o} is ambiguous on the box {dims}: its "
                    f"component {c} reaches half the extent {d}")
        out.append((0,) * (3 - len(dims)) + comps)
    return tuple(out)


def _dia_entries(planes: np.ndarray, triples):
    """(rows, cols, vals) of the nonzero in-box entries of one part's DIA
    planes (D, nz, ny, nx)."""
    box = planes.shape[1:]
    idx = np.indices(box).reshape(3, -1)
    flat = np.arange(int(np.prod(box)))
    rows, cols, vals = [], [], []
    for k, t in enumerate(triples):
        tgt = idx + np.asarray(t)[:, None]
        v = planes[k].reshape(-1)
        ok = np.all((tgt >= 0) & (tgt < np.asarray(box)[:, None]), axis=0)
        ok &= v != 0
        rows.append(flat[ok])
        cols.append(flat[ok] + (t[0] * box[1] + t[1]) * box[2] + t[2])
        vals.append(v[ok])
    cat = lambda a, dt: np.concatenate(a) if a else np.zeros(0, dt)
    return cat(rows, np.int64), cat(cols, np.int64), cat(vals, planes.dtype)


def _check_windows(starts: np.ndarray, R: int, xlen: int) -> None:
    """Every BDIA window must lie inside the padded x, ``[0, xlen)``."""
    if starts.size and (int(starts.min()) < 0
                        or int(starts.max()) + R > xlen):
        raise ValueError(f"BDIA window outside [0, {xlen})")


def _bdia_staging(diag_parts, R, D, row_pad, col_pad):
    """Every part's BDIA staging at (R, D), :func:`kernels.bdia.compact`'s:
    ``(starts (P, B, D) int32 in the padded x, xpad, xlen, [flat indices],
    [values], [(overflow rows, cols, values)])``."""
    nparts = len(diag_parts)
    B = (row_pad + R - 1) // R
    starts_raw = np.zeros((nparts, B, D), np.int64)
    s_idx, s_val, ovf_parts = [], [], []
    for p, (dlr, dlc, dv) in enumerate(diag_parts):
        starts_raw[p], fi, vo, o_r, o_c, o_v = bdia_mod.compact(
            dlr, dlc, dv, row_pad, col_pad, R, D, dtype=dv.dtype,
            overflow=True)
        s_idx.append(fi)
        s_val.append(vo)
        ovf_parts.append((o_r, o_c, o_v))
    lo = int(min(0, starts_raw.min()))
    hi = int(max(col_pad, starts_raw.max() + R))
    xpad = -lo
    xlen = xpad + hi
    starts = (starts_raw + xpad).astype(np.int32)
    _check_windows(starts, R, xlen)
    return starts, xpad, xlen, s_idx, s_val, ovf_parts


def _bdia_fields(plan, row_pad, col_pad, dtype, device) -> dict:
    """BDIA tensors and metadata for :func:`choose_layout`'s plan."""
    R, D, _, staging, xl = plan
    starts, xpad, xlen, s_idx, s_val, ovf_parts = staging
    B = starts.shape[1]
    fields = dict(
        bdia_vals=materialize(s_idx, s_val, (B, D, R), dtype, device),
        bdia_starts=to_tensor(starts, device),
        bdia_block=R, bdia_xpad=xpad, bdia_xlen=xlen)
    fields.update(_ovf_fields(ovf_parts, row_pad, col_pad, dtype, device))
    if xl is not None:
        gb, step_lo, panel = xl
        fields.update(bdia_gb=int(gb), bdia_step_lo=to_tensor(step_lo, device),
                      bdia_panel=int(panel))
    return fields


def _bell_fields(diag_parts, bk, row_pad, col_pad, dtype, device) -> dict:
    """BELL tensors and metadata for K = ``bk`` tiles per group."""
    G = bell_mod._ngroups(row_pad)
    ids = np.zeros((len(diag_parts), G, bk), np.int32)
    b_idx, b_val = [], []
    for p, (dlr, dlc, dv) in enumerate(diag_parts):
        ids[p], fi, vo = bell_mod.bell_compact(dlr, dlc, dv, row_pad,
                                               col_pad, bk, dtype=dtype)
        b_idx.append(fi)
        b_val.append(vo)
    return dict(
        bell_vals=materialize(b_idx, b_val, (G, bk, bell_mod.TM, bell_mod.TN),
                              dtype, device),
        bell_ids=to_tensor(ids, device),
        bell_nwin=(col_pad + bell_mod.TN - 1) // bell_mod.TN)


def _ovf_fields(ovf_parts, row_pad, col_pad, dtype, device) -> dict:
    """Overflow-list tensors from per-part (rows, cols, vals): entries with
    row ``row_pad`` are padding and dropped; the rest are sorted by row
    (stable) under a CSR row pointer.  Empty dict when no part spills."""
    parts = []
    for o_r, o_c, o_v in ovf_parts:
        o_r = np.asarray(o_r, np.int64)
        keep = o_r < row_pad
        order = np.argsort(o_r[keep], kind="stable")
        parts.append((o_r[keep][order], np.asarray(o_c)[keep][order],
                      np.asarray(o_v)[keep][order]))
    k_ovf = max(o[0].size for o in parts)
    if k_ovf == 0:
        return {}
    nparts = len(parts)
    cols = np.zeros((nparts, k_ovf), np.int32)
    vals = np.zeros((nparts, k_ovf), dtype)
    ptr = np.zeros((nparts, row_pad + 1), np.int32)
    for p, (o_r, o_c, o_v) in enumerate(parts):
        if o_r.size and (o_r.min() < 0 or o_c.min() < 0
                         or o_c.max() >= col_pad):
            raise ValueError("overflow entry outside the part")
        cols[p, :o_c.size] = o_c
        vals[p, :o_v.size] = o_v
        ptr[p, 1:] = np.cumsum(np.bincount(o_r, minlength=row_pad))
    return dict(bdia_ovf_ptr=to_tensor(ptr, device),
                bdia_ovf_cols=to_tensor(cols, device),
                bdia_ovf_vals=to_tensor(vals, device))


def _ell_compact(k, lrows, lcols, vals):
    """Compact ELL staging: flat indices into a (row_pad, k) layout plus
    row-ordered values/columns (position = rank within row)."""
    if lrows.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, vals.dtype),
                np.zeros(0, np.int32))
    if np.all(lrows[:-1] <= lrows[1:]):      # already row-sorted
        lr = lrows
        vo, co = vals, lcols
    else:
        order = np.argsort(lrows, kind="stable")
        lr = lrows[order]
        vo, co = vals[order], lcols[order]
    nr = int(lr[-1]) + 1
    starts = np.searchsorted(lr, np.arange(nr + 1))
    pos = np.arange(lr.size) - starts[lr]
    return lr * k + pos, vo, co.astype(np.int32)
