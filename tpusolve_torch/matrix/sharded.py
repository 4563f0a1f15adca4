"""ShardedMatrix — the ParCSR-analog sparse matrix of the port (the port of
``tpusolve/matrix/sharded.py``).

HYPRE stores a distributed matrix as a 1-D row-block partition with a *diag*
block (owned columns) and an *offd* block (ghost columns) per rank (ref:
src/HypreSystem.cpp:552-636).  The port keeps ``tpusolve``'s stacked layout:
every tensor has a leading part axis of size ``nparts``, rows are padded per
part to ``row_pad``, padded vector entries are exact zeros and padded
diagonal entries are 1.  All parts live on one device.  Each part's entries
split into its *diag* block (the columns it owns) and its *offd* block (the
columns other parts own, ``tpusolve``'s ghosts): the offd block is
``tpusolve``'s padded ELL over the part's sorted ghost list
(``offd_vals``, ``offd_cols``), and its halo plan (``send_idx``,
``ghost_slot``) is kept as ``tpusolve`` builds it, beside the flat index of
x each ghost is read from (``halo_src``), by which the SpMV gathers every
part's ghosts at once (``matrix/spmv.py``).  Across R processes
(``dist.py``) each rank holds N / R consecutive parts of the N-part
operator, :meth:`ShardedMatrix.rank_slice` of it: the same arrays for its
parts, and a halo plan by peer rank (:class:`RankHalo`) in place of
``halo_src``; a box-DIA operator is built as that slice from the rank's
own planes and every part's couplings (:meth:`from_dia_parts`'s
``parts``), with no other part's planes anywhere.  The diag block takes
one of these layouts:

* **DIA** (box DIA, ``kernels/dia.py``), built by :meth:`from_dia_parts`
  (the stencil generator and the structured multigrid levels), by
  :meth:`from_arrays` and by the assembly's DIA-first candidacy: one plane
  of coefficients per (dz, dy, dx) triple over the part's (nz, ny, nx) box,
  run by K1.  The triples are kept, never turned back from flat offsets
  where that is ambiguous (:func:`dia_triples`); an assembled operator
  without a ``dia_shape`` is the 1-D form, triples (0, 0, offset).

The assembly from entries (:meth:`from_local_parts`) takes ``tpusolve``'s
decision order DIA -> BDIA -> BELL -> ELL:

* **DIA** first, where the diag block has at most ``DIA_MAX_OFFSETS``
  distinct offsets and fills at least ``DIA_MIN_FILL`` of its planes
  (``tpusolve``'s rule and constants), in the 1-D form;

* **BDIA** (blocked DIA, ``kernels/bdia.py``) with an overflow list of the
  entries that do not fit a block's slots, kept row-sorted with a CSR row
  pointer so that the kernel adds each row's spilled entries itself; for
  banded matrices with enough entries (file-loaded systems after RCM).  It
  runs K4, or K5 by panel steps (BDIA-XL) where a step plan fits a block's
  shared memory and the time model prices K5 strictly faster: K5 skips the
  32-row segments of a slot that hold no entry (the segment mask, built
  from the stored values on the operator's device), so it is priced on the
  bytes it reads;
* **BELL** (block ELL, ``kernels/bell.py``), run by K6;
* **ELL** otherwise, or where K2's modelled time is below both (from
  ``BDIA_MIN_NNZ`` entries up), run by K2 (``kernels/ell.py``) in one of two
  forms, whichever K2's model prices faster (:func:`ell_form`; padded
  where the two are within ``K2_FORM_TIE``): padded
  (every row padded to a fixed width; padding entries carry value 0 and
  column 0) or row-pointer (the entries alone, in the padded slot order,
  under a CSR row pointer).

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
from tpusolve_torch.kernels import ell as ell_mod
from tpusolve_torch.matrix import coo as coo_mod
from tpusolve_torch.matrix.build import materialize
from tpusolve_torch.matrix.vectors import to_tensor, torch_dtype, numpy_dtype
from tpusolve_torch.parts import row_decomposition

# DIA is used when the diag block has at most this many distinct offsets...
DIA_MAX_OFFSETS = 96
# ...and the dense-diagonal storage is at least this full of real entries
# (tpusolve/matrix/sharded.py:54-56)
DIA_MIN_FILL = 0.2

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
# and K2 (ELL), priced by its own model (ell_model_s: a launch's floor, then
# the longer of its bytes at its rate and its longest lane's rounds of
# dependent loads) with its own constants by storage form and item size
# (kernels/ell.py:K2_MODEL, from `calibrate --k2`):
SPMV_MODEL = {"bdia": (2.922e12, 24_848), "bell": (3.164e12, 80_511),
              "ell": ell_mod.K2_MODEL}
# K4 against K5 on a BDIA layout (band_model_s): each kernel's rate by item
# size, on one banded operator with an overflow list like the RCM-ordered
# ILU factors', in one full round of blocks (K5's bytes count its panels
# and only the segments its mask keeps; K5's rates from the redesigned
# kernel's device time):
BAND_RATE = {("bdia", 4): 2.530e12, ("bdia", 8): 2.542e12,
             ("bdia_xl", 4): 2.681e12, ("bdia_xl", 8): 2.542e12}


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


def skipped_bytes(nparts: int, B: int, D: int, R: int, itemsize: int,
                  live: int | None) -> int:
    """Bytes of a BDIA layout's values that K5 does not read: those of the
    32-row segments its mask clears, where ``live`` of the layout's
    segments are set (None: all)."""
    if live is None:
        return 0
    return ((nparts * B * D * (R // bdia_mod.SEG_ROWS) - live)
            * bdia_mod.SEG_ROWS * itemsize)


def plan_xl(starts: np.ndarray, R: int, xpad: int, itemsize: int,
            nbytes: int, live: int | None = None, work=None, cols: int = 1):
    """``(gb, step_lo, panel, step_b0, stage, seconds)`` of K5's cheapest
    step plan (``kernels/bdia.py:plan_steps``, steps of balanced ``work``
    where it is given: :meth:`ShardedMatrix.xl_work`) on a BDIA layout with
    padded-x window ``starts`` (P, B, D) that streams ``nbytes``
    (:func:`bdia_bytes`), ``live`` of its 32-row segments set in its mask
    (None: all), priced by :func:`band_model_s` on the bytes K5 reads:
    ``nbytes`` less the segments the mask skips (:func:`skipped_bytes`),
    plus every step's x panel; None when no plan fits one block's shared
    memory.  ``cols``: the plan of K5's k-column form
    (``kernels/bdia.py:plan_steps``), priced on the x panels it stages
    (one column's span, or the cover of each step's windows,
    ``kernels/bdia.py:step_cover``, once a column)."""
    nparts, B, D = starts.shape
    reads = nbytes - skipped_bytes(nparts, B, D, R, itemsize, live)

    def price(gb, nsteps, panel, smem):
        return band_model_s(
            "bdia_xl", itemsize,
            reads + cols * nparts * nsteps * panel * itemsize,
            nparts * nsteps, xl_resident(
                smem, bdia_mod.xl_threads(gb, R, itemsize, cols)))

    plan = bdia_mod.plan_steps(starts, R, xpad, itemsize, price, work,
                               cols)
    if plan is None:
        return None
    gb, step_lo, panel = plan[:3]
    return (*plan, price(gb, step_lo.shape[1], panel, bdia_mod.xl_smem_bytes(
        panel, gb, D, itemsize, R, plan[4], cols)))


def xl_work(mask: torch.Tensor, ovf_ptr, R: int, row_pad: int,
            itemsize: int) -> tuple:
    """``(block_bytes, block_ovf)``, numpy (P, B) each, of a BDIA layout
    with segment mask ``mask`` and overflow row pointer ``ovf_ptr`` (or
    None): the bytes of the values K5 reads for each R-row block (those of
    the segments its mask keeps) and its rows' overflow entries; what
    ``kernels/bdia.py:plan_steps`` balances steps by."""
    P, B = mask.shape[:2]
    bits = torch.arange(8, dtype=torch.uint8, device=mask.device)
    live = ((mask.unsqueeze(-1) >> bits) & 1).sum(
        dim=(2, 3, 4)).cpu().numpy().astype(np.int64)
    ovf = np.zeros((P, B), np.int64)
    if ovf_ptr is not None:
        rows = np.minimum(np.arange(B + 1) * R, row_pad)
        ptr = ovf_ptr.cpu().numpy().astype(np.int64)[:, rows]
        ovf = ptr[:, 1:] - ptr[:, :-1]
    return live * bdia_mod.SEG_ROWS * itemsize, ovf


def choose_xl(starts: np.ndarray, R: int, xpad: int, itemsize: int,
              nbytes: int, live: int | None = None, work=None):
    """K5's step plan ``(gb, step_lo, panel, step_b0, stage)`` for a BDIA
    layout where it is eligible and its modelled time (:func:`plan_xl`, on
    the bytes it reads) is strictly below K4's on the same layout
    (:func:`k4_model_s`, every slot value), else None (K4)."""
    nparts, B, D = starts.shape
    t4 = k4_model_s(itemsize, nbytes, nparts, B, D, R)
    xl = plan_xl(starts, R, xpad, itemsize, nbytes, live, work)
    return xl[:5] if xl is not None and xl[5] < t4 else None


def _spill_counts(diag_parts, row_pad: int, col_pad: int, R: int,
                  profiles: dict | None = None) -> np.ndarray:
    """``ovf`` with ``ovf[D]`` the entries a BDIA layout of R-row blocks
    and D slots spills to its overflow list, summed over the parts
    (``kernels/bdia.py:plan_fill_profile``; empty when the parts hold no
    entry).  ``profiles``, where given, keeps it by R: the port's plan and
    the record of ``tpusolve``'s (:func:`tpusolve_layout`) share it, and
    :func:`_bell_k`'s count beside it."""
    if profiles is not None and R in profiles:
        return profiles[R]
    profs = [bdia_mod.plan_fill_profile(dp[0], dp[1], row_pad, col_pad, R)
             for dp in diag_parts]
    Dfull = max((len(pr) for pr in profs), default=0)
    rank_totals = np.zeros(Dfull, np.int64)
    for pr in profs:
        rank_totals[:len(pr)] += pr
    ovf = (np.concatenate([np.cumsum(rank_totals[::-1])[::-1], [0]])
           if Dfull else np.zeros(0, np.int64))
    if profiles is not None:
        profiles[R] = ovf
    return ovf


def plan_bdia(diag_parts, row_pad: int, col_pad: int, itemsize: int,
              total_nnz: int, nparts: int = 1, profiles: dict | None = None):
    """``(R, D, bytes)`` of the (R, D) pair of least :func:`bdia_bytes`, or
    None when no layout fits the memory cap with an overflow list of at
    most ``max(4096, total_nnz // 8)`` entries (the overflow must stay a
    correction, not a layout).  ``profiles``: :func:`_spill_counts`'."""
    budget = tile_budget(total_nnz, itemsize)
    best, best_bytes = None, None
    for R in bdia_mod.BLOCK_SIZES:
        ovf = _spill_counts(diag_parts, row_pad, col_pad, R, profiles)
        Dfull = ovf.size - 1
        if Dfull <= 0:
            continue
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


# tpusolve's own choice between BDIA, BELL and ELL
# (tpusolve/matrix/sharded.py:335-423), copied to record the layout class
# tpusolve gives an operator (ShardedMatrix.tpusolve_layout), which decides
# where tpusolve factors ILU(0) and sets AMG levels up; it never chooses the
# port's layout.  Its constants are the v5e's that its CPU runs assume
# (tpusolve/runtime.py:device_profile): the HBM rate, the BDIA kernels'
# per-slot issue costs and the overflow's per-entry cost
# (tpusolve/kernels/bdia.py:55-131), and the VMEM budget that a BDIA plan's
# x (whole or a panel) and double-buffered values must fit
# (tpusolve/matrix/sharded.py:70, :374-398).
TPU_HBM_BPS = 819.0e9
TPU_BELL_SHARE = 0.67          # of the HBM rate that its BELL kernel streams
TPU_OVF_S = 25.0e-9            # an overflow entry's gather and scatter-add
TPU_VMEM_BUDGET = 13 << 20
TPU_LANE = 128
TPU_STEP_BLOCKS = 8
TPU_UNROLL_MAX = 64


def _tpu_slot_s(D: int, R: int) -> float:
    """``tpusolve``'s per-slot issue seconds of its BDIA kernels
    (``tpusolve/kernels/bdia.py:_per_slot_ns``)."""
    if D <= TPU_UNROLL_MAX:
        return (4.0 + R / 128.0) * 1e-9
    return (40.0 + 12.0 * R / 128.0) * 1e-9


def tpusolve_layout(diag_parts, row_pad: int, col_pad: int, itemsize: int,
                    total_nnz: int, nparts: int = 1, allow_bdia: bool = True,
                    allow_bell: bool = True,
                    profiles: dict | None = None) -> str:
    """``"bdia"``, ``"bell"`` or ``"ell"``: the layout ``tpusolve``'s
    ``from_local_parts`` gives a diag block that is not DIA, on the CPU
    (f64 keeps BDIA and BELL there).  BDIA and BELL by its modelled
    seconds, BDIA on a tie; a BDIA plan must fit the VMEM budget with its
    whole x or, banded, an x panel a step; ELL below ``BDIA_MIN_NNZ`` or
    when neither fits.  ``profiles``: :func:`_spill_counts`'."""
    if total_nnz < BDIA_MIN_NNZ:
        return "ell"
    budget = tile_budget(total_nnz, itemsize)
    bell_t = bdia_t = float("inf")
    if allow_bell:
        bk = _bell_k(diag_parts, row_pad, profiles)
        tile_bytes = (nparts * bell_mod._ngroups(row_pad) * bk * bell_mod.TM
                      * bell_mod.TN * itemsize)
        if bk > 0 and tile_bytes <= budget:
            bell_t = 1.125 * tile_bytes / (TPU_BELL_SHARE * TPU_HBM_BPS
                                           * nparts)
    if allow_bdia:
        d_min = min([0] + [int((dc - dr).min()) for dr, dc, _ in diag_parts
                           if dr.size])
        d_max = max([0] + [int((dc - dr).max()) for dr, dc, _ in diag_parts
                           if dr.size])
        gb = TPU_STEP_BLOCKS
        for R in bdia_mod.BLOCK_SIZES:
            ovf = _spill_counts(diag_parts, row_pad, col_pad, R, profiles)
            B = (row_pad + R - 1) // R
            rr = R // TPU_LANE
            xlen = max(col_pad, row_pad + d_max + R) - d_min
            for D in range(1, ovf.size):
                if nparts * B * D * R * itemsize > budget:
                    break
                k = int(ovf[D])
                if k > max(4096, total_nnz // 8):
                    continue
                stream = 2 * gb * D * R * itemsize
                issue = B * D * _tpu_slot_s(D, R)
                if xlen * itemsize + stream <= TPU_VMEM_BUDGET:
                    t = max(2.0 * B * D * R * itemsize / TPU_HBM_BPS, issue)
                else:
                    span = (d_max - d_min + gb * R) // TPU_LANE + rr + 2
                    pxrows = max(8, 1 << max(0, span - 1).bit_length())
                    if 2 * pxrows * TPU_LANE * itemsize + stream \
                            > TPU_VMEM_BUDGET:
                        continue
                    nsteps = (B + gb - 1) // gb
                    t = max((B * D * R + nsteps * pxrows * TPU_LANE)
                            * itemsize / TPU_HBM_BPS, issue)
                bdia_t = min(bdia_t, t + k * TPU_OVF_S)
    if bdia_t <= bell_t and bdia_t < float("inf"):
        return "bdia"
    return "bell" if bell_t < float("inf") else "ell"


def _bell_k(diag_parts, row_pad: int, profiles: dict | None = None) -> int:
    """The BELL tile count K a group needs (``kernels/bell.py:
    bell_plan_k``, the largest over the parts), kept in ``profiles`` under
    ``"bell"`` where given, as :func:`_spill_counts` keeps its counts."""
    if profiles is not None and "bell" in profiles:
        return profiles["bell"]
    bk = max((bell_mod.bell_plan_k(dp[0], dp[1], row_pad)
              for dp in diag_parts), default=0)
    if profiles is not None:
        profiles["bell"] = bk
    return bk


def plan_bell(diag_parts, row_pad: int, itemsize: int, total_nnz: int,
              nparts: int = 1, profiles: dict | None = None):
    """``(K, bytes)`` of the BELL layout (K tiles per 8-row group; bytes of
    its tiles and window ids), or None when its tiles do not fit the memory
    cap.  ``profiles``: :func:`_bell_k`'s."""
    bk = _bell_k(diag_parts, row_pad, profiles)
    G = bell_mod._ngroups(row_pad)
    tile_bytes = nparts * G * bk * bell_mod.TM * bell_mod.TN * itemsize
    if bk <= 0 or tile_bytes > tile_budget(total_nnz, itemsize):
        return None
    return bk, tile_bytes + nparts * G * bk * 4


def ell_model_s(form: str, rows: int, ncols: int, K: int, nnz: int,
                itemsize: int, width: int | None = None) -> float:
    """Modelled seconds of one K2 launch in ``form`` (``kernels/ell.py``
    ``FORMS``) on ``rows`` rows padded to ``K`` slots, at most ``width``
    entries a row (``K`` unless given), ``nnz`` in all, over an x of
    ``ncols``: with ``K2_MODEL``'s (rate, floor, round), the floor plus the
    longer of :func:`~tpusolve_torch.kernels.ell.ell_bytes` at the rate and
    ``ell_stages`` rounds.  A launch on a few hundred rows takes about the
    floor in either form, however many bytes it moves: its lanes' loads are
    in flight at once.  Past the floor, a row-pointer launch that waits on
    its loads pays one more round than the padded one, for the row
    pointer."""
    rate, floor, round_s = SPMV_MODEL["ell"][form][itemsize]
    return floor + max(
        ell_mod.ell_bytes(form, rows, ncols, K, nnz, itemsize) / rate,
        ell_mod.ell_stages(form, rows, K, nnz, width) * round_s)


def ell_form(rows: int, ncols: int, K: int, nnz: int, itemsize: int,
             width: int | None = None) -> tuple:
    """``(form, seconds)``: the storage form in which K2 runs an ELL
    operator of ``rows`` rows padded to ``K`` slots (at most ``width``
    entries a row, ``K`` unless given), ``nnz`` entries and ``ncols``
    columns fastest by :func:`ell_model_s`: the row-pointer form where it
    is priced below the padded form by more than ``K2_FORM_TIE``, else
    padded (``tpusolve``'s form) as on a tie.  Every site that makes an ELL
    operator stores it in this form, and only in it."""
    t = {form: ell_model_s(form, rows, ncols, K, nnz, itemsize, width)
         for form in ell_mod.FORMS}
    form = ("rowptr" if t["rowptr"] * (1 + ell_mod.K2_FORM_TIE)
            < t["padded"] else "padded")
    return form, t[form]


def row_counts_max(diag_parts, row_counts) -> int:
    """The largest count of entries a row of the parts has (at least 1):
    the padded ELL width."""
    kd = 1
    for p, (dlr, _, _) in enumerate(diag_parts):
        if dlr.size:
            kd = max(kd, int(np.bincount(
                dlr, minlength=int(row_counts[p])).max()))
    return kd


def choose_layout(diag_parts, row_pad: int, col_pad: int, itemsize: int,
                  total_nnz: int, nparts: int = 1, allow_bdia: bool = True,
                  allow_bell: bool = True, allow_ell: bool = True,
                  profiles: dict | None = None):
    """``("bdia", (R, D, bytes, staging))``, ``("bell", (K, bytes))``
    or ``("ell", over)`` for a diag block: BDIA, BELL or ELL by modelled
    time (:func:`spmv_model_s` with ``SPMV_MODEL``, ELL by
    :func:`ell_form`'s cheaper form), BDIA on a tie and ELL only where
    strictly faster; ELL below ``BDIA_MIN_NNZ`` or when neither BDIA nor
    BELL fits (``tpusolve``'s order, caps and tie rule).  With
    ``allow_ell=False`` ELL is only that fallback, as in ``tpusolve``.
    BDIA's (R, D) is :func:`plan_bdia`'s and ``staging``
    :func:`_bdia_staging`'s at (R, D); whether K4 or K5 runs it is decided
    on the assembled values (:meth:`ShardedMatrix.with_kernel`).  ``over``
    is the layout
    this choice takes with ``allow_ell=False`` where K2 was priced below it,
    ``"bdia"`` or ``"bell"``; None where ELL is that choice too.  It is the
    port's: :func:`tpusolve_layout` records ``tpusolve``'s.  ``profiles``:
    :func:`_spill_counts`'."""
    if total_nnz < BDIA_MIN_NNZ:
        return "ell", None
    best = ("ell", None, float("inf"))
    if allow_bdia:
        plan = plan_bdia(diag_parts, row_pad, col_pad, itemsize, total_nnz,
                         nparts, profiles)
        if plan is not None:
            R, D, nbytes = plan
            t = spmv_model_s(SPMV_MODEL["bdia"], nbytes, nparts * bdia_threads(
                (row_pad + R - 1) // R, R))
            best = ("bdia", (R, D, nbytes), t)
    if allow_bell:
        plan = plan_bell(diag_parts, row_pad, itemsize, total_nnz, nparts,
                         profiles)
        if plan is not None:
            t = spmv_model_s(SPMV_MODEL["bell"], plan[1], nparts * bell_threads(
                bell_mod._ngroups(row_pad), plan[0]))
            if t < best[2]:
                best = ("bell", plan, t)
    if allow_ell and best[0] != "ell":
        K = row_counts_max(diag_parts, [row_pad] * len(diag_parts))
        t = nparts * ell_form(row_pad, col_pad, K, total_nnz // nparts,
                              itemsize)[1]
        if t < best[2]:
            best = ("ell", best[0], t)
    if best[0] == "bdia":
        R, D, nbytes = best[1]
        staging = _bdia_staging(diag_parts, R, D, row_pad, col_pad)
        return "bdia", (R, D, nbytes, staging)
    return best[:2]


@dataclass(frozen=True)
class ShardedMatrix:
    # --- device data (leading axis = part) ---
    diag_vals: torch.Tensor   # (P, row_pad, Kd) padded-ELL values (1 wide
    diag_cols: torch.Tensor   # and zero in other layouts); int32 columns
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
    # --- BDIA segment mask (kernels/bdia.py:segment_mask): (P, B, D, W)
    # uint8, bit q set where rows 32q ... 32q + 31 of the slot hold a value
    bdia_mask: torch.Tensor | None = None
    # --- BDIA-XL step plan (K5, kernels/bdia.py:plan_steps); None -> K4
    bdia_gb: int | None = None                  # R-row blocks per step, most
    bdia_step_lo: torch.Tensor | None = None    # (P, nsteps) int32
    bdia_panel: int | None = None               # panel length, elements
    bdia_step_b0: torch.Tensor | None = None    # (P, nsteps + 1) int32
    bdia_stage: int | None = None               # overflow entries staged
    # K5's launch arguments, checked once (kernels/bdia.py:xl_operator), on
    # a CUDA device
    bdia_xl_op: bdia_mod.XLOperator | None = None
    # --- box DIA (K1, kernels/dia.py); None -> another layout
    dia_vals: torch.Tensor | None = None   # (P, D, nz, ny, nx) planes
    dia_offsets: tuple | None = None       # D (dz, dy, dx) triples
    dia_shape: tuple | None = None         # declared (nz, ny, nx); None: 1-D
    # --- row-pointer ELL (K2's other form); None -> padded or another
    # layout.  Part p's row i holds entries [rowptr[p, i], rowptr[p, i+1])
    # of ell_vals[p], ell_cols[p], in the padded form's slot order
    ell_rowptr: torch.Tensor | None = None  # (P, row_pad + 1) int32 / int64
    ell_vals: torch.Tensor | None = None    # (P, nnz)
    ell_cols: torch.Tensor | None = None    # (P, nnz) int32 local columns
    # the largest count of entries a row has: on either ELL form, and on
    # BDIA and BELL built from entries (ILU reads it where tpusolve stores
    # such an operator ELL); None where it is not known
    row_width: int | None = None
    # the layout class tpusolve gives this operator ("dia", "bdia", "bell"
    # or "ell"; tpusolve_layout), which may differ from the port's; None
    # where it is not known
    tpusolve_layout: str | None = None
    # --- offd block (tpusolve/matrix/sharded.py:916-998): part p's
    # couplings to columns other parts own, padded ELL over its sorted
    # ghost list, a padded slot value 0 and ghost slot 0; and the halo plan.
    # None on an operator whose parts own all their columns' entries
    offd_vals: torch.Tensor | None = None   # (P, row_pad, Ko)
    offd_cols: torch.Tensor | None = None   # (P, row_pad, Ko) int32 slots
    send_idx: torch.Tensor | None = None    # (P, P, S) int32: local x
    #   indices part p sends part q, in q's ghost order
    ghost_slot: torch.Tensor | None = None  # (P, G) int32: owner * S + slot
    halo_src: torch.Tensor | None = None    # (P * G,) int64: the index of
    #   the padded x each ghost is read from, owner * col_pad + send_idx
    has_offd: bool = False    # on a rank's slice: whether any part has one
    # --- a rank's slice (rank_slice): parts [part_lo, part_lo + nparts) of
    # the operator over every part, whose (row, col) offsets ``all_offsets``
    # holds; None on an operator over every part
    part_lo: int = 0
    all_offsets: tuple | None = None
    rank_halo: "RankHalo | None" = None  # the slice's halo plan by rank
    # the whole operator's K2 form on the offd block and what it is priced
    # on over every part (rows, ghost columns, K, row-pointer entries,
    # widest row; ``_offd_price``: a cast slice prices its form again), and
    # the widths the row-pointer forms (diag, offd) take in their plain
    # versions, so that a slice computes its rows' bits as the whole
    # operator does
    offd_form: str | None = None
    offd_price: tuple | None = None
    plain_widths: tuple = (None, None)

    @property
    def nparts(self) -> int:
        """The parts this operator holds (a rank's slice: its own)."""
        return len(self.row_offsets) - 1

    @property
    def all_row_offsets(self) -> tuple:
        """The row offsets of every part, on a rank's slice too."""
        return self.row_offsets if self.all_offsets is None \
            else self.all_offsets[0]

    @property
    def all_col_offsets(self) -> tuple:
        return self.col_offsets if self.all_offsets is None \
            else self.all_offsets[1]

    @property
    def all_nparts(self) -> int:
        """The parts of the whole operator (``tpusolve``'s mesh size)."""
        return len(self.all_row_offsets) - 1

    @property
    def is_slice(self) -> bool:
        return self.all_offsets is not None

    @property
    def priced_over(self) -> str | None:
        """The layout ``tpusolve`` takes (``"bdia"`` or ``"bell"``) where
        the port stores ELL, K2 priced below it; None where ``tpusolve``'s
        is ELL too or the operator is in another layout."""
        if self.uses_ell and self.tpusolve_layout in ("bdia", "bell"):
            return self.tpusolve_layout
        return None

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
    def uses_ell(self) -> bool:
        """An ELL layout, run by K2: padded (``diag_vals``/``diag_cols``
        hold the operator) or row-pointer (:attr:`uses_ell_rowptr`); no
        other layout's arrays are set."""
        return not (self.uses_dia or self.uses_bdia or self.uses_bell)

    @property
    def uses_ell_rowptr(self) -> bool:
        """The row-pointer ELL form (``ell_rowptr``, ``ell_vals``,
        ``ell_cols``)."""
        return self.ell_rowptr is not None

    def _cached(self, key: str, make):
        """``make()``, computed once for this operator (the K2 launch
        arrays below: an ``astype`` or ``replace`` makes a new operator and
        computes them again)."""
        cache = self.__dict__.setdefault("_k2_cache", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    @property
    def ell_arrays(self) -> tuple:
        """``(vals, cols, rowptr)`` of an ELL operator's diag block over
        all its parts, as ``kernels.ell.ell_spmv`` takes them (one K2
        launch): the padded (rows, K) arrays and None, or the row-pointer
        form's.  On more than one part the rows of the parts follow each
        other (P * row_pad of them) and part p's columns are rebased by p *
        col_pad into the stacked x; the stored per-part arrays stay as
        ``tpusolve`` lays them out."""
        if self.nparts == 1:
            if self.uses_ell_rowptr:
                return self.ell_vals[0], self.ell_cols[0], self.ell_rowptr[0]
            return self.diag_vals[0], self.diag_cols[0], None
        if self.uses_ell_rowptr:
            return self._cached("ell", lambda: _flat_rowptr(
                self.ell_rowptr, self.ell_vals, self.ell_cols, self.col_pad))
        return self._cached("ell", lambda: _flat_padded(
            self.diag_vals, self.diag_cols, self.col_pad))

    @property
    def offd_k2(self) -> tuple:
        """``(vals, cols, rowptr)`` of the offd block of all parts as one
        K2 launch: P * row_pad rows over the stacked ghosts (P * G of them,
        part p's ghost slots rebased by p * G), in the form K2's model
        prices cheaper (:func:`ell_form`; the row-pointer form keeps a
        row's entries up to its last, so the shell rows of a stencil part
        are all it reads)."""
        def make():
            G = self.ghost_slot.shape[1]
            rp = offd_rowptr(self.offd_vals, self.offd_cols, G)
            form = self.offd_form or _offd_form(
                self._offd_price(rp), self.offd_vals.element_size())
            if form == "padded":
                return _flat_padded(self.offd_vals, self.offd_cols, G)
            rowptr, rv, rc = rp
            return rv, rc, rowptr
        return self._cached("offd", make)

    def _offd_price(self, rp=None) -> tuple:
        """``(rows, ghost columns, K, entries, widest row)`` of the offd
        block of every part in K2's row-pointer form (``rp``, that form of
        this operator's block, where the caller has it), which
        :func:`ell_form` prices: a slice's ``offd_price``, else this
        operator's own."""
        if self.offd_price is not None:
            return self.offd_price
        G = self.ghost_slot.shape[1]
        rowptr, rv, _ = rp or offd_rowptr(self.offd_vals, self.offd_cols, G)
        P, R, K = self.offd_vals.shape
        return (P * R, P * G, K, rv.numel(),
                max(1, int((rowptr[1:] - rowptr[:-1]).max())))

    @property
    def bdia_ovf(self):
        """(ptr, cols, vals) of the overflow list, as ``bdia_spmv`` takes
        it, or None."""
        if self.bdia_ovf_ptr is None:
            return None
        return self.bdia_ovf_ptr, self.bdia_ovf_cols, self.bdia_ovf_vals

    @property
    def layout(self) -> str:
        """One line naming the layout, for logs: the diag block's, and on
        an operator with an offd block, K2's form on it."""
        line = self._diag_layout
        if self.has_offd:
            vals, _, rowptr = self.offd_k2
            kind = (f"ELL K={vals.shape[-1]}" if rowptr is None
                    else f"ELL-RP nnz={vals.numel()}")
            line += (f"; offd {kind} ghosts="
                     f"{self.ghost_slot.shape[1]} x {self.nparts} parts")
        return line

    @property
    def _diag_layout(self) -> str:
        if self.uses_dia:
            box = "x".join(str(d) for d in self.dia_vals.shape[2:])
            return f"DIA D={self.dia_vals.shape[1]} box={box}"
        if self.uses_bell:
            _, G, K = self.bell_ids.shape
            return f"BELL K={K} G={G}"
        if self.uses_ell_rowptr:
            return f"ELL-RP nnz={self.nnz} W={self.row_width}"
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

    @property
    def bdia_live(self) -> int | None:
        """The 32-row segments set in a BDIA operator's mask (K5 reads
        those), or None."""
        if self.bdia_mask is None:
            return None
        return bdia_mod.live_segments(self.bdia_mask)

    # ------------------------------------------------------------------
    @staticmethod
    def from_coo(shape, rows, cols, vals, *, device, dtype=None,
                 dedup="add", row_offsets=None, col_offsets=None,
                 nparts: int = 1, allow_dia: bool = True,
                 allow_bdia: bool = True, allow_bell: bool = True,
                 allow_ell: bool = True):
        """Assemble a global COO (any order, duplicates combined per
        ``dedup``) — the IJ ``SetValues/AddToValues + Assemble`` pipeline
        (ref: src/HypreSystem.cpp:600-636, 897-955) — over ``nparts``
        parts (``tpusolve``'s mesh size) unless ``row_offsets`` name
        them."""
        nrows, ncols = shape
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
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
            allow_dia=allow_dia, allow_bdia=allow_bdia,
            allow_bell=allow_bell, allow_ell=allow_ell)

    @staticmethod
    def from_csr_host(M, *, device, dtype=None, row_offsets=None,
                      col_offsets=None, nparts: int = 1,
                      allow_dia: bool = True, allow_bdia: bool = True,
                      allow_bell: bool = True, allow_ell: bool = True):
        """Assemble a host CSR directly: row blocks are contiguous indptr
        slices, already row-sorted, so no global COO sort (the AMG setup's
        P, R and Galerkin coarse operators arrive as CSR); over ``nparts``
        parts unless ``row_offsets`` name them."""
        M = M.tocsr()
        nrows = M.shape[0]
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
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
            allow_dia=allow_dia, allow_bdia=allow_bdia,
            allow_bell=allow_bell, allow_ell=allow_ell)

    @staticmethod
    def from_local_parts(shape, parts, *, device, dtype=None,
                         row_offsets=None, col_offsets=None,
                         allow_dia: bool = True, allow_bdia: bool = True,
                         allow_bell: bool = True, allow_ell: bool = True):
        """Assemble from per-part (local_rows, global_cols, vals) triples,
        unique per (row, col), in any order.  Each part's entries in columns
        it owns (``col_offsets``) form its diag block, the rest its offd
        block (:func:`_offd_fields`).  ``allow_*`` take a layout of the
        diag block out of the choice (:func:`choose_layout`); ELL stays the
        fallback."""
        nrows, ncols = shape
        nparts = len(parts)
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
        diag_parts, offd_parts = [], []
        for p, (lr, gc, v) in enumerate(parts):
            lr = np.asarray(lr, np.int64)
            gc = np.asarray(gc, np.int64)
            v = np.asarray(v, dtype)
            lo, hi = col_offsets[p], col_offsets[p + 1]
            own = (gc >= lo) & (gc < hi)
            if own.all():
                diag_parts.append((lr, gc - lo, v))
                offd_parts.append((lr[:0], gc[:0], v[:0]))
            else:
                diag_parts.append((lr[own], gc[own] - lo, v[own]))
                offd_parts.append((lr[~own], gc[~own], v[~own]))
        total_nnz = sum(dp[0].size for dp in diag_parts)

        same_partition = np.array_equal(row_offsets, col_offsets)
        if allow_dia and same_partition:
            union = _dia_candidate(diag_parts, row_pad, total_nnz)
            if union is not None:
                empty = np.zeros(0, np.int64)
                vals = materialize(
                    [np.searchsorted(union, dlc - dlr) * row_pad + dlr
                     for dlr, dlc, _ in diag_parts],
                    [dv for _, _, dv in diag_parts],
                    (union.size, row_pad), dtype, device)
                return ShardedMatrix.from_dia_parts(
                    shape, [int(o) for o in union], vals, offd_parts,
                    device=device, dtype=dtype, dia_nnz=total_nnz,
                    row_offsets=row_offsets, col_offsets=col_offsets)

        # f64 keeps BDIA and BELL: tpusolve turns them off for 8-byte
        # values off the CPU (tpusolve/matrix/sharded.py:326-328), a TPU
        # restriction (XLA's f64 emulation cannot rewrite its Pallas calls)
        # that K4, K5 and K6 do not have
        profiles = {}
        kind, plan = choose_layout(diag_parts, row_pad, col_pad, itemsize,
                                   total_nnz, nparts, allow_bdia, allow_bell,
                                   allow_ell, profiles)
        kd = row_counts_max(diag_parts, row_counts)
        fields = {"tpusolve_layout": tpusolve_layout(
            diag_parts, row_pad, col_pad, itemsize, total_nnz, nparts,
            allow_bdia, allow_bell, profiles), "row_width": kd}
        if kind != "ell":
            if kind == "bdia":
                fields.update(_bdia_fields(plan, row_pad, col_pad, dtype,
                                           device))
            else:
                fields.update(_bell_fields(diag_parts, plan[0], row_pad,
                                           col_pad, dtype, device))
            dvals, dcols = _placeholders(nparts, row_pad, dtype, device)
        else:
            form = ell_form(row_pad, col_pad, kd, total_nnz // nparts,
                            itemsize)[0]
            if form == "rowptr":
                fields.update(_ell_rowptr_fields(kd, diag_parts, row_pad,
                                                 dtype, device))
                dvals, dcols = _placeholders(nparts, row_pad, dtype, device)
            else:
                compacted = [_ell_compact(kd, *dp) for dp in diag_parts]
                idx = [c[0] for c in compacted]
                dvals = materialize(idx, [c[1] for c in compacted],
                                    (row_pad, kd), dtype, device)
                dcols = materialize(idx, [c[2] for c in compacted],
                                    (row_pad, kd), np.int32, device)

        # main diagonal: only where rows and columns share one partition
        # (square operators; a rectangular P or R has none)
        diag_main = np.zeros((nparts, row_pad), dtype)
        for p, (dlr, dlc, dv) in enumerate(diag_parts):
            diag_main[p, int(row_counts[p]):] = 1.0  # padded rows
            if same_partition and row_offsets[p] == col_offsets[p] \
                    and dlr.size:
                on_diag = dlc == dlr
                diag_main[p, dlr[on_diag]] += dv[on_diag]
        offd = _offd_fields(offd_parts, row_pad, col_offsets, dtype, device)
        A = ShardedMatrix(
            diag_vals=dvals, diag_cols=dcols,
            bdia_vals=fields.pop("bdia_vals", None),
            bdia_starts=fields.pop("bdia_starts", None),
            bell_vals=fields.pop("bell_vals", None),
            bell_ids=fields.pop("bell_ids", None),
            diag=to_tensor(diag_main, device),
            ell_rowptr=fields.pop("ell_rowptr", None),
            ell_vals=fields.pop("ell_vals", None),
            ell_cols=fields.pop("ell_cols", None),
            shape=(int(nrows), int(ncols)),
            row_offsets=tuple(int(o) for o in row_offsets),
            col_offsets=tuple(int(o) for o in col_offsets),
            row_pad=row_pad, col_pad=col_pad,
            nnz=int(total_nnz) + offd.pop("nnz"), **fields, **offd)
        return A.with_kernel() if A.uses_bdia else A

    @staticmethod
    def from_dia_parts(shape, offsets, dia_vals, offd_parts, *, device,
                       dtype=None, dia_shape=None,
                       dia_nnz: int | None = None, row_offsets=None,
                       col_offsets=None,
                       parts: tuple | None = None) -> "ShardedMatrix":
        """Assemble from per-part box-DIA diag blocks (``tpusolve``'s
        ``from_dia_parts``): the stencil generator's and the structured
        multigrid's operators, whose diag block is pure box geometry.

        ``offsets``: one (dz, dy, dx) triple per plane, or flat offsets,
        which :func:`dia_triples` decomposes over ``dia_shape`` where that is
        unambiguous.  ``dia_vals``: (P, D, R) or (P, D, nz, ny, nx) numpy
        array or tensor, zeros where a neighbour leaves the box.
        ``dia_shape``: the (nz, ny, nx) box of a part's R rows; None is the
        1-D form.  ``offd_parts``: per part (local rows, global cols, vals)
        of the couplings that leave the part (the stencil's boundary
        shells), none on one part.  ``row_offsets`` (default: the
        decomposition of the rows over the parts) and ``col_offsets``
        (default: the same) give the parts' rows; each part's box holds its
        rows first, zero planes in its padded tail.  The main diagonal comes
        from the (0, 0, 0) plane, 1 on padded rows.  The caller keeps its
        input: nothing is consumed (``tpusolve`` donates a device input).

        ``parts`` = (lo, hi, world) builds rank ``lo // (hi - lo)``'s slice
        of the operator over every part (:meth:`rank_slice`'s, field for
        field) directly: ``dia_vals`` holds parts ``[lo, hi)`` alone, and
        ``offd_parts`` every part's couplings, from which each rank derives
        the whole halo plan (:func:`_offd_fields`); ``dia_nnz`` (every
        part's diag-block entries) must be given.  No other part's planes
        are placed anywhere."""
        nrows, ncols = shape
        D = int(dia_vals.shape[1])
        nparts = len(offd_parts) if parts is not None \
            else int(dia_vals.shape[0])
        lo, hi = (0, nparts) if parts is None else parts[:2]
        if parts is not None and (dia_nnz is None
                                  or int(dia_vals.shape[0]) != hi - lo):
            raise ValueError("a rank's DIA parts need every part's entry "
                             "count and its own parts' planes")
        R = int(np.prod(dia_vals.shape[2:]))
        if dia_shape is not None and int(np.prod(dia_shape)) != R:
            raise ValueError("dia_shape does not tile the row space")
        row_offsets = np.asarray(
            row_decomposition(nrows, nparts) if row_offsets is None
            else row_offsets, np.int64)
        col_offsets = (row_offsets if col_offsets is None
                       else np.asarray(col_offsets, np.int64))
        row_counts = np.diff(row_offsets)
        if nrows != ncols or len(row_counts) != nparts \
                or int(row_counts.max()) != R \
                or not np.array_equal(row_offsets, col_offsets):
            raise ValueError(f"DIA block of {nparts} x {R} rows for shape "
                             f"{shape}")
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
        L = hi - lo
        vals = vals.reshape((L, D) + box).contiguous()
        if (0, 0, 0) in triples:
            diag = vals[:, triples.index((0, 0, 0))].reshape(L, R).clone()
        else:
            diag = torch.zeros((L, R), dtype=tdt, device=device)
        for p in range(L):
            diag[p, int(row_counts[lo + p]):] = 1.0     # padded rows
        offd = _offd_fields(offd_parts, R, col_offsets, numpy_dtype(tdt),
                            device, parts)
        nnz = (int(dia_nnz) if dia_nnz is not None
               else int(torch.count_nonzero(vals))) + offd.pop("nnz")
        zeros = torch.zeros((L, R, 1), dtype=tdt, device=device)
        offsets = lambda o: tuple(int(v) for v in o)
        if parts is not None:
            price = offd.get("offd_price", (None,) * 5)
            offd.update(part_lo=lo, plain_widths=(None, price[4]),
                        all_offsets=(offsets(row_offsets),
                                     offsets(col_offsets)))
        return ShardedMatrix(
            diag_vals=zeros, diag_cols=zeros.to(torch.int32),
            bdia_vals=None, bdia_starts=None, bell_vals=None, bell_ids=None,
            diag=diag, shape=(int(nrows), int(ncols)),
            row_offsets=offsets(row_offsets[lo:hi + 1]),
            col_offsets=offsets(col_offsets[lo:hi + 1]),
            row_pad=R, col_pad=R, nnz=nnz, dia_vals=vals,
            dia_offsets=triples, tpusolve_layout="dia",
            dia_shape=(None if dia_shape is None
                       else tuple(int(d) for d in dia_shape)), **offd)

    @staticmethod
    def from_arrays(arrays: dict, meta: dict, device) -> "ShardedMatrix":
        """Build the port's matrix from ``tpusolve``'s ShardedMatrix fields
        fetched as numpy (``arrays``: ``bdia_vals``, ``bdia_starts``,
        ``bdia_ovf_rows/cols/vals``, ``bell_vals``, ``bell_ids``,
        ``diag_vals``, ``diag_cols``, ``diag``; ``meta``: ``shape``,
        ``row_offsets``, ``col_offsets``, ``row_pad``, ``col_pad``, ``nnz``,
        ``bdia_block``, ``bdia_xpad``, ``bdia_xlen``, ``bell_nwin``,
        ``has_offd``, ``uses_dia``, ``dia_offsets``, ``dia_shape``), so
        that both packages can run on one identical layout (``reuse``,
        output and the tests).  On more than one part ``arrays`` also hold
        the offd block and its halo plan (``offd_vals``, ``offd_cols``,
        ``send_idx``, ``ghost_slot``), taken as they are.  A padded-ELL
        operator takes the form K2's model prices cheaper
        (:func:`ell_form`), as every ELL operator of the port does: the
        same entries in the same slot order.  A DIA operator
        (``arrays``' ``dia_vals``) goes through :meth:`from_dia_parts`, its
        flat offsets decomposed by :func:`dia_triples`, which raises where
        that is ambiguous.  The overflow list (the same entries) is converted
        to the port's CSR form.  A ``tpusolve`` XL operator (``arrays``'
        ``bdia_rowstart`` set) keeps its values and starts and runs the
        port's K5 on the port's own step plan (:func:`plan_xl`), where one
        fits a block's shared memory; ``tpusolve``'s TPU panel plan
        (``bdia_rowstart``, ``bdia_pxrows``, ``bdia_xrows``) is not used."""
        nparts = len(meta["row_offsets"]) - 1
        offd = {}
        if meta.get("has_offd") and nparts == 1:
            raise ValueError("from_arrays: one part owns every column, so it "
                             "has no offd block")
        if nparts > 1:
            offd = _offd_from_plan(arrays, int(meta["col_pad"]), device)
        if meta.get("uses_dia"):
            empty = np.zeros(0, np.int64)
            A = ShardedMatrix.from_dia_parts(
                tuple(meta["shape"]), meta["dia_offsets"],
                arrays["dia_vals"], [(empty, empty, empty)] * nparts,
                device=device, dia_shape=meta.get("dia_shape"),
                dia_nnz=meta["nnz"], row_offsets=meta["row_offsets"],
                col_offsets=meta["col_offsets"])
            return dataclasses.replace(A, **offd) if offd else A
        row_pad, col_pad = int(meta["row_pad"]), int(meta["col_pad"])
        ovf = {}
        if arrays.get("bdia_ovf_rows") is not None:
            ovf = _ovf_fields(list(zip(
                arrays["bdia_ovf_rows"], arrays["bdia_ovf_cols"],
                arrays["bdia_ovf_vals"])), row_pad, col_pad,
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
            bell_nwin=meta.get("bell_nwin"), **ovf, **offd,
            tpusolve_layout=("bdia" if arrays.get("bdia_vals") is not None
                             else "bell" if arrays.get("bell_vals")
                             is not None else "ell"))
        if A.uses_ell:
            A = A.with_ell_form()
        if A.uses_bdia:
            _check_windows(arrays["bdia_starts"], A.bdia_block, A.bdia_xlen)
            A = dataclasses.replace(
                A, bdia_mask=bdia_mod.segment_mask(A.bdia_vals))
            if arrays.get("bdia_rowstart") is not None:
                xl = plan_xl(A.bdia_starts.cpu().numpy(), A.bdia_block,
                             A.bdia_xpad, A.bdia_vals.element_size(),
                             A.bdia_nbytes, A.bdia_live, A.xl_work())
                if xl is not None:
                    A = A._with_xl(xl[:5])
        return A

    # ------------------------------------------------------------------
    def to_scipy(self):
        """The global matrix as scipy CSR (tests and host use): every
        part's diag block, and its offd block with each ghost slot turned
        back into its global column through the halo plan
        (``tpusolve/matrix/sharded.py:804-893``).  On a rank's slice, the
        global matrix with this rank's rows alone."""
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        ghosts = None
        if self.has_offd:
            ro = np.asarray(self.all_col_offsets)
            S = self.send_idx.shape[-1]
            send = self.send_idx.cpu().numpy().astype(np.int64)
            gs = self.ghost_slot.cpu().numpy().astype(np.int64)
            ovals = self.offd_vals.cpu().numpy()
            ocols = self.offd_cols.cpu().numpy().astype(np.int64)
        for p in range(self.nparts):
            nr = self.row_offsets[p + 1] - self.row_offsets[p]
            lr, lc, v = self._part_entries(p)
            keep = lr < nr     # drop padding rows
            rows.append(self.row_offsets[p] + lr[keep])
            cols.append(self.col_offsets[p] + lc[keep])
            vals.append(v[keep])
            if self.has_offd:
                owners, pos = gs[p] // S, gs[p] % S
                ghosts = ro[owners] + send[owners, self.part_lo + p, pos]
                r_i, k_i = np.nonzero(ovals[p][:nr])
                rows.append(self.row_offsets[p] + r_i)
                cols.append(ghosts[ocols[p][r_i, k_i]])
                vals.append(ovals[p][r_i, k_i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))), shape=self.shape)

    def _part_entries(self, p: int) -> tuple:
        """(local rows, local columns, values) of part ``p``'s diag block,
        padded rows included."""
        if self.uses_dia:
            lr, lc, vals = _dia_entries(self.dia_vals[p].cpu().numpy(),
                                        self.dia_offsets)
        elif self.uses_bell:
            bv = self.bell_vals[p].cpu().numpy()        # (G, K, 8, 128)
            bi = self.bell_ids[p].cpu().numpy()         # (G, K)
            g_i, k_i, r_i, c_i = np.nonzero(bv)
            lr = g_i * bell_mod.TM + r_i
            lc = bi[g_i, k_i].astype(np.int64) * bell_mod.TN + c_i
            vals = bv[g_i, k_i, r_i, c_i]
        elif self.uses_bdia:
            bv = self.bdia_vals[p].cpu().numpy()        # (B, D, R)
            bs = self.bdia_starts[p].cpu().numpy()      # (B, D)
            R = self.bdia_block
            b_i, d_i, r_i = np.nonzero(bv)
            lr = b_i * R + r_i
            lc = bs[b_i, d_i].astype(np.int64) - self.bdia_xpad + r_i
            vals = bv[b_i, d_i, r_i]
            if self.bdia_ovf_ptr is not None:
                ptr = self.bdia_ovf_ptr[p].cpu().numpy()
                k = int(ptr[-1])
                lr = np.concatenate([lr, np.repeat(np.arange(self.row_pad),
                                                   np.diff(ptr))])
                lc = np.concatenate([lc, self.bdia_ovf_cols[p, :k].cpu()
                                     .numpy()])
                vals = np.concatenate([vals, self.bdia_ovf_vals[p, :k].cpu()
                                       .numpy()])
        elif self.uses_ell_rowptr:
            ptr = self.ell_rowptr[p].cpu().numpy().astype(np.int64)
            k = int(ptr[-1])
            lr = np.repeat(np.arange(self.row_pad), np.diff(ptr))
            lc = self.ell_cols[p, :k].cpu().numpy().astype(np.int64)
            vals = self.ell_vals[p, :k].cpu().numpy()
            live = vals != 0   # as the padded form: stored zeros dropped
            lr, lc, vals = lr[live], lc[live], vals[live]
        else:
            ev = self.diag_vals[p].cpu().numpy()
            ec = self.diag_cols[p].cpu().numpy()
            lr, k_idx = np.nonzero(ev)
            lc = ec[lr, k_idx].astype(np.int64)
            vals = ev[lr, k_idx]
        return lr, lc, vals

    def astype(self, dtype) -> "ShardedMatrix":
        """Value-dtype cast of the same operator (layout and index tensors
        shared).  Used for the mixed-precision f32 twin.  A BDIA operator
        builds its segment mask from the cast values and chooses between K4
        and K5 again (:meth:`with_kernel`): whether a panel fits, and what
        it costs, depend on the item size.  An ELL
        operator keeps its form; the offd block is cast too."""
        dtype = torch_dtype(dtype)
        if self.dtype == dtype:
            return self
        cast = lambda a: a.to(dtype) if a is not None else None
        A = dataclasses.replace(
            self, diag_vals=cast(self.diag_vals),
            bdia_vals=cast(self.bdia_vals), bell_vals=cast(self.bell_vals),
            bdia_ovf_vals=cast(self.bdia_ovf_vals), diag=cast(self.diag),
            dia_vals=cast(self.dia_vals), ell_vals=cast(self.ell_vals),
            offd_vals=cast(self.offd_vals),
            offd_form=None if self.offd_price is None else _offd_form(
                self.offd_price, torch.empty(0, dtype=dtype).element_size()))
        if A.uses_bdia:
            # a cast may round a value to zero: the mask follows the values
            A = dataclasses.replace(
                A, bdia_mask=bdia_mod.segment_mask(A.bdia_vals)).with_kernel()
        return A

    def with_ell_form(self) -> "ShardedMatrix":
        """A padded-ELL operator in the form K2's model prices cheaper
        (:func:`ell_form`, a part's rows and its share of the entries, as
        :meth:`from_local_parts` prices it): itself, or the row-pointer form
        of the same entries (``kernels/ell.py:padded_to_rowptr``), part by
        part.  ``row_width`` is set from the entries."""
        P = self.nparts
        forms = [ell_mod.padded_to_rowptr(self.diag_vals[p],
                                          self.diag_cols[p])
                 for p in range(P)]
        width = max(1, max(int((f[0][1:] - f[0][:-1]).max()) for f in forms))
        nnz = sum(f[1].numel() for f in forms)
        form = ell_form(self.row_pad, self.col_pad, self.diag_vals.shape[-1],
                        nnz // P, self.diag_vals.element_size(), width)[0]
        if form == "padded":
            return dataclasses.replace(self, row_width=width)
        dvals, dcols = _placeholders(P, self.row_pad, self.dtype, self.device)
        return dataclasses.replace(
            self, diag_vals=dvals, diag_cols=dcols, row_width=width,
            **_stack_rowptr(forms))

    @property
    def bdia_nbytes(self) -> int:
        """:func:`bdia_bytes` of a BDIA operator: what K4 streams."""
        P, B, D, R = self.bdia_vals.shape
        k = 0 if self.bdia_ovf_ptr is None else int(
            self.bdia_ovf_ptr[:, -1].sum())
        return bdia_bytes(P * B, D, R, k, self.bdia_vals.element_size())

    def xl_work(self) -> tuple:
        """:func:`xl_work` of a BDIA operator."""
        return xl_work(self.bdia_mask, self.bdia_ovf_ptr, self.bdia_block,
                       self.row_pad, self.bdia_vals.element_size())

    def with_kernel(self) -> "ShardedMatrix":
        """A BDIA operator run by the kernel the time model prices faster
        on it (:func:`choose_xl` on its mask's live segments, steps of
        balanced work): K5 on its step plan, else K4."""
        return self._with_xl(choose_xl(
            self.bdia_starts.cpu().numpy(), self.bdia_block, self.bdia_xpad,
            self.bdia_vals.element_size(), self.bdia_nbytes, self.bdia_live,
            self.xl_work()))

    def xl_cols_op(self, k: int) -> bdia_mod.XLOperator:
        """K5's k-column launch arguments on this BDIA-XL operator (on a
        CUDA device), made once a k: a step plan of its own
        (:func:`plan_xl` with ``cols=k``, steps of balanced work) and, for
        k > 1, the cover of each step's windows that its k panels stage
        (``kernels/bdia.py:step_cover``, ``csrc/bdia_spmv_xl.cu``)."""
        cache = self.__dict__.get("_xl_cols")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_xl_cols", cache)
        if k not in cache:
            starts = self.bdia_starts.cpu().numpy()
            itemsize = self.bdia_vals.element_size()
            xl = plan_xl(starts, self.bdia_block, self.bdia_xpad, itemsize,
                         self.bdia_nbytes, self.bdia_live, self.xl_work(),
                         cols=k)
            if xl is None:
                raise ValueError(f"bdia_spmv_xl: no {k}-column step plan "
                                 "fits a block's shared memory")
            gb, step_lo, panel, step_b0, stage = xl[:5]
            cover, ovf = None, self.bdia_ovf
            if k > 1:
                tables = bdia_mod.step_cover(starts, self.bdia_block,
                                             self.bdia_xpad, step_b0)[:3]
                cover = tuple(to_tensor(t, self.device) for t in tables)
                if ovf is not None:
                    # the list's columns as the launch reads them
                    ovf = (ovf[0], to_tensor(bdia_mod.cover_overflow(
                        ovf[0].cpu().numpy(), ovf[1].cpu().numpy(),
                        self.bdia_block, step_b0, *tables[:2]),
                        self.device), ovf[2])
            cache[k] = bdia_mod.xl_operator(
                self.bdia_vals, self.bdia_starts, self.bdia_xpad,
                self.row_pad, self.col_pad, int(gb),
                to_tensor(step_lo, self.device), int(panel), ovf,
                mask=self.bdia_mask, step_b0=to_tensor(step_b0, self.device),
                stage=int(stage), cols=k, cover=cover)
        return cache[k]

    def _with_xl(self, xl) -> "ShardedMatrix":
        """The same operator run by K5 on step plan ``xl`` = (gb, step_lo,
        panel, step_b0, stage) (``kernels/bdia.py:plan_steps``), or by K4
        when ``xl`` is None."""
        if xl is None:
            return dataclasses.replace(self, bdia_gb=None, bdia_step_lo=None,
                                       bdia_panel=None, bdia_step_b0=None,
                                       bdia_stage=None, bdia_xl_op=None)
        gb, step_lo, panel, step_b0, stage = xl
        A = dataclasses.replace(
            self, bdia_gb=int(gb), bdia_step_lo=to_tensor(step_lo,
                                                          self.device),
            bdia_panel=int(panel), bdia_step_b0=to_tensor(step_b0,
                                                          self.device),
            bdia_stage=int(stage), bdia_xl_op=None)
        if A.device.type != "cuda":
            return A
        return dataclasses.replace(A, bdia_xl_op=bdia_mod.xl_operator(
            A.bdia_vals, A.bdia_starts, A.bdia_xpad, A.row_pad, A.col_pad,
            A.bdia_gb, A.bdia_step_lo, A.bdia_panel, A.bdia_ovf,
            mask=A.bdia_mask, step_b0=A.bdia_step_b0, stage=A.bdia_stage))


    def rank_slice(self, rank: int, world: int, device) -> "ShardedMatrix":
        """Rank ``rank``'s parts of this operator over every part, as
        ``world`` ranks split them (``dist.place``): parts ``[rank N/R,
        (rank+1) N/R)`` on ``device``, each of their arrays as this
        operator has it (``row_pad``, ``col_pad``, the layout and its plan,
        the offd blocks), and the halo plan by peer rank
        (:func:`rank_halo`) in place of ``halo_src``.  K2's form on the
        offd block and the widths of the row-pointer forms' plain versions
        are this operator's, so the slice's rows keep their bits."""
        P = self.nparts
        if self.is_slice or P % world:
            raise ValueError(f"rank_slice: {P} parts over {world} ranks")
        per = P // world
        lo, hi = rank * per, (rank + 1) * per
        device = torch.device(device)
        take = lambda t: None if t is None else t[lo:hi].to(device,
                                                            copy=True)
        fields = {f: take(getattr(self, f)) for f in _PART_FIELDS}
        halo = {}
        if self.has_offd:
            halo = _slice_halo(self.send_idx.cpu().numpy(),
                               self.halo_src.cpu().numpy(),
                               self.ghost_slot.shape[1], self.col_pad, P,
                               rank, world, self._offd_price(), device)
            halo["offd_form"] = ("padded" if self.offd_k2[2] is None
                                 else "rowptr")
        A = dataclasses.replace(
            self, **fields, **halo, halo_src=None, bdia_xl_op=None,
            row_offsets=self.row_offsets[lo:hi + 1],
            col_offsets=self.col_offsets[lo:hi + 1], part_lo=lo,
            all_offsets=(self.row_offsets, self.col_offsets),
            plain_widths=(_rowptr_width(self.ell_rowptr)
                          if self.uses_ell_rowptr else None,
                          halo.get("offd_price", (None,) * 5)[4]))
        if A.uses_bdia_xl:
            A = A._with_xl((A.bdia_gb, A.bdia_step_lo.cpu(), A.bdia_panel,
                            A.bdia_step_b0.cpu(), A.bdia_stage))
        return A


# the fields of ShardedMatrix with a leading part axis, which a rank's
# slice takes its parts of (send_idx, (P, P, S), stays whole)
_PART_FIELDS = ("diag_vals", "diag_cols", "bdia_vals", "bdia_starts",
                "bell_vals", "bell_ids", "diag", "bdia_ovf_ptr",
                "bdia_ovf_cols", "bdia_ovf_vals", "bdia_mask",
                "bdia_step_lo", "bdia_step_b0", "dia_vals", "ell_rowptr",
                "ell_vals", "ell_cols", "offd_vals", "offd_cols",
                "ghost_slot")


def _rowptr_width(rowptr: torch.Tensor) -> int:
    """The largest count of entries a row of a row pointer (one, or a stack
    of them) has, at least 1: the width its plain version pads to."""
    return max(1, int((rowptr[..., 1:] - rowptr[..., :-1]).max()))


@dataclass(frozen=True)
class RankHalo:
    """A rank's halo plan (:func:`rank_halo`): ``send_idx`` the entries of
    its padded x it sends, peer by peer in rank order (``send_splits`` of
    them to each); ``recv_splits`` the entries each peer sends it; ``src``
    (L * G,) the index of each of its parts' ghosts into its padded x
    followed by the received entries."""
    send_idx: torch.Tensor
    send_splits: tuple
    recv_splits: tuple
    src: torch.Tensor


def rank_halo(halo_src: np.ndarray, G: int, col_pad: int,
              part_rank: np.ndarray, rank: int, device) -> RankHalo:
    """The halo plan of rank ``rank`` from the whole operator's one-gather
    plan ``halo_src`` (P * G,) (:func:`halo_sources`; part p on rank
    ``part_rank[p]``, each rank's parts consecutive): the ghosts its own
    parts hold come from its padded x, the others from the one
    ``all_to_all_single`` (``tpusolve/matrix/spmv.py:60-70``), each peer
    sending every entry any of this rank's ghosts reads once, in global
    order.  Every rank builds every rank's lists from the global column
    ownership, so no plan is exchanged at run time; the ghosts, padded
    slots too, are the whole operator's gather bit for bit."""
    P = part_rank.size
    R = int(part_rank.max()) + 1
    lo = int(np.searchsorted(part_rank, rank))
    hi = int(np.searchsorted(part_rank, rank, side="right"))
    dest = part_rank[np.arange(P * G) // G]
    owner = part_rank[halo_src // col_pad]

    def wanted(s, d):
        if s == d:
            return np.zeros(0, np.int64)
        return np.unique(halo_src[(owner == s) & (dest == d)])

    sends = [wanted(rank, d) for d in range(R)]
    recvs = [wanted(s, rank) for s in range(R)]
    base = lo * col_pad
    mine, own = halo_src[lo * G:hi * G], owner[lo * G:hi * G]
    src = mine - base
    roff = np.concatenate([[0], np.cumsum([r.size for r in recvs])])
    for s in range(R):
        at = own == s
        if s != rank and at.any():
            src[at] = (hi - lo) * col_pad + roff[s] + np.searchsorted(
                recvs[s], mine[at])
    return RankHalo(
        send_idx=to_tensor(np.concatenate(sends) - base, device),
        send_splits=tuple(int(a.size) for a in sends),
        recv_splits=tuple(int(a.size) for a in recvs),
        src=to_tensor(src, device))


def _offd_form(price: tuple, itemsize: int) -> str:
    """K2's form on an offd block of ``price`` (``ShardedMatrix.
    _offd_price``) and values of ``itemsize`` bytes: K2_MODEL has f32 and
    f64 constants, so a bf16 twin's block is priced as f32."""
    rows, ncols, K, nnz, width = price
    return ell_form(rows, ncols, K, nnz, max(4, itemsize), width)[0]


def _slice_halo(send_idx: np.ndarray, halo_src: np.ndarray, G: int,
                col_pad: int, P: int, rank: int, world: int, price: tuple,
                device) -> dict:
    """The halo fields of rank ``rank``'s slice of an operator of ``P``
    parts over ``world`` ranks, from the whole operator's plan (``send_idx``
    (P, P, S), ``halo_src`` (P * G,)) and its offd block's ``price``
    (``ShardedMatrix._offd_price``): ``send_idx`` whole, ``rank_halo``
    (:func:`rank_halo`) and ``offd_price``."""
    return dict(send_idx=to_tensor(np.asarray(send_idx, np.int32), device),
                rank_halo=rank_halo(np.asarray(halo_src, np.int64), G,
                                    col_pad, np.arange(P) // (P // world),
                                    rank, device),
                offd_price=tuple(int(v) for v in price))


def _dia_candidate(diag_parts, row_pad: int, total_nnz: int):
    """The sorted flat (col - row) offsets of the 1-D DIA layout when
    ``tpusolve``'s DIA-first rule takes the diag block
    (``tpusolve/matrix/sharded.py:287-302``): at most ``DIA_MAX_OFFSETS``
    distinct offsets filling at least ``DIA_MIN_FILL`` of the planes.  None
    when DIA is not taken.  (``tpusolve``'s looser rule under a
    caller-vouched ``dia_shape`` serves only its scipy-RAP
    ``structured_mg_setup``, which the port does not run.)"""
    sets = [np.unique(dlc - dlr) for dlr, dlc, _ in diag_parts if dlr.size]
    if not sets or not total_nnz:
        return None
    union = np.unique(np.concatenate(sets))
    D = union.size
    fill = total_nnz / max(D * len(diag_parts) * row_pad, 1)
    if 0 < D <= DIA_MAX_OFFSETS and fill >= DIA_MIN_FILL:
        return union
    return None


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
    """BDIA tensors and metadata for :func:`choose_layout`'s plan, with the
    segment mask of the stored values, built on ``device``."""
    R, D, _, staging = plan
    starts, xpad, xlen, s_idx, s_val, ovf_parts = staging
    B = starts.shape[1]
    vals = materialize(s_idx, s_val, (B, D, R), dtype, device)
    fields = dict(
        bdia_vals=vals, bdia_starts=to_tensor(starts, device),
        bdia_mask=bdia_mod.segment_mask(vals),
        bdia_block=R, bdia_xpad=xpad, bdia_xlen=xlen)
    fields.update(_ovf_fields(ovf_parts, row_pad, col_pad, dtype, device))
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


def _placeholders(nparts: int, row_pad: int, dtype, device) -> tuple:
    """The (P, row_pad, 1) zero ``diag_vals`` and ``diag_cols`` of a layout
    that keeps its operator elsewhere (they carry its dtype and device)."""
    tdt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
    return (torch.zeros((nparts, row_pad, 1), dtype=tdt, device=device),
            torch.zeros((nparts, row_pad, 1), dtype=torch.int32,
                        device=device))


def _ell_rowptr_fields(k, diag_parts, row_pad, dtype, device) -> dict:
    """Row-pointer ELL tensors of every part's (local rows, cols, vals),
    packed by ``kernels/ell.py:pack_rowptr``: each row's entries at their
    ranks in :func:`_ell_compact`'s padded layout of width ``k`` (its slot
    order); :func:`_stack_rowptr` stacks the parts."""
    t = lambda a: to_tensor(a, device)
    forms = []
    for part in diag_parts:
        idx, vals, cols = _ell_compact(k, *part)
        row, rank = idx // k, idx % k
        forms.append(ell_mod.pack_rowptr(
            t(np.bincount(row, minlength=row_pad)),
            [(t(row), t(rank), t(vals), t(cols))], torch_dtype(dtype)))
    return _stack_rowptr(forms)


def _stack_rowptr(forms) -> dict:
    """The ``ell_rowptr``, ``ell_vals``, ``ell_cols`` fields of the parts'
    row-pointer forms ``(rowptr, vals, cols)``: (P, row_pad + 1) pointers
    (int64 where any part needs it), values and columns padded at each
    part's end to the largest part's entries with value 0 and column 0."""
    if len(forms) == 1:
        rowptr, vals, cols = forms[0]
        return dict(ell_rowptr=rowptr[None], ell_vals=vals[None],
                    ell_cols=cols[None])
    idt = (torch.int64 if any(f[0].dtype == torch.int64 for f in forms)
           else torch.int32)
    width = max(1, max(f[1].numel() for f in forms))
    vals = torch.zeros((len(forms), width), dtype=forms[0][1].dtype,
                       device=forms[0][1].device)
    cols = torch.zeros((len(forms), width), dtype=torch.int32,
                       device=vals.device)
    for p, (_, v, c) in enumerate(forms):
        vals[p, :v.numel()] = v
        cols[p, :c.numel()] = c
    return dict(ell_rowptr=torch.stack([f[0].to(idt) for f in forms]),
                ell_vals=vals, ell_cols=cols)


def _flat_padded(vals: torch.Tensor, cols: torch.Tensor, ncols: int):
    """``(vals, cols, None)``: a padded (P, rows, K) operator over parts of
    ``ncols`` columns each as one (P * rows, K) launch over the stacked
    columns, part p's columns rebased by p * ncols (int32: the stacked
    columns stay below 2**31)."""
    P, rows, K = vals.shape
    if P * ncols >= 2 ** 31:
        raise ValueError("K2: the stacked columns pass 2**31")
    base = torch.arange(P, dtype=torch.int32, device=cols.device) * ncols
    return (vals.reshape(P * rows, K),
            (cols + base[:, None, None]).reshape(P * rows, K), None)


def offd_rowptr(vals: torch.Tensor, cols: torch.Tensor, ghosts: int):
    """``(rowptr, vals, cols)``: the stacked offd block (P, rows, Ko) of ``P``
    parts of ``ghosts`` ghost slots each in K2's row-pointer form, one row
    pointer over all parts' rows, each row's slots up to its last that is
    not padding (``kernels/ell.py:padded_to_rowptr``, on the stored slots),
    part p's ghost slots then rebased by p * ``ghosts``."""
    P, rows, K = vals.shape
    rowptr, rv, rc = ell_mod.padded_to_rowptr(vals.reshape(P * rows, K),
                                              cols.reshape(P * rows, K))
    part = torch.repeat_interleave(
        torch.arange(P * rows, device=vals.device) // rows,
        (rowptr[1:] - rowptr[:-1]).long())
    return rowptr, rv, (rc + part * ghosts).to(torch.int32)


def _flat_rowptr(rowptr: torch.Tensor, vals: torch.Tensor,
                 cols: torch.Tensor, ncols: int):
    """``(vals, cols, rowptr)``: a row-pointer operator of P parts
    (:func:`_stack_rowptr`) as one launch, one row pointer over all parts'
    rows and part p's columns rebased by p * ncols."""
    P = rowptr.shape[0]
    if P * ncols >= 2 ** 31:
        raise ValueError("K2: the stacked columns pass 2**31")
    counts = rowptr[:, -1].to(torch.int64)
    base = torch.zeros(P, dtype=torch.int64, device=rowptr.device)
    base[1:] = torch.cumsum(counts, 0)[:-1]
    ptr = torch.cat([(rowptr[:, :-1].to(torch.int64) + base[:, None])
                     .reshape(-1), counts.sum().reshape(1)])
    if int(ptr[-1]) < 2 ** 31:
        ptr = ptr.to(torch.int32)
    keep = [slice(0, int(c)) for c in counts]
    v = torch.cat([vals[p, keep[p]] for p in range(P)])
    c = torch.cat([cols[p, keep[p]] + p * ncols for p in range(P)])
    return v, c.to(torch.int32), ptr


def _offd_fields(offd_parts, row_pad: int, col_offsets, dtype,
                 device, parts: tuple | None = None) -> dict:
    """The offd block and halo plan of an operator of more than one part
    (``tpusolve``'s ``_build_offd_and_halo``, ``tpusolve/matrix/
    sharded.py:916-973``, the same arrays): ``offd_vals`` and ``offd_cols``
    (P, row_pad, Ko) over each part's sorted ghost list, ``send_idx`` (P,
    P, S) and ``ghost_slot`` (P, G), with ``halo_src`` (P * G,) for the one
    gather (a padded ghost slot reads what ``tpusolve``'s exchange gives
    it, a real x entry), ``has_offd`` and ``nnz`` (the offd entries, which
    the caller pops).  On one part: no offd block (``nnz`` 0).

    With ``parts`` = (lo, hi, world), the fields of that rank's slice
    (``ShardedMatrix.rank_slice``) from every part's couplings, which the
    plan needs: ``offd_vals``, ``offd_cols`` and ``ghost_slot`` of parts
    ``[lo, hi)`` alone, the halo by rank (:func:`_slice_halo`) in place of
    ``halo_src``, priced as the whole block (``offd_price``, from the
    entries, with no block of the other parts built)."""
    nparts = len(offd_parts)
    if nparts == 1:
        if len(offd_parts[0][0]):
            raise ValueError("one part owns every column")
        return dict(nnz=0)
    col_offsets = np.asarray(col_offsets, np.int64)
    ghost_lists, local_offd = [], []
    ko, total = 1, 0
    for p in range(nparts):
        olr, ogc, ov = offd_parts[p]
        olr = np.asarray(olr, np.int64)
        ogc = np.asarray(ogc, np.int64)
        ov = np.asarray(ov, dtype)
        ghosts = np.unique(ogc)
        ghost_lists.append(ghosts)
        local_offd.append((olr, np.searchsorted(ghosts, ogc), ov))
        total += olr.size
        if olr.size:
            ko = max(ko, int(np.bincount(olr).max()))
    ghost_pad = max(1, max(g.size for g in ghost_lists))
    send_counts = np.zeros((nparts, nparts), np.int64)
    for q in range(nparts):
        send_counts[:, q] = np.diff(np.searchsorted(ghost_lists[q],
                                                    col_offsets))
    send_pad = max(1, int(send_counts.max()))
    send_idx = np.zeros((nparts, nparts, send_pad), np.int32)
    ghost_slot = np.zeros((nparts, ghost_pad), np.int32)
    for q in range(nparts):
        gl = ghost_lists[q]
        st = np.searchsorted(gl, col_offsets)
        owners = np.searchsorted(col_offsets, gl, side="right") - 1
        ghost_slot[q, :gl.size] = owners * send_pad + np.arange(gl.size) \
            - st[owners]
        for p in range(nparts):
            seg = gl[st[p]:st[p + 1]] - col_offsets[p]
            send_idx[p, q, :seg.size] = seg
    compact = [_ell_compact(ko, *lo) for lo in local_offd]
    col_pad = max(1, int(np.diff(col_offsets).max()))
    src = halo_sources(send_idx, ghost_slot, col_pad)
    if parts is None or not total:
        lo, hi = (0, nparts) if parts is None else parts[:2]
        plan = dict(send_idx=to_tensor(send_idx, device))
        if parts is None:
            plan["halo_src"] = to_tensor(src, device)
    else:
        lo, hi, world = parts
        price = _price_entries(compact, row_pad, ko, ghost_pad)
        plan = _slice_halo(send_idx, src, ghost_pad, col_pad, nparts,
                           lo // (hi - lo), world, price, device)
        plan["offd_form"] = _offd_form(price, np.dtype(dtype).itemsize)
    idx = [c[0] for c in compact[lo:hi]]
    return dict(
        offd_vals=materialize(idx, [c[1] for c in compact[lo:hi]],
                              (row_pad, ko), dtype, device),
        offd_cols=materialize(idx, [c[2] for c in compact[lo:hi]],
                              (row_pad, ko), np.int32, device),
        ghost_slot=to_tensor(ghost_slot[lo:hi], device),
        has_offd=total > 0, nnz=total, **plan)


def _price_entries(compact, row_pad: int, ko: int, ghost_pad: int) -> tuple:
    """``ShardedMatrix._offd_price`` of the offd block that
    :func:`_ell_compact`'s stagings ``compact`` of every part lay out (P,
    row_pad, ko), from the entries: a row keeps its slots up to its last
    whose value or column is not 0 (``kernels/ell.py:padded_to_rowptr``)."""
    nnz, width = 0, 1
    for idx, vals, cols in compact:
        live = (vals != 0) | (cols != 0)
        counts = np.zeros(row_pad, np.int64)
        np.maximum.at(counts, idx[live] // ko, idx[live] % ko + 1)
        nnz += int(counts.sum())
        width = max(width, int(counts.max(initial=0)))
    P = len(compact)
    return (P * row_pad, P * ghost_pad, ko, nnz, width)


def halo_sources(send_idx: np.ndarray, ghost_slot: np.ndarray,
                 col_pad: int) -> np.ndarray:
    """(P * G,) int64: for ghost g of part q, the index into the stacked
    padded x (P * col_pad) of the entry ``tpusolve``'s exchange delivers to
    it, ``owner * col_pad + send_idx[owner, q, slot]`` with ``owner,
    slot = divmod(ghost_slot[q, g], S)``: the all_to_all of the plan
    folded into one index."""
    send_idx = np.asarray(send_idx, np.int64)
    ghost_slot = np.asarray(ghost_slot, np.int64)
    P, G = ghost_slot.shape
    owner, slot = np.divmod(ghost_slot, send_idx.shape[-1])
    q = np.repeat(np.arange(P), G).reshape(P, G)
    return (owner * col_pad + send_idx[owner, q, slot]).reshape(-1)


def _offd_from_plan(arrays: dict, col_pad: int, device) -> dict:
    """The offd fields of ``tpusolve``'s arrays (``offd_vals``,
    ``offd_cols``, ``send_idx``, ``ghost_slot``) as they are."""
    ov = np.asarray(arrays["offd_vals"])
    return dict(
        offd_vals=to_tensor(ov, device),
        offd_cols=to_tensor(np.asarray(arrays["offd_cols"], np.int32),
                            device),
        send_idx=to_tensor(np.asarray(arrays["send_idx"], np.int32), device),
        ghost_slot=to_tensor(np.asarray(arrays["ghost_slot"], np.int32),
                             device),
        halo_src=to_tensor(halo_sources(arrays["send_idx"],
                                        arrays["ghost_slot"], col_pad),
                           device),
        has_offd=bool(np.count_nonzero(ov)))


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
