"""Level setup on the operator's device for generic ELL operators (the port
of ``tpusolve/amg/device_setup_ell.py``, one part).

The DIA device setup (``amg/device_setup.py``) covers stencil operators on
an offset lattice; a file-loaded system (the reference's MatrixMarket and
HYPRE-IJ readers, src/HypreSystem.cpp:1613-1969, :1021-1318, feeding its
device BoomerAMGSetup, :692) has none, and neither have the coarse
operators that the device setups build.  This module runs the same level
pipeline on any padded-ELL operator, in eager PyTorch on its device:

* strength of connection and the interpolation weights: row-local slot
  arithmetic on the (rows, K) ELL planes;
* PMIS: an independent set whose neighbour maximum is one gather over S's
  rows and one scatter-max over the rows of S^T a round, on exact integer
  keys;
* direct (``interp_type`` 3), classical-modified (0) and extended+i (6)
  interpolation, the last two chunked over rows: each strong-F neighbour's
  row is gathered and its columns found among the row's strong-C (or
  extended) set by a sorted search;
* Galerkin RAP as two sort-based sparse products (expand, stable sort,
  run sums, pack), chunked over rows so that no temporary exceeds
  ``BUDGET`` bytes, and R = P^T by one stable sort of P's entries.

Every floating-point sum runs in an order that does not depend on the
device or the launch: a row's slots one after another (:func:`_rowsum`), a
sorted run by Hillis-Steele doubling steps (:func:`_run_scan`), and a
weight into its slot by a scatter whose live destinations are distinct (the
rest add exact zeros).  No floating-point atomic accumulates into P, R or
the coarse operator, so the card gives the CPU's bits, on every run.

Semantics follow ``amg/{strength,coarsen,interp,galerkin}.py`` and
``tpusolve``'s module (the same formulas; the PMIS tie-break ranks from the
same seeded host generator), so the device and host hierarchies agree to
roundoff.  Differences from ``tpusolve``, each on purpose:

* the PMIS ranks always come from the host generator
  (``device_setup.pmis_rank``), as ``tpusolve`` does under
  ``TPUSOLVE_PMIS_HOST_RANK=1``; no environment variable is read:
  :func:`eligible` takes ``min_n``;
* its sums over a row's slots and its TPU devices (one-hot contractions,
  compare-counts, static pack widths chosen for compile caches) become the
  fixed-order sums, sorted searches and per-chunk widths above; the values
  agree to roundoff;
* an operator of more than one part goes to the N-part pipeline
  (``amg/device_setup_ell_mp.py``), as ``tpusolve``'s does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpusolve_torch.amg.device_setup import (config_eligible, host_csr,
                                             pmis_rank, _pmis_keys,
                                             _round_up)
from tpusolve_torch.ilu.device_setup import (_ell_padded,
                                             from_device_ell_parts)
from tpusolve_torch.matrix.sharded import ShardedMatrix

# tpusolve sets a level up here from this many rows (its crossover,
# measured on its TPU; device_setup_ell.py:55) and up to this ELL width
# (:61)
MIN_DEVICE_N = 1 << 19
MAX_ELL_K = 128
# the largest temporary, in bytes, of a chunked stage: an interpolation
# chunk's gathered rows or extended set, a sparse product's expansion
BUDGET = 1 << 29
_I32_MAX = 2 ** 31 - 1
UND, C_PT, F_PT = -1, 1, 0


def eligible(A: ShardedMatrix, cfg, A_host=None,
             min_n: int | None = MIN_DEVICE_N) -> bool:
    """``tpusolve``'s rule for this setup, on the layout ``tpusolve`` gives
    ``A`` (``ShardedMatrix.tpusolve_layout``): a square operator of
    ``min_n`` (None: never) to 2**31 rows, with no offd block on one part;
    an ELL source of at most ``MAX_ELL_K`` entries a row, which is ``A``'s
    entries (the offd block's width counted too) where ``tpusolve`` stores
    it ELL and else the host CSR ``A_host``; and a config of
    ``config_eligible`` with interpolation 0, 3 or 6, on one part or many
    (the N-part pipeline, ``amg/device_setup_ell_mp.py``, runs all
    three)."""
    if min_n is None or A.shape[0] != A.shape[1]:
        return False
    if A.all_nparts == 1 and A.has_offd:
        return False
    if not min_n <= A.shape[0] < 2 ** 31:
        return False
    if A.tpusolve_layout == "ell":
        width = A.row_width + (0 if A.offd_vals is None
                               else A.offd_vals.shape[-1])
        if width > MAX_ELL_K:
            return False
    elif A_host is None or int(np.diff(
            A_host.tocsr().indptr).max(initial=0)) > MAX_ELL_K:
        return False
    return config_eligible(cfg, interp_types=(0, 3, 6))


# ----------------------------------------------------------------------
# fixed-order sums and packing

def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each row of (rows, K) ``x``, its slots added one after another
    from slot 0 (the same order, and bits, on every device)."""
    acc = x[:, 0].clone()
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _run_scan(vals: torch.Tensor, cols: torch.Tensor, combine):
    """Within-run inclusive scans over column-sorted rows (a run: equal
    columns side by side) by Hillis-Steele doubling: ``acc[j] =
    combine(acc[j], acc[j - s])`` where ``cols[j - s] == cols[j]``, s = 1,
    2, 4, ...  A run combines only its own terms, in an order fixed by the
    positions: ``torch.add`` gives each run's sum at its last entry,
    ``torch.maximum`` of 0/1 flags its OR."""
    M = vals.shape[1]
    acc = vals
    s = 1
    while s < M:
        nxt = acc.clone()
        nxt[:, s:] = combine(acc[:, s:], torch.where(
            cols[:, :-s] == cols[:, s:], acc[:, :-s], 0))
        acc = nxt
        s *= 2
    return acc


def _left_pack(mask: torch.Tensor, width: int, pairs) -> list:
    """Left-pack the slots of each row where ``mask`` holds into ``width``
    slots, in slot order (``tpusolve``'s cursor packs and slot-key sorts);
    ``pairs``: (array, fill) tuples of (rows, K) arrays.  Slots past
    ``width`` are dropped."""
    rows = mask.shape[0]
    slot = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask & (slot < width), slot, width)
    out = []
    for arr, fill in pairs:
        buf = torch.full((rows, width + 1), fill, dtype=arr.dtype,
                         device=arr.device)
        buf.scatter_(1, slot, arr)
        out.append(buf[:, :width].contiguous())
    return out


def _chunks(n: int, row_bytes: int, budget: int):
    """Row slices of at least 256 rows (a multiple of 256) whose
    temporaries of ``row_bytes`` a row stay within ``budget``."""
    chunk = max(256, min(n, budget // max(row_bytes, 1)))
    chunk = _round_up(chunk, 256)
    return [slice(s, min(n, s + chunk)) for s in range(0, n, chunk)]


# ----------------------------------------------------------------------
# input staging

def _stage_ell(A: ShardedMatrix, A_host):
    """(vals, cols) (rows, K) padded ELL of ``A`` on its device, columns
    int64: the ELL arrays where ``tpusolve`` stores ``A`` ELL (a
    row-pointer operator unpacked, one the port stores otherwise laid out
    ELL from its entries, as ``ilu/device_setup.py`` does), else packed
    from the host CSR with ``K = max(8, round_up(max count, 8))``, each row
    in the CSR's order (``tpusolve``'s ``_stage_ell``)."""
    if A.tpusolve_layout == "ell":
        vals, cols = _ell_padded(A)
        return vals, cols.long()
    M = A_host.tocsr()
    n = M.shape[0]
    counts = np.diff(M.indptr)
    K = max(8, _round_up(int(counts.max(initial=0)), 8))
    dev = A.device
    counts_t = torch.from_numpy(counts.astype(np.int64)).to(dev)
    row = torch.repeat_interleave(torch.arange(n, device=dev), counts_t)
    start = torch.from_numpy(M.indptr[:-1].astype(np.int64)).to(dev)
    slot = torch.arange(M.nnz, device=dev) - start[row]
    vals = torch.zeros((A.row_pad, K), dtype=A.dtype, device=dev)
    cols = torch.zeros((A.row_pad, K), dtype=torch.int64, device=dev)
    vals[row, slot] = torch.from_numpy(M.data).to(dev, A.dtype)
    cols[row, slot] = torch.from_numpy(M.indices.astype(np.int64)).to(dev)
    return vals, cols


# ----------------------------------------------------------------------
# strength + PMIS

def _strength(vals, cols, n: int, theta: float):
    """Strength mask on the ELL slots (``strength.classical_strength``):
    ``(S, diag, offd)``."""
    n_pad = vals.shape[0]
    rows = torch.arange(n_pad, device=vals.device)[:, None]
    offd = cols != rows
    diag = _rowsum(torch.where(offd, 0.0, vals))
    sflip = torch.where(diag < 0, -1.0, 1.0).to(vals.dtype)
    # padding slots carry cand 0 and never pass cand > 0
    cand = torch.where(offd, -vals * sflip[:, None], -torch.inf)
    rowmax = cand.amax(dim=1)
    S = (cand >= theta * rowmax[:, None]) & (cand > 0) & (rows < n)
    return S, diag, offd


def _pmis_round(state, w, scols, Smk, rows, wa_full):
    """One PMIS round on ``rows`` (indices of the rows it decides, with
    their packed strong columns ``scols`` and mask ``Smk``): the new C
    points are the undecided rows whose key beats every neighbour's in
    S and S^T, the new F points the undecided rows with a strong new C
    column.  ``wa_full``: the keys of the undecided rows over all rows, 0
    elsewhere.  Returns the rows' new states."""
    st = state[rows]
    active = st == UND
    wa = torch.where(active, w[rows], 0)
    m_row = torch.where(Smk, wa_full[scols], 0).amax(dim=1)
    m_colT = torch.zeros_like(wa_full).scatter_reduce_(
        0, scols.reshape(-1), torch.where(Smk, wa[:, None], 0).reshape(-1),
        "amax")
    newC = active & (wa > torch.maximum(m_row, m_colT[rows]))
    newC_full = torch.zeros(state.shape[0], dtype=torch.bool,
                            device=state.device)
    newC_full[rows] = newC
    hit = (Smk & newC_full[scols]).any(dim=1)
    st = torch.where(newC, C_PT, st)
    return torch.where(active & ~newC & hit, F_PT, st)


def _pmis(S, cols, rank, n: int, max_rounds: int):
    """PMIS C/F split (``coarsen.pmis``; ``tpusolve``'s
    ``_pmis_phase_a_jit`` and ``_pmis_phase_b_jit``): rounds over every row
    until the undecided rows fit ``m0``, then rounds over those rows alone
    (undecided rows only leave the set); undecided rows after
    ``max_rounds`` become C.  Keys are exact integers, influence first,
    then the host ranks.  Returns (state, rounds)."""
    n_pad = S.shape[0]
    dev = S.device
    Ks = max(1, int(S.sum(dim=1).max()))
    scols, = _left_pack(S, Ks, [(cols, n_pad - 1)])
    Smk = torch.arange(Ks, device=dev)[None] < S.sum(dim=1)[:, None]
    influence = torch.bincount(scols[Smk], minlength=n_pad)
    w = _pmis_keys(influence, rank)
    valid = torch.arange(n_pad, device=dev) < n
    state = torch.where((influence == 0) | ~valid, F_PT, UND)
    m0 = min(n_pad, max(4096, 1 << max(0, n_pad // 16 - 1).bit_length()))
    all_rows = torch.arange(n_pad, device=dev)
    rem = int((state == UND).sum())
    it = 0
    while it < max_rounds and rem > m0:
        state = _pmis_round(state, w, scols, Smk, all_rows,
                            torch.where(state == UND, w, 0))
        rem = int((state == UND).sum())
        it += 1
    act = torch.nonzero(state == UND).reshape(-1)
    sc_a, sm_a = scols[act], Smk[act]
    while it < max_rounds and rem > 0:
        state[act] = _pmis_round(state, w, sc_a, sm_a, act,
                                 torch.where(state == UND, w, 0))
        rem = int((state[act] == UND).sum())
        it += 1
    state = torch.where(state == UND, C_PT, state)
    return torch.where(valid, state, F_PT), it


# ----------------------------------------------------------------------
# interpolation

def _interp_direct(vals, cols, S, offd, is_C, cmap, diag):
    """Direct interpolation (``interp.direct_interpolation``): (w, pcol,
    keep) on the ELL slots, C rows left out."""
    strongC = S & is_C[cols]
    neg, pos = vals < 0, vals > 0
    sum_neg = _rowsum(torch.where(offd & neg, vals, 0.0))
    sum_pos = _rowsum(torch.where(offd & pos, vals, 0.0))
    sC_neg = _rowsum(torch.where(strongC & neg, vals, 0.0))
    sC_pos = _rowsum(torch.where(strongC & pos, vals, 0.0))
    alpha = torch.where(sC_neg != 0, sum_neg / torch.where(
        sC_neg != 0, sC_neg, 1.0), 0.0)
    beta = torch.where(sC_pos != 0, sum_pos / torch.where(
        sC_pos != 0, sC_pos, 1.0), 0.0)
    dlump = torch.where(sC_pos == 0, sum_pos, 0.0)
    dii = diag + dlump
    dii = torch.where(dii != 0, dii, 1.0)
    keep = strongC & ~is_C[:, None]
    scale = torch.where(vals < 0, alpha[:, None], beta[:, None])
    w = torch.where(keep, -scale * vals / dii[:, None], 0.0)
    pcol = torch.where(keep, cmap[cols], 0)
    return w, pcol, keep


def _strong_sets(vals, cols, S, offd, is_C):
    """The distance-2 interpolations' inputs (``_classical_masks_jit`` and
    the packs): the strong-C slots packed to (rows, Kc) (vals, cols,
    counts), the strong-F ones to (rows, KF) (vals, cols, counts), and the
    weak off-diagonal row sums."""
    isC_col = is_C[cols]
    strongC = S & isC_col
    strongF = S & ~isC_col
    weaksum = _rowsum(torch.where(offd & ~S, vals, 0.0))
    ccnt = strongC.sum(dim=1)
    fcnt = strongF.sum(dim=1)
    Kc = max(1, int(ccnt.max()))
    KF = max(1, int(fcnt.max()))
    scv, scc = _left_pack(strongC, Kc, [(vals, 0.0), (cols, 0)])
    fv, fc = _left_pack(strongF, KF, [(vals, 0.0), (cols, 0)])
    return (scv, scc, ccnt), (fv, fc, fcnt), strongC, weaksum


def _probe(keys, vals, cols, diag, k):
    """Neighbour row ``k`` (one a row) of the ELL against each row's sorted
    column set ``keys`` (INF on dead slots): its hat entries (the sign
    opposite to its diagonal), the slot of each column in ``keys`` and
    whether it is there."""
    bv, bc = vals[k], cols[k]
    hv = torch.where(bv * diag[k][:, None] < 0, bv, 0.0)
    width = keys.shape[1]
    s = torch.searchsorted(keys, bc)
    cand = torch.gather(keys, 1, torch.clamp(s, max=width - 1))
    member = (cand == bc) & (s < width)
    return hv, s, member, bc


def _add_to_slots(T, s, member, terms):
    """``T[i, s[i, j]] += terms[i, j]`` where ``member``: distinct slots a
    row (a neighbour row's columns are distinct; its padding adds exact
    zeros), the rest into the spare last column."""
    T.scatter_add_(1, torch.where(member, s, T.shape[1] - 1), terms)


def _classical_chunk(fv, fc, scv, scc, ccnt, diag_c, weak_c, vals, cols,
                     diag, KF: int):
    """One row chunk of classical-modified weights
    (``_classical_chunk_jit``): (w, keys) over the strong-C slots sorted by
    column (0 and INF on dead slots)."""
    C_, Kc = scv.shape
    scm = torch.arange(Kc, device=scv.device)[None] < ccnt[:, None]
    key_s, idx = torch.sort(torch.where(scm, scc, _I32_MAX), dim=1,
                            stable=True)
    scv_s = torch.gather(scv, 1, idx)
    T = torch.zeros((C_, Kc + 1), dtype=vals.dtype, device=vals.device)
    dlump = torch.zeros(C_, dtype=vals.dtype, device=vals.device)
    for t in range(KF):
        hv, s, member, _ = _probe(key_s, vals, cols, diag, fc[:, t])
        hvm = torch.where(member, hv, 0.0)
        d = _rowsum(hvm)
        fvt = fv[:, t]
        W = torch.where(d != 0, fvt / torch.where(d != 0, d, 1.0), 0.0)
        dlump = dlump + torch.where(d == 0, fvt, 0.0)
        _add_to_slots(T, s, member, W[:, None] * hvm)
    dii = diag_c + weak_c + dlump
    dii = torch.where(dii != 0, dii, 1.0)
    live = key_s < _I32_MAX
    w = torch.where(live, -(scv_s + T[:, :Kc]) / dii[:, None], 0.0)
    return w, key_s


def _interp_classical(vals, cols, S, offd, is_C, cmap, diag, budget, log):
    """Classical-modified interpolation (``interp.classical_interpolation``,
    ``tpusolve``'s ``_interp_classical_ell``), chunked over rows taken in
    order of descending strong-F count, so that each chunk's loop stops at
    its own largest count.  Returns (w, pcol) over each row's strong-C
    slots sorted by column."""
    n_pad, K = vals.shape
    (scv, scc, ccnt), (fv, fc, fcnt), _, weaksum = _strong_sets(
        vals, cols, S, offd, is_C)
    order = torch.argsort(-fcnt, stable=True)
    fcnt_s = fcnt[order].cpu()
    parts = _chunks(n_pad, K * 8 * 8, budget)
    if log is not None:
        log(f"      classical interp: KF={fv.shape[1]} Kc={scv.shape[1]} "
            f"chunks={len(parts)}")
    ws, keys = [], []
    for sl in parts:
        o = order[sl]
        KF_c = min(fv.shape[1], max(1, _round_up(int(fcnt_s[sl.start]), 4)))
        w, k = _classical_chunk(fv[o, :KF_c], fc[o, :KF_c], scv[o], scc[o],
                                ccnt[o], diag[o], weaksum[o], vals, cols,
                                diag, KF_c)
        ws.append(w)
        keys.append(k)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_pad, device=order.device)
    w = torch.cat(ws)[inv]
    key_s = torch.cat(keys)[inv]
    return w, cmap[torch.where(key_s < _I32_MAX, key_s, 0)]


def _exti_set(vals_c, cols_c, offd_c, strongC_c, fv_c, fc_c, scc, ccnt):
    """A chunk's extended column sets (``_exti_cat`` and the run collapse of
    ``_exti_chunk_jit``): each row's own off-diagonal columns (with their
    values; in the pattern where strong C) and each strong-F neighbour's
    strong-C columns (value 0, in the pattern), sorted, each column's run
    summed; the pattern's columns left-packed.  Returns (keys (rows, W)
    INF-padded, a_ij on them)."""
    C_ = vals_c.shape[0]
    KF, Kc = fc_c.shape[1], scc.shape[1]
    own_cols = torch.where(offd_c & (vals_c != 0), cols_c, _I32_MAX)
    own_vals = torch.where(own_cols < _I32_MAX, vals_c, 0.0)
    nb_live = (torch.arange(Kc, device=vals_c.device)[None, None]
               < ccnt[fc_c][:, :, None]) & (fv_c != 0)[:, :, None]
    nb_cols = torch.where(nb_live, scc[fc_c], _I32_MAX).reshape(C_, KF * Kc)
    cat_c = torch.cat([own_cols, nb_cols], dim=1)
    cat_v = torch.cat([own_vals, torch.zeros(
        (C_, KF * Kc), dtype=vals_c.dtype, device=vals_c.device)], dim=1)
    cat_p = torch.cat([strongC_c.long(), nb_live.reshape(C_, -1).long()],
                      dim=1)
    c_s, idx = torch.sort(cat_c, dim=1, stable=True)
    val_run = _run_scan(torch.gather(cat_v, 1, idx), c_s, torch.add)
    pat_run = _run_scan(torch.gather(cat_p, 1, idx), c_s, torch.maximum)
    end = torch.ones_like(c_s, dtype=torch.bool)
    end[:, :-1] = c_s[:, :-1] != c_s[:, 1:]
    end &= (c_s < _I32_MAX) & (pat_run > 0)
    width = max(1, int(end.sum(dim=1).max()))
    key_s, idx = torch.sort(torch.where(end, c_s, _I32_MAX), dim=1,
                            stable=True)
    keys = key_s[:, :width].contiguous()
    aon = torch.where(keys < _I32_MAX,
                      torch.gather(val_run, 1, idx[:, :width]), 0.0)
    return keys, aon


def _exti_chunk(keys, aon, fv_c, fc_c, diag_c, weak_c, vals, cols, diag,
                rows_i):
    """One row chunk of extended+i weights (``_exti_chunk_jit``) over the
    chunk's extended sets: (w, keys).  ``rows_i``: the chunk's rows'
    own column ids, in the space of ``cols``."""
    C_, width = keys.shape
    T = torch.zeros((C_, width + 1), dtype=vals.dtype, device=vals.device)
    dlump = torch.zeros(C_, dtype=vals.dtype, device=vals.device)
    backflow = torch.zeros_like(dlump)
    for t in range(fc_c.shape[1]):
        hv, s, member, bc = _probe(keys, vals, cols, diag, fc_c[:, t])
        hvm = torch.where(member, hv, 0.0)
        hat_i = _rowsum(torch.where(bc == rows_i[:, None], hv, 0.0))
        d = _rowsum(hvm) + hat_i
        fvt = fv_c[:, t]
        W = torch.where(d != 0, fvt / torch.where(d != 0, d, 1.0), 0.0)
        dlump = dlump + torch.where(d == 0, fvt, 0.0)
        backflow = backflow + W * hat_i
        _add_to_slots(T, s, member, W[:, None] * hvm)
    dii = diag_c + weak_c + dlump + backflow
    dii = torch.where(dii != 0, dii, 1.0)
    live = keys < _I32_MAX
    w = torch.where(live, -(aon + T[:, :width]) / dii[:, None], 0.0)
    return w, keys


def _interp_exti(vals, cols, S, offd, is_C, cmap, diag, budget, log):
    """Extended+i interpolation (``interp.extended_i_interpolation``,
    ``tpusolve``'s ``_interp_exti_ell``), chunked over rows.  Returns (w,
    pcol) over each row's extended columns sorted."""
    n_pad, K = vals.shape
    (scv, scc, ccnt), (fv, fc, _), strongC, weaksum = _strong_sets(
        vals, cols, S, offd, is_C)
    KF, Kc = fc.shape[1], scc.shape[1]
    parts = _chunks(n_pad, (K + KF * Kc) * 8 * 4, budget)
    ws, keys = [], []
    for sl in parts:
        kc, aon = _exti_set(vals[sl], cols[sl], offd[sl], strongC[sl],
                            fv[sl], fc[sl], scc, ccnt)
        w, k = _exti_chunk(kc, aon, fv[sl], fc[sl], diag[sl], weaksum[sl],
                           vals, cols, diag,
                           torch.arange(sl.start, sl.stop, device=vals.device))
        ws.append(w)
        keys.append(k)
    Kce = _round_up(max(k.shape[1] for k in keys), 4)
    if log is not None:
        log(f"      ext+i interp: KF={KF} Kc={Kc} Kce={Kce} "
            f"chunks={len(parts)}")
    pad = lambda a, fill: torch.nn.functional.pad(
        a, (0, Kce - a.shape[1]), value=fill)
    w = torch.cat([pad(a, 0.0) for a in ws])
    key_s = torch.cat([pad(a, _I32_MAX) for a in keys])
    return w, cmap[torch.where(key_s < _I32_MAX, key_s, 0)]


def _pack_p(w, pcol, keep, is_C, cmap, pw: int):
    """(Pv, Pc, nnz): P's ELL (rows, Kp), ``Kp = max(8, round_up(pw, 8))``,
    from weight planes: each F row's ``keep`` slots left-packed in slot
    order, each C row the identity at ``cmap`` in slot 0
    (``_interp_direct_jit``'s and ``_pack_p_from_w_jit``'s packs)."""
    Kp = max(8, _round_up(max(pw, 1), 8))
    keep = keep & ~is_C[:, None]
    Pv, Pc = _left_pack(keep, Kp, [(w, 0.0), (pcol, 0)])
    Pv[:, 0] = torch.where(is_C, 1.0, Pv[:, 0])
    Pc[:, 0] = torch.where(is_C, cmap, Pc[:, 0])
    return Pv, Pc, int(keep.sum()) + int(is_C.sum())


# ----------------------------------------------------------------------
# sort-based sparse products and R = P^T

def _run_pack(termM, colsM, sentinel: int):
    """Rows of terms at columns (``sentinel`` on dead slots) -> each row's
    distinct columns in order with their terms summed: a stable sort by
    column, each run summed by :func:`_run_scan`, the run ends
    left-packed (``tpusolve``'s ``_pack_runs``).  Returns (vals, cols,
    counts), (rows, widest row), dead slots value 0 and column 0."""
    cols_s, idx = torch.sort(colsM, dim=1, stable=True)
    runsum = _run_scan(torch.gather(termM, 1, idx), cols_s, torch.add)
    del idx
    end = torch.ones_like(cols_s, dtype=torch.bool)
    end[:, :-1] = cols_s[:, :-1] != cols_s[:, 1:]
    end &= cols_s < sentinel
    cnt = end.sum(dim=1)
    width = max(1, int(cnt.max())) if cnt.numel() else 1
    key_s, idx = torch.sort(torch.where(end, cols_s, sentinel), dim=1,
                            stable=True)
    oc = key_s[:, :width]
    ok = oc < sentinel
    return (torch.where(ok, torch.gather(runsum, 1, idx[:, :width]), 0.0),
            torch.where(ok, oc, 0), cnt)


def _product(Av, Ac, Bv, Bc, sentinel: int, budget: int):
    """ELL x ELL -> ELL (``tpusolve``'s ``_chunked_product``), chunked over
    the left factor's rows: each chunk's terms expanded to (rows, K * Kb),
    stable-sorted by column, each column's run summed (:func:`_run_scan`),
    the run ends left-packed.  Returns (vals, cols, K, nnz), ``K = max(8,
    round_up(widest row, 8))``; nnz counts the runs, cancelled ones too."""
    n_pad, K = Av.shape
    Kb = Bv.shape[1]
    ovs, ocs = [], []
    nnz = kmax = 0
    for sl in _chunks(n_pad, K * Kb * 8, budget):
        av, ac = Av[sl], Ac[sl]
        bv, bc = Bv[ac], Bc[ac]
        ok = (av != 0)[:, :, None] & (bv != 0)
        C_ = av.shape[0]
        colsM = torch.where(ok, bc, sentinel).reshape(C_, -1)
        termM = torch.where(ok, av[:, :, None] * bv, 0.0).reshape(C_, -1)
        del bv, bc, ok
        ov, oc, cnt = _run_pack(termM, colsM, sentinel)
        del colsM, termM
        nnz += int(cnt.sum())
        kmax = max(kmax, oc.shape[1])
        ovs.append(ov)
        ocs.append(oc)
    Kout = max(8, _round_up(kmax, 8))
    pad = lambda a: torch.nn.functional.pad(a, (0, Kout - a.shape[1]))
    return (torch.cat([pad(a) for a in ovs]),
            torch.cat([pad(a) for a in ocs]), Kout, nnz)


def _transpose(Pv, Pc, nc: int):
    """R = P^T as (nc, Kr) ELL (``_p_coo_sorted``, ``_pack_transpose``):
    P's entries stable-sorted by coarse column, each coarse row's entries
    in fine-row order, ``Kr = max(8, round_up(widest row, 8))``."""
    n_pad, Kp = Pv.shape
    dev = Pv.device
    rows = torch.arange(n_pad, device=dev).repeat_interleave(Kp)
    vals = Pv.reshape(-1)
    key = torch.where(vals != 0, Pc.reshape(-1), _I32_MAX)
    key_s, idx = torch.sort(key, stable=True)
    rows_s, vals_s = rows[idx], vals[idx]
    valid = key_s < _I32_MAX
    rr = torch.where(valid, key_s, nc)
    Kr = max(8, _round_up(int(torch.bincount(rr, minlength=nc + 1)[:nc]
                              .max()), 8))
    pos = torch.arange(key_s.numel(), device=dev)
    start = torch.ones_like(valid)
    start[1:] = key_s[1:] != key_s[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, -1), dim=0).values
    kk = torch.where(valid & (rank < Kr), rank, Kr)
    Rv = torch.zeros((nc + 1, Kr + 1), dtype=Pv.dtype, device=dev)
    Rc = torch.zeros((nc + 1, Kr + 1), dtype=torch.int64, device=dev)
    Rv[rr, kk] = vals_s
    Rc[rr, kk] = rows_s
    return Rv[:nc, :Kr].contiguous(), Rc[:nc, :Kr].contiguous()


# ----------------------------------------------------------------------
# orchestrator

def device_level0_ell(A: ShardedMatrix, cfg, *, A_host=None,
                      seed: int = 1234, log=None, budget: int = BUDGET):
    """Set up one level of ``A`` on its device (``tpusolve``'s
    ``device_level0_ell``).

    Returns None when coarsening stalls (no C point, or all C), else the
    dict of ``device_setup.device_level0``: ``Cmask``, ``nc``, ``P``, ``R``
    and ``Ac`` as ELL operators on the device (each in the form K2's model
    prices cheaper), ``Ah_c_fn`` (the coarse operator as a sorted host CSR,
    fetched only when called), ``dinv``, ``dinv_l1``, ``coarse_row_offsets``
    and ``seconds`` (wall seconds of each stage, the device synchronised at
    each stage's end).  ``log`` (a print-like callable) receives a line per
    stage; ``budget`` bounds each chunked temporary, in bytes.  An operator
    of more than one part is set up by the N-part pipeline
    (``device_setup_ell_mp.device_level0_ell_mp``)."""
    if A.nparts != 1:
        from tpusolve_torch.amg.device_setup_ell_mp import (
            device_level0_ell_mp)
        return device_level0_ell_mp(A, cfg, A_host=A_host, seed=seed,
                                    log=log, budget=budget)
    dev = A.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    seconds = {}
    t = [time.perf_counter()]

    def stage(label):
        sync()
        now = time.perf_counter()
        seconds[label] = now - t[0]
        t[0] = now
        if log is not None:
            log(f"    setup[dev-ell]: {label:24s} {seconds[label]:8.3f}s")

    n = A.shape[0]
    dt = A.dtype
    vals, cols = _stage_ell(A, A_host)
    n_pad, K = vals.shape
    if K > MAX_ELL_K:
        return None
    stage("ELL staging")

    # --- strength + PMIS (exact integer tie-break keys, host ranks) ---
    S, diag, offd = _strength(vals, cols, n, float(cfg.strong_threshold))
    rank = torch.from_numpy(pmis_rank(seed, n, n_pad)).to(dev)
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    state, rounds = _pmis(S, cols, rank, n, max_rounds)
    is_C = state == C_PT
    nc = int(is_C.sum())
    if log is not None:
        log(f"      pmis rounds: {rounds}")
    stage("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation ---
    cmap = torch.cumsum(is_C, dim=0) - 1
    # P's width as tpusolve sizes it: the widest row of kept slots, which
    # for a distance-2 interpolation counts the C rows' weights too
    if cfg.interp_type in (0, 6):
        interp = _interp_classical if cfg.interp_type == 0 else _interp_exti
        w, pcol = interp(vals, cols, S, offd, is_C, cmap, diag, budget, log)
        keep = w != 0
    else:
        w, pcol, keep = _interp_direct(vals, cols, S, offd, is_C, cmap,
                                       diag)
    Pv, Pc, nnz_p = _pack_p(w, pcol, keep, is_C, cmap,
                            int(keep.sum(dim=1).max()))
    del S, w, pcol, keep
    dinv = 1.0 / torch.where(diag != 0, diag, 1.0)
    l1 = _rowsum(vals.abs())
    dinv_l1 = 1.0 / torch.where(l1 != 0, l1, 1.0)
    stage("interpolation")

    # --- W = A P, R = P^T, Ac = R W ---
    Wv, Wc, _, _ = _product(vals, cols, Pv, Pc, nc, budget)
    if log is not None:
        log(f"      spgemm[A@P]: K={Wv.shape[1]}")
    stage("A@P")
    Rv, Rc = _transpose(Pv, Pc, nc)
    stage("R = P^T")
    Acv, Acc, Kc, nnz_c = _product(Rv, Rc, Wv, Wc, nc, budget)
    del Wv, Wc
    if log is not None:
        log(f"      spgemm[R@(AP)]: K={Kc} nnz={nnz_c}")
    stage("R@(AP)")

    rows_c = torch.arange(nc, device=dev)[:, None]
    dmain = _rowsum(torch.where((Acc == rows_c) & (Acv != 0), Acv, 0.0))
    dmain = torch.where(dmain == 0, 1.0, dmain)
    # ELL in the form K2's model prices cheaper; nnz as tpusolve counts it
    Ac_sh = from_device_ell_parts((nc, nc), Acv, Acc, dmain, nnz_c)
    P_sh = from_device_ell_parts((n, nc), Pv, Pc, nnz=nnz_p)
    R_sh = from_device_ell_parts((nc, n), Rv, Rc, nnz=nnz_p)
    del Acv, Acc, Pv, Pc, Rv, Rc
    stage("P/R/Ac wrap")
    return dict(Cmask=is_C.to(dt), nc=nc, P=P_sh, R=R_sh, Ac=Ac_sh,
                Ah_c_fn=lambda: host_csr(Ac_sh), dinv=dinv, dinv_l1=dinv_l1,
                coarse_row_offsets=np.array([0, nc], np.int64),
                seconds=seconds)
