"""Interpolation operator construction (the port of
``tpusolve/amg/interp.py``, its numpy and scipy paths).

Covers the reference's ``interp_type`` codes (src/HypreSystem.cpp:192-193;
default 0 in etc/hypre_app.yaml:41):

* 0  — classical *modified* interpolation (Ruge-Stueben distance-1 with
       weak-connection lumping and F-F redistribution)
* 3  — direct interpolation
* 4  — multipass (forced on aggressively coarsened levels)
* 6/7 — extended+i; the other distance-2 codes map to it with a note.

All are vectorized over scipy CSR (masked sparse products replace the
per-row loops of the classical formulation), and P's truncation knobs
(``trunc_factor``, ``p_max_elmts``, src/HypreSystem.cpp:195-205) are applied
with row-sum-preserving rescaling as in BoomerAMG.  Where ``tpusolve`` calls
its native kernels (sampled products, SpGEMM, the one-pass classical and
extended+i kernels, the pattern mask), the port calls the same kernels
(``amg/spk.py``), and takes ``tpusolve``'s numpy and scipy fallbacks, the
plain versions (``*_plain``), only where a kernel declines its input.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.amg import spk
from tpusolve_torch.amg.coarsen import C_PT
from tpusolve_torch.amg.galerkin import spgemm


def _on_pattern(vals, Pat: sp.csr_matrix) -> sp.csr_matrix:
    return sp.csr_matrix((vals, Pat.indices.copy(), Pat.indptr.copy()),
                         shape=Pat.shape)


def _sampled_abt(X: sp.csr_matrix, Y: sp.csr_matrix,
                 Pat: sp.csr_matrix) -> sp.csr_matrix:
    """CSR with Pat's exact pattern holding (X @ Y.T)[i, k] there: the
    native SDDMM computes the values at Pat's entries only; the plain
    version materializes the whole (distance-2) product first."""
    vals = spk.masked_abt(X, Y, Pat)
    if vals is not None:
        return _on_pattern(vals, Pat)
    return _restrict_to_pattern((X @ Y.T).tocsr(), Pat)


def _sampled_ab(X: sp.csr_matrix, Y: sp.csr_matrix,
                Pat: sp.csr_matrix) -> sp.csr_matrix:
    """CSR with Pat's exact pattern holding (X @ Y)[i, j] there."""
    vals = spk.masked_ab(X, Y, Pat)
    if vals is not None:
        return _on_pattern(vals, Pat)
    return _restrict_to_pattern((X @ Y).tocsr(), Pat)


def _sampled_transpose(Y: sp.csr_matrix, Pat: sp.csr_matrix) -> sp.csr_matrix:
    """CSR with Pat's exact pattern holding Y^T's values there."""
    vals = spk.sampled_transpose(Y, Pat)
    if vals is not None:
        return _on_pattern(vals, Pat)
    return _restrict_to_pattern(Y.T.tocsr(), Pat)


def _coarse_numbering(splitting: np.ndarray) -> np.ndarray:
    """Map fine index -> coarse index for C-points (-1 for F)."""
    cmap = np.cumsum(splitting == C_PT) - 1
    return np.where(splitting == C_PT, cmap, -1)


def direct_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                         splitting: np.ndarray) -> sp.csr_matrix:
    """Direct interpolation (interp_type 3)."""
    A = A.tocsr()
    n = A.shape[0]
    is_C = splitting == C_PT
    cmap = _coarse_numbering(splitting)
    nc = int(is_C.sum())
    if nc == 0:
        return sp.csr_matrix((n, 0))

    diag = A.diagonal()
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data
    offd = cols != rows

    strong = _pattern_mask(A, S)              # strong entries of A
    strongC = strong & is_C[cols]

    neg = vals < 0
    pos = vals > 0
    # row sums: all neg/pos offd, and strong-C neg/pos
    sum_neg = _rowsum(n, rows, vals, offd & neg)
    sum_pos = _rowsum(n, rows, vals, offd & pos)
    sumC_neg = _rowsum(n, rows, vals, strongC & neg)
    sumC_pos = _rowsum(n, rows, vals, strongC & pos)

    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sumC_neg != 0, sum_neg / sumC_neg, 0.0)
        beta = np.where(sumC_pos != 0, sum_pos / sumC_pos, 0.0)
    # positive connections with no positive strong C: lump into diagonal
    dlump = np.where((sumC_pos == 0), sum_pos, 0.0)
    dii = diag + dlump
    dii = np.where(dii != 0, dii, 1.0)

    keep = strongC & ~is_C[rows]
    r_k, c_k, v_k = rows[keep], cols[keep], vals[keep]
    scale = np.where(v_k < 0, alpha[r_k], beta[r_k])
    w = -scale * v_k / dii[r_k]

    P_rows = np.concatenate([r_k, np.flatnonzero(is_C)])
    P_cols = np.concatenate([cmap[c_k], cmap[is_C]])
    P_vals = np.concatenate([w, np.ones(nc)])
    return sp.csr_matrix((P_vals, (P_rows, P_cols)), shape=(n, nc))


def classical_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                            splitting: np.ndarray) -> sp.csr_matrix:
    """P of interp_type 0 (:func:`classical_interpolation_plain` gives the
    formulas) by the native one-pass kernel ``sk_classical_interp_*``, as
    ``tpusolve`` builds it, where A's and S's columns are sorted; else the
    plain version."""
    A = A.tocsr()
    is_C = splitting == C_PT
    if is_C.any() and A.has_sorted_indices and getattr(
            S, "has_sorted_indices", False):
        P = spk.classical_interp(A, S.tocsr(), is_C,
                                 _coarse_numbering(splitting))
        if P is not None:
            return P
    return classical_interpolation_plain(A, S, splitting)


def classical_interpolation_plain(A: sp.csr_matrix, S: sp.csr_matrix,
                                  splitting: np.ndarray) -> sp.csr_matrix:
    """Classical modified interpolation (interp_type 0).

    For F-point i with strong C-set C_i, strong F-set F_i and weak set W_i:

        P_ij = -( a_ij + sum_{k in F_i} a_ik * hat_a_kj / d_ik ) / tilde_a_ii
        d_ik = sum_{m in C_i} hat_a_km
        tilde_a_ii = a_ii + sum_{k in W_i} a_ik  (+ a_ik where d_ik = 0)

    where hat_a_kj keeps only entries of sign opposite to a_kk.
    """
    A = A.tocsr()
    n = A.shape[0]
    is_C = splitting == C_PT
    is_F = ~is_C
    cmap = _coarse_numbering(splitting)
    nc = int(is_C.sum())
    if nc == 0:
        return sp.csr_matrix((n, 0))

    diag = A.diagonal()
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data
    offd = cols != rows
    strong = _pattern_mask(A, S) & offd
    weak = offd & ~strong

    strongC = strong & is_C[cols]
    strongF = strong & is_F[cols]

    # hat A: entries of sign opposite to the row's diagonal.  Ahat shares
    # A's index arrays (never mutated; explicit zeros are harmless to the
    # masked products); the strong pieces are extracted compactly.
    opp = (vals * diag[rows]) < 0
    Ahat = sp.csr_matrix((np.where(opp, vals, 0.0), cols, A.indptr),
                         shape=A.shape)

    A_sC = _extract_csr(n, n, rows, cols, vals, strongC)
    A_sF = _extract_csr(n, n, rows, cols, vals, strongF)
    SC_pat = sp.csr_matrix((np.ones(A_sC.nnz), A_sC.indices, A_sC.indptr),
                           shape=A.shape)

    # d_ik = sum_{m in C_i} hat_a_km, needed only at A_sF's pattern
    D = _sampled_abt(SC_pat, Ahat, A_sF)

    # k's with d_ik == 0: lump a_ik into the diagonal
    D_data_zero = D.data == 0
    dlump = _rowsum_csr(n, D.indptr, A_sF.data * D_data_zero)

    # W_ik = a_ik / d_ik where d_ik != 0 — written in place into D's data
    np.divide(A_sF.data, D.data, out=D.data, where=~D_data_zero)
    D.data[D_data_zero] = 0.0
    W = D

    # distributed contributions T = W @ Ahat, masked to strong-C pattern of i
    T = _sampled_ab(W, Ahat, A_sC)

    # tilde diagonal: a_ii + weak connections + lumped dead F connections
    sum_weak = _rowsum(n, rows, vals, weak)
    dii = diag + sum_weak + dlump
    dii = np.where(dii != 0, dii, 1.0)

    num = A_sC + T                               # same pattern as A_sC
    num = num.tocsr()
    nrows = np.repeat(np.arange(n), np.diff(num.indptr))
    keep = is_F[nrows]
    r_k = nrows[keep]
    c_k = num.indices[keep]
    w = -num.data[keep] / dii[r_k]

    P_rows = np.concatenate([r_k, np.flatnonzero(is_C)])
    P_cols = np.concatenate([cmap[c_k], cmap[is_C]])
    P_vals = np.concatenate([w, np.ones(nc)])
    P = sp.csr_matrix((P_vals, (P_rows, P_cols)), shape=(n, nc))
    P.eliminate_zeros()
    return P


def truncate(P: sp.csr_matrix, trunc_factor: float = 0.0,
             p_max_elmts: int = 0) -> sp.csr_matrix:
    """BoomerAMG-style interpolation truncation with row-sum-preserving
    rescaling (knobs ref: src/HypreSystem.cpp:195-205)."""
    if trunc_factor <= 0.0 and p_max_elmts <= 0:
        return P
    P = P.tocsr()
    n = P.shape[0]
    indptr, indices, data = P.indptr, P.indices, P.data
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n), counts)
    absv = np.abs(data)
    nonempty = counts > 0
    starts = indptr[:-1]
    row_max = np.zeros(n)
    if nonempty.any():
        row_max[nonempty] = np.maximum.reduceat(absv, starts[nonempty])
    keep = np.ones(data.size, bool)
    if trunc_factor > 0:
        keep &= absv >= trunc_factor * row_max[rows]
    if p_max_elmts > 0 and data.size:
        order = np.lexsort((-absv, rows))       # by row, |v| descending
        rank = np.empty(data.size, np.int64)
        rank[order] = np.arange(data.size) - np.repeat(starts, counts)
        keep &= rank < p_max_elmts
    # row-sum-preserving rescale of the kept entries
    kept_data = np.where(keep, data, 0.0)
    old_sum = np.zeros(n)
    new_sum = np.zeros(n)
    if nonempty.any():
        old_sum[nonempty] = np.add.reduceat(data, starts[nonempty])
        new_sum[nonempty] = np.add.reduceat(kept_data, starts[nonempty])
    scale = np.where(new_sum != 0, old_sum / np.where(new_sum == 0, 1.0,
                                                      new_sum), 1.0)
    out = sp.csr_matrix((kept_data * scale[rows], indices.copy(),
                         indptr.copy()), shape=P.shape)
    out.eliminate_zeros()
    return out


def extended_i_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                             splitting: np.ndarray) -> sp.csr_matrix:
    """P of interp_type 6/7 (:func:`extended_i_interpolation_plain` gives the
    formulas) by the native one-pass kernel ``sk_exti_interp_*``, as
    ``tpusolve`` builds it, where A's and S's columns are sorted; else the
    plain version."""
    A = A.tocsr()
    is_C = splitting == C_PT
    if is_C.any() and A.has_sorted_indices and getattr(
            S, "has_sorted_indices", False):
        P = spk.exti_interp(A, S.tocsr(), is_C,
                            _coarse_numbering(splitting))
        if P is not None:
            return P
    return extended_i_interpolation_plain(A, S, splitting)


def extended_i_interpolation_plain(A: sp.csr_matrix, S: sp.csr_matrix,
                                   splitting: np.ndarray) -> sp.csr_matrix:
    """Extended+i interpolation (interp_type 6/7; De Sterck, Falgout,
    Nolting, Yang, "Distance-two interpolation for parallel algebraic
    multigrid", 2008).  The distance-2 repair for PMIS-style coarsenings.

    Interpolation set C_i^e = C_i ∪ {C_k : k ∈ F_i^s}; weights

        w_ij = -( a_ij + sum_{k in F_i^s} a_ik hat_a_kj / d_ik ) / tilde_a_ii
        d_ik = sum_{m in C_i^e} hat_a_km + hat_a_ki          ("+i" term)
        tilde_a_ii = a_ii + sum_{n in W_i} a_in
                     + sum_{k in F_i^s} a_ik hat_a_ki / d_ik  (k->i backflow)
                     (+ a_ik where d_ik = 0)

    with hat_a keeping only entries of sign opposite to the row diagonal.
    """
    A = A.tocsr()
    n = A.shape[0]
    is_C = splitting == C_PT
    is_F = ~is_C
    cmap = _coarse_numbering(splitting)
    nc = int(is_C.sum())
    if nc == 0:
        return sp.csr_matrix((n, 0))

    diag = A.diagonal()
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data
    offd = cols != rows
    strong = _pattern_mask(A, S) & offd
    weak = offd & ~strong

    strongC = strong & is_C[cols]
    strongF = strong & is_F[cols]

    opp = (vals * diag[rows]) < 0
    Ahat = sp.csr_matrix((np.where(opp, vals, 0.0), cols, A.indptr),
                         shape=A.shape)
    A_sC = _extract_csr(n, n, rows, cols, vals, strongC)
    A_sF = _extract_csr(n, n, rows, cols, vals, strongF)

    # extended interpolation pattern: strong C of i, plus strong C of i's
    # strong F neighbors
    SC_pat = sp.csr_matrix((np.ones(A_sC.nnz), A_sC.indices, A_sC.indptr),
                           shape=A.shape)
    SF_pat = sp.csr_matrix((np.ones(A_sF.nnz), A_sF.indices, A_sF.indptr),
                           shape=A.shape)
    Ce_pat = (SC_pat + spgemm(SF_pat.tocsr(), SC_pat.tocsr())).tocsr()
    Ce_pat.data = np.ones_like(Ce_pat.data)

    # d_ik over A_sF's pattern: sum_m Ce_pat[i,m] Ahat[k,m] + Ahat[k,i]
    # (both built with exactly A_sF's pattern, so their data arrays align
    # 1:1 and add directly)
    D = _sampled_abt(Ce_pat, Ahat, A_sF)
    D.data = D.data + _sampled_transpose(Ahat, A_sF).data

    D_data_zero = D.data == 0
    dlump = _rowsum_csr(n, D.indptr, A_sF.data * D_data_zero)

    # W_ik = a_ik / d_ik where d_ik != 0, written in place into D's data
    np.divide(A_sF.data, D.data, out=D.data, where=~D_data_zero)
    D.data[D_data_zero] = 0.0
    W = D

    # distributed contributions masked to the extended pattern
    T = _sampled_ab(W, Ahat, Ce_pat)
    A_on_Ce = _restrict_to_pattern(A, Ce_pat)

    # k -> i backflow onto the diagonal: sum_k (a_ik / d_ik) * hat_a_ki
    AhatT_on_F = _sampled_transpose(Ahat, A_sF)
    backflow = _rowsum_csr(n, W.indptr, W.data * AhatT_on_F.data)

    sum_weak = _rowsum(n, rows, vals, weak)
    dii = diag + sum_weak + dlump + backflow
    dii = np.where(dii != 0, dii, 1.0)

    num = (A_on_Ce + T).tocsr()
    nrows = np.repeat(np.arange(n), np.diff(num.indptr))
    keep = is_F[nrows] & is_C[num.indices]
    r_k = nrows[keep]
    c_k = num.indices[keep]
    w = -num.data[keep] / dii[r_k]

    P_rows = np.concatenate([r_k, np.flatnonzero(is_C)])
    P_cols = np.concatenate([cmap[c_k], cmap[is_C]])
    P_vals = np.concatenate([w, np.ones(nc)])
    P = sp.csr_matrix((P_vals, (P_rows, P_cols)), shape=(n, nc))
    P.eliminate_zeros()
    return P


def multipass_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                            splitting: np.ndarray) -> sp.csr_matrix:
    """Multipass interpolation (interp/agg_interp type 4; Stueben).

    Distance-2 capable — required after aggressive coarsening, where
    F-points may have no strong C neighbor at distance 1.  Pass 1 is direct
    interpolation on the F-points that do have strong C neighbors; each
    later pass interpolates the remaining F-points *through* their already-
    assigned strong neighbors:

        P_i = sigma_i * sum_{k in K_i} a_ik P_k
        sigma_i = -(sum_{j != i} a_ij) / (a_ii * sum_{k in K_i} a_ik)
    """
    A = A.tocsr()
    n = A.shape[0]
    is_C = splitting == C_PT
    nc = int(is_C.sum())
    if nc == 0:
        return sp.csr_matrix((n, 0))

    diag = A.diagonal()
    diag = np.where(diag != 0, diag, 1.0)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data
    offd = cols != rows
    strong = _pattern_mask(A, S) & offd
    # strong-connection operator (rows = all, cols = all)
    A_s = sp.csr_matrix((np.where(strong, vals, 0.0), cols.copy(),
                         A.indptr.copy()), shape=A.shape)
    A_s.eliminate_zeros()
    rowsum_offd = _rowsum(n, rows, vals, offd)

    # pass 1: direct interpolation for F-points with a strong C neighbor
    P = direct_interpolation(A, S, splitting).tolil(copy=False).tocsr()
    has_sC = np.asarray(
        (A_s @ sp.diags(is_C.astype(float))).getnnz(axis=1)) > 0
    assigned = is_C | (~is_C & has_sC)

    for _ in range(10):
        todo = ~assigned
        if not todo.any():
            break
        # ready: unassigned F with at least one assigned strong neighbor
        asn = sp.diags(assigned.astype(float))
        W = (A_s @ asn).tocsr()
        W.eliminate_zeros()
        ready = todo & (np.diff(W.indptr) > 0)
        if not ready.any():
            break
        sumK = np.asarray(W.sum(axis=1)).ravel()
        denom = diag * np.where(sumK != 0, sumK, 1.0)
        sigma = np.where(ready & (sumK != 0), -rowsum_offd / denom, 0.0)
        P_new = (sp.diags(sigma) @ W) @ P
        mask = sp.diags(ready.astype(float))
        P = P + (mask @ P_new)
        assigned |= ready
    P = P.tocsr()
    P.eliminate_zeros()
    return P


def build_interpolation(A, S, splitting, interp_type: int = 0,
                        trunc_factor: float = 0.0, p_max_elmts: int = 0,
                        require_distance2: bool = False):
    """Dispatch on interp_type -> (P, note).

    ``require_distance2`` is set by the builder on aggressively-coarsened
    levels (ref agg_interp_type, src/HypreSystem.cpp:207-213), where
    F-points may sit at distance 2 from every C-point: any distance-1
    family would leave them uninterpolated, so multipass is enforced."""
    note = None
    if require_distance2 and interp_type != 4:
        note = (f"aggressive level: interp_type {interp_type} replaced by "
                "multipass (distance-2 required)")
        interp_type = 4
    if interp_type == 4:
        P = multipass_interpolation(A, S, splitting)
    elif interp_type == 3:
        P = direct_interpolation(A, S, splitting)
    elif interp_type == 0:
        P = classical_interpolation(A, S, splitting)
    elif interp_type in (6, 7):
        P = extended_i_interpolation(A, S, splitting)
    elif interp_type in (8, 12, 13, 14, 16, 17, 18):
        # remaining distance-2 family codes (standard, FF, extended,
        # adaptive-weight variants) -> extended+i
        P = extended_i_interpolation(A, S, splitting)
        note = f"interp_type {interp_type} mapped to extended+i"
    else:
        raise ValueError(f"unsupported interp_type {interp_type}")
    P = truncate(P, trunc_factor, p_max_elmts)
    return P, note


# ----------------------------------------------------------------------
def _rowsum(n, rows, vals, mask):
    return np.bincount(rows[mask], weights=vals[mask], minlength=n)


def _extract_csr(n, m, rows, cols, vals, mask) -> sp.csr_matrix:
    """Compact CSR of A's entries where ``mask`` holds (rows must be the
    CSR row expansion, so entries stay row- and column-sorted)."""
    idx = np.flatnonzero(mask)
    counts = np.bincount(rows[idx], minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(cols.dtype)
    out = sp.csr_matrix((vals[idx], cols[idx], indptr), shape=(n, m))
    out.has_sorted_indices = True
    return out


def _rowsum_csr(n, indptr, data):
    """Per-row sums of CSR-aligned data without building a matrix."""
    counts = np.diff(indptr)
    out = np.zeros(n)
    ne = counts > 0
    if ne.any():
        out[ne] = np.add.reduceat(data, indptr[:-1][ne])
    return out


def _keys(M: sp.csr_matrix) -> np.ndarray:
    """(row, col) -> single sortable int64 key per stored entry."""
    rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                     np.diff(M.indptr))
    return rows * M.shape[1] + M.indices


def _pattern_mask(A: sp.csr_matrix, S: sp.csr_matrix) -> np.ndarray:
    """Boolean mask over A.data: True where (i,j) is in S's pattern."""
    m = spk.pattern_mask(A, S)
    return _pattern_mask_plain(A, S) if m is None else m


def _pattern_mask_plain(A: sp.csr_matrix, S: sp.csr_matrix) -> np.ndarray:
    """:func:`_pattern_mask` in numpy, for any column order."""
    keyA = _keys(A)
    keyS = np.sort(_keys(S.tocsr()))
    pos = np.searchsorted(keyS, keyA)
    pos = np.clip(pos, 0, max(keyS.size - 1, 0))
    if keyS.size == 0:
        return np.zeros(keyA.size, bool)
    return keyS[pos] == keyA


def _restrict_to_pattern(M: sp.csr_matrix, Pat: sp.csr_matrix) -> sp.csr_matrix:
    """Return a CSR with exactly Pat's sparsity pattern holding M's values
    there (0 where M has no entry).  Output data aligns 1:1 with Pat.data."""
    M = M.tocsr()
    M.sum_duplicates()
    keyM = _keys(M)
    order = np.argsort(keyM, kind="stable")
    keyM_sorted = keyM[order]
    valM_sorted = M.data[order]
    keyP = _keys(Pat)
    pos = np.searchsorted(keyM_sorted, keyP)
    pos_c = np.clip(pos, 0, max(keyM_sorted.size - 1, 0))
    if keyM_sorted.size == 0:
        vals = np.zeros(keyP.size)
    else:
        hit = keyM_sorted[pos_c] == keyP
        vals = np.where(hit, valM_sorted[pos_c], 0.0)
    return sp.csr_matrix((vals, Pat.indices.copy(), Pat.indptr.copy()),
                         shape=Pat.shape)
