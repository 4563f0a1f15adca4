"""C/F splitting (coarsening) (the port of ``tpusolve/amg/coarsen.py``).

PMIS (parallel modified independent set, De Sterck-Yang-Heys) is the
data-parallel algorithm: every step is a neighborhood max.  The
``coarsen_type`` codes the reference exposes (src/HypreSystem.cpp:125-126;
default 8 = PMIS) map as in ``tpusolve``:

    0/7 (CLJP family), 8 (PMIS), 10 (HMIS), 21/22 (CGC) -> PMIS
    1/3/6 (RS, RS3, Falgout)                            -> serial RS

PMIS and RS run in the native kernels ``sk_pmis`` and ``sk_rs_coarsen``
(``amg/spk.py``), the aggressive pass's distance-2 product in its SpGEMM,
as ``tpusolve`` runs them; :func:`pmis_rounds` is PMIS in numpy, the plain
version.  Serial RS is the reference's own default coarsening (Falgout
reduces to RS on one process); it has no numpy version in either package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.amg import spk
from tpusolve_torch.amg.galerkin import spgemm

F_PT, C_PT, UNDECIDED = 0, 1, -1


def pmis(S: sp.csr_matrix, seed: int = 1234) -> np.ndarray:
    """PMIS C/F splitting.

    S is the strength pattern (S[i,j]=1 iff j strongly influences i).
    Returns an int array: 1 = C-point, 0 = F-point.
    """
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    S = S.tocsr()

    # measure: number of points i strongly influences (|S^T row|) + rand
    rng = np.random.default_rng(seed)
    influence = np.bincount(S.indices, minlength=n).astype(np.float64)
    w = influence + rng.random(n)
    # the native kernel: the same synchronous rounds on the same w, with
    # active-set shrinking
    state = spk.pmis(S, w)
    return pmis_rounds(S, w) if state is None else state


def pmis_rounds(S: sp.csr_matrix, w: np.ndarray) -> np.ndarray:
    """PMIS's synchronous rounds in numpy on measures ``w``
    (``tpusolve``'s fallback of ``sk_pmis``, the plain version)."""
    S = S.tocsr()
    n = S.shape[0]
    influence = np.bincount(S.indices, minlength=n)
    St = S.T.tocsr()

    state = np.full(n, UNDECIDED, np.int64)
    # PMIS: initial F-points are those with measure < 1 (no influence)
    state[influence == 0] = F_PT

    # symmetrized adjacency for the independent-set test
    G = ((S + St) > 0).tocsr()

    active = state == UNDECIDED
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    for _ in range(max_rounds):
        if not active.any():
            break
        # candidate C: w[i] > w[j] for all active graph neighbors j
        w_active = np.where(active, w, -1.0)
        nbr_max = _neighbor_max(G, w_active)
        is_max = active & (w_active > nbr_max)
        state[is_max] = C_PT
        # any active point strongly influenced BY a new C-point becomes F:
        # i is F if S[i, j] = 1 for some new C j
        newC = np.zeros(n)
        newC[is_max] = 1.0
        influenced = (S @ newC) > 0
        becomes_F = active & ~is_max & influenced
        state[becomes_F] = F_PT
        active = state == UNDECIDED
    # leftovers (ties exhausted rounds): make them C for safety
    state[state == UNDECIDED] = C_PT
    return state


def _neighbor_max(G: sp.csr_matrix, w: np.ndarray) -> np.ndarray:
    """max over graph neighbors of w (excluding self), -1 for no neighbors."""
    n = G.shape[0]
    out = np.full(n, -1.0)
    indptr, indices = G.indptr, G.indices
    counts = np.diff(indptr)
    nonempty = counts > 0
    if nonempty.any():
        vals = w[indices]
        out[nonempty] = np.maximum.reduceat(vals, indptr[:-1][nonempty])
    return out


def aggressive_pmis(S: sp.csr_matrix, seed: int = 1234) -> np.ndarray:
    """Two-pass aggressive coarsening (``agg_num_levels`` levels use this;
    ref: src/HypreSystem.cpp:207-213).  BoomerAMG's A2 scheme: a standard
    PMIS pass, then a second PMIS over the *distance-2 strength graph
    restricted to first-pass C-points* — only the survivors stay C.  Final
    C-points are distance <= 2 from every F-point, so interpolation must be
    distance-2 capable (multipass / extended)."""
    n = S.shape[0]
    split1 = pmis(S, seed=seed)
    C1 = np.flatnonzero(split1 == C_PT)
    if C1.size <= 1:
        return split1
    # distance-2 strength restricted to C1, without materializing the full
    # (Sb @ Sb) graph: (Sb@Sb)[C1][:, C1] == Sb[C1] @ Sb[:, C1]
    Sb = S.tocsr().astype(bool)
    Sb_rows = Sb[C1]                       # (|C1|, n)
    Sb_cols = Sb.tocsc()[:, C1].tocsr()    # (n, |C1|)
    prod = spgemm(Sb_rows.astype(np.float64), Sb_cols.astype(np.float64))
    S2 = (prod.astype(bool) + Sb_rows[:, C1]).tocsr()
    S2.setdiag(False)
    S2.eliminate_zeros()
    sub = pmis(S2.astype(np.float64), seed=seed + 1)
    # a first-pass C-point isolated in the restricted graph (no other
    # C1 within distance 2) must stay C: demoting it would strand its
    # F-children with no coarse anchor at any distance
    isolated = np.diff(S2.indptr) == 0
    sub[isolated] = C_PT
    split = np.full(n, F_PT, np.int64)
    split[C1[sub == C_PT]] = C_PT
    return split


# hypre coarsen_type codes: 0=CLJP, 1=RS(classical), 3=RS(strong boundary),
# 6=Falgout, 7=CLJP-c, 8=PMIS, 10=HMIS, 21/22=CGC.  CLJP-family codes map to
# the PMIS independent-set path; the serial-RS kernel backs the RS family
COARSEN_MAP = {
    0: "pmis", 1: "rs", 3: "rs", 6: "rs", 7: "pmis", 8: "pmis", 10: "pmis",
    21: "pmis", 22: "pmis",
}


def coarsen(S: sp.csr_matrix, coarsen_type: int = 8, seed: int = 1234):
    """Dispatch on the reference's coarsen_type codes -> (splitting, note).

    note records any substitution performed (CLJP-family codes mapped to
    PMIS, the RS family run as serial RS) for reporting parity with
    BoomerAMG settings, in ``tpusolve``'s words.
    """
    algo = COARSEN_MAP.get(coarsen_type)
    if algo is None:
        raise ValueError(f"unsupported coarsen_type {coarsen_type}")
    note = None
    if algo == "rs":
        # classical Ruge-Stueben, first and second pass, by the native
        # kernel: the exact serial semantics of the reference's coarsen_type
        # 6 (Falgout reduces to RS on one process)
        split = spk.rs_coarsen(S)
        if split is None:
            raise ValueError(f"coarsen_type {coarsen_type}: the strength "
                             "graph exceeds the RS kernel's int32 indexing")
        if coarsen_type == 6:
            note = ("coarsen_type 6 (Falgout) run as serial RS "
                    "(Falgout reduces to RS without subdomains)")
        elif coarsen_type == 3:
            note = ("coarsen_type 3 (RS + strong boundary) run as "
                    "serial RS (no subdomain boundaries single-process)")
        return split, note
    if coarsen_type not in (8,):
        note = (f"coarsen_type {coarsen_type} mapped to PMIS "
                "(CLJP-family independent-set coarsening, "
                "data-parallel TPU policy)")
    return pmis(S, seed=seed), note
