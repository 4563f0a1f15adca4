"""Galerkin coarse-grid operator: A_c = R A P (R = P^T) (the port of
``tpusolve/amg/galerkin.py``, with scipy's sparse products where
``tpusolve`` calls its native SpGEMM).

The sparse triple product BoomerAMG performs per level (``rap2`` /
``keep_transpose`` knobs ref: src/HypreSystem.cpp:184-190), plus the
non-Galerkin sparsification tolerances (``non_galerkin_tol`` /
``nongalerk_tol`` per level, ref: src/HypreSystem.cpp:161-178) which drop
small coarse-level entries to bound operator growth, with dropped mass
lumped onto the diagonal to preserve row sums.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rap(A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    AP = (A.tocsr() @ P.tocsr()).tocsr()
    Ac = (P.T.tocsr() @ AP).tocsr()
    Ac.sum_duplicates()
    # drop exact cancellations (stencil RAP produces them in droves)
    Ac.eliminate_zeros()
    return Ac


def nongalerkin_sparsify(Ac: sp.csr_matrix, tol: float) -> sp.csr_matrix:
    """Drop |a_ij| < tol * max_j |a_ij| off-diagonals, lumping the dropped
    values onto the diagonal (row-sum preserving)."""
    if tol <= 0:
        return Ac
    Ac = Ac.tocsr()
    n = Ac.shape[0]
    rows = np.repeat(np.arange(n), np.diff(Ac.indptr))
    cols = Ac.indices
    vals = Ac.data
    absv = np.abs(vals)
    row_max = np.zeros(n)
    nonempty = np.diff(Ac.indptr) > 0
    if nonempty.any():
        row_max[nonempty] = np.maximum.reduceat(
            absv, Ac.indptr[:-1][nonempty])
    offd = cols != rows
    drop = offd & (absv < tol * row_max[rows])
    lump = np.bincount(rows[drop], weights=vals[drop], minlength=n)
    keep = ~drop
    out = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=Ac.shape)
    out = out + sp.diags(lump)
    return out.tocsr()
