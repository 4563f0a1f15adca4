"""Galerkin coarse-grid operator: A_c = R A P (R = P^T) (the port of
``tpusolve/amg/galerkin.py``: the two products by the native SpGEMM,
``amg/spk.py``, as ``tpusolve`` computes them).

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

from tpusolve_torch.amg import spk


def spgemm(X: sp.csr_matrix, Y: sp.csr_matrix) -> sp.csr_matrix:
    """X @ Y by the native SpGEMM, or scipy's where it declines."""
    out = spk.spgemm(X, Y)
    return (X @ Y).tocsr() if out is None else out


def rap(A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    AP = spgemm(A.tocsr(), P.tocsr())
    Ac = spgemm(P.T.tocsr(), AP)
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
