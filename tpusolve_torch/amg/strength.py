"""Classical strength-of-connection (the port of ``tpusolve/amg/strength.py``):
the native kernel ``sk_strength`` (``amg/spk.py``), with the numpy version
beside it as its plain version.

The first stage of BoomerAMG setup (configured via ``strong_threshold``,
default 0.57 in the reference: src/HypreSystem.cpp:158-159, yaml
etc/hypre_app.yaml:42).  Classical definition: column j strongly influences
row i iff

    -a_ij >= theta * max_{k != i} (-a_ik)

with the sign convention flipped when the diagonal is negative.  Vectorized
over scipy CSR on the host (AMG setup is a separate timed phase in the
reference too — "Preconditioner setup", src/HypreSystem.cpp:731).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.amg import spk


def classical_strength(A: sp.csr_matrix, theta: float = 0.25) -> sp.csr_matrix:
    """Strength graph S (pattern-only CSR, no diagonal, sorted columns).

    S[i, j] = 1 iff j strongly influences i.  The native kernel, as
    ``tpusolve`` calls it; :func:`classical_strength_plain` where it
    declines the input.
    """
    S = spk.strength(A.tocsr(), theta)
    return classical_strength_plain(A, theta) if S is None else S


def classical_strength_plain(A: sp.csr_matrix,
                             theta: float = 0.25) -> sp.csr_matrix:
    """:func:`classical_strength` in numpy (``tpusolve``'s fallback)."""
    A = A.tocsr()
    n = A.shape[0]
    diag = A.diagonal()
    # flip rows with negative diagonal so "negative off-diagonal" is the
    # signal in both conventions
    sign = np.where(diag < 0, -1.0, 1.0)

    indptr, indices, data = A.indptr, A.indices, A.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    offd = indices != rows
    vals = -(data * sign[rows])          # candidate strength values
    vals = np.where(offd, vals, -np.inf)

    # per-row max via maximum.reduceat (rows with no entries -> -inf)
    row_max = np.full(n, -np.inf)
    nonempty = np.diff(indptr) > 0
    red = np.maximum.reduceat(vals, indptr[:-1][nonempty]) if nonempty.any() else []
    row_max[nonempty] = red
    thresh = theta * row_max

    strong = offd & (vals >= thresh[rows]) & (vals > 0)
    S = sp.csr_matrix(
        (np.ones(int(strong.sum())), (rows[strong], indices[strong])),
        shape=A.shape)
    return S
