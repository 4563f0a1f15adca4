"""ILU(k) preconditioner with Jacobi triangular solves (the port of
``tpusolve/ilu/ilu.py``).

Replacement for ``HYPRE_ILU*`` as a preconditioner and as a solver (ref:
src/HypreSystem.cpp:328-370, :457-497), with the two parallel-friendly
choices the reference exposes for its GPU path:

* **Factorization**: Chow-Patel fixed-point iterative ILU (the algorithm
  behind ``ilu_iterative_setup_*``, src/HypreSystem.cpp:352-361).  ILU(0)
  of a DIA or ELL operator of 65,536 rows or more runs on its device
  (``ilu/device_setup.py``), where ``tpusolve`` runs it on its device; the
  rest on the host, a numpy copy of ``tpusolve``'s ``chow_patel_ilu``
  with its fill pattern (``ilu_fill_level``), ILUT's drop and row cap
  (``ilu_type: 1``) and RCM local reordering (``ilu_local_reordering``).
  BDIA and BELL operators, as gate 4's, take the host path in both
  packages.
* **Triangular solves**: Jacobi iterations (``ilu_tri_solve: 0`` with
  ``ilu_lower/upper_jacobi_iters``, src/HypreSystem.cpp:363-365); each
  iteration is one SpMV on a strict triangle in its update form
  (``matrix.spmv.spmv_update``): one K5 launch with the sweep fused into it
  when the triangle is stored in BDIA-XL (K2 on ELL, K1 on DIA), the K4
  SpMV and an eager update on K4's BDIA.

``ilu_type`` mapping (HYPRE codes, src/HypreSystem.cpp:337): 0 is ILU(k)
with k = ``ilu_fill_level``; 1 is ILUT, approximated by ILU(k) with a drop
at ``ilu_drop_threshold`` and a cap of ``ilu_max_nnz_per_row`` entries a
row; other codes run ILU(k) with a note.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch.amg.interp import _restrict_to_pattern
from tpusolve_torch.config import ILUConfig
from tpusolve_torch.ilu import device_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv_update
from tpusolve_torch.matrix.vectors import numpy_dtype, to_device_vector


def _fill_pattern(A: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Structural fill pattern for ILU(k): the pattern of (|A| + I)^(k+1),
    with A's values on it (0 elsewhere)."""
    if k <= 0:
        return A
    P = (sp.csr_matrix((np.abs(A.data), A.indices, A.indptr), shape=A.shape)
         + sp.eye(A.shape[0], format="csr"))
    G = P.copy()
    for _ in range(k):
        G = (G @ P).tocsr()
        G.data[:] = 1.0
    return _restrict_to_pattern(A, G)


def chow_patel_ilu(A: sp.csr_matrix, sweeps: int = 5, fill_level: int = 0):
    """Iterative ILU factorization on the (possibly grown) pattern of A.

    Returns (L_strict, u_diag, U_strict) with unit-lower L and U including
    its diagonal separately: A ~= (I + L_strict) @ (diag(u_diag) + U_strict).
    """
    A = _fill_pattern(A.tocsr(), fill_level)
    A.sum_duplicates()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data.astype(np.float64)
    lower = rows > cols
    upper = ~lower                      # includes diagonal

    diag = A.diagonal()
    diag = np.where(diag != 0, diag, 1.0)

    # init: l_ij = a_ij / a_jj ; u_ij = a_ij
    lvals = np.where(lower, vals / diag[cols], 0.0)
    uvals = np.where(upper, vals, 0.0)

    pat = sp.csr_matrix((np.ones_like(vals), cols.copy(), A.indptr.copy()),
                        shape=A.shape)

    for _ in range(max(sweeps, 1)):
        # NB: the (data, indices, indptr) constructor does NOT copy data —
        # eliminate_zeros() would corrupt lvals/uvals in place
        L = sp.csr_matrix((lvals.copy(), cols.copy(), A.indptr.copy()),
                          shape=A.shape)
        U = sp.csr_matrix((uvals.copy(), cols.copy(), A.indptr.copy()),
                          shape=A.shape)
        L.eliminate_zeros()
        U.eliminate_zeros()
        prod = _restrict_to_pattern((L @ U).tocsr(), pat)
        p = prod.data                          # aligned with A's pattern
        ujj = np.bincount(rows[rows == cols],
                          weights=uvals[rows == cols], minlength=n)
        ujj = np.where(ujj != 0, ujj, 1.0)
        # i > j:  l_ij = (a_ij - (p_ij - l_ij u_jj)) / u_jj
        new_l = np.where(lower,
                         (vals - p + lvals * ujj[cols]) / ujj[cols], 0.0)
        # i <= j: u_ij = a_ij - p_ij   (p excludes the k=i term since L is
        # strict lower)
        new_u = np.where(upper, vals - p, 0.0)
        lvals, uvals = new_l, new_u

    ujj = np.bincount(rows[rows == cols], weights=uvals[rows == cols],
                      minlength=n)
    ujj = np.where(ujj != 0, ujj, 1.0)
    strict_u = uvals * (rows != cols)
    L = sp.csr_matrix((lvals, (rows, cols)), shape=A.shape)
    U = sp.csr_matrix((strict_u, (rows, cols)), shape=A.shape)
    L.eliminate_zeros()
    U.eliminate_zeros()
    return L.tocsr(), ujj, U.tocsr()


def _drop_small(M: sp.csr_matrix, tol: float) -> sp.csr_matrix:
    """ILUT drop: entries below ``tol`` times their row's largest
    magnitude go."""
    if tol <= 0:
        return M
    M = M.tocsr().copy()
    n = M.shape[0]
    rows = np.repeat(np.arange(n), np.diff(M.indptr))
    absv = np.abs(M.data)
    row_max = np.zeros(n)
    nonempty = np.diff(M.indptr) > 0
    if nonempty.any():
        row_max[nonempty] = np.maximum.reduceat(absv, M.indptr[:-1][nonempty])
    M.data[absv < tol * row_max[rows]] = 0.0
    M.eliminate_zeros()
    return M


def _cap_row_nnz(M: sp.csr_matrix, max_nnz: int) -> sp.csr_matrix:
    """ILUT row cap: keep only the ``max_nnz`` largest-magnitude entries per
    row (``ilu_max_nnz_per_row``, ref: src/HypreSystem.cpp:344-350), ranked
    within each row by one lexsort."""
    if max_nnz <= 0:
        return M
    M = M.tocsr()
    counts = np.diff(M.indptr)
    if not (counts > max_nnz).any():
        return M
    n = M.shape[0]
    rows = np.repeat(np.arange(n), counts)
    absv = np.abs(M.data)
    order = np.lexsort((-absv, rows))
    rank = np.empty(M.data.size, np.int64)
    rank[order] = np.arange(M.data.size) - np.repeat(M.indptr[:-1], counts)
    out = M.copy()
    out.data[rank >= max_nnz] = 0.0
    out.eliminate_zeros()
    return out


def _rcm_permutation(A: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee on the pattern (``ilu_local_reordering: 1``,
    ref: src/HypreSystem.cpp:351)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(A.tocsr(), symmetric_mode=False),
                      np.int64)


def ilu_apply(L: ShardedMatrix, U: ShardedMatrix, dinv: torch.Tensor,
              r: torch.Tensor, lower_iters: int,
              upper_iters: int) -> torch.Tensor:
    """z ~= (D+U)^-1 (I+L)^-1 r via Jacobi trisolve iterations (the
    reference's ilu_tri_solve: 0 path, src/HypreSystem.cpp:363-365):
    ``z = r - L z`` and ``x = dinv * (z - U x)``, each sweep one update
    form (``spmv_update``).  Jacobi reads the old iterate while it writes
    the new one, so the sweeps alternate between two buffers; the lower
    sweeps' second buffer, free once z is final, serves the upper ones."""
    bufs = [torch.empty_like(r), torch.empty_like(r)]
    z = r
    for i in range(lower_iters):
        z = spmv_update(L, z, b=r, out=bufs[i % 2])
    free = bufs[lower_iters % 2]
    x = dinv * z
    for _ in range(upper_iters):
        x, free = spmv_update(U, x, b=z, s=dinv, out=free), x
    return x


@dataclass
class ILUPreconditioner:
    L: ShardedMatrix          # strict lower
    U: ShardedMatrix          # strict upper
    udiag_inv: torch.Tensor   # padded 1/u_ii
    lower_iters: int
    upper_iters: int
    notes: list[str] = field(default_factory=list)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z ~= U^-1 L^-1 r via Jacobi trisolve iterations."""
        return ilu_apply(self.L, self.U, self.udiag_inv, r,
                         self.lower_iters, self.upper_iters)


def ilu_setup(A: ShardedMatrix, config: ILUConfig | None = None, *,
              A_host: sp.csr_matrix | None = None,
              device_min_n: int | None = device_setup.MIN_DEVICE_N
              ) -> ILUPreconditioner:
    """ILU of ``A`` in ``tpusolve``'s order: on A's device where
    ``device_setup.device_path`` holds at ``device_min_n`` rows (None:
    never), block-Jacobi across the parts there, else by the host
    Chow-Patel factorization of ``A_host`` (or of ``A``'s entries) with
    the fill level, ILUT's drop and cap and RCM local reordering the
    config asks for; the host factors are stored as
    ShardedMatrix on A's device in A's dtype."""
    cfg = config or ILUConfig()
    path = device_setup.device_path(A, cfg, device_min_n)
    if path == "dia":
        return device_setup.ilu_setup_device(A, cfg)
    if path == "ell":
        return device_setup.ilu_setup_device_ell(A, cfg)
    notes: list[str] = []
    if cfg.ilu_type == 1:
        notes.append("ilu_type 1 (ILUT) approximated by ILU(k) + "
                     f"drop at {cfg.ilu_drop_threshold} capped at "
                     f"{cfg.ilu_max_nnz_per_row} nnz/row")
    elif cfg.ilu_type not in (0, 1):
        notes.append(f"ilu_type {cfg.ilu_type} mapped to ILU(k) block-Jacobi")
    Ah = (A_host if A_host is not None else A.to_scipy()).tocsr()
    perm = None
    if cfg.ilu_local_reordering:
        # factor P A P^T, then carry the factors back by similarity: they
        # stay nilpotent, so the Jacobi sweeps apply unchanged
        perm = _rcm_permutation(Ah)
        notes.append("ilu_local_reordering: RCM")
        Ah = Ah[perm][:, perm].tocsr()
    sweeps = max(cfg.ilu_iterative_setup_max_iter, 1) * 5
    L_host, ujj, U_host = chow_patel_ilu(Ah, sweeps=sweeps,
                                         fill_level=cfg.ilu_fill_level)
    if cfg.ilu_type == 1:
        L_host = _cap_row_nnz(_drop_small(L_host, cfg.ilu_drop_threshold),
                              cfg.ilu_max_nnz_per_row)
        U_host = _cap_row_nnz(_drop_small(U_host, cfg.ilu_drop_threshold),
                              cfg.ilu_max_nnz_per_row)
    if perm is not None:
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(perm.size)
        L_host = L_host[iperm][:, iperm].tocsr()
        U_host = U_host[iperm][:, iperm].tocsr()
        ujj = ujj[iperm]

    ro = np.asarray(A.row_offsets)
    np_dtype = numpy_dtype(A.dtype)
    Lc, Uc = L_host.tocoo(), U_host.tocoo()
    L_sh = ShardedMatrix.from_coo(A.shape, Lc.row, Lc.col, Lc.data,
                                  device=A.device, dtype=np_dtype,
                                  row_offsets=ro, col_offsets=ro)
    U_sh = ShardedMatrix.from_coo(A.shape, Uc.row, Uc.col, Uc.data,
                                  device=A.device, dtype=np_dtype,
                                  row_offsets=ro, col_offsets=ro)
    udiag_inv = to_device_vector(1.0 / ujj, ro, A.row_pad, A.device,
                                 dtype=np_dtype)
    return ILUPreconditioner(
        L=L_sh, U=U_sh, udiag_inv=udiag_inv,
        lower_iters=max(cfg.ilu_lower_jacobi_iters, 1),
        upper_iters=max(cfg.ilu_upper_jacobi_iters, 1), notes=notes)
