"""ILU(0) preconditioner with Jacobi triangular solves (the port of
``tpusolve/ilu/ilu.py``).

Replacement for ``HYPRE_ILU*`` as a preconditioner (ref:
src/HypreSystem.cpp:328-370), with the two parallel-friendly choices the
reference exposes for its GPU path:

* **Factorization**: Chow-Patel fixed-point iterative ILU on the host (the
  algorithm behind ``ilu_iterative_setup_*``, src/HypreSystem.cpp:352-361),
  a numpy copy of ``tpusolve``'s ``chow_patel_ilu`` for fill level 0.
  ``tpusolve`` factors a DIA or ELL operator of 65,536 rows or more on the
  device (``ilu/device_setup.py``); the port's host factorization stands in
  there and says so in a note (ROADMAP.md Queue 1, item 14).  BDIA
  operators, as gate 4's, take the host path in both packages.
* **Triangular solves**: Jacobi iterations (``ilu_tri_solve: 0`` with
  ``ilu_lower/upper_jacobi_iters``, src/HypreSystem.cpp:363-365); each
  iteration is one SpMV on a strict triangle in its update form
  (``matrix.spmv.spmv_update``): one K5 launch with the sweep fused into it
  when the triangle is stored in BDIA-XL (K2 on ELL, K1 on DIA), the K4
  SpMV and an eager update on K4's BDIA.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch.amg.interp import _restrict_to_pattern
from tpusolve_torch.config import ILUConfig
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv_update
from tpusolve_torch.matrix.vectors import numpy_dtype, to_device_vector


def chow_patel_ilu(A: sp.csr_matrix, sweeps: int = 5):
    """Iterative ILU(0) factorization on the pattern of A.

    Returns (L_strict, u_diag, U_strict) with unit-lower L and U including
    its diagonal separately: A ~= (I + L_strict) @ (diag(u_diag) + U_strict).
    """
    A = A.tocsr()
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


# tpusolve factors ILU(0) on the device from this many rows
# (tpusolve/ilu/device_setup.py:38), ELL operators up to this row width
DEVICE_ILU_MIN_N = 1 << 16
DEVICE_ILU_MAX_K = 128


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


def device_factorization_note(A: ShardedMatrix) -> str | None:
    """The note that ``tpusolve`` would factor ``A`` on the device (its
    ``_device_path`` for ILU(0): a DIA operator with the main and both
    off-diagonal sides, or an ELL one of at most ``DEVICE_ILU_MAX_K``
    entries a row, from ``DEVICE_ILU_MIN_N`` rows), or None.  It reads the
    layout ``tpusolve`` gives ``A``: an ELL operator that K2's pricing took
    from BDIA or BELL (``A.priced_over``) is not ELL there."""
    if A.shape[0] < DEVICE_ILU_MIN_N:
        return None
    if A.uses_dia:
        flat = [(dz * A.dia_vals.shape[3] + dy) * A.dia_vals.shape[4] + dx
                for dz, dy, dx in A.dia_offsets]
        if not (0 in flat and min(flat) < 0 < max(flat)):
            return None
        kind = "DIA"
    elif A.uses_bdia or A.uses_bell or A.priced_over is not None \
            or A.row_width > DEVICE_ILU_MAX_K:
        return None
    else:
        kind = "ELL"
    return (f"ILU(0) factored on the host: tpusolve factors this {kind} "
            "operator on the device (ilu/device_setup.py), not ported yet; "
            "see ROADMAP.md Queue 1, item 14")


def ilu_setup(A: ShardedMatrix, config: ILUConfig | None = None, *,
              A_host: sp.csr_matrix | None = None) -> ILUPreconditioner:
    """Host Chow-Patel ILU(0) of ``A`` (from ``A_host`` when given), with
    the factors stored as ShardedMatrix on A's device in A's dtype."""
    cfg = config or ILUConfig()
    if cfg.ilu_type != 0 or cfg.ilu_fill_level != 0 \
            or cfg.ilu_local_reordering:
        raise NotImplementedError(
            "only ILU(0) without local reordering is ported (ilu_type 0, "
            "ilu_fill_level 0, ilu_local_reordering 0); see ROADMAP.md "
            "Queue 1")
    Ah = (A_host if A_host is not None else A.to_scipy()).tocsr()
    sweeps = max(cfg.ilu_iterative_setup_max_iter, 1) * 5
    L_host, ujj, U_host = chow_patel_ilu(Ah, sweeps=sweeps)

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
    note = device_factorization_note(A)
    return ILUPreconditioner(
        L=L_sh, U=U_sh, udiag_inv=udiag_inv,
        lower_iters=max(cfg.ilu_lower_jacobi_iters, 1),
        upper_iters=max(cfg.ilu_upper_jacobi_iters, 1),
        notes=[note] if note else [])
