"""Smoothers: l1-Jacobi, weighted Jacobi, Chebyshev (the port of
``tpusolve/amg/smoothers.py``).

BoomerAMG's default relaxations are Gauss-Seidel hybrids (``relax_type`` 6 /
8, ref: src/HypreSystem.cpp:127-151, yaml etc/hypre_app.yaml:37) which are
inherently sequential.  ``tpusolve`` substitutes the data-parallel
smoothers the AMG literature blesses for SIMD hardware, and the port keeps
its map:

    relax_type 0, 7          -> weighted Jacobi (relax_weight)
    relax_type 3-6,8,13,14   -> l1-Jacobi   (convergent for any SPD A)
    relax_type 18            -> l1-Jacobi (hypre's own l1-Jacobi code)
    relax_type 16            -> Chebyshev polynomial (cheby_order/fraction)

The l1 row norms and the Chebyshev eigenvalue bound are computed at setup
on the host.  Each sweep's update around an SpMV is
``matrix.spmv.spmv_update``: one K1 launch on a box-DIA level, the SpMV's
kernel and eager PyTorch on the other layouts.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.matrix.spmv import spmv, spmv_update


def l1_row_norms(A_csr: sp.csr_matrix) -> np.ndarray:
    """d_i = |a_ii| + sum_{j != i} |a_ij| (the l1-Jacobi diagonal)."""
    n = A_csr.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A_csr.indptr))
    absv = np.abs(A_csr.data)
    d = np.bincount(rows, weights=absv, minlength=n)
    return np.where(d != 0, d, 1.0)


def jacobi_sweeps(A, dinv, b, x, nsweeps: int, weight: float = 1.0):
    """x <- x + w * Dinv (b - A x), nsweeps times."""
    for _ in range(nsweeps):
        x = spmv_update(A, x, b=b, s=dinv, c=x, w=weight)
    return x


def cf_jacobi_sweeps(A, dinv, cmask, b, x, nsweeps: int,
                     weight: float = 1.0):
    """CF-ordered relaxation (``relax_order: 1``, ref:
    src/HypreSystem.cpp:153-156): each sweep updates C-points first, then
    F-points with the fresh C values — two masked Jacobi half-sweeps (the
    parallel substitute for CF Gauss-Seidel).  ``cmask`` is 1.0 at C-points,
    0.0 at F-points (padded slots 0)."""
    fmask = 1.0 - cmask
    for _ in range(nsweeps):
        x = x + weight * cmask * dinv * (b - spmv(A, x))
        x = x + weight * fmask * dinv * (b - spmv(A, x))
    return x


def chebyshev_bounds(A_csr: sp.csr_matrix, dinv: np.ndarray,
                     iters: int = 20, seed: int = 0) -> float:
    """Estimate lambda_max(D^-1 A) by power iteration on the host."""
    n = A_csr.shape[0]
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A_csr @ v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        lam = float(v @ w)
        v = w / nw
    return max(abs(lam), 1e-12)


def chebyshev_sweeps(A, dinv, b, x, coeffs_lower_upper, order: int):
    """Chebyshev polynomial smoothing of D^-1 A on [lower, upper]:
    the standard three-term recurrence on the preconditioned residual,
    ``order`` matvecs per invocation (hypre's cheby_order, default 2)."""
    lower, upper = coeffs_lower_upper
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = spmv_update(A, x, b=b, s=dinv)
    d = r / theta
    for _ in range(order - 1):
        x = x + d
        r = spmv_update(A, d, s=dinv, c=r)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def chebyshev4_sweeps(A, dinv, b, x, lam_max, order: int):
    """Fourth-kind Chebyshev smoothing (Lottes, "Optimal polynomial
    smoothers for multigrid V-cycles", 2022; see PAPERS.md): needs only an
    upper eigenvalue bound, ``order`` matvecs per invocation."""
    r = spmv_update(A, x, b=b, s=dinv)
    d = (4.0 / 3.0) * r / lam_max
    for k in range(1, order):
        x = x + d
        r = spmv_update(A, d, s=dinv, c=r)
        a1 = (2.0 * k - 1.0) / (2.0 * k + 3.0)
        a2 = (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lam_max)
        d = a1 * d + a2 * r
    return x + d


RELAX_L1_JACOBI = "l1_jacobi"
RELAX_JACOBI = "jacobi"
RELAX_CHEBYSHEV = "chebyshev"
RELAX_DIRECT = "direct"          # coarsest level only: dense (pseudo)inverse

RELAX_MAP = {
    0: (RELAX_JACOBI, None),
    3: (RELAX_L1_JACOBI, "relax_type 3 (hybrid GS) mapped to l1-Jacobi"),
    4: (RELAX_L1_JACOBI, "relax_type 4 (hybrid GS backward) mapped to l1-Jacobi"),
    5: (RELAX_L1_JACOBI, "relax_type 5 (chaotic GS) mapped to l1-Jacobi"),
    6: (RELAX_L1_JACOBI, "relax_type 6 (hybrid sym GS) mapped to l1-Jacobi"),
    7: (RELAX_JACOBI, None),
    8: (RELAX_L1_JACOBI, "relax_type 8 (l1 sym GS) mapped to l1-Jacobi"),
    13: (RELAX_L1_JACOBI, "relax_type 13 (forward l1 GS) mapped to l1-Jacobi"),
    14: (RELAX_L1_JACOBI, "relax_type 14 (backward l1 GS) mapped to l1-Jacobi"),
    16: (RELAX_CHEBYSHEV, None),
    18: (RELAX_L1_JACOBI, None),
}


def resolve_relax(relax_type: int):
    """reference relax_type code -> (smoother kind, substitution note)."""
    if relax_type not in RELAX_MAP:
        raise ValueError(f"unsupported relax_type {relax_type}")
    return RELAX_MAP[relax_type]


def resolve_coarse_relax(relax_coarse):
    """``relax_coarse`` code -> coarsest-level treatment.  HYPRE defaults to
    9 (Gaussian elimination, ref: src/HypreSystem.cpp:129-151); codes 9/19/
    98/99 are GE variants -> dense inverse here; anything else is relaxation
    sweeps via the standard map."""
    if relax_coarse is None or relax_coarse in (9, 19, 98, 99):
        return RELAX_DIRECT, None
    return resolve_relax(relax_coarse)
