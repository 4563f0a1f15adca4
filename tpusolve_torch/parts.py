"""1-D row-block decomposition over parts (the port of ``tpusolve/mesh.py``).

The reference decomposes matrix rows into contiguous blocks across MPI ranks
(ref: src/HypreSystem.cpp:525-544 ``init_row_decomposition``): each rank gets
``total/nproc`` rows and the remainder is spread one row at a time over the
first ranks.  The rule is reproduced exactly so partition-dependent file
formats (HYPRE-IJ multi-file dumps) round-trip bit-identically.  The
stencil generator's process grid comes from
:func:`compute_3d_process_distribution`, as in ``tpusolve``.

Every device tensor of the port keeps ``tpusolve``'s stacked layout
``(nparts, ...)``: rows padded per part to ``row_pad``, padded diagonal
entries 1, padded vector entries exactly 0.  All parts live on one torch
device: ``nparts`` is ``tpusolve``'s mesh size, and where ``tpusolve``
exchanges data between its devices the port gathers over the stacked parts.
"""

from __future__ import annotations

import numpy as np

def row_decomposition(total_rows: int, nparts: int) -> np.ndarray:
    """Contiguous 1-D block partition offsets, shape ``(nparts + 1,)``:
    part ``p`` owns global rows ``[offsets[p], offsets[p+1])``."""
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    if total_rows < 0:
        raise ValueError(f"total_rows must be >= 0, got {total_rows}")
    base = total_rows // nparts
    rem = total_rows % nparts
    counts = np.full(nparts, base, dtype=np.int64)
    counts[:rem] += 1
    offsets = np.zeros(nparts + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def owner_of(indices: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Owning part for each global index under a block partition."""
    return np.searchsorted(offsets, np.asarray(indices), side="right") - 1


def local_range(offsets: np.ndarray, part: int) -> tuple[int, int]:
    """(iLower, iUpper) inclusive range for a part, reference-style."""
    return int(offsets[part]), int(offsets[part + 1]) - 1


def compute_3d_process_distribution(nparts: int) -> tuple[int, int, int]:
    """Factor ``nparts`` into a 3-D process grid (px, py, pz).

    Functional equivalent of the reference's prime-factorization grid
    builder (src/laplace_3d_weak_scaling.hpp:98-169): distribute prime
    factors across the three dimensions, largest factors first, always onto
    the currently smallest dimension, yielding a near-cubic grid.
    """
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    factors = []
    n = nparts
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    grid = [1, 1, 1]
    for f in sorted(factors, reverse=True):
        grid[int(np.argmin(grid))] *= f
    px, py, pz = sorted(grid, reverse=True)
    return px, py, pz
