"""1-D row-block decomposition over parts (the port of ``tpusolve/mesh.py``).

The reference decomposes matrix rows into contiguous blocks across MPI ranks
(ref: src/HypreSystem.cpp:525-544 ``init_row_decomposition``): each rank gets
``total/nproc`` rows and the remainder is spread one row at a time over the
first ranks.  The rule is reproduced exactly so partition-dependent file
formats (HYPRE-IJ multi-file dumps) round-trip bit-identically.

Every device tensor of the port keeps ``tpusolve``'s stacked layout
``(nparts, ...)``: rows padded per part to ``row_pad``, padded diagonal
entries 1, padded vector entries exactly 0.  All parts live on one torch
device; this slice runs ``nparts = 1`` (see :func:`require_single_part`).
"""

from __future__ import annotations

import numpy as np

# ROADMAP.md Queue 1 item that brings multi-part operators (offd ELL block
# plus the halo exchange) to the port
MULTIPART_ITEM = "ROADMAP.md Queue 1, 'Multi-part operators'"


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


def require_single_part(nparts: int) -> None:
    """Raise for layouts this slice of the port does not carry yet."""
    if nparts != 1:
        raise NotImplementedError(
            f"nparts={nparts}: multi-part operators (offd ELL block and halo "
            f"exchange) are not ported yet; see {MULTIPART_ITEM}")
