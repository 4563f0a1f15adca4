"""Host-side COO staging: sort, deduplicate, owner-bucket.

This is the TPU-native replacement for HYPRE's IJ assembly semantics
(``HYPRE_IJMatrixSetValues2`` / ``AddToValues2`` / ``Assemble``, ref:
src/HypreSystem.cpp:897-955, 1567-1573, 600-636): entries may arrive for any
global (row, col) in any order with duplicates; assembly routes each entry to
the owner of its row, combines duplicates, and splits owned entries into a
local (diag) block and an off-owner (offd) block.

Routing/combination runs vectorized in NumPy on the host (the staging arrays
live on the host in the reference too; device upload happens at assembly,
src/HypreSystem.cpp:907-926).
"""

from __future__ import annotations

import numpy as np


def sort_coo(rows, cols, vals):
    """Sort entries by (row, col), stable."""
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def dedup_coo(rows, cols, vals, mode: str = "add"):
    """Combine duplicate (row, col) entries.

    ``mode='add'`` sums duplicates (``AddToValues`` semantics);
    ``mode='set'`` keeps the last occurrence in the *original* input order
    (``SetValues`` semantics).  Input need not be sorted; output is sorted
    by (row, col).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if rows.size == 0:
        return rows, cols, vals
    if mode == "set":
        # stable lexsort keeps original order within duplicate groups;
        # keep the last element of each group
        order = np.lexsort((np.arange(rows.size), cols, rows))
        r, c, v = rows[order], cols[order], vals[order]
        last = np.ones(r.size, bool)
        last[:-1] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        return r[last], c[last], v[last]
    if mode != "add":
        raise ValueError(f"unknown dedup mode: {mode}")
    r, c, v = sort_coo(rows, cols, vals)
    new_group = np.ones(r.size, bool)
    new_group[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = np.flatnonzero(new_group)
    v_sum = np.add.reduceat(v, starts)
    return r[starts], c[starts], v_sum


def bucket_by_owner(rows, cols, vals, offsets):
    """Split sorted COO into per-owner slices by row block.

    Returns a list of (local_rows, global_cols, vals) per part.  Input must
    be sorted by row (e.g. output of :func:`dedup_coo`).
    """
    nparts = len(offsets) - 1
    starts = np.searchsorted(rows, offsets[:-1])
    ends = np.searchsorted(rows, offsets[1:])
    out = []
    for p in range(nparts):
        s, e = starts[p], ends[p]
        out.append((rows[s:e] - offsets[p], cols[s:e], vals[s:e]))
    return out
