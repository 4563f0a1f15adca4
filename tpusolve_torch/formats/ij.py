"""HYPRE-IJ multi-file text format (the port of ``tpusolve/formats/ij.py``).

File naming: ``<prefix>.00000 .. <prefix>.{nfiles-1:05d}``
(ref: src/HypreSystem.cpp:1192-1196).

Matrix file layout (ref reader: src/HypreSystem.cpp:1181-1249)::

    ilower iupper jlower jupper        # inclusive global ranges of this part
    row col value                      # one entry per line

Vector file layout (ref reader: src/HypreSystem.cpp:1252-1318)::

    ilower iupper
    row value

Bodies are parsed by the native parser ``formats/fastio.py`` (the copy of
``tpusolve``'s ``native/fastio.cpp``) on every device, with no fallback;
``tpusolve``'s per-host ``row_range`` filter is not carried (one process
reads every file).  Writers produce the same text as ``tpusolve``'s,
formatted a chunk of lines at a time.
"""

from __future__ import annotations

import os

import numpy as np

from tpusolve_torch.formats import fastio

_CHUNK = 1 << 16   # lines formatted per write


def part_path(prefix: str, part: int) -> str:
    return f"{prefix}.{part:05d}"


def determine_matrix_extent(prefix: str, nfiles: int) -> tuple[int, int]:
    """Global (min_row, max_row) from the per-file headers, clamped to
    include 0 as the reference does (src/HypreSystem.cpp:1138-1176)."""
    imin, imax = 0, 0
    for p in range(nfiles):
        with open(part_path(prefix, p)) as fh:
            ilower, iupper, _, _ = (int(x) for x in fh.readline().split())
        imin = min(imin, ilower)
        imax = max(imax, iupper)
    return imin, imax


def num_global_rows(prefix: str, nfiles: int) -> int:
    imin, imax = determine_matrix_extent(prefix, nfiles)
    return imax - imin + 1


def _read_part(path: str, what: str) -> bytes:
    """A part file's bytes (header included)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot open {what} file: {path}")
    with open(path, "rb") as fh:
        return fh.read()


def read_matrix(prefix: str, nfiles: int):
    """Read all partitions -> COO (rows, cols, vals)."""
    all_r, all_c, all_v = [], [], []
    for p in range(nfiles):
        data = _read_part(part_path(prefix, p), "matrix")
        # skip the header: ilower iupper jlower jupper
        r, c, v, _ = fastio.parse_triplets(data, 1, 3,
                                           fastio.max_lines(data))
        all_r.append(r)
        all_c.append(c)
        all_v.append(v)
    if not all_r:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    return (np.concatenate(all_r), np.concatenate(all_c),
            np.concatenate(all_v))


def read_vector(prefix: str, nfiles: int):
    """Read all vector partitions -> (indices, values)."""
    all_i, all_v = [], []
    for p in range(nfiles):
        data = _read_part(part_path(prefix, p), "vector")
        # skip the header: ilower iupper
        i, v = fastio.parse_pairs(data, 1, fastio.max_lines(data))
        all_i.append(i)
        all_v.append(v)
    if not all_i:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    return np.concatenate(all_i), np.concatenate(all_v)


def read_dense_vector(prefix: str, nfiles: int, n: int | None = None):
    """Read a vector into a dense array indexed by global row."""
    idx, vals = read_vector(prefix, nfiles)
    if n is None:
        n = int(idx.max()) + 1 if idx.size else 0
    out = np.zeros(n, np.float64)
    out[idx] = vals
    return out


def write_lines(fh, fmt: str, *columns) -> None:
    """Write ``fmt % (col0[i], col1[i], ...)`` for every i, a chunk at a
    time (one %-format of a chunk-long template per write)."""
    k = len(columns)
    for s in range(0, len(columns[0]), _CHUNK):
        cols = [c[s:s + _CHUNK].tolist() for c in columns]
        flat = [None] * (k * len(cols[0]))
        for j, c in enumerate(cols):
            flat[j::k] = c
        fh.write((fmt * len(cols[0])) % tuple(flat))


def write_matrix(prefix: str, rows, cols, vals, offsets,
                 ncols: int | None = None):
    """Write COO partitioned by the row decomposition ``offsets``: one file
    per part, reference header, entries sorted by (row, col)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    nparts = len(offsets) - 1
    n = int(offsets[-1])
    ncols = n if ncols is None else ncols
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    starts = np.searchsorted(rows, np.asarray(offsets[:-1]))
    ends = np.searchsorted(rows, np.asarray(offsets[1:]))
    for p in range(nparts):
        lo, hi = int(offsets[p]), int(offsets[p + 1]) - 1
        with open(part_path(prefix, p), "w") as fh:
            fh.write(f"{lo} {hi} 0 {ncols - 1}\n")
            s, e = starts[p], ends[p]
            write_lines(fh, "%d %d %.15e\n", rows[s:e], cols[s:e],
                         vals[s:e])


def write_vector(prefix: str, vec, offsets):
    """Write a dense vector partitioned by ``offsets``."""
    vec = np.asarray(vec, np.float64)
    nparts = len(offsets) - 1
    for p in range(nparts):
        lo, hi = int(offsets[p]), int(offsets[p + 1]) - 1
        with open(part_path(prefix, p), "w") as fh:
            fh.write(f"{lo} {hi}\n")
            write_lines(fh, "%d %.15e\n", np.arange(lo, hi + 1),
                         vec[lo:hi + 1])
