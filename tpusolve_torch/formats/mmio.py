"""MatrixMarket I/O (the port of ``tpusolve/formats/mmio.py``).

Clean-room implementation of the NIST MatrixMarket format as consumed by the
reference (banner/size handling: src/mmio.c:1-515; matrix scan and
complex→real 2x2 block expansion: src/HypreSystem.cpp:1717-1853; dense
"array" vector reader incl. complex: src/HypreSystem.cpp:1855-1969).

Supports coordinate and array formats; real / integer / complex / pattern
fields; general / symmetric / skew-symmetric / hermitian symmetries (the
reference's hand-rolled scanner only handles ``general`` — symmetry expansion
here is an intentional capability superset).

Complex systems are expanded to real form with doubled DOFs, matching the
reference convention (src/HypreSystem.cpp:1800-1833)::

    a + ib  ->  [[a, -b],
                 [b,  a]]

Bodies are parsed by the native parser ``formats/fastio.py`` (the copy of
``tpusolve``'s ``native/fastio.cpp``) on every device, paths and text
streams alike, with no fallback: an entry count that disagrees with the
size line raises.  The writers produce the same text as ``tpusolve``'s,
formatted a chunk of lines at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpusolve_torch.formats import fastio
from tpusolve_torch.formats.ij import write_lines

_BANNER = "%%MatrixMarket"

VALID_FORMATS = ("coordinate", "array")
VALID_FIELDS = ("real", "integer", "complex", "pattern")
VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclass
class MMInfo:
    fmt: str
    field: str
    symmetry: str
    nrows: int
    ncols: int
    nnz: int | None  # None for array format


class MMError(ValueError):
    pass


def _open(path_or_file, mode="r"):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    return open(path_or_file, mode), True


def _text(line) -> str:
    return line.decode() if isinstance(line, bytes) else line


def read_banner(fh) -> tuple[str, str, str]:
    line = _text(fh.readline())
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != _BANNER:
        raise MMError(f"invalid MatrixMarket banner: {line!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    if obj != "matrix":
        raise MMError(f"unsupported MatrixMarket object: {obj}")
    if fmt not in VALID_FORMATS:
        raise MMError(f"unsupported MatrixMarket format: {fmt}")
    if field not in VALID_FIELDS:
        raise MMError(f"unsupported MatrixMarket field: {field}")
    if symmetry not in VALID_SYMMETRIES:
        raise MMError(f"unsupported MatrixMarket symmetry: {symmetry}")
    return fmt, field, symmetry


def _read_sizes(fh, fmt: str) -> tuple[int, int, int | None]:
    for line in fh:
        line = _text(line)
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        parts = s.split()
        if fmt == "coordinate":
            if len(parts) != 3:
                raise MMError(f"bad coordinate size line: {line!r}")
            m, n, nnz = (int(p) for p in parts)
            return m, n, nnz
        else:
            if len(parts) != 2:
                raise MMError(f"bad array size line: {line!r}")
            m, n = (int(p) for p in parts)
            return m, n, None
    raise MMError("missing size line")


def read_info(path_or_file) -> MMInfo:
    """Banner + sizes only (the reference's ``determine_mm_system_sizes``,
    src/HypreSystem.cpp:1670-1713)."""
    fh, close = _open(path_or_file, "rb")
    try:
        fmt, field, symmetry = read_banner(fh)
        m, n, nnz = _read_sizes(fh, fmt)
        return MMInfo(fmt, field, symmetry, m, n, nnz)
    finally:
        if close:
            fh.close()


def _expand_symmetry(rows, cols, vals, symmetry):
    if symmetry == "general":
        return rows, cols, vals
    off = rows != cols
    if symmetry == "symmetric":
        mirror = vals[off]
    elif symmetry == "skew-symmetric":
        mirror = -vals[off]
    else:  # hermitian
        mirror = np.conj(vals[off])
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, mirror]))


def _read_header_and_body(path_or_file):
    """(format, field, symmetry, m, n, nnz, body bytes) of an MM file or
    text stream: a path is read as bytes, a stream's rest is encoded."""
    fh, close = _open(path_or_file, "rb")
    try:
        fmt, field, symmetry = read_banner(fh)
        m, n, nnz = _read_sizes(fh, fmt)
        body = fh.read()
    finally:
        if close:
            fh.close()
    if isinstance(body, str):
        body = body.encode()
    return fmt, field, symmetry, m, n, nnz, body


def _parse_coordinate(body: bytes, field: str, nnz: int):
    """0-based (rows, cols, vals) of ``nnz`` coordinate lines."""
    ncol_data = {"pattern": 2, "real": 3, "integer": 3, "complex": 4}[field]
    # one entry more than the size line says shows a longer body
    rows, cols, vals, vals2 = fastio.parse_triplets(body, 0, ncol_data,
                                                    nnz + 1)
    if rows.size != nnz:
        found = rows.size if rows.size < nnz else "more"
        raise MMError(f"expected {nnz} entries, found {found}")
    if field == "pattern":
        vals = np.ones(nnz, np.float64)
    elif field == "complex":
        vals = vals + 1j * vals2
    return rows - 1, cols - 1, vals


def read_matrix(path_or_file, expand_symmetry: bool = True,
                row_range=None):
    """Read a coordinate matrix → (rows, cols, vals, (nrows, ncols)).

    Indices are converted to 0-based (the reference decrements in-place,
    src/HypreSystem.cpp:1796-1797).  ``vals`` is float64, or complex128 for
    a complex field, or all-ones for pattern.  With ``row_range=(lo,
    hi)`` only the entries of rows lo..hi are kept, symmetry expanded
    first (a rank's rows; the reference's filter,
    src/HypreSystem.cpp:1751-1835).
    """
    fmt, field, symmetry, m, n, nnz, body = _read_header_and_body(
        path_or_file)
    if fmt != "coordinate":
        raise MMError("read_matrix requires coordinate format "
                      "(the reference rejects non-coordinate too, "
                      "src/HypreSystem.cpp:1689-1690)")
    rows, cols, vals = _parse_coordinate(body, field, nnz)
    if expand_symmetry:
        rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry)
    if row_range is not None:
        keep = (rows >= row_range[0]) & (rows <= row_range[1])
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    return rows, cols, vals, (m, n)


def expand_complex_to_real(rows, cols, vals, shape):
    """Complex COO → real 2x2-block COO with doubled DOFs
    (reference convention, src/HypreSystem.cpp:1800-1833)."""
    a = np.real(vals)
    b = np.imag(vals)
    r2 = np.concatenate([2 * rows, 2 * rows, 2 * rows + 1, 2 * rows + 1])
    c2 = np.concatenate([2 * cols, 2 * cols + 1, 2 * cols, 2 * cols + 1])
    v2 = np.concatenate([a, -b, b, a])
    return r2, c2, v2, (2 * shape[0], 2 * shape[1])


def expand_complex_vector(vec):
    """Complex vector → interleaved real vector [re0, im0, re1, im1, ...]
    (ref: src/HypreSystem.cpp:1930-1946)."""
    out = np.empty(2 * vec.shape[0], np.float64)
    out[0::2] = np.real(vec)
    out[1::2] = np.imag(vec)
    return out


def read_vector(path_or_file):
    """Read an MM file as a dense vector (array format, or a coordinate
    m x 1 file).  Returns float64 or complex128 of shape (m,)."""
    fmt, field, symmetry, m, n, nnz, body = _read_header_and_body(
        path_or_file)
    if n != 1:
        raise MMError(f"vector file must have 1 column, got {n}")
    if fmt == "array":
        vals, vals2 = fastio.parse_floats(
            body, 0, 2 if field == "complex" else 1, m + 1)
        if vals.size != m:
            found = vals.size if vals.size < m else "more"
            raise MMError(f"expected {m} entries, found {found}")
        return vals + 1j * vals2 if field == "complex" else vals
    # coordinate vector: scatter entries, implicit zeros
    rows, cols, vals = _parse_coordinate(body, field, nnz)
    rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry)
    out = np.zeros(m, vals.dtype)
    out[rows] = vals
    return out


def write_matrix(path_or_file, rows, cols, vals, shape, symmetry="general",
                 comment: str | None = None):
    """Write a coordinate MM file (1-based indices)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    field = "complex" if np.iscomplexobj(vals) else "real"
    fh, close = _open(path_or_file, "w")
    try:
        fh.write(f"{_BANNER} matrix coordinate {field} {symmetry}\n")
        if comment:
            for ln in comment.splitlines():
                fh.write(f"% {ln}\n")
        fh.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        if field == "complex":
            write_lines(fh, "%d %d %.16e %.16e\n", rows + 1, cols + 1,
                        vals.real, vals.imag)
        else:
            write_lines(fh, "%d %d %.16e\n", rows + 1, cols + 1, vals)
    finally:
        if close:
            fh.close()


def write_vector(path_or_file, vec, comment: str | None = None):
    """Write a dense vector as an MM array file."""
    vec = np.asarray(vec)
    field = "complex" if np.iscomplexobj(vec) else "real"
    fh, close = _open(path_or_file, "w")
    try:
        fh.write(f"{_BANNER} matrix array {field} general\n")
        if comment:
            for ln in comment.splitlines():
                fh.write(f"% {ln}\n")
        fh.write(f"{vec.shape[0]} 1\n")
        if field == "complex":
            write_lines(fh, "%.16e %.16e\n", vec.real, vec.imag)
        else:
            write_lines(fh, "%.16e\n", vec)
    finally:
        if close:
            fh.close()
