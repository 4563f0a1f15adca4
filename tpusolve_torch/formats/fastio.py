"""Native text parsing for the readers (``formats/ij.py``, ``formats/mmio.py``).

The parser is ``csrc/fastio.cpp``, a copy of ``tpusolve``'s
``native/fastio.cpp`` parse loops that reads a buffer instead of a path,
built with g++ at first use (``kernels/build.py``) and bound with ctypes.  It
runs on every device: there is no fallback, so a build failure raises.
:func:`parse_plain` is its plain version, ``numpy.loadtxt``, which the tests
hold it against.

Each parser takes the file's bytes and skips ``skip_lines`` lines first; it
skips blank lines, lines starting with ``%`` or ``#``, and lines that do not
parse, and ignores a line's trailing fields.
"""

from __future__ import annotations

import ctypes
import functools
import io

import numpy as np

from tpusolve_torch.kernels import build

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fastio")
    lib.fastio_parse_triplets.restype = ctypes.c_int64
    lib.fastio_parse_triplets.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, _I64P, _I64P, _F64P, _F64P]
    lib.fastio_parse_pairs.restype = ctypes.c_int64
    lib.fastio_parse_pairs.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P, _F64P]
    lib.fastio_parse_floats.restype = ctypes.c_int64
    lib.fastio_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, _F64P, _F64P]
    return lib


def _ptr(a, kind):
    return None if a is None else a.ctypes.data_as(kind)


def max_lines(data: bytes) -> int:
    """An upper bound on the entries of ``data``: its line count."""
    return data.count(b"\n") + 1


def parse_triplets(data: bytes, skip_lines: int, ncols: int,
                   max_entries: int):
    """``(rows, cols, vals, vals2)`` of lines "int int [double [double]]":
    ``ncols`` 2 (pattern: vals all 1), 3, or 4 (complex: the imaginary
    parts in ``vals2``, else None).  ``bytes`` objects end in a NUL byte,
    which the parser relies on."""
    cap = max(int(max_entries), 0)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float64)
    vals2 = np.empty(cap, np.float64) if ncols >= 4 else None
    got = _lib().fastio_parse_triplets(
        data, len(data), skip_lines, ncols, cap, _ptr(rows, _I64P),
        _ptr(cols, _I64P), _ptr(vals, _F64P), _ptr(vals2, _F64P))
    return (rows[:got], cols[:got], vals[:got],
            None if vals2 is None else vals2[:got])


def parse_pairs(data: bytes, skip_lines: int, max_entries: int):
    """``(indices, values)`` of lines "int double"."""
    cap = max(int(max_entries), 0)
    idx = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float64)
    got = _lib().fastio_parse_pairs(data, len(data), skip_lines, cap,
                                    _ptr(idx, _I64P), _ptr(vals, _F64P))
    return idx[:got], vals[:got]


def parse_floats(data: bytes, skip_lines: int, width: int,
                 max_entries: int):
    """``(vals, vals2)`` of lines of ``width`` (1 or 2) floats; ``vals2``
    is None for width 1."""
    cap = max(int(max_entries), 0)
    vals = np.empty(cap, np.float64)
    vals2 = np.empty(cap, np.float64) if width >= 2 else None
    got = _lib().fastio_parse_floats(data, len(data), skip_lines, width, cap,
                                     _ptr(vals, _F64P), _ptr(vals2, _F64P))
    return vals[:got], None if vals2 is None else vals2[:got]


def parse_plain(data: bytes, skip_lines: int, ncols: int) -> np.ndarray:
    """The plain version: ``numpy.loadtxt`` of the first ``ncols`` fields
    of every line after ``skip_lines``, blank and ``%``/``#`` lines
    skipped; (N, ncols) float64.  Unlike the parser it raises on a line
    that does not parse."""
    text = data.decode()
    body = "".join(text.splitlines(keepends=True)[skip_lines:])
    if not any(ln.strip() and ln.lstrip()[0] not in "%#"
               for ln in body.splitlines()):
        return np.zeros((0, ncols))
    return np.loadtxt(io.StringIO(body), dtype=np.float64, ndmin=2,
                      comments=("%", "#"), usecols=range(ncols))
