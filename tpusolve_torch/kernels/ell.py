"""ELL SpMV: plain PyTorch versions and the CUDA kernel K2, in two forms.

A padded-ELL block stores, for each of its ``rows`` rows, ``K`` slots:

* ``vals``: (rows, K) values, zero in padded slots and padded rows;
* ``cols``: (rows, K) int32 columns into x, zero in padded slots.

The row-pointer form stores the same entries without the padding:

* ``rowptr``: (rows + 1,) int32 or int64, row i's entries at
  ``[rowptr[i], rowptr[i + 1])``;
* ``vals``: (nnz,) values and ``cols``: (nnz,) int32 columns, each row's
  entries in the padded form's slot order (so that a row sums them in the
  same order in either form).

SpMV gathers x at every entry's column::

    y[i] = sum_k vals[i, k] * x[cols[i, k]]

and x may be longer or shorter than y (the AMG transfers P and R).  Besides
``y = A x``, one launch computes the update form ``y = c + w * s (.) (b -
A x)`` of :func:`~tpusolve_torch.kernels.dia.epilogue_plain`, as K1 does,
with ``out`` allowed to be ``c``: the prolongation ``x + P e`` is written
into x in place.

``ell_spmv`` launches the hand-written Hopper kernel K2,
``csrc/ell_spmv.cuh`` (the port of ``tpusolve``'s ``ell_spmv_local``), on
CUDA tensors in either form and runs the plain versions
(``ell_spmv_plain``, ``ell_rowptr_plain``) on CPU tensors.  Which form an
operator is stored in is the time model's choice
(``matrix/sharded.py:ell_form``, on :func:`ell_bytes` and
:func:`ell_stages` with ``K2_MODEL``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusolve_torch.kernels import build
from tpusolve_torch.kernels.dia import epilogue_mode, epilogue_plain

GROUPS = (1, 2, 4, 8, 16, 32)   # threads a row K2 is built for
FORMS = ("padded", "rowptr")    # the two storage forms K2 runs
# K2's launch plan (k2_plan): G threads a row until a launch has
# K2_FILL_THREADS threads and a lane at most K2_LANE_SLOTS slots.  On the
# ELL shapes of the BoomerAMG paths (H100 80GB HBM3 at 700 W,
# `python -m tpusolve_torch.kernels.calibrate --k2`; PERF.md) this picks
# the fastest G but at K = 123 (32 where 8 is 13 % faster in f64)
K2_FILL_THREADS = 131_072
K2_LANE_SLOTS = 6
# The row-pointer form's plan (k2_rowptr_plan): G threads a row until a
# launch has K2_FILL_THREADS threads and a lane at most
# K2_ROWPTR_LANE_ENTRIES of the mean row's entries
K2_ROWPTR_LANE_ENTRIES = 4
K2_STAGE = 4    # entries a lane loads before its adds (csrc kStage)
# K2's constants for its time model (matrix/sharded.py:ell_model_s), by
# form and item size: (rate in bytes/s, floor s, round s): a launch takes
# the floor, then the longer of streaming ell_bytes at the rate and its
# longest lane's ell_stages rounds of dependent loads.  The floor is a
# launch's time on a 64-row operator, the rate the largest shape's bytes
# over its time less the floor, the round the smallest shape's time less
# the floor over its rounds; all at the plans, from `calibrate --k2` (its
# K2_MODEL line; NVIDIA H100 80GB HBM3, 700.00 W).  The layout choice
# (matrix/sharded.py:choose_layout) prices K2 with them beside K4 and K6,
# and ell_form keeps the cheaper form (padded on a tie, K2_FORM_TIE)
K2_MODEL = {"padded": {4: (3.046e12, 1.451e-06, 2.455e-07),
                       8: (3.052e12, 1.484e-06, 2.68e-07)},
            "rowptr": {4: (2.349e12, 1.529e-06, 2.035e-07),
                       8: (2.583e12, 1.583e-06, 1.888e-07)}}
# The model's resolution between K2's forms: ell_form keeps the padded form
# unless the row-pointer form is priced lower by more than this fraction.
# Near the floor the model cannot tell the forms apart: on the card gate
# 3's level-2 P and R (1,507 and 131 rows) measured within 1 % in the two
# forms while the model priced them 3-4 % apart, which of the two was
# faster differed between two cards, and the row-pointer floor measured
# 1.51-1.58 us (4.8 %) in separate calls of `calibrate --k2` (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md)
K2_FORM_TIE = 0.05


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   b=None, s=None, c=None, w: float = 1.0,
                   out=None) -> torch.Tensor:
    """Plain PyTorch padded-ELL SpMV, ``tpusolve``'s ``ell_spmv_local``:
    gather x at every slot, multiply, sum each row (in float64 for
    float32 operands too, rounded once a row, as K2 sums them: a row that
    cancels to near zero keeps its f32 result exact to rounding, where f32
    partial sums leave an error of the diagonal's size).  With any of ``b``,
    ``s``, ``c`` given, the update form (:func:`epilogue_plain`) of that
    product; with ``out``, the result is copied into it and returned.

    ``vals`` and ``cols`` (rows, K), ``x`` (n,), ``b``, ``s``, ``c``
    (rows,) -> y (rows,)."""
    acc = torch.float64 if x.dtype == torch.float32 else x.dtype
    y = (vals.to(acc) * x.index_select(0, cols.reshape(-1)).reshape(
        cols.shape).to(acc)).sum(dim=-1).to(x.dtype)
    if b is not None or s is not None or c is not None:
        y = epilogue_plain(y, b, s, c, w)
    if out is None:
        return y
    return out.copy_(y)


def rowptr_to_padded(rowptr: torch.Tensor, vals: torch.Tensor,
                     cols: torch.Tensor, width: int | None = None):
    """(vals, cols) of the padded form, (rows, width), of a row-pointer
    operator: row i's entries in slots ``0 .. count - 1`` in their order,
    the rest value 0 and column 0.  ``width`` defaults to the largest count
    of entries a row has (at least 1)."""
    rows = rowptr.numel() - 1
    counts = rowptr[1:] - rowptr[:-1]
    nnz = int(rowptr[-1])
    if width is None:
        width = max(1, int(counts.max())) if rows else 1
    row = torch.repeat_interleave(
        torch.arange(rows, device=rowptr.device), counts.long())
    slot = torch.arange(nnz, device=rowptr.device) - rowptr[row].long()
    pv = torch.zeros((rows, width), dtype=vals.dtype, device=vals.device)
    pc = torch.zeros((rows, width), dtype=torch.int32, device=cols.device)
    pv[row, slot] = vals[:nnz]
    pc[row, slot] = cols[:nnz]
    return pv, pc


def pack_rowptr(counts: torch.Tensor, chunks, dtype) -> tuple:
    """(rowptr, vals, cols) of the row-pointer form of an operator with
    ``counts[i]`` entries in row i, from ``chunks``: an iterable (read
    after the row pointer is made) of (row, rank, vals, cols) tensors, the
    entry of rank r in row i going to ``rowptr[i] + r``.  ``rowptr`` is
    int32 unless the entries need int64; ``vals`` of ``dtype``, ``cols``
    int32.  Every site that makes the form packs it here."""
    dev = counts.device
    rowptr = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=rowptr[1:])
    nnz = int(rowptr[-1])
    out_v = torch.zeros(nnz, dtype=dtype, device=dev)
    out_c = torch.zeros(nnz, dtype=torch.int32, device=dev)
    for row, rank, v, c in chunks:
        pos = rowptr[row] + rank
        out_v[pos] = v.to(dtype)
        out_c[pos] = c.to(torch.int32)
    if nnz < 2 ** 31:
        rowptr = rowptr.to(torch.int32)
    return rowptr, out_v, out_c


def padded_to_rowptr(vals: torch.Tensor, cols: torch.Tensor):
    """(rowptr, vals, cols) of the row-pointer form of a padded operator
    (:func:`pack_rowptr`): each row keeps its slots up to its last one that
    is not padding (value or column not 0), in slot order.
    :func:`rowptr_to_padded` at the padded width gives the padded form back
    exactly."""
    rows, K = vals.shape
    live = (vals != 0) | (cols != 0)
    slot1 = torch.arange(1, K + 1, device=vals.device)
    counts = torch.where(live, slot1, 0).amax(dim=1) if K else \
        torch.zeros(rows, dtype=torch.int64, device=vals.device)
    keep = slot1[None] <= counts[:, None]
    row, rank = keep.nonzero(as_tuple=True)
    return pack_rowptr(counts, [(row, rank, vals[keep], cols[keep])],
                       vals.dtype)


def ell_rowptr_plain(rowptr: torch.Tensor, vals: torch.Tensor,
                     cols: torch.Tensor, x: torch.Tensor, b=None, s=None,
                     c=None, w: float = 1.0, out=None,
                     width: int | None = None) -> torch.Tensor:
    """Plain PyTorch SpMV of the row-pointer form: the padded form at
    ``width`` (:func:`rowptr_to_padded`) through :func:`ell_spmv_plain`, so
    that it gives the padded plain version's bits on the same operator at
    the same width.  Arguments as :func:`ell_spmv_plain`; ``rowptr``
    (rows + 1,), ``vals`` and ``cols`` (nnz,)."""
    pv, pc = rowptr_to_padded(rowptr, vals, cols, width)
    return ell_spmv_plain(pv, pc, x, b, s, c, w, out)


def ell_bytes(form: str, rows: int, ncols: int, K: int, nnz: int,
              itemsize: int) -> int:
    """Bytes one K2 launch moves in ``form``: the padded slots (value and
    int32 column) or the entries and the row pointer (int32, int64 past
    2**31 entries), plus x (``ncols``) and y once each."""
    vec = (rows + ncols) * itemsize
    if form == "padded":
        return (itemsize + 4) * rows * K + vec
    ptr = 4 if nnz < 2 ** 31 else 8
    return (itemsize + 4) * nnz + ptr * (rows + 1) + vec


def ell_stages(form: str, rows: int, K: int, nnz: int,
               width: int | None = None) -> int:
    """Rounds of dependent loads of K2's longest lane in ``form``: its
    entries (``K`` slots padded, the longest row's ``width`` entries in the
    row-pointer form, ``K`` unless given) over the plan's G, in stages of
    ``K2_STAGE``; in the row-pointer form one more, the row's two pointers,
    which a lane reads before it can load an entry."""
    if form == "padded":
        g, w = k2_plan(rows, K), K
    else:
        g, w = k2_rowptr_plan(rows, nnz), K if width is None else width
    lane = -(-w // g)
    return -(-lane // K2_STAGE) + (form != "padded")


@functools.cache
def k2_plan(rows: int, K: int) -> int:
    """G, the threads a row of K2 on a block of ``rows`` rows and ``K``
    slots: the least G of ``GROUPS`` with ``rows * G`` at least
    ``K2_FILL_THREADS`` and ``ceil(K / G)`` at most ``K2_LANE_SLOTS``, but
    none above the least power of two that reaches K (every lane at least
    one slot)."""
    g = 1
    while g < GROUPS[-1] and g < K and (
            rows * g < K2_FILL_THREADS or -(-K // g) > K2_LANE_SLOTS):
        g *= 2
    return g


@functools.cache
def k2_rowptr_plan(rows: int, nnz: int) -> int:
    """G, the threads a row of K2 on a row-pointer operator of ``rows``
    rows and ``nnz`` entries: the least G of ``GROUPS`` with ``rows * G``
    at least ``K2_FILL_THREADS`` and at most ``K2_ROWPTR_LANE_ENTRIES`` of
    the mean row's entries a lane, but none at or above the mean (every
    lane of a mean row at least one entry)."""
    g = 1
    while g < GROUPS[-1] and g * rows < nnz and (
            rows * g < K2_FILL_THREADS
            or -(-nnz // (rows * g)) > K2_ROWPTR_LANE_ENTRIES):
        g *= 2
    return g


MAX_COLS = 8    # columns of K2's k-column form (csrc kMaxCols)


def pack_columns(x: torch.Tensor) -> torch.Tensor:
    """The batch ``x`` (k, n), 2 <= k <= ``MAX_COLS``, packed as K2's
    k-column form reads it: (n, k), entry i's k columns side by side.  CUDA
    tensors launch ``csrc/ell_spmv.cuh``'s ``ell_pack`` (counted by
    ``pack_columns.launches``); CPU tensors take the plain version."""
    k, n = x.shape
    if not 2 <= k <= MAX_COLS:
        raise ValueError(f"pack_columns: 2 to {MAX_COLS} columns")
    if x.device.type == "cpu":
        return x.T.contiguous()
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError(f"pack_columns: unsupported {x.dtype} on "
                         f"{x.device}")
    if x.stride(1) != 1:
        raise ValueError("pack_columns: x's columns must be contiguous")
    lib, _ = _kernel_fns()
    xp = torch.empty((n, k), dtype=x.dtype, device=x.device)
    fn = lib.ell_pack_f32 if x.dtype == torch.float32 else lib.ell_pack_f64
    build.launch(lib, fn, x, "ell_pack launch", x.data_ptr(), x.stride(0),
                 n, k, xp.data_ptr())
    pack_columns.launches += 1
    return xp


pack_columns.launches = 0


@functools.cache
def _kernel_fns(defines: tuple = ()):
    """(library, {(value dtype, x dtype): entry point}) with ctypes
    signatures declared, of the build with ``defines`` (none: the port's;
    ``kernels/calibrate.py --k2-sum`` compares others): the entry points
    on values of x's dtype and the pack from ``csrc/ell_spmv.cu``, those
    on bf16 values from ``csrc/ell_spmv_bf16.cu``, which compile apart."""
    lib = build.load("ell_spmv", defines)
    bf16 = build.load("ell_spmv_bf16", defines)
    fns = {(torch.float32, torch.float32): lib.ell_spmv_f32,
           (torch.float64, torch.float64): lib.ell_spmv_f64,
           (torch.bfloat16, torch.float32): bf16.ell_spmv_bf16_f32,
           (torch.bfloat16, torch.float64): bf16.ell_spmv_bf16_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.ell_pack_f32, lib.ell_pack_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fns


def _check_operands(vals, cols, x, rowptr) -> tuple:
    """(form, rows, K or nnz) of K2's operands, or raise.  ``vals`` are of
    x's dtype, or bfloat16 (the smoother twin)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv: unsupported dtype {x.dtype}")
    if vals.dtype not in (x.dtype, torch.bfloat16):
        raise TypeError("ell_spmv: vals must be of x's dtype or bfloat16")
    if rowptr is None:
        if vals.dim() != 2:
            raise TypeError("ell_spmv: vals must be (rows, K)")
        if cols.dtype != torch.int32 or cols.shape != vals.shape:
            raise TypeError("ell_spmv: cols must be int32 of vals' shape")
        rows, K = vals.shape
        if rows >= 2 ** 31 or K >= 2 ** 31 or rows * K == 0:
            raise ValueError("ell_spmv: vals must be (rows, K) non-empty, "
                             "below 2**31 rows")
        return "padded", rows, K
    if vals.dim() != 1:
        raise TypeError("ell_spmv: row-pointer vals must be (nnz,)")
    if cols.dtype != torch.int32 or cols.shape != vals.shape:
        raise TypeError("ell_spmv: cols must be int32 of vals' shape")
    if rowptr.dim() != 1 or rowptr.dtype not in (torch.int32, torch.int64):
        raise TypeError("ell_spmv: rowptr must be (rows + 1,) int32 or int64")
    rows = rowptr.numel() - 1
    if not 1 <= rows < 2 ** 31:
        raise ValueError("ell_spmv: rowptr must hold 1 to 2**31 - 1 rows")
    return "rowptr", rows, vals.numel()


def _plain(vals, cols, x, b, s, c, w, out, rowptr):
    """The plain version of one column, or column by column of a batch
    (each column the single form's bits)."""
    if x.dim() == 2:
        col = lambda t, j: t if t is None or t.dim() == 1 else t[j]
        ys = [_plain(vals, cols, x[j], col(b, j), s, col(c, j), w,
                     col(out, j), rowptr) for j in range(x.shape[0])]
        return out if out is not None else torch.stack(ys)
    if rowptr is None:
        return ell_spmv_plain(vals, cols, x, b, s, c, w, out)
    return ell_rowptr_plain(rowptr, vals, cols, x, b, s, c, w, out)


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             b=None, s=None, c=None, w: float = 1.0, *, out=None,
             groups: int | None = None, rowptr=None, packed: bool = False,
             offd: bool = False,
             ghost_prolong: bool = False) -> torch.Tensor:
    """ELL SpMV, ``y = A @ x``, or with any of ``b``, ``s``, ``c`` given its
    update form ``y = c + w * s * (b - A x)`` (arguments as
    :func:`ell_spmv_plain`); written into ``out`` when given, which may be
    ``c`` but not x, b or s.  Without ``rowptr`` the operator is padded
    (``vals``, ``cols`` (rows, K)); with it, row-pointer (``vals``, ``cols``
    (nnz,)).

    ``x`` (n,) is one vector; ``x`` (k, n), 1 <= k <= ``MAX_COLS``, is k
    vectors (the k-column form: one launch reads the operator once for
    all), and ``b``, ``c``, ``out`` are then (k, rows) and ``s`` one
    (rows,) vector for all columns.  On the card a batch of k > 1 is
    packed first (:func:`pack_columns`, one launch) and read packed;
    ``packed=True`` takes x already packed, (n, k) (chip_smoke.py times the
    launch without the pack so).
    ``vals`` may be bfloat16 (the smoother twin): each value widened
    exactly to x's dtype.

    CPU tensors take the plain version of their form (a batch column by
    column).  CUDA tensors launch the kernel of ``csrc/ell_spmv.cuh``
    (building it on first use) once, on the launch plan of :func:`k2_plan`
    or :func:`k2_rowptr_plan` unless ``groups`` names another G, or raise;
    there is no fallback.  ``ell_spmv.launches`` counts kernel launches,
    ``ell_spmv.launches_by_form`` the same by the update form's name
    (:func:`~tpusolve_torch.kernels.dia.epilogue_mode`),
    ``ell_spmv.launches_by_layout`` by storage form (``FORMS``),
    ``ell_spmv.launches_by_cols`` by the columns k of a launch,
    ``ell_spmv.launches_bf16`` those on bfloat16 values and
    ``ell_spmv.launches_offd`` those the caller marks ``offd`` (a
    multi-part operator's offd block, ``matrix/spmv.py``) and
    ``ell_spmv.launches_ghost_prolong`` those it marks ``ghost_prolong``
    (the box prolongation's rows at the ghosts' sources,
    ``amg/structured.py:_ghost_prolongation``)."""
    if packed and x.dim() != 2:
        raise ValueError("ell_spmv: a packed x is (n, k)")
    if x.device.type == "cpu":
        return _plain(vals, cols, x.T if packed else x, b, s, c, w, out,
                      rowptr)
    form, rows, size = _check_operands(vals, cols, x, rowptr)
    if x.dim() not in (1, 2):
        raise ValueError("ell_spmv: x must be (n,) or a batch of vectors")
    k = x.shape[1] if packed else (1 if x.dim() == 1 else x.shape[0])
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"ell_spmv: 1 to {MAX_COLS} columns")
    vec = (rows,) if x.dim() == 1 else (k, rows)
    for name, t in (("vals", vals), ("cols", cols), ("rowptr", rowptr),
                    ("x", x), ("b", b), ("s", s), ("c", c), ("out", out)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ell_spmv: {name} must be contiguous on "
                             f"{x.device}")
        if name in ("b", "s", "c", "out") and (
                t.dtype != x.dtype
                or tuple(t.shape) != ((rows,) if name == "s" else vec)):
            raise TypeError(f"ell_spmv: {name} must be of x's dtype and "
                            f"shape {(rows,) if name == 's' else vec}")
    if out is not None and any(
            t is not None and t.data_ptr() == out.data_ptr()
            for t in (x, b, s)):
        raise ValueError("ell_spmv: out may be c, never x, b or s")
    if form == "padded":
        g = k2_plan(rows, size) if groups is None else groups
    else:
        g = k2_rowptr_plan(rows, size) if groups is None else groups
    if g not in GROUPS:
        raise ValueError(f"ell_spmv: groups must be one of {GROUPS}")
    # the device last: tensors on the meta device try every check above
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {x.device}")
    lib, fns = _kernel_fns()
    if k > 1 and not packed:
        x = pack_columns(x)
    y = torch.empty(vec, dtype=x.dtype, device=x.device) if out is None \
        else out
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch(lib, fns[vals.dtype, x.dtype], x, "ell_spmv launch",
                 ptr(rowptr), int(rowptr is not None
                                  and rowptr.dtype == torch.int64),
                 vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
                 y.data_ptr(), rows, size if form == "padded" else 0, g, k,
                 rows, ptr(b), ptr(s), ptr(c), float(w))
    ell_spmv.launches += 1
    for counts, key in ((ell_spmv.launches_by_form, epilogue_mode(b, s, c)),
                        (ell_spmv.launches_by_layout, form),
                        (ell_spmv.launches_by_cols, k)):
        counts[key] = counts.get(key, 0) + 1
    ell_spmv.launches_bf16 += vals.dtype == torch.bfloat16
    ell_spmv.launches_offd += bool(offd)
    ell_spmv.launches_ghost_prolong += bool(ghost_prolong)
    return y


ell_spmv.launches = 0
ell_spmv.launches_by_form = {}
ell_spmv.launches_by_layout = {}
ell_spmv.launches_by_cols = {}
ell_spmv.launches_bf16 = 0
ell_spmv.launches_offd = 0
ell_spmv.launches_ghost_prolong = 0
