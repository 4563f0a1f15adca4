"""Padded-ELL SpMV: plain PyTorch version and the CUDA kernel K2.

A padded-ELL block stores, for each of its ``rows`` rows, ``K`` slots:

* ``vals``: (rows, K) values, zero in padded slots and padded rows;
* ``cols``: (rows, K) int32 columns into x, zero in padded slots.

SpMV gathers x at every slot's column::

    y[i] = sum_k vals[i, k] * x[cols[i, k]]

and x may be longer or shorter than y (the AMG transfers P and R).  Besides
``y = A x``, one launch computes the update form ``y = c + w * s (.) (b -
A x)`` of :func:`~tpusolve_torch.kernels.dia.epilogue_plain`, as K1 does,
with ``out`` allowed to be ``c``: the prolongation ``x + P e`` is written
into x in place.

``ell_spmv`` launches the hand-written Hopper kernel K2,
``csrc/ell_spmv.cu`` (the port of ``tpusolve``'s ``ell_spmv_local``), on
CUDA tensors and runs ``ell_spmv_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusolve_torch.kernels import build
from tpusolve_torch.kernels.dia import epilogue_mode, epilogue_plain

GROUPS = (1, 2, 4, 8, 16, 32)   # threads a row K2 is built for
# K2's launch plan (k2_plan): G threads a row until a launch has
# K2_FILL_THREADS threads and a lane at most K2_LANE_SLOTS slots.  On the
# ELL shapes of the BoomerAMG paths (H100 80GB HBM3 at 700 W,
# `python -m tpusolve_torch.kernels.calibrate --k2`; PERF.md) this picks
# the fastest G but at K = 123 (32 where 8 is 13 % faster in f64)
K2_FILL_THREADS = 131_072
K2_LANE_SLOTS = 6
# K2's constants for the SpMV time model (matrix/sharded.py:spmv_model_s),
# by item size: (bytes/s at the full shape, threads_full), from the same
# measurement; no layout choice reads them yet
K2_MODEL = {4: (2.952e12, 48_954), 8: (2.992e12, 38_661)}


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   b=None, s=None, c=None, w: float = 1.0,
                   out=None) -> torch.Tensor:
    """Plain PyTorch padded-ELL SpMV, ``tpusolve``'s ``ell_spmv_local``:
    gather x at every slot, multiply, sum each row.  With any of ``b``,
    ``s``, ``c`` given, the update form (:func:`epilogue_plain`) of that
    product; with ``out``, the result is copied into it and returned.

    ``vals`` and ``cols`` (rows, K), ``x`` (n,), ``b``, ``s``, ``c``
    (rows,) -> y (rows,)."""
    y = (vals * x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
         ).sum(dim=-1)
    if b is not None or s is not None or c is not None:
        y = epilogue_plain(y, b, s, c, w)
    if out is None:
        return y
    return out.copy_(y)


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
def _kernel_fns():
    """(library, {dtype: entry point}) with ctypes signatures declared."""
    lib = build.load("ell_spmv")
    fns = {torch.float32: lib.ell_spmv_f32, torch.float64: lib.ell_spmv_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             b=None, s=None, c=None, w: float = 1.0, *, out=None,
             groups: int | None = None) -> torch.Tensor:
    """Padded-ELL SpMV, ``y = A @ x``, or with any of ``b``, ``s``, ``c``
    given its update form ``y = c + w * s * (b - A x)`` (arguments as
    :func:`ell_spmv_plain`); written into ``out`` when given, which may be
    ``c`` but not x, b or s.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/ell_spmv.cu`` (building it on first use) once, on the launch
    plan of :func:`k2_plan` unless ``groups`` names another G, or raise;
    there is no fallback.  ``ell_spmv.launches`` counts kernel launches,
    ``ell_spmv.launches_by_form`` the same by the form's name
    (:func:`~tpusolve_torch.kernels.dia.epilogue_mode`)."""
    if x.device.type == "cpu":
        return ell_spmv_plain(vals, cols, x, b, s, c, w, out)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv: unsupported dtype {x.dtype}")
    if vals.dim() != 2 or vals.dtype != x.dtype:
        raise TypeError("ell_spmv: vals must be (rows, K) of x's dtype")
    if cols.dtype != torch.int32 or cols.shape != vals.shape:
        raise TypeError("ell_spmv: cols must be int32 of vals' shape")
    rows, K = vals.shape
    if x.dim() != 1 or rows >= 2 ** 31 or K >= 2 ** 31 or rows * K == 0:
        raise ValueError("ell_spmv: x must be flat and vals (rows, K) "
                         "non-empty, below 2**31 rows")
    for name, t in (("vals", vals), ("cols", cols), ("x", x), ("b", b),
                    ("s", s), ("c", c), ("out", out)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ell_spmv: {name} must be contiguous on "
                             f"{x.device}")
        if name in ("b", "s", "c", "out") and (
                t.dtype != x.dtype or t.shape != (rows,)):
            raise TypeError(f"ell_spmv: {name} must be ({rows},) of x's "
                            "dtype")
    if out is not None and any(
            t is not None and t.data_ptr() == out.data_ptr()
            for t in (x, b, s)):
        raise ValueError("ell_spmv: out may be c, never x, b or s")
    g = k2_plan(rows, K) if groups is None else groups
    if g not in GROUPS:
        raise ValueError(f"ell_spmv: groups must be one of {GROUPS}")
    # the device last: tensors on the meta device try every check above
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {x.device}")
    lib, fns = _kernel_fns()
    y = torch.empty(rows, dtype=x.dtype, device=x.device) if out is None \
        else out
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch(lib, fns[x.dtype], x, "ell_spmv launch", vals.data_ptr(),
                 cols.data_ptr(), x.data_ptr(), y.data_ptr(), rows, K, g,
                 ptr(b), ptr(s), ptr(c), float(w))
    ell_spmv.launches += 1
    form = epilogue_mode(b, s, c)
    forms = ell_spmv.launches_by_form
    forms[form] = forms.get(form, 0) + 1
    return y


ell_spmv.launches = 0
ell_spmv.launches_by_form = {}
