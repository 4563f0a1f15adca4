"""Box-DIA SpMV: plain PyTorch version and the CUDA kernel K1.

A box-DIA diag block stores, for a part's (nz, ny, nx) box of rows (x
fastest), one plane of coefficients per slot d:

* ``vals``: (P, D, nz, ny, nx), ``vals[p, d, z, y, x]`` couples row
  (z, y, x) to its neighbour (z + dz_d, y + dy_d, x + dx_d);
* ``offsets``: D triples (dz, dy, dx), in stored order.

SpMV adds every slot's plane times x shifted by the slot's triple, a
neighbour outside the box reading as zero::

    y[z, y, x] = sum_d vals[d, z, y, x] * x[z + dz_d, y + dy_d, x + dx_d]

``tpusolve`` keeps flat offsets and turns each back into its triple
(``matrix/spmv.py:_decompose_offset``), which fails on a box whose y or x
extent is 4 under a 125-point operator; the port keeps the triples.  The
1-D DIA form of ``tpusolve`` (no ``dia_shape``) is the box (1, 1, R) with
triples (0, 0, offset).

Besides ``y = A x``, one launch computes the update form
``y = c + w * s (.) (b - A x)``, any of ``b``, ``s``, ``c`` absent (b = 0,
s = 1, c = 0): the residual, Jacobi and Chebyshev updates of the V-cycle
(``matrix/spmv.py:spmv_update``).

``dia_spmv`` launches the hand-written Hopper kernel K1, ``csrc/dia_spmv.cu``
(the port of ``tpusolve``'s ``dia_spmv_local``), on CUDA tensors and runs
``dia_spmv_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusolve_torch.kernels import build

MAX_SLOTS = 128   # slots K1's table holds (csrc/dia_spmv.cu: kMaxSlots)
GROUPS = (1, 2, 4, 8, 16)   # threads a row K1 is built for
# K1's launch plan (k1_plan): G threads a row until a launch has
# K1_FILL_THREADS threads and a thread at most K1_THREAD_SLOTS slots.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md,
# `python -m tpusolve_torch.kernels.calibrate --k1`)
K1_FILL_THREADS = 131_072
K1_THREAD_SLOTS = 64


def epilogue_plain(y: torch.Tensor, b=None, s=None, c=None,
                   w: float = 1.0) -> torch.Tensor:
    """``c + w * s * (b - y)`` for ``y = A x``, each of ``b``, ``s``, ``c``
    possibly None (b = 0, s = 1, c = 0), in the order the eager callers
    computed it: ``t = b - y`` (or ``y``), ``t = (w * s) * t``, then
    ``c + t`` (``c - t`` without b).  With ``w == 1`` the factor is
    skipped, so ``s * (b - y)``, ``b - y`` and ``c - s * y`` are the bits
    of the expressions they replace."""
    t = y if b is None else b - y
    if s is not None:
        t = (s if w == 1.0 else w * s) * t
    elif w != 1.0:
        t = w * t
    if c is None:
        return t if b is not None else -t
    return c + t if b is not None else c - t


def epilogue_mode(b=None, s=None, c=None) -> str:
    """The name of the form a K1 launch computes, by which of b, s, c it
    has: ``"Ax"``, else ``[c+]w*[s*](b-Ax)`` with ``-Ax`` when b is
    absent."""
    if b is None and s is None and c is None:
        return "Ax"
    return (("c+" if c is not None else "") + "w*"
            + ("s*" if s is not None else "")
            + ("(b-Ax)" if b is not None else "(-Ax)"))


def dia_spmv_plain(vals: torch.Tensor, offsets, x: torch.Tensor, b=None,
                   s=None, c=None, w: float = 1.0) -> torch.Tensor:
    """Plain PyTorch box-DIA SpMV, the math of ``tpusolve``'s
    ``dia_spmv_local``: pad each part's box of x with zeros, then add slot by
    slot, in the stored order, the plane times the shifted slice.  With any
    of ``b``, ``s``, ``c`` given, the update form
    (:func:`epilogue_plain`) of that product.

    ``vals`` (P, D, nz, ny, nx), ``offsets`` D triples (dz, dy, dx), ``x``
    and ``b``, ``s``, ``c`` (P * nz * ny * nx,) -> y of x's shape."""
    P = vals.shape[0]
    box = tuple(vals.shape[2:])
    pads = [max(1, max((abs(o[i]) for o in offsets), default=0))
            for i in range(3)]
    xs = x.reshape((P,) + box)
    xp = torch.nn.functional.pad(xs, (pads[2], pads[2], pads[1], pads[1],
                                      pads[0], pads[0]))
    acc = torch.zeros((P,) + box, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        lo = [p + c_ for p, c_ in zip(pads, off)]
        seg = xp[:, lo[0]:lo[0] + box[0], lo[1]:lo[1] + box[1],
                 lo[2]:lo[2] + box[2]]
        acc = acc + vals[:, k] * seg
    y = acc.reshape(-1)
    if b is None and s is None and c is None:
        return y
    return epilogue_plain(y, b, s, c, w)


@functools.cache
def k1_plan(rows: int, nslots: int) -> int:
    """G, the threads a row of K1 on a box of ``rows`` rows a part and
    ``nslots`` slots.

    The rule: the least G of ``GROUPS`` with ``rows * G`` at least
    ``K1_FILL_THREADS`` and ``ceil(D / G)`` at most ``K1_THREAD_SLOTS``,
    but none above the one that leaves each thread one stage of 8 slots
    (ceil(D / 8)).  On the structured levels: one thread a row at 64^3 and
    128^3 under D = 27, two at 64^3 under D = 125, four at 32^3, sixteen
    at 16^3 and 8^3."""
    g = 1
    cap = max(1, -(-nslots // 8))
    while g < GROUPS[-1] and g < cap and (
            rows * g < K1_FILL_THREADS or -(-nslots // g) > K1_THREAD_SLOTS):
        g *= 2
    return g


@functools.cache
def _kernel_fns():
    """(library, {dtype: entry point}) with ctypes signatures declared."""
    lib = build.load("dia_spmv")
    fns = {torch.float32: lib.dia_spmv_f32, torch.float64: lib.dia_spmv_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_double,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


@functools.lru_cache(maxsize=256)
def _table(offsets: tuple):
    """The triples as the flat C int array K1's entry point reads."""
    flat = [int(c) for off in offsets for c in off]
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def dia_spmv(vals: torch.Tensor, offsets: tuple, x: torch.Tensor, b=None,
             s=None, c=None, w: float = 1.0, *, groups: int | None = None
             ) -> torch.Tensor:
    """Box-DIA SpMV, ``y = A @ x``, or with any of ``b``, ``s``, ``c``
    given its update form ``y = c + w * s * (b - A x)`` (arguments as
    :func:`dia_spmv_plain`; ``offsets`` a tuple of int triples).

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/dia_spmv.cu`` (building it on first use) once, on the launch plan
    of :func:`k1_plan` unless ``groups`` names another G, or
    raise; there is no fallback.  ``dia_spmv.launches`` counts kernel
    launches, ``dia_spmv.launches_by_form`` the same by which of (b, s, c)
    were given (named by :func:`launches_by_mode`)."""
    if x.device.type == "cpu":
        return dia_spmv_plain(vals, offsets, x, b, s, c, w)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_spmv: unsupported dtype {x.dtype}")
    if vals.dim() != 5 or vals.dtype != x.dtype:
        raise TypeError("dia_spmv: vals must be (P, D, nz, ny, nx) of x's "
                        "dtype")
    P, D, nz, ny, nx = vals.shape
    if len(offsets) != D or any(len(o) != 3 for o in offsets):
        raise ValueError(f"dia_spmv: need {D} offset triples")
    if D > MAX_SLOTS:
        raise ValueError(f"dia_spmv: {D} slots, K1 takes at most "
                         f"{MAX_SLOTS}")
    box = nz * ny * nx
    if box >= 2 ** 31 or x.shape != (P * box,):
        raise ValueError("dia_spmv: x must be flat (P * nz * ny * nx,) "
                         "below 2**31 rows a part")
    for name, t in (("vals", vals), ("x", x), ("b", b), ("s", s), ("c", c)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"dia_spmv: {name} must be contiguous on "
                             f"{x.device}")
        if name != "vals" and (t.dtype != x.dtype or t.shape != x.shape):
            raise TypeError(f"dia_spmv: {name} must be of x's dtype and "
                            "shape")
    g = k1_plan(box, D) if groups is None else groups
    if g not in GROUPS:
        raise ValueError(f"dia_spmv: groups must be one of {GROUPS}")
    # the device last: tensors on the meta device try every check above
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
    lib, fns = _kernel_fns()
    y = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch(lib, fns[x.dtype], x, "dia_spmv launch", vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), ctypes.addressof(_table(
                     offsets)), D, P, nz, ny, nx, g, ptr(b),
                 ptr(s), ptr(c), float(w))
    dia_spmv.launches += 1
    form = (b is not None, s is not None, c is not None)
    forms = dia_spmv.launches_by_form
    forms[form] = forms.get(form, 0) + 1
    return y


dia_spmv.launches = 0
dia_spmv.launches_by_form = {}


def launches_by_mode() -> dict:
    """``dia_spmv.launches_by_form`` keyed by :func:`epilogue_mode`'s
    names."""
    return {epilogue_mode(*(True if f else None for f in form)): n
            for form, n in dia_spmv.launches_by_form.items()}
