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


def dia_spmv_plain(vals: torch.Tensor, offsets, x: torch.Tensor
                   ) -> torch.Tensor:
    """Plain PyTorch box-DIA SpMV, the math of ``tpusolve``'s
    ``dia_spmv_local``: pad each part's box of x with zeros, then add slot by
    slot, in the stored order, the plane times the shifted slice.

    ``vals`` (P, D, nz, ny, nx), ``offsets`` D triples (dz, dy, dx), ``x``
    (P * nz * ny * nx,) -> y of x's shape."""
    P = vals.shape[0]
    box = tuple(vals.shape[2:])
    pads = [max(1, max((abs(o[i]) for o in offsets), default=0))
            for i in range(3)]
    xs = x.reshape((P,) + box)
    xp = torch.nn.functional.pad(xs, (pads[2], pads[2], pads[1], pads[1],
                                      pads[0], pads[0]))
    acc = torch.zeros((P,) + box, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        lo = [p + c for p, c in zip(pads, off)]
        seg = xp[:, lo[0]:lo[0] + box[0], lo[1]:lo[1] + box[1],
                 lo[2]:lo[2] + box[2]]
        acc = acc + vals[:, k] * seg
    return acc.reshape(-1)


@functools.cache
def _kernel_fns():
    """(library, {dtype: entry point}) with ctypes signatures declared."""
    lib = build.load("dia_spmv")
    fns = {torch.float32: lib.dia_spmv_f32, torch.float64: lib.dia_spmv_f64}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


@functools.lru_cache(maxsize=256)
def _table(offsets: tuple):
    """The triples as the flat C int array K1's entry point reads."""
    flat = [int(c) for off in offsets for c in off]
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def dia_spmv(vals: torch.Tensor, offsets: tuple, x: torch.Tensor
             ) -> torch.Tensor:
    """Box-DIA SpMV, ``y = A @ x`` (arguments as :func:`dia_spmv_plain`;
    ``offsets`` a tuple of int triples).

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/dia_spmv.cu`` (building it on first use) or raise; there is no
    fallback.  ``dia_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return dia_spmv_plain(vals, offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
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
    for name, t in (("vals", vals), ("x", x)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"dia_spmv: {name} must be contiguous on "
                             f"{x.device}")
    lib, fns = _kernel_fns()
    y = torch.empty_like(x)
    build.launch(lib, fns[x.dtype], x, "dia_spmv launch", vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), ctypes.addressof(_table(
                     offsets)), D, P, nz, ny, nx)
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
