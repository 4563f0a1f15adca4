"""Box transfers of the structured V-cycle: plain PyTorch versions and the
CUDA kernels K3.

One part's coarse box (nz, ny, nx) and its fine box (2nz, 2ny, 2nx), x
fastest.  The prolongation is cell-centred trilinear interpolation, one axis
at a time (``tpusolve/amg/structured.py:_up1``)::

    fine 2c   = .75 a[c] + .25 a[max(c - 1, 0)]
    fine 2c+1 = .75 a[c] + .25 a[min(c + 1, m - 1)]

and the restriction is its exact adjoint (``_down1``): coarse c =
.75 (r[2c] + r[2c+1]) + .25 r[2c-1] + .25 r[2c+2], the edge cell standing
in for a neighbour outside the box.

``box_prolong`` and ``box_restrict`` launch the hand-written Hopper kernels
of ``csrc/box_transfer.cu`` (the port of ``tpusolve``'s ``_prolong_local``
and ``_restrict_local``, an XLA fusion there) on CUDA tensors, one launch a
transfer with the three axes in one pass, and run ``prolong_plain`` and
``restrict_plain`` on CPU tensors.  The kernels do the plain versions'
arithmetic in their order, so the two agree bit for bit.

On the V-cycle the transfers ride inside K1's launches:
``box_restrict_residual`` computes ``P^T (b - A x)`` and
``box_prolong_update`` computes ``x' = x + P ec`` and K1's update
``[x'] + w * s * (b - A x')`` in one launch each (``csrc/box_cycle.cu``),
equal to the K1 -> K3 and K3 -> K1 pairs bit for bit; on CPU tensors they
run ``restrict_residual_plain`` and ``prolong_update_plain``, the plain
versions of those pairs in their order.  ``box_prolong`` and
``box_restrict`` stay as the yardstick the fused kernels must equal.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusolve_torch.kernels import build
from tpusolve_torch.kernels.dia import (
    MAX_SLOTS, _table, dia_spmv_plain, k1_plan)


# ----------------------------------------------------------------------
# plain versions: eager PyTorch over the part's box
def _interleave(even, odd, axis):
    """out[2i] = even[i], out[2i+1] = odd[i] along ``axis``.  (``tpusolve``
    interleaves by dilation padding, for the TPU's tiling only.)"""
    shape = list(even.shape)
    shape[axis] *= 2
    return torch.stack((even, odd), dim=axis + 1).reshape(shape)


def _clamp_shift(a, axis, direction):
    """shift by one with edge clamp: direction -1 -> a[i-1], +1 -> a[i+1]."""
    n = a.shape[axis]
    if direction < 0:
        first = a.narrow(axis, 0, 1)
        rest = a.narrow(axis, 0, n - 1)
        return torch.cat([first, rest], dim=axis)
    last = a.narrow(axis, n - 1, 1)
    rest = a.narrow(axis, 1, n - 1)
    return torch.cat([rest, last], dim=axis)


def _up1(a, axis):
    even = 0.75 * a + 0.25 * _clamp_shift(a, axis, -1)
    odd = 0.75 * a + 0.25 * _clamp_shift(a, axis, +1)
    return _interleave(even, odd, axis)


def _down1(r, axis):
    """Exact adjoint of _up1 along axis (fine size even)."""
    n = r.shape[axis]
    sl = [slice(None)] * r.dim()
    sl[axis] = slice(0, n, 2)
    even = r[tuple(sl)]
    sl[axis] = slice(1, n, 2)
    odd = r[tuple(sl)]
    mc = even.shape[axis]
    e_first = even.narrow(axis, 0, 1)
    o_prev = odd.narrow(axis, 0, mc - 1)
    t1 = torch.cat([e_first, o_prev], dim=axis)        # r[2c-1] | clamp
    e_next = even.narrow(axis, 1, mc - 1)
    o_last = odd.narrow(axis, mc - 1, 1)
    t2 = torch.cat([e_next, o_last], dim=axis)         # r[2c+2] | clamp
    return 0.75 * (even + odd) + 0.25 * t1 + 0.25 * t2


def _parts_box(v: torch.Tensor, box: tuple) -> tuple:
    """(parts, box) of flat vector ``v`` over whole boxes."""
    n = box[0] * box[1] * box[2]
    if v.dim() != 1 or n == 0 or v.numel() % n:
        raise ValueError(f"box transfer: a vector of {tuple(v.shape)} is "
                         f"not whole boxes {box}")
    return v.numel() // n, tuple(box)


def prolong_plain(fine_box, coarse_box, xc: torch.Tensor, x=None,
                  out=None) -> torch.Tensor:
    """``x + P xc`` (``P xc`` without ``x``) over whole coarse boxes ``xc``
    (parts * nz * ny * nx,), the z, y and x axes in turn; written into
    ``out`` when it is given (it may be ``x``)."""
    P, box = _parts_box(xc, coarse_box)
    a = xc.reshape((P,) + box)
    for axis in range(3):
        a = _up1(a, axis + 1)
    y = a.reshape(-1)
    if x is not None:
        y = x + y
    if out is None:
        return y
    out.copy_(y)
    return out


def restrict_plain(fine_box, coarse_box, rf: torch.Tensor) -> torch.Tensor:
    """``P^T rf`` over whole fine boxes ``rf`` (parts * 8 * nz * ny * nx,),
    the z, y and x axes in turn."""
    P, box = _parts_box(rf, fine_box)
    a = rf.reshape((P,) + box)
    for axis in range(3):
        a = _down1(a, axis + 1)
    return a.reshape(-1)


def restrict_residual_plain(fine_box, coarse_box, vals, offsets,
                            x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``P^T (b - A x)`` for the box-DIA operator ``A`` (``vals``,
    ``offsets`` as :func:`kernels.dia.dia_spmv_plain` takes them): the
    residual, then the restriction, as the cycle ran them in turn."""
    return restrict_plain(fine_box, coarse_box,
                          dia_spmv_plain(vals, offsets, x, b=b))


def prolong_update_plain(fine_box, coarse_box, vals, offsets,
                         ec: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                         s=None, w: float = 1.0, c_is_xnew: bool = True,
                         xnew_out=None, out=None) -> torch.Tensor:
    """``y = [x'] + w * s * (b - A x')`` for ``x' = x + P ec``, the bracket
    (``c = x'``) present when ``c_is_xnew``: the prolongation with its add,
    then K1's update form, as the cycle ran them in turn.  ``x'`` is copied
    into ``xnew_out`` and ``y`` into ``out`` when they are given."""
    xn = prolong_plain(fine_box, coarse_box, ec, x)
    y = dia_spmv_plain(vals, offsets, xn, b=b, s=s,
                       c=xn if c_is_xnew else None, w=w)
    if xnew_out is not None:
        xnew_out.copy_(xn)
    return y if out is None else out.copy_(y)


# ----------------------------------------------------------------------
# the kernels
@functools.cache
def _kernel_fns():
    """(library, {(kind, dtype): entry point}) with ctypes signatures."""
    lib = build.load("box_transfer")
    fns = {}
    for dt, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fp = getattr(lib, f"box_prolong_{suffix}")
        fp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fr = getattr(lib, f"box_restrict_{suffix}")
        fr.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        for fn in (fp, fr):
            fn.restype = ctypes.c_int
        fns["prolong", dt], fns["restrict", dt] = fp, fr
    return lib, fns


@functools.cache
def _fused_fns():
    """(library, {(kind, dtype): entry point}) of ``csrc/box_cycle.cu``."""
    lib = build.load("box_cycle")
    fns = {}
    for dt, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fr = getattr(lib, f"box_restrict_residual_{suffix}")
        fr.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fp = getattr(lib, f"box_prolong_update_{suffix}")
        fp.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        fb = getattr(lib, f"box_prolong_update_bf16_{suffix}")
        fb.argtypes = fp.argtypes
        for fn in (fr, fp, fb):
            fn.restype = ctypes.c_int
        fns["restrict", dt], fns["prolong", dt] = fr, fp
        fns["prolong", torch.bfloat16, dt] = fb
    return lib, fns


def _check(what: str, fine_box, coarse_box, v: torch.Tensor, box, others):
    """Raise unless ``v`` (and each of ``others``, None or not) is a flat
    contiguous f32/f64 CUDA vector over whole ``box`` boxes; returns the
    parts.  The device is checked last, so that every check can be tried
    on the CPU with tensors on the ``meta`` device."""
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {v.dtype}")
    if tuple(2 * c for c in coarse_box) != tuple(fine_box) or len(
            fine_box) != 3:
        raise ValueError(f"{what}: fine box {fine_box} is not twice the "
                         f"coarse box {coarse_box}")
    parts, _ = _parts_box(v, box)
    if parts * 8 * coarse_box[0] * coarse_box[1] * coarse_box[2] >= 2 ** 31:
        raise ValueError(f"{what}: the boxes exceed 2**31 fine points")
    if not v.is_contiguous():
        raise ValueError(f"{what}: the vector must be contiguous")
    for name, t, shape in others:
        if t is None:
            continue
        if t.device != v.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{v.device}")
        if t.dtype != v.dtype or tuple(t.shape) != shape:
            raise TypeError(f"{what}: {name} must be {v.dtype} of shape "
                            f"{shape}")
    if v.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {v.device}")
    return parts


def box_prolong(fine_box, coarse_box, xc: torch.Tensor, x=None,
                out=None) -> torch.Tensor:
    """``x + P xc`` (``P xc`` without ``x``), as :func:`prolong_plain`.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/box_transfer.cu`` once (the add is its epilogue) or raise; there
    is no fallback.  ``out`` may be ``x``: the kernel then updates ``x`` in
    place (``tpusolve``'s version is pure).  ``box_prolong.launches``
    counts kernel launches."""
    if xc.device.type == "cpu":
        return prolong_plain(fine_box, coarse_box, xc, x, out)
    nf = 8 * xc.numel()
    parts = _check("box_prolong", fine_box, coarse_box, xc, coarse_box,
                   (("x", x, (nf,)), ("out", out, (nf,))))
    if out is None:
        out = torch.empty(nf, dtype=xc.dtype, device=xc.device)
    lib, fns = _kernel_fns()
    build.launch(lib, fns["prolong", xc.dtype], xc, "box_prolong launch",
                 xc.data_ptr(), None if x is None else x.data_ptr(),
                 out.data_ptr(), parts, *coarse_box)
    box_prolong.launches += 1
    return out


def box_restrict(fine_box, coarse_box, rf: torch.Tensor) -> torch.Tensor:
    """``P^T rf``, as :func:`restrict_plain`.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/box_transfer.cu`` once or raise; there is no fallback.
    ``box_restrict.launches`` counts kernel launches."""
    if rf.device.type == "cpu":
        return restrict_plain(fine_box, coarse_box, rf)
    parts = _check("box_restrict", fine_box, coarse_box, rf, fine_box, ())
    out = torch.empty(rf.numel() // 8, dtype=rf.dtype, device=rf.device)
    lib, fns = _kernel_fns()
    build.launch(lib, fns["restrict", rf.dtype], rf, "box_restrict launch",
                 rf.data_ptr(), out.data_ptr(), parts, *coarse_box)
    box_restrict.launches += 1
    return out


box_prolong.launches = 0
box_restrict.launches = 0


def _aliases(a, b) -> bool:
    """Whether tensors ``a`` and ``b`` share memory (on the ``meta``
    device, whether they are one tensor)."""
    if a is None or b is None:
        return False
    if a is b:
        return True
    if a.device.type == "meta" or b.device.type == "meta":
        return False
    sa, sb = a.untyped_storage(), b.untyped_storage()
    return sa.data_ptr() == sb.data_ptr() and sa.nbytes() > 0


def _check_fused(what: str, fine_box, coarse_box, vals, offsets, x,
                 others, bf16: bool = False) -> tuple:
    """Raise unless ``vals`` is the (P, D, *fine_box) plane stack of x's
    dtype (or, with ``bf16``, bfloat16) under D triples K1 takes, and ``x``
    and ``others`` pass :func:`_check`; returns (parts, G)."""
    if vals.dim() != 5 or tuple(vals.shape[2:]) != tuple(fine_box):
        raise ValueError(f"{what}: vals must be (P, D) + the fine box "
                         f"{tuple(fine_box)}")
    if vals.dtype != x.dtype and not (bf16 and vals.dtype == torch.bfloat16):
        raise TypeError(f"{what}: vals must be of x's dtype"
                        + (" or bfloat16" if bf16 else ""))
    D = vals.shape[1]
    if len(offsets) != D or any(len(o) != 3 for o in offsets) \
            or D > MAX_SLOTS:
        raise ValueError(f"{what}: need {D} offset triples, at most "
                         f"{MAX_SLOTS}")
    if vals.device != x.device or not vals.is_contiguous():
        raise ValueError(f"{what}: vals must be contiguous on {x.device}")
    parts = _check(what, fine_box, coarse_box, x, fine_box, others)
    if parts != vals.shape[0]:
        raise ValueError(f"{what}: {parts} parts of x, {vals.shape[0]} of "
                         "vals")
    return parts, k1_plan(int(np.prod(fine_box)), D)


def box_restrict_residual(fine_box, coarse_box, vals, offsets,
                          x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``P^T (b - A x)``, as :func:`restrict_residual_plain`.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/box_cycle.cu`` once (cooperatively: K1's residual at K1's G
    threads a row, ``k1_plan``, into a scratch vector, a grid barrier, then
    the restriction), or raise; there is no fallback.
    ``box_restrict_residual.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return restrict_residual_plain(fine_box, coarse_box, vals, offsets,
                                       x, b)
    if b is None:
        raise ValueError("box_restrict_residual: b is required")
    nf = x.numel()
    parts, g = _check_fused("box_restrict_residual", fine_box, coarse_box,
                            vals, offsets, x, (("b", b, (nf,)),))
    rr = torch.empty_like(x)
    out = torch.empty(nf // 8, dtype=x.dtype, device=x.device)
    lib, fns = _fused_fns()
    build.launch(lib, fns["restrict", x.dtype], x,
                 "box_restrict_residual launch", vals.data_ptr(),
                 ctypes.addressof(_table(tuple(offsets))), len(offsets),
                 x.data_ptr(), b.data_ptr(), rr.data_ptr(), out.data_ptr(),
                 parts, *fine_box, g)
    box_restrict_residual.launches += 1
    return out


def box_prolong_update(fine_box, coarse_box, vals, offsets,
                       ec: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       s=None, w: float = 1.0, c_is_xnew: bool = True,
                       xnew_out=None, out=None) -> torch.Tensor:
    """``y = [x'] + w * s * (b - A x')`` for ``x' = x + P ec``, as
    :func:`prolong_update_plain` (``x'`` into ``xnew_out`` when given).

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/box_cycle.cu`` once (cooperatively: x' into ``xnew_out`` or a
    scratch vector, a grid barrier, then K1's update at K1's G threads a
    row), or raise; there is no fallback.  ``y`` (``out``) and ``xnew_out``
    must not share memory with ``x``, ``b``, ``s``, ``ec`` or each other.
    ``vals`` may be bfloat16 (the smoother twin's planes): each value
    widened exactly to x's dtype, so that the launch equals the
    full-precision one on the rounded values bit for bit.
    ``box_prolong_update.launches`` counts kernel launches,
    ``box_prolong_update.launches_bf16`` those on bfloat16 planes."""
    if x.device.type == "cpu":
        return prolong_update_plain(fine_box, coarse_box, vals, offsets, ec,
                                    x, b, s, w, c_is_xnew, xnew_out, out)
    if b is None or ec is None:
        raise ValueError("box_prolong_update: ec and b are required")
    for name, t in (("out", out), ("xnew_out", xnew_out)):
        for other in (x, b, s, ec) + ((xnew_out,) if name == "out" else ()):
            if _aliases(t, other):
                raise ValueError(f"box_prolong_update: {name} must not "
                                 "share memory with x, b, s, ec or the "
                                 "other output")
    nf = x.numel()
    parts, g = _check_fused(
        "box_prolong_update", fine_box, coarse_box, vals, offsets, x,
        (("ec", ec, (nf // 8,)), ("b", b, (nf,)), ("s", s, (nf,)),
         ("xnew_out", xnew_out, (nf,)), ("out", out, (nf,))), bf16=True)
    if out is None:
        out = torch.empty_like(x)
    if xnew_out is None:
        xnew_out = torch.empty_like(x)     # x' between the two phases
    lib, fns = _fused_fns()
    key = ("prolong", x.dtype) if vals.dtype == x.dtype else (
        "prolong", vals.dtype, x.dtype)
    build.launch(lib, fns[key], x, "box_prolong_update launch",
                 vals.data_ptr(), ctypes.addressof(_table(tuple(offsets))),
                 len(offsets), ec.data_ptr(), x.data_ptr(), b.data_ptr(),
                 None if s is None else s.data_ptr(), out.data_ptr(),
                 xnew_out.data_ptr(), parts, *fine_box, g, float(w),
                 int(bool(c_is_xnew)))
    box_prolong_update.launches += 1
    box_prolong_update.launches_bf16 += vals.dtype == torch.bfloat16
    return out


box_restrict_residual.launches = 0
box_prolong_update.launches = 0
box_prolong_update.launches_bf16 = 0
