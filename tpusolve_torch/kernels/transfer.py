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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusolve_torch.kernels import build


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
