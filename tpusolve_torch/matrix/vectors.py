"""Padded vector layout and host<->device staging (the port of
``tpusolve/matrix/vectors.py``).

Vectors are flat tensors of shape ``(nparts * pad,)``: part ``p`` holds
global entries ``[offsets[p], offsets[p+1])`` in its first ``count_p`` slots,
with zeros in the padded tail.  Every kernel keeps "padding is exactly
zero", so dot products and norms need no masks.  (Analog of
``HYPRE_IJVector`` staging, ref: src/HypreSystem.cpp:546-598, :957-1015.)
Across ranks a vector holds the rank's parts: ``offsets`` are then the
rank's (a slice's ``row_offsets``, global rows), so :func:`to_device_vector`
places its parts of a global host vector and :func:`from_device_vector`
returns its rows; ``dist.fetch_host`` gathers the global vector.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_vector(x: np.ndarray, offsets, pad: int) -> np.ndarray:
    """Host layout transform: global (n,) -> padded (nparts*pad,)."""
    offsets = np.asarray(offsets)
    nparts = len(offsets) - 1
    out = np.zeros((nparts, pad) + x.shape[1:], x.dtype)
    for p in range(nparts):
        lo, hi = offsets[p], offsets[p + 1]
        out[p, : hi - lo] = x[lo:hi]
    return out.reshape((nparts * pad,) + x.shape[1:])


def unpad_vector(xp: np.ndarray, offsets, pad: int) -> np.ndarray:
    """Inverse of :func:`pad_vector`."""
    offsets = np.asarray(offsets)
    nparts = len(offsets) - 1
    xp = np.asarray(xp).reshape((nparts, pad) + np.asarray(xp).shape[1:])
    out = np.zeros((int(offsets[-1]),) + xp.shape[2:], xp.dtype)
    for p in range(nparts):
        lo, hi = offsets[p], offsets[p + 1]
        out[lo:hi] = xp[p, : hi - lo]
    return out


_TORCH_DTYPES = {np.dtype(t): getattr(torch, t)
                 for t in ("float32", "float64", "int32", "int64")}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of a torch dtype, unchanged)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (or of a numpy dtype)."""
    if isinstance(dtype, torch.dtype):
        return next(k for k, v in _TORCH_DTYPES.items() if v == dtype)
    return np.dtype(dtype)


def to_tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Copy a host array to a tensor on ``device`` (never a view of the
    numpy buffer, so the tensor owns its memory on the CPU too)."""
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def to_device_vector(x: np.ndarray, offsets, pad: int, device,
                     dtype=None) -> torch.Tensor:
    """Place a global host vector on ``device`` in the padded layout."""
    return to_tensor(pad_vector(np.asarray(x), offsets, pad), device, dtype)


def from_device_vector(x: torch.Tensor, offsets, pad: int) -> np.ndarray:
    """Fetch a padded vector back to a host global vector."""
    return unpad_vector(x.detach().cpu().numpy(), offsets, pad)
