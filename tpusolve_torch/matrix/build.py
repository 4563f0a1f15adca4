"""Layout materialization: compact staging -> padded device tensors (the
port of ``tpusolve/matrix/build.py``).

The padded layouts the kernels consume (ELL, BDIA) are much larger than the
nnz-compact data they are built from.  The host prepares compact
``(flat_index, value)`` staging per part; only those go to the device, where
one ``index_put_`` writes them into a zero tensor of the layout's shape.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusolve_torch.matrix.vectors import to_tensor, torch_dtype


def materialize(idx_parts, val_parts, shape_tail, dtype,
                device) -> torch.Tensor:
    """``(nparts, *shape_tail)`` tensor on ``device`` with
    ``out[p].reshape(-1)[idx_parts[p]] = val_parts[p]``, zeros elsewhere.

    ``idx_parts[p]``: flat indices into one part's output (unique per part);
    ``val_parts[p]``: matching values."""
    nparts = len(idx_parts)
    shape_tail = tuple(int(s) for s in shape_tail)
    per_size = int(np.prod(shape_tail))
    dtype = np.dtype(dtype)
    flat_idx = np.concatenate([np.asarray(idx, np.int64) + p * per_size
                               for p, idx in enumerate(idx_parts)])
    flat_val = np.concatenate([np.asarray(v, dtype) for v in val_parts])
    out = torch.zeros(nparts * per_size, dtype=torch_dtype(dtype),
                      device=device)
    if flat_idx.size:
        out.index_put_((to_tensor(flat_idx, device, np.int64),),
                       to_tensor(flat_val, device))
    return out.reshape((nparts,) + shape_tail)
