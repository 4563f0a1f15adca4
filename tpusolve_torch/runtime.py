"""What the port assumes of the CUDA card: device-memory bandwidth by device
name, and the shared memory one thread block may use.

The port's speed of light: a memory-bound kernel's roofline share is its
bytes per second over this figure.  The H100 variants differ (NVIDIA data
sheets): SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s, NVL 94 GB
HBM3 3.9 TB/s; the H200 has 4.8 TB/s.  Keys are matched in order against
``torch.cuda.get_device_name()``, most specific first.

``SMEM_PER_BLOCK`` is Hopper's opt-in dynamic shared memory per block, and
the ``SM_*`` figures are the H100 SXM5's (NVIDIA's Hopper tuning guide).
They are constants, not queries, so that a layout that depends on them
(BDIA-XL panels and steps, ``kernels/bdia.py``, ``matrix/sharded.py``) is
chosen the same on the CPU and on the card; the first launch that relies on
the shared memory checks the device (:func:`require_smem`).  On a card with
other SM figures a plan stays correct and may be slower.
"""

from __future__ import annotations

import functools

SMEM_PER_BLOCK = 232_448    # bytes: 227 KB of the SM's 228 KB (sm_90)
SM_COUNT = 132              # SMs of an H100 SXM5
SM_SMEM = 233_472           # shared memory of one SM, bytes (228 KB)
SM_SMEM_RESERVED = 1_024    # bytes the hardware keeps per resident block

HBM_GBPS = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),        # SXM5, e.g. "NVIDIA H100 80GB HBM3"
    ("H200", 4800.0),
)


def hbm_gbps(device_name: str) -> float | None:
    """Published device-memory bandwidth in GB/s, or None for a card the
    table does not know (no guess is made)."""
    for key, gbps in HBM_GBPS:
        if key.lower() in device_name.lower():
            return gbps
    return None


@functools.cache
def require_smem(device_index: int) -> None:
    """Raise unless CUDA device ``device_index`` lets one block opt in to
    ``SMEM_PER_BLOCK`` bytes of shared memory (checked once per device)."""
    import torch
    props = torch.cuda.get_device_properties(device_index)
    got = getattr(props, "shared_memory_per_block_optin", None)
    if got is None or got < SMEM_PER_BLOCK:
        raise RuntimeError(
            f"{props.name}: {got} bytes of opt-in shared memory per block, "
            f"the port's layouts assume {SMEM_PER_BLOCK} (Hopper)")
