"""Device-memory bandwidth of the attached CUDA card, by device name.

The port's speed of light: a memory-bound kernel's roofline share is its
bytes per second over this figure.  The H100 variants differ (NVIDIA data
sheets): SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s, NVL 94 GB
HBM3 3.9 TB/s; the H200 has 4.8 TB/s.  Keys are matched in order against
``torch.cuda.get_device_name()``, most specific first.
"""

from __future__ import annotations

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
