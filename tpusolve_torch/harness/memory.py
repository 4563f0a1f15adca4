"""Device memory probe (the port of ``tpusolve/harness/memory.py``).

Analog of the reference's ``checkMemory`` (cudaMemGetInfo and device
properties printed at lifecycle stages, ref: src/HypreSystem.cpp:638-671,
call sites src/main.cpp:175-177), on ``torch.cuda.memory_stats`` (what the
caching allocator holds) and ``torch.cuda.mem_get_info`` (what CUDA
reports free).  A CPU device has no such statistics.
"""

from __future__ import annotations

import torch

GIB = 1 << 30


def allocated_bytes(device) -> int | None:
    """The bytes the caching allocator has allocated on a CUDA ``device``
    now (the report's ``in_use``); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get(
        "allocated_bytes.all.current", 0))


def memory_report(device, label: str | None = None) -> str:
    """One line per device: for a CUDA device the bytes allocated now and at
    peak, the bytes the allocator reserves and the card's free and total
    memory; for the CPU, that no statistics exist.  With a ``label`` (a
    rank's, ``"rank 1"``) the line starts with it."""
    device = torch.device(device)
    head = "Device memory:\n" + ("" if label is None else f"[{label}]")
    if device.type != "cuda":
        return f"{head}  {device}: memory stats unavailable"
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    line = (f"  {device} ({torch.cuda.get_device_name(device)}): "
            f"in_use={allocated_bytes(device) / GIB:.2f}"
            f"GiB peak={stats.get('allocated_bytes.all.peak', 0) / GIB:.2f}"
            f"GiB reserved="
            f"{stats.get('reserved_bytes.all.current', 0) / GIB:.2f}GiB "
            f"free={free / GIB:.2f}GiB limit={total / GIB:.2f}GiB")
    return head + line


def check_memory(device, label: str | None = None) -> str:
    """Print and return :func:`memory_report`."""
    rep = memory_report(device, label)
    print(rep, flush=True)
    return rep
