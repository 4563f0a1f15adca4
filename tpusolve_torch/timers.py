"""Named phase timers with cross-run CSV export (the port of
``tpusolve/timers.py``).

An ordered list of ``(name, seconds)`` pairs appended at each lifecycle
phase (ref: src/HypreSystem.h:230), a summary table
(src/HypreSystem.cpp:880-889) and a cross-test CSV profile
(src/HypreSystem.cpp:847-878, writer src/main.cpp:195-216).  Timer names are
kept identical to the reference's.  The reference fences each span with
``MPI_Barrier``; here a span on a CUDA device ends with
``torch.cuda.synchronize``, so it includes the device work queued inside it.
Across ranks each rank keeps its own timers, and its summary's rows carry
its rank (``label``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Timers:
    """Ordered collection of named wall-clock spans (duplicates allowed)."""

    def __init__(self, device: torch.device | str = "cpu",
                 label: str | None = None) -> None:
        self.device = torch.device(device)
        self.label = label       # e.g. "rank 1": each row is prefixed so
        self.entries: list[tuple[str, float]] = []

    def add(self, name: str, seconds: float) -> None:
        self.entries.append((name, float(seconds)))

    def sync(self) -> None:
        """Wait for the device's queued work (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        """Time a block, fenced on the device at both ends."""
        self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.add(name, time.perf_counter() - start)

    def total(self) -> float:
        return sum(t for _, t in self.entries)

    def summarize(self) -> str:
        """Rank-0-style summary table (ref: src/HypreSystem.cpp:880-889);
        with a ``label``, every row after the title starts with it."""
        pre = "    " if self.label is None else f"[{self.label}] "
        lines = [f"{pre}{'Description':40s} Time (s)", pre + "-" * 50]
        for name, secs in self.entries:
            lines.append(f"{pre}{name:40s} {secs:10.6f}")
        lines.append(pre + "-" * 50)
        lines.append(f"{pre}{'Total':40s} {self.total():10.6f}")
        title = "Timing summary:" if self.label is None \
            else f"Timing summary ({self.label}):"
        return "\n".join(["", title] + lines)

    def as_dict(self) -> dict[str, float]:
        """Accumulate duplicate names by summing, preserving first-seen order
        (matches ``retrieve_timers`` accumulation semantics)."""
        out: dict[str, float] = {}
        for name, secs in self.entries:
            out[name] = out.get(name, 0.0) + secs
        return out


class CsvProfile:
    """Cross-test CSV accumulation: one header row of timer names, one data
    row per test (ref: src/main.cpp:195-216)."""

    def __init__(self) -> None:
        self.names: list[str] = []
        self.rows: list[dict[str, float]] = []

    def append(self, timers: Timers) -> None:
        d = timers.as_dict()
        for name in d:
            if name not in self.names:
                self.names.append(name)
        self.rows.append(d)

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(", ".join(self.names) + "\n")
            for row in self.rows:
                fh.write(", ".join(f"{row.get(n, 0.0):.6f}" for n in self.names) + "\n")
