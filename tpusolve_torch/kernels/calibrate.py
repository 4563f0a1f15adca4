"""Measure the SpMV time model's constants on the card.

    python -m tpusolve_torch.kernels.calibrate [REPEATS]

``matrix/sharded.py`` chooses between a feasible BDIA layout (kernel K4)
and a BELL layout (kernel K6) by :func:`~tpusolve_torch.matrix.sharded.
spmv_model_s`: ``bytes / (rate * min(1, threads / threads_full))``.  For
each kernel this times, in f64 with CUDA events, one synthetic operator
whose launch fills the card and one at the shape of the 64^3 gate-3
hierarchy's level 2 (1,507 rows: BDIA B=12, D=927, R=128; BELL G=189,
K=12), and one in between as a check of the model:

* ``rate`` = the full shape's bytes over its time;
* ``threads_full`` = the small shape's threads x rate x time / bytes, the
  thread count at which the linear ramp of the model reaches the full rate.

It prints one line per shape and, last, the constants as JSON.  Needs a
CUDA card; the numbers belong to the card they were taken on.
"""

from __future__ import annotations

import json
import sys

import torch

from tpusolve_torch.kernels.bdia import bdia_spmv
from tpusolve_torch.kernels.bell import TM, TN, bell_spmv

# (B, D, R) of BDIA and (G, K) of BELL, by role
SHAPES = {
    "bdia": {"full": (6912, 46, 128), "mid": (128, 200, 128),
             "small": (12, 927, 128)},
    "bell": {"full": (16384, 12), "mid": (1024, 12), "small": (189, 12)},
}


def _events_ms(fn, reps: int) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_ms(fn, warmup_s: float = 0.2, window_s: float = 0.05) -> float:
    """Mean milliseconds per call between CUDA events, over enough calls to
    fill ``window_s`` seconds, after ``warmup_s`` seconds of calls that
    bring the card's clocks up (a launch of microseconds otherwise times
    the idle clock)."""
    fn()
    torch.cuda.synchronize()
    est = max(_events_ms(fn, 10), 1e-3)
    for _ in range(int(warmup_s * 1e3 / est)):
        fn()
    return _events_ms(fn, max(10, int(window_s * 1e3 / est)))


def _bdia_case(shape, device, gen):
    """(call, bytes streamed, threads) of K4 on a random BDIA operator."""
    from tpusolve_torch.matrix.sharded import bdia_bytes, bdia_threads
    B, D, R = shape
    n = B * R
    vals = torch.randn((1, B, D, R), dtype=torch.float64, device=device,
                       generator=gen)
    starts = torch.randint(0, n - R + 1, (1, B, D), dtype=torch.int32,
                           device=device, generator=gen)
    x = torch.randn(n, dtype=torch.float64, device=device, generator=gen)
    return (lambda: bdia_spmv(vals, starts, x, 0, n, n),
            bdia_bytes(B, D, R, 0, 8), bdia_threads(B, R))


def _bell_case(shape, device, gen):
    """(call, bytes streamed, threads) of K6 on a random BELL operator."""
    from tpusolve_torch.matrix.sharded import bell_threads
    G, K = shape
    n = G * TM
    nwin = (n + TN - 1) // TN
    vals = torch.randn((1, G, K, TM, TN), dtype=torch.float64,
                       device=device, generator=gen)
    ids = torch.randint(0, nwin, (1, G, K), dtype=torch.int32, device=device,
                        generator=gen)
    x = torch.randn(n, dtype=torch.float64, device=device, generator=gen)
    nbytes = G * K * (TM * TN * 8 + 4)
    return lambda: bell_spmv(vals, ids, x, nwin, n), nbytes, bell_threads(G)


def measure(device=None, log=print) -> dict:
    """{"rate": {kernel: bytes/s}, "threads_full": {kernel: threads}} on
    ``device`` (default: the current CUDA device)."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"rate": {}, "threads_full": {}}
    for kernel, make in (("bdia", _bdia_case), ("bell", _bell_case)):
        got = {}
        for role, shape in SHAPES[kernel].items():
            call, nbytes, threads = make(shape, device, gen)
            ms = time_ms(call)
            got[role] = (nbytes, threads, ms)
            log(f"{kernel} {role} {shape}: {nbytes / 1e6:.3f} MB, "
                f"{threads} threads, {ms:.5f} ms, "
                f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        nbytes, _, ms = got["full"]
        rate = nbytes / (ms * 1e-3)
        nbytes, threads, ms = got["small"]
        out["rate"][kernel] = rate
        out["threads_full"][kernel] = threads * rate * ms * 1e-3 / nbytes
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    print(torch.cuda.get_device_name(0))
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        print(json.dumps(measure()), flush=True)
