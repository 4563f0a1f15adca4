"""Measure the SpMV time model's constants on the card.

    python -m tpusolve_torch.kernels.calibrate [REPEATS]

``matrix/sharded.py`` chooses between BDIA and a BELL layout (K4 against
K6) by :func:`~tpusolve_torch.matrix.sharded.spmv_model_s`, ``bytes /
(rate * min(1, threads / threads_full))``, and between K4 and K5 on a BDIA
layout by :func:`~tpusolve_torch.matrix.sharded.band_model_s`, ``bytes /
rate`` times the rounds of blocks.  For each kernel this times one
synthetic operator whose launch fills the card, one small one, and one in
between as a check of the model.  The constants come from device time
(:func:`device_ms`, the kernels' durations in a ``torch.profiler`` trace);
each line also prints the time per call between CUDA events
(:func:`time_ms`), which on a small launch is the host's time per call:

* ``bdia`` (K4) and ``bell`` (K6), for BDIA against BELL, in f64: random
  window starts and ids, the small shape that of the 64^3 gate-3
  hierarchy's level 2 (1,507 rows: BDIA B=12, D=927, R=128; BELL G=189,
  K=12).  ``rate`` = the full shape's bytes over its time; ``threads_full``
  = the small shape's threads x rate x time / bytes, the thread count at
  which the linear ramp of the model reaches the full rate;
* ``bdia_band`` (K4) and ``bdia_xl`` (K5), for K4 against K5, in f32 and
  f64, on one banded operator like the RCM-ordered gate-4 ILU factors: D=23
  slots, each block's windows within ``XL_BAND`` entries below its rows
  (27,500 in f32, the 96^3 factors' band; 13,000 in f64, gate 3's 64^3
  level 0), so that K5's panels have real lengths, and an overflow list of
  1.5 entries a row.  The full shape is 132 x 52 blocks: one round of 132
  K5 steps of 52 blocks on 132 SMs; K5's bytes count the panels.  ``rate``
  = the full shape's bytes over its time; the other shapes print the
  model's time beside the measured one.

It prints one line per shape and, last, the constants as JSON.  Needs a
CUDA card; the numbers belong to the card they were taken on.

    python -m tpusolve_torch.kernels.calibrate --steps

times K5 on the f32 banded operator at the 96^3 factors' shape at several
blocks per step, beside K4 and the model's prices: how the rounds of blocks
over the SMs, and the panels' bytes, set K5's time
(``matrix/sharded.py:band_model_s``).

    python -m tpusolve_torch.kernels.calibrate --k4

times K4 at each register-stage depth it is built for (``sweep_k4``).

    python -m tpusolve_torch.kernels.calibrate --k1

times K1 at every threads-a-row count G it is built for, at the box shapes
of gates 1 and 2 (``sweep_k1``): the measurement behind
``kernels/dia.py:k1_plan``.
"""

from __future__ import annotations

import json
import sys

import torch

from tpusolve_torch.kernels import bdia as bdia_mod
from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
from tpusolve_torch.kernels.bell import TM, TN, bell_spmv

# (B, D, R) of BDIA, (G, K) of BELL and (B, D, R, gb) of BDIA-XL, by role
SHAPES = {
    "bdia": {"full": (6912, 46, 128), "mid": (128, 200, 128),
             "small": (12, 927, 128)},
    "bell": {"full": (16384, 12), "mid": (1024, 12), "small": (189, 12)},
    "bdia_band": {"full": (6864, 23, 128), "mid": (1024, 23, 128),
                  "small": (96, 23, 128)},
    "bdia_xl": {"full": (6864, 23, 128, 52), "mid": (1024, 23, 128, 8),
                "small": (96, 23, 128, 8)},
}
XL_BAND = {4: 27_500, 8: 13_000}
BOTH = (torch.float64, torch.float32)


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


# traces device_ms takes before it gives up on an empty one
TRACE_TRIES = 5
SPAN = "device_ms "   # name prefix of device_ms_each's ranges


def device_ms(fn, reps: int = 50) -> float:
    """Device milliseconds per call: the durations of the kernels, copies
    and sets that ``reps`` calls put on the card, from a ``torch.profiler``
    (CUPTI) trace.  Unlike :func:`time_ms` it leaves out the host's time
    per call (argument checks, allocation, the launch itself), which sets
    the event-loop time of a small launch."""
    return device_ms_each({"call": fn}, reps)["call"]


def device_ms_each(calls: dict, reps: int = 50,
                   only: str | None = None) -> dict:
    """:func:`device_ms` of each of several calls, ``{key: fn}``, from one
    trace: each call's ``reps`` runs sit in a ``record_function`` range of
    their own, the card synchronised at its end and left idle for a
    millisecond before the next, and each device event counts for the range
    its start falls in.  With ``only``, just the device events whose name
    holds it count (one kernel among what a call puts on the card).

    On the card's machine a trace now and then lacks a few device events
    (3 of 50 launches of a 6 us kernel, late in a long process) or all of
    them (three traces in a row, late in a long ``chip_smoke.py``).  So each
    kind of event (by name) counts its mean duration times its number per
    call, rounded, and a trace that leaves a call without events is taken
    again; raises after ``TRACE_TRIES`` such traces."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for key, fn in calls.items():
                with record_function(SPAN + key):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                time.sleep(1e-3)
        events = prof.events()
        spans = {e.name[len(SPAN):]: e.time_range for e in events
                 if e.device_type == DeviceType.CPU
                 and e.name.startswith(SPAN)}
        by_key = {key: {} for key in calls}
        for e in events:
            if (e.device_type != DeviceType.CUDA
                    or e.name.startswith(SPAN)
                    or (only is not None and only not in e.name)):
                continue
            t = e.time_range.start
            key = next((k for k, r in spans.items() if r.start <= t <= r.end),
                       None)
            if key is not None:
                by_key[key].setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        for key, by_name in by_key.items():
            us = sum(round(len(d) / reps) * sum(d) / len(d)
                     for d in by_name.values())
            if us > 0:
                out.setdefault(key, us / 1e3)
        if len(out) == len(calls):
            return out
        time.sleep(0.2)
    raise RuntimeError(f"device_ms_each: no device activity for "
                       f"{sorted(set(calls) - set(out))} in {TRACE_TRIES} "
                       f"traces")


def _bdia_case(shape, dtype, device, gen):
    """(call, bytes streamed, threads) of K4 on a random BDIA operator."""
    from tpusolve_torch.matrix.sharded import bdia_bytes, bdia_threads
    B, D, R = shape
    n = B * R
    vals = torch.randn((1, B, D, R), dtype=dtype, device=device,
                       generator=gen)
    starts = torch.randint(0, n - R + 1, (1, B, D), dtype=torch.int32,
                           device=device, generator=gen)
    x = torch.randn(n, dtype=dtype, device=device, generator=gen)
    return (lambda: bdia_spmv(vals, starts, x, 0, n, n),
            bdia_bytes(B, D, R, 0, vals.element_size()), bdia_threads(B, R))


def _bell_case(shape, dtype, device, gen):
    """(call, bytes streamed, threads) of K6 on a random BELL operator."""
    from tpusolve_torch.matrix.sharded import bell_threads
    G, K = shape
    n = G * TM
    nwin = (n + TN - 1) // TN
    vals = torch.randn((1, G, K, TM, TN), dtype=dtype, device=device,
                       generator=gen)
    ids = torch.randint(0, nwin, (1, G, K), dtype=torch.int32, device=device,
                        generator=gen)
    x = torch.randn(n, dtype=dtype, device=device, generator=gen)
    nbytes = G * K * (TM * TN * vals.element_size() + 4)
    return (lambda: bell_spmv(vals, ids, x, nwin, n), nbytes,
            bell_threads(G, K))


def _banded(shape, dtype, device, gen):
    """A banded BDIA operator like the RCM-ordered gate-4 ILU factors':
    each block's D windows start within ``XL_BAND`` entries below its rows,
    in slot order, and rows spill 1 and 2 entries in turn to an overflow
    list (1.5 a row; the 96^3 factors spill 1.57), columns within the band.
    Returns (vals, starts, x, xpad, ovf, overflow entries)."""
    B, D, R = shape[:3]
    itemsize = torch.empty((), dtype=dtype).element_size()
    band = XL_BAND[itemsize]
    n = B * R
    vals = torch.randn((1, B, D, R), dtype=dtype, device=device,
                       generator=gen)
    off = torch.randint(-band, 1, (1, B, D), device=device, generator=gen)
    starts = (torch.arange(B, device=device).view(1, B, 1) * R
              + off.sort(dim=2).values + band).to(torch.int32)
    x = torch.randn(n, dtype=dtype, device=device, generator=gen)
    per_row = 1 + torch.arange(n, device=device) % 2
    ptr = torch.zeros((1, n + 1), dtype=torch.int32, device=device)
    ptr[0, 1:] = per_row.cumsum(0)
    rows = torch.repeat_interleave(torch.arange(n, device=device), per_row)
    k = rows.numel()
    cols = (rows - torch.randint(1, band, (k,), device=device,
                                 generator=gen)).clamp(min=0)
    ovf = (ptr, cols.to(torch.int32).view(1, k),
           torch.randn((1, k), dtype=dtype, device=device, generator=gen))
    return vals, starts, x, band, ovf, k


def _bdia_band_case(shape, dtype, device, gen):
    """(call, bytes streamed, (blocks, resident)) of K4 on the banded
    operator."""
    from tpusolve_torch.matrix.sharded import bdia_bytes, k4_blocks
    B, D, R = shape
    vals, starts, x, band, ovf, k = _banded(shape, dtype, device, gen)
    n = B * R
    itemsize = vals.element_size()
    return (lambda: bdia_spmv(vals, starts, x, band, n + band, n, ovf),
            bdia_bytes(B, D, R, k, itemsize),
            k4_blocks(1, B, D, R, itemsize))


def _bdia_xl_case(shape, dtype, device, gen):
    """(call, bytes streamed with the panels, (blocks, resident)) of K5 on
    the banded operator, in steps of gb blocks."""
    from tpusolve_torch.matrix.sharded import bdia_bytes, xl_resident
    B, D, R, gb = shape
    vals, starts, x, band, ovf, k = _banded(shape, dtype, device, gen)
    itemsize = vals.element_size()
    plan = bdia_mod.plan_steps(starts.cpu().numpy(), R, band, itemsize,
                               lambda g, nsteps, panel: abs(g - gb))
    if plan is None or plan[0] != gb:
        raise RuntimeError(f"calibrate: no K5 plan with gb={gb} for {shape}")
    _, step_lo, panel = plan
    nsteps = step_lo.shape[1]
    step_lo = torch.tensor(step_lo, device=device)
    n = B * R
    return (lambda: bdia_spmv_xl(vals, starts, x, band, n, gb, step_lo,
                                 panel, ovf),
            bdia_bytes(B, D, R, k, itemsize) + nsteps * panel * itemsize,
            (nsteps, xl_resident(bdia_mod.xl_smem_bytes(panel, gb, D,
                                                        itemsize),
                                 bdia_mod.xl_threads(gb, R, itemsize))))


# kernel: (operator, item types)
CASES = {"bdia": (_bdia_case, (torch.float64,)),
         "bell": (_bell_case, (torch.float64,)),
         "bdia_band": (_bdia_band_case, BOTH),
         "bdia_xl": (_bdia_xl_case, BOTH)}


def _rounds(blocks: int, resident: int) -> float:
    """``band_model_s``'s factor: ceil(blocks / resident) * resident /
    blocks."""
    return -(-blocks // resident) * resident / blocks


def measure(device=None, log=print) -> dict:
    """{"rate": {kernel: {itemsize: bytes/s}}, "threads_full": {kernel:
    {itemsize: threads}}} on ``device`` (default: the current CUDA device);
    the band kernels have a rate only."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"rate": {}, "threads_full": {}}
    for kernel, (make, dtypes) in CASES.items():
        band = kernel in ("bdia_band", "bdia_xl")
        for dtype in dtypes:
            itemsize = torch.empty((), dtype=dtype).element_size()
            got, rate = {}, None
            for role, shape in SHAPES[kernel].items():
                call, nbytes, occ = make(shape, dtype, device, gen)
                call_ms = time_ms(call)
                ms = device_ms(call)
                got[role] = (nbytes, occ, ms)
                note = ""
                if band:
                    if rate is None:      # the full shape comes first
                        rate = nbytes * _rounds(*occ) / (ms * 1e-3)
                    note = (f", model {1e3 * nbytes * _rounds(*occ) / rate:.5f}"
                            f" ms; {occ[0]} blocks, {occ[1]} resident")
                else:
                    note = f", {occ} threads"
                log(f"{kernel} f{8 * itemsize} {role} {shape}: "
                    f"{nbytes / 1e6:.3f} MB, device {ms:.5f} ms, per call "
                    f"{call_ms:.5f} ms, {nbytes / (ms * 1e-3) / 1e9:.1f} "
                    f"GB/s{note}")
            if band:
                out["rate"].setdefault(kernel, {})[itemsize] = rate
                continue
            nbytes, _, ms = got["full"]
            rate = nbytes / (ms * 1e-3)
            nbytes, threads, ms = got["small"]
            out["rate"].setdefault(kernel, {})[itemsize] = rate
            out["threads_full"].setdefault(kernel, {})[itemsize] = (
                threads * rate * ms * 1e-3 / nbytes)
    return out


STEPS_GB = (8, 16, 27, 32, 53, 64)


def sweep_steps(device=None, log=print) -> list:
    """K5 at ``STEPS_GB`` blocks a step and K4 on the f32 banded full
    shape, with the model's prices; returns (gb, steps, ms, model ms) rows
    (gb 0: K4)."""
    from tpusolve_torch.matrix import sharded
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    B, D, R = 6912, 23, 128          # the 96^3 gate-4 factors' shape
    vals, starts, x, band, ovf, k = _banded((B, D, R), torch.float32,
                                            device, gen)
    n = B * R
    nbytes = sharded.bdia_bytes(B, D, R, k, 4)
    ms = device_ms(lambda: bdia_spmv(vals, starts, x, band, n + band, n, ovf))
    model = 1e3 * sharded.k4_model_s(4, nbytes, 1, B, D, R)
    log(f"K4 f32 {(B, D, R)} overflow={k}: {ms:.5f} ms (model {model:.5f})")
    rows = [(0, B, ms, model)]
    starts_np = starts.cpu().numpy()
    for gb in STEPS_GB:
        plan = bdia_mod.plan_steps(starts_np, R, band, 4,
                                   lambda g, nsteps, panel: abs(g - gb))
        _, step_lo, panel = plan
        nsteps = step_lo.shape[1]
        lo = torch.tensor(step_lo, device=device)
        ms = device_ms(lambda: bdia_spmv_xl(vals, starts, x, band, n, gb, lo,
                                          panel, ovf))
        resident = sharded.xl_resident(bdia_mod.xl_smem_bytes(
            panel, gb, D, 4), bdia_mod.xl_threads(gb, R, 4))
        model = 1e3 * sharded.band_model_s(
            "bdia_xl", 4, nbytes + nsteps * panel * 4, nsteps, resident)
        log(f"K5 f32 gb={gb}: {nsteps} steps, panel {panel}, {resident} "
            f"resident: {ms:.5f} ms (model {model:.5f})")
        rows.append((gb, nsteps, ms, model))
    return rows


def sweep_k4(device=None, log=print) -> list:
    """K4's device time at every register-stage depth S of ``K4_SLOTS`` on
    three operators with the main path's shapes: random windows like gate
    3's 64^3 level 1 (B=169, D=688, R=128, f64), and the banded operator
    like gate 4's A at 96^3 (B=6912, D=46, R=128) in f64 and f32.  Returns
    (operator, S, device ms) rows; the module's plan constants are restored
    after."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ops = [("level-1 shape f64", _bdia_case((169, 688, 128), torch.float64,
                                            device, gen)[0])]
    for dtype in BOTH:
        ops.append((f"A shape f{torch.finfo(dtype).bits}",
                    _bdia_band_case((6912, 46, 128), dtype, device, gen)[0]))
    keep = (bdia_mod.K4_DEEP_WARPS, bdia_mod.K4_SLOTS_DEEP)
    rows = []
    try:
        bdia_mod.K4_DEEP_WARPS = 1 << 30       # every launch takes S below
        for name, call in ops:
            for S in bdia_mod.K4_SLOTS:
                bdia_mod.K4_SLOTS_DEEP = S
                bdia_mod.k4_plan.cache_clear()
                ms = device_ms(call)
                log(f"K4 {name}: S={S}: device {ms:.5f} ms")
                rows.append((name, S, ms))
    finally:
        bdia_mod.K4_DEEP_WARPS, bdia_mod.K4_SLOTS_DEEP = keep
        bdia_mod.k4_plan.cache_clear()
    return rows


# (box side, slots) of the structured levels of gates 1 and 2
K1_SHAPES = ((128, 27), (64, 27), (64, 125), (32, 125), (16, 125),
             (8, 125))


def sweep_k1(device=None, log=print) -> list:
    """K1's device time, in f32, at each (side^3 box, D) of ``K1_SHAPES``
    (random planes; the 27 stencil triples, or all 125 of [-2, 2]^3), for
    every G of ``dia.GROUPS``, in the plain form y = A x and the Jacobi
    form; ``k1_plan``'s choice is marked.  Returns (side, D, G, form,
    device ms) rows."""
    import itertools
    from tpusolve_torch.kernels import dia
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for side, D in K1_SHAPES:
        span = 1 if D == 27 else 2
        offs = tuple(itertools.product(range(-span, span + 1), repeat=3))
        box = (side,) * 3
        vals = torch.randn((1, D) + box, generator=gen, device=device)
        x, b, s = (torch.randn(side ** 3, generator=gen, device=device)
                   for _ in range(3))
        plan = dia.k1_plan(side ** 3, D)
        for g in dia.GROUPS:
            for form, call in (
                    ("Ax", lambda: dia.dia_spmv(vals, offs, x, groups=g)),
                    ("jacobi", lambda: dia.dia_spmv(vals, offs, x, b, s, x,
                                                    0.9, groups=g))):
                ms = device_ms(call)
                mark = " (plan)" if plan == g else ""
                log(f"K1 {side}^3 D={D} G={g} {form}: device {ms:.5f} "
                    f"ms{mark}")
                rows.append((side, D, g, form, ms))
    return rows


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    print(torch.cuda.get_device_name(0))
    if sys.argv[1:] == ["--steps"]:
        sweep_steps()
        sys.exit(0)
    if sys.argv[1:] == ["--k4"]:
        sweep_k4()
        sys.exit(0)
    if sys.argv[1:] == ["--k1"]:
        sweep_k1()
        sys.exit(0)
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        print(json.dumps(measure()), flush=True)
