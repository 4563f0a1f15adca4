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
  level 0), so that K5's panels have real lengths, an overflow list of
  1.5 entries a row, and ``ZERO_SHARE`` of its 32-row (block, slot)
  segments all zero, as in the factors.  The full shape is 132 x 52
  blocks: one round of 132 K5 steps of 52 blocks on 132 SMs; K5's bytes
  count the panels and only the segments its mask keeps.  ``rate`` = the
  full shape's bytes over its time; the other shapes print the model's
  time beside the measured one.

It prints one line per shape and, last, the constants as JSON.  Needs a
CUDA card; the numbers belong to the card they were taken on.

    python -m tpusolve_torch.kernels.calibrate --steps

times K5 on the f32 banded operator at the 96^3 factors' shape at several
blocks per step, beside K4 and the model's prices: how the rounds of blocks
over the SMs, and the panels' bytes, set K5's time
(``matrix/sharded.py:band_model_s``).

    python -m tpusolve_torch.kernels.calibrate --k5

times K5 against K4 on gate 4's ILU factors L and U at 96^3 (the
fixture's pattern, RCM, host Chow-Patel ILU(0) of the f32 twin, as the
CLI's ``mixed`` run builds them) and on the banded operator in f32 and
f64: without the segment mask on the parent's steps of equal blocks, with
it, with it on steps of balanced work at several weights of the overflow
(``kernels/bdia.py:XL_OVF_WEIGHT``), the update forms of the ILU sweeps,
and the slots alone; each checked equal to K4 bit for bit first
(``sweep_k5``).

    python -m tpusolve_torch.kernels.calibrate --k4

times K4 at each register-stage depth it is built for (``sweep_k4``).

    python -m tpusolve_torch.kernels.calibrate --k1

times K1 at every threads-a-row count G it is built for, at the box shapes
of gates 1 and 2 (``sweep_k1``): the measurement behind
``kernels/dia.py:k1_plan``.

    python -m tpusolve_torch.kernels.calibrate --k2

times K2 at every threads-a-row count, in the padded and the row-pointer
form, on a 64-row operator and the ELL shapes of the BoomerAMG paths with
their rows' real spread of lengths, in f32 and f64, beside the library's
CSR SpMV (``sweep_k2``), and prints each form's rate, floor and round for
K2's time model: the measurement behind ``kernels/ell.py:k2_plan``,
``k2_rowptr_plan`` and ``K2_MODEL`` there, with which ``matrix/sharded.py``
picks an ELL operator's form (``ell_form``) and prices K2 beside K4 and K6
(``choose_layout``).

    python -m tpusolve_torch.kernels.calibrate --k2-sum

times K2's f32 forms built with each way of summing a row
(``K2_SUMS``, ``csrc/ell_spmv.cu:TPUSOLVE_K2_F32_SUM``: in f32 as before
the gate-3 ``single`` repair, in double, in compensated f32, and the
port's build, compensated at one thread a row and double at more) on the
operators of PERF.md's K2 rows: the weak-scaling YAML's level-0 P and R
and level-1 A at 128^3 and its bf16 twin, and gate 4's ``A_lo`` at 96^3
for 1 and 3 columns; beside each, the error of each build against the f64
product on a random x and on a smooth x, where a Laplacian row cancels
(``sweep_k2_sum``).

    python -m tpusolve_torch.kernels.calibrate --fused

times the fused cycle kernels of ``csrc/box_cycle.cu`` at the structured
transitions of gates 1 and 2, in f32 and f64, beside the pair of launches
each replaces (K1's residual then K3's restriction; K3's prolongation then
K1's Jacobi update), after checking each result against the pair's bit for
bit (``sweep_fused``).
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
# share of the banded operator's 32-row (block, slot) segments left all
# zero: gate 4's L at 96^3 has 32.1 % (U 31.4 %)
ZERO_SHARE = 0.32
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


# traces device_ms takes before it gives up on an empty one: late in a long
# process a call whose first traces lack its device events lacks them in
# every try (80-103 calls of a chip_smoke.py run on the H100 came back
# empty from all of 5, then 3 tries, PERF.md), and once one call has, so do
# most later ones: from then on a call is traced once (_LOSSY).  A fresh
# process gets the events
TRACE_TRIES = 3
_LOSSY = [False]      # whether a call of this process lost every trace
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
    again; raises after ``TRACE_TRIES`` such traces (one, once a call of
    the process has lost all of its traces)."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(1 if _LOSSY[0] else TRACE_TRIES):
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
    _LOSSY[0] = True
    raise RuntimeError(f"device_ms_each: no device activity for "
                       f"{sorted(set(calls) - set(out))} in its traces")


def retrace(path: str):
    """:func:`device_ms` of ``spmv(M, x)`` on the operator and vector that
    ``torch.save`` left at ``path`` (``{"M": ..., "x": ...}``), taken in
    this process: late in a long process a trace can lack a kernel's device
    events in every try (``chip_smoke.py:fresh_device_ms``).  A file of
    multi-part offd blocks (``{"offd": {name: (vals, cols, rowptr, x,
    halo_src)}}``, ``chip_smoke.py:fresh_offd_ms``) gives ``{name: {"k2":
    K2 on the block over x's ghosts, "gather": the halo's index gather,
    "lib": cuSPARSE's CSR SpMV on the same block, "lib_kernels": the device
    events of one library call, by name: their count and device ms}}``
    instead."""
    saved = torch.load(path, weights_only=False)
    if "offd" in saved:
        return {name: _offd_ms(*arrays)
                for name, arrays in saved["offd"].items()}
    from tpusolve_torch.matrix.spmv import spmv
    M, x = saved["M"], saved["x"]
    return device_ms(lambda: spmv(M, x))


def _offd_ms(vals, cols, rowptr, x, src) -> dict:
    """Device ms of K2 on an offd block over the ghosts of ``x``, of the
    halo's gather of those ghosts (``matrix/spmv.py:halo_gather``) and of
    cuSPARSE's CSR SpMV on the same block (``torch.sparse`` with int64
    indices, the matrix built once, outside the timed call); and the names
    and counts of the device events of one library call, which show
    whether it converts the format as it runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpusolve_torch.kernels.ell import ell_spmv
    g = x.index_select(0, src)
    if rowptr is None:
        keep = vals != 0
        ptr = torch.zeros(vals.shape[0] + 1, dtype=torch.int64,
                          device=vals.device)
        torch.cumsum(keep.sum(1), 0, out=ptr[1:])
        lv, lc = vals[keep], cols[keep].long()
    else:
        ptr, lv, lc = rowptr.long(), vals, cols.long()
    csr = torch.sparse_csr_tensor(ptr, lc, lv, size=(ptr.numel() - 1,
                                                     g.numel()))
    out = device_ms_each({
        "k2": lambda: ell_spmv(vals, cols, g, rowptr=rowptr),
        "gather": lambda: x.index_select(0, src),
        "lib": lambda: csr @ g})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        csr @ g
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = names.get(e.name[:80], (0, 0.0))
            names[e.name[:80]] = (n + 1, us + e.time_range.elapsed_us())
    out["lib_kernels"] = {k: dict(count=n, device_ms=us / 1e3)
                          for k, (n, us) in names.items()}
    return out


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
    in slot order, ``ZERO_SHARE`` of its 32-row segments all zero, and rows
    spill 1 and 2 entries in turn to an overflow list (1.5 a row; the 96^3
    factors spill 1.57), columns within the band.  Returns (vals, starts,
    x, xpad, ovf, overflow entries)."""
    B, D, R = shape[:3]
    itemsize = torch.empty((), dtype=dtype).element_size()
    band = XL_BAND[itemsize]
    n = B * R
    seg = bdia_mod.SEG_ROWS
    keep = torch.rand((1, B, D, R // seg), device=device,
                      generator=gen) >= ZERO_SHARE
    vals = torch.randn((1, B, D, R), dtype=dtype, device=device,
                       generator=gen) * keep.repeat_interleave(seg, dim=-1)
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
    """(call, bytes read with the panels, (blocks, resident)) of K5 on the
    banded operator, in steps of gb blocks."""
    from tpusolve_torch.matrix.sharded import (bdia_bytes, skipped_bytes,
                                               xl_resident)
    B, D, R, gb = shape
    vals, starts, x, band, ovf, k = _banded(shape, dtype, device, gen)
    itemsize = vals.element_size()
    mask = bdia_mod.segment_mask(vals)
    plan = bdia_mod.plan_steps(starts.cpu().numpy(), R, band, itemsize,
                               lambda g, nsteps, panel, smem: abs(g - gb))
    if plan is None or plan[0] != gb:
        raise RuntimeError(f"calibrate: no K5 plan with gb={gb} for {shape}")
    _, step_lo, panel, step_b0, stage = plan
    nsteps = step_lo.shape[1]
    step_lo, step_b0 = (torch.tensor(a, device=device)
                        for a in (step_lo, step_b0))
    n = B * R
    return (lambda: bdia_spmv_xl(vals, starts, x, band, n, gb, step_lo,
                                 panel, ovf, mask=mask, step_b0=step_b0,
                                 stage=stage),
            bdia_bytes(B, D, R, k, itemsize) - skipped_bytes(
                1, B, D, R, itemsize, bdia_mod.live_segments(mask))
            + nsteps * panel * itemsize,
            (nsteps, xl_resident(bdia_mod.xl_smem_bytes(panel, gb, D,
                                                        itemsize, R, stage),
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
    mask = bdia_mod.segment_mask(vals)
    reads = nbytes - sharded.skipped_bytes(1, B, D, R, 4,
                                           bdia_mod.live_segments(mask))
    ms = device_ms(lambda: bdia_spmv(vals, starts, x, band, n + band, n, ovf))
    model = 1e3 * sharded.k4_model_s(4, nbytes, 1, B, D, R)
    log(f"K4 f32 {(B, D, R)} overflow={k}: {ms:.5f} ms (model {model:.5f})")
    rows = [(0, B, ms, model)]
    starts_np = starts.cpu().numpy()
    for gb in STEPS_GB:
        plan = bdia_mod.plan_steps(starts_np, R, band, 4,
                                   lambda g, nsteps, panel, smem: abs(g - gb))
        _, step_lo, panel, step_b0, stage = plan
        nsteps = step_lo.shape[1]
        lo, b0 = (torch.tensor(a, device=device) for a in (step_lo, step_b0))
        ms = device_ms(lambda: bdia_spmv_xl(vals, starts, x, band, n, gb, lo,
                                          panel, ovf, mask=mask, step_b0=b0,
                                          stage=stage))
        resident = sharded.xl_resident(bdia_mod.xl_smem_bytes(
            panel, gb, D, 4, R, stage), bdia_mod.xl_threads(gb, R, 4))
        model = 1e3 * sharded.band_model_s(
            "bdia_xl", 4, reads + nsteps * panel * 4, nsteps, resident)
        log(f"K5 f32 gb={gb}: {nsteps} steps, panel {panel}, {resident} "
            f"resident: {ms:.5f} ms (model {model:.5f})")
        rows.append((gb, nsteps, ms, model))
    return rows


def gate4_factors(side: int, device):
    """(L, U): gate 4's ILU(0) factors at side^3 as the CLI's ``mixed`` run
    builds them: the momentum fixture's matrix (``fixtures.make_system``,
    seed 11, skew 0.35), RCM, assembled on ``device`` in f64, host
    Chow-Patel ILU(0) of the f32 twin (the fixture's ILU settings are the
    defaults), each factor laid out as the model chooses."""
    import numpy as np
    from tpusolve_torch.ilu.ilu import ilu_setup
    A, H = _gate4_operator(side, device)
    pre = ilu_setup(A.astype(np.float32), A_host=H)
    return pre.L, pre.U


# K5's designs in --k5: (name, the operator's segment mask used (else every
# segment set, kernels/bdia.py:full_mask), the overflow's weight in the
# steps' balance, None: steps of equal blocks); the last is the plan's
# (kernels/bdia.py:XL_OVF_WEIGHT)
K5_DESIGNS = (("every segment, equal steps", False, None),
              ("mask, equal steps", True, None),
              ("mask, balanced steps, overflow weight 1", True, 1.0),
              ("mask, balanced steps, overflow weight 2", True, 2.0),
              ("mask, balanced steps (the plan's)", True,
               bdia_mod.XL_OVF_WEIGHT))


def sweep_k5(device=None, log=print, side: int = 96) -> list:
    """K5's designs (``K5_DESIGNS``: every segment read and the segments of
    the mask, on
    steps of equal blocks (the parent's plan) and of balanced work at
    several weights of the overflow (the last the model's plan)) and K4 on
    gate 4's L and U at side^3 (:func:`gate4_factors`)
    and on the banded operator at the full shape in f32 and f64: every
    design checked equal to K4 by ``torch.equal`` (raises otherwise), then
    each timed in a trace of its own; then the ILU sweeps' update forms,
    ``r - A z`` and ``dinv * (z - A x)``, fused into K5's launch against
    K4 and the eager update, each equal bit for bit; then the slots alone
    (no overflow list), K5 against K4.  Prints the bytes the layout stores
    and the bytes K5 reads.  Returns (operator, dtype, design, device ms)
    rows."""
    from tpusolve_torch.kernels.dia import epilogue_plain
    from tpusolve_torch.matrix import sharded
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ops = []
    L, U = gate4_factors(side, device)
    for name, M in (("L", L), ("U", U)):
        ops.append((f"gate-4 {name}", M.bdia_vals, M.bdia_starts,
                    M.bdia_xpad, M.bdia_xlen, M.row_pad, M.bdia_ovf))
    for dtype in BOTH[::-1]:
        B, D, R = SHAPES["bdia_band"]["full"]
        vals, starts, x, band, ovf, _ = _banded((B, D, R), dtype, device, gen)
        ops.append(("banded", vals, starts, band, B * R + band, B * R, ovf))
    rows = []
    for name, vals, starts, xpad, xlen, row_pad, ovf in ops:
        P, B, D, R = vals.shape
        itemsize = vals.element_size()
        dt = str(vals.dtype)[6:]
        mask = bdia_mod.segment_mask(vals)
        live = bdia_mod.live_segments(mask)
        k = 0 if ovf is None else int(ovf[0][0, -1])
        nbytes = sharded.bdia_bytes(B, D, R, k, itemsize)
        reads = nbytes - sharded.skipped_bytes(1, B, D, R, itemsize, live)
        # the parent's plan (steps of gb blocks), and the model's balanced
        # at each weight of the overflow
        work = sharded.xl_work(mask, None if ovf is None else ovf[0], R,
                               row_pad, itemsize)
        plans, keep = {}, bdia_mod.XL_OVF_WEIGHT
        try:
            for _, _, wgt in K5_DESIGNS:
                if wgt is not None:
                    bdia_mod.XL_OVF_WEIGHT = wgt
                got = sharded.plan_xl(starts.cpu().numpy(), R, xpad,
                                      itemsize, nbytes,
                                      *(() if wgt is None else (live, work)))
                if got is None:
                    raise RuntimeError(f"calibrate: no K5 plan for {name} "
                                       f"{dt}")
                plans[wgt] = dict(
                    gb=got[0], step_lo=torch.tensor(got[1], device=device),
                    panel=got[2], step_b0=torch.tensor(got[3], device=device),
                    stage=got[4])
        finally:
            bdia_mod.XL_OVF_WEIGHT = keep
        final = plans[keep]
        panels = final["step_lo"].shape[1] * final["panel"] * itemsize
        x = torch.randn(row_pad, dtype=vals.dtype, device=device,
                        generator=gen)
        y4 = bdia_spmv(vals, starts, x, xpad, xlen, row_pad, ovf)
        calls = {"K4": lambda: bdia_spmv(vals, starts, x, xpad, xlen,
                                         row_pad, ovf)}
        every = bdia_mod.full_mask(P, B, D, R, device)
        for design, use_mask, wgt in K5_DESIGNS:
            call = (lambda m=mask if use_mask else every, pl=plans[wgt]:
                    bdia_spmv_xl(vals, starts, x, xpad, row_pad, pl["gb"],
                                 pl["step_lo"], pl["panel"], ovf, mask=m,
                                 step_b0=pl["step_b0"], stage=pl["stage"]))
            if not torch.equal(call(), y4):
                raise RuntimeError(f"K5 {design} on {name} {dt} is not K4")
            calls[design] = call
        kw = dict(mask=mask, step_b0=final["step_b0"], stage=final["stage"])
        args = (vals, starts, x, xpad, row_pad, final["gb"],
                final["step_lo"], final["panel"])
        r = torch.randn_like(x)
        dinv = torch.randn_like(x)
        for form, upd in (("lower r - A z", dict(b=r)),
                          ("upper dinv * (z - A x)", dict(b=r, s=dinv))):
            fused = (lambda u=upd: bdia_spmv_xl(*args, ovf, **kw, **u))
            eager = (lambda u=upd: epilogue_plain(bdia_spmv(
                vals, starts, x, xpad, xlen, row_pad, ovf), **u))
            if not torch.equal(fused(), eager()):
                raise RuntimeError(f"K5 update {form} on {name} {dt} is not "
                                   "K4 and the eager update")
            calls[f"{form}: K5 fused"] = fused
            calls[f"{form}: K4 + eager"] = eager
        # the slots alone, without the overflow list
        k5_slots = (lambda: bdia_spmv_xl(*args, mask=mask,
                                         step_b0=final["step_b0"], stage=0))
        k4_slots = (lambda: bdia_spmv(vals, starts, x, xpad, xlen, row_pad))
        if not torch.equal(k5_slots(), k4_slots()):
            raise RuntimeError(f"K5 without overflow on {name} {dt} is not K4")
        calls["slots only: K4"] = k4_slots
        calls["slots only: K5 mask, balanced"] = k5_slots
        ms = {key: device_ms_each({key: fn})[key] for key, fn in calls.items()}
        log(f"K5 {name} {dt} B={B} D={D} R={R} overflow={k}; parent plan "
            f"gb={plans[None]['gb']} panel={plans[None]['panel']} steps="
            f"{plans[None]['step_lo'].shape[1]}; the plan's gb="
            f"{final['gb']} panel={final['panel']} steps="
            f"{final['step_lo'].shape[1]} stage={final['stage']}: segments live "
            f"{live}/{B * D * R // bdia_mod.SEG_ROWS} "
            f"({1 - live * bdia_mod.SEG_ROWS / (B * D * R):.3f} skipped); "
            f"stored {nbytes / 1e6:.3f} MB, K5 reads {reads / 1e6:.3f} MB "
            f"with the mask, panels {panels / 1e6:.3f} MB; all designs equal "
            "to K4")
        for key, t in ms.items():
            log(f"K5 {name} {dt} {key}: device {t:.5f} ms")
            rows.append((name, dt, key, t))
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


# (fine box side, slots) of the structured transitions of gates 1 and 2
FUSED_SHAPES = ((128, 27), (64, 27), (64, 125), (32, 125), (16, 125))


def sweep_fused(device=None, log=print) -> list:
    """At each (side^3 fine box, D) of ``FUSED_SHAPES`` (random planes under
    the 27 stencil triples or all 125 of [-2, 2]^3), in f32 and f64: the
    fused restriction and prolongation, each checked against the pair of
    launches it replaces bit for bit (raises otherwise), then both and both
    pairs timed in one trace.  Returns (side, D, dtype, kernel, fused
    device ms, pair device ms) rows."""
    import itertools
    from tpusolve_torch.kernels import dia, transfer
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for (side, D), dt in itertools.product(FUSED_SHAPES, BOTH[::-1]):
        span = 1 if D == 27 else 2
        offs = tuple(itertools.product(range(-span, span + 1), repeat=3))
        fine, coarse = (side,) * 3, (side // 2,) * 3
        vals = torch.randn((1, D) + fine, generator=gen, device=device,
                           dtype=dt)
        x, b, s = (torch.randn(side ** 3, generator=gen, device=device,
                               dtype=dt) for _ in range(3))
        ec = torch.randn((side // 2) ** 3, generator=gen, device=device,
                         dtype=dt)
        calls = {
            "restrict pair": lambda: transfer.box_restrict(
                fine, coarse, dia.dia_spmv(vals, offs, x, b=b)),
            "restrict fused": lambda: transfer.box_restrict_residual(
                fine, coarse, vals, offs, x, b),
            "prolong pair": lambda: dia.dia_spmv(
                vals, offs, transfer.box_prolong(fine, coarse, ec, x), b, s,
                None, 1.0),
            "prolong fused": lambda: transfer.box_prolong_update(
                fine, coarse, vals, offs, ec, x, b, s, 1.0, False)}
        for kind in ("restrict", "prolong"):
            if not torch.equal(calls[kind + " pair"](),
                               calls[kind + " fused"]()):
                raise RuntimeError(f"fused {kind} {side}^3 D={D} {dt} "
                                   "differs from the pair")
        ms = device_ms_each(calls)
        name = str(dt).replace("torch.", "")
        for kind in ("restrict", "prolong"):
            f, p = ms[kind + " fused"], ms[kind + " pair"]
            log(f"fused {side}^3 D={D} {name} {kind}: device {f:.5f} ms, "
                f"the pair {p:.5f} ms ({f / p:.3f})")
            rows.append((side, D, name, kind, f, p))
    return rows


# (rows, K, x length, mean entries a row) of the ELL operators on the
# BoomerAMG paths: the weak-scaling YAML at 128^3 (level 0's P and R, level
# 1's A) and the 64^3 gate-3 hierarchy (level 0's P, the R of levels 0, 1
# and 2); the first fills the card, the last is the small shape.  The means
# are the operators' (PERF.md), estimated where PERF.md has no count
K2_SHAPES = ((2_097_152, 8, 170_854, 2.17), (170_854, 27, 2_097_152, 26.6),
             (170_854, 40, 170_854, 26.4), (262_144, 21, 21_588, 8.9),
             (21_588, 123, 262_144, 108.0), (1_507, 371, 21_588, 185.0),
             (131, 638, 1_507, 320.0))
# the shape of K2's floor: a launch's time with almost nothing to move
K2_FLOOR_SHAPE = (64, 4, 64, 2.5)


def _ell_case(rows: int, K: int, ncols: int, mean: float, dtype, device,
              gen):
    """(padded (vals, cols), row-pointer (rowptr, vals, cols), x) of an
    operator of ``rows`` rows whose counts of entries are 1 + Binomial(K -
    1, p) with mean ``mean``, as ragged as an AMG transfer's (1 to K a row),
    row i's columns near i * ncols / rows (within 4 K), as an AMG
    transfer's are; the padded form pads each row to K slots."""
    from tpusolve_torch.kernels import ell
    p = min(1.0, max(0.0, (mean - 1) / max(K - 1, 1)))
    counts = 1 + torch.binomial(
        torch.full((rows,), float(K - 1), device=device),
        torch.full((rows,), p, device=device), generator=gen).long()
    base = torch.arange(rows, device=device, dtype=torch.int64) * ncols \
        // rows
    off = torch.randint(-4 * K, 4 * K + 1, (rows, K), generator=gen,
                        device=device)
    cols = (base[:, None] + off).clamp_(0, ncols - 1).to(torch.int32)
    vals = torch.randn((rows, K), generator=gen, device=device, dtype=dtype)
    pad = torch.arange(K, device=device)[None] >= counts[:, None]
    vals[pad] = 0
    cols[pad] = 0
    x = torch.randn(ncols, generator=gen, device=device, dtype=dtype)
    return (vals, cols), ell.padded_to_rowptr(vals, cols), x


def sweep_k2(device=None, log=print) -> dict:
    """K2's device time, in f32 and f64, at each (rows, K, x length, mean)
    of ``K2_SHAPES``, for every G of ``ell.GROUPS`` in both forms (each
    plan's choice marked) beside the library's CSR SpMV (cuSPARSE), each
    row-pointer launch checked against the padded kernel at the same G (the
    same bits) and the plain version; and the constants of K2's time model
    (``matrix/sharded.py:ell_model_s``) for each form from device time at
    the plans: ``floor`` = a launch's time on ``K2_FLOOR_SHAPE``, ``rate``
    = the first shape's ``ell.ell_bytes`` over its time less the floor,
    ``round`` = the last shape's time less the floor over its
    ``ell.ell_stages`` (at its longest row).  Returns {"rows": [(dtype,
    rows, K, nnz, form, G, device ms, plan)], "library": [(dtype, rows, K,
    device ms)], "model": {form: {itemsize: (rate, floor, round)}}}."""
    from tpusolve_torch.kernels import ell
    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"rows": [], "library": [], "model": {f: {} for f in ell.FORMS}}
    for dtype in BOTH:
        got = {f: [] for f in ell.FORMS}
        itemsize = torch.empty((), dtype=dtype).element_size()
        dt = str(dtype)[6:]
        for rows, K, ncols, mean in (K2_FLOOR_SHAPE,) + K2_SHAPES:
            (pv, pc), (rp, rv, rc), x = _ell_case(rows, K, ncols, mean,
                                                  dtype, device, gen)
            nnz = rv.numel()
            width = int((rp[1:] - rp[:-1]).max())
            ref = ell.ell_spmv_plain(pv, pc, x)
            scale = float(ref.abs().max())
            plan = {"padded": ell.k2_plan(rows, K),
                    "rowptr": ell.k2_rowptr_plan(rows, nnz)}
            calls = {}
            for form in ell.FORMS:
                for g in ell.GROUPS:
                    if form == "padded":
                        fn = (lambda g=g: ell.ell_spmv(pv, pc, x, groups=g))
                    else:
                        fn = (lambda g=g: ell.ell_spmv(rv, rc, x, rowptr=rp,
                                                       groups=g))
                        y = fn()
                        y_pad = ell.ell_spmv(pv, pc, x, groups=g)
                        err = float((y - ref).abs().max()) / scale
                        if not torch.equal(y, y_pad) or err > (
                                1e-5 if itemsize == 4 else 1e-12):
                            raise RuntimeError(
                                f"K2 rowptr G={g} rows={rows} K={K} {dt}: "
                                f"rel err {err:.3e}, equal to the padded "
                                f"kernel: {torch.equal(y, y_pad)}")
                    calls[f"{form} {g}"] = fn
            csr = torch.sparse_csr_tensor(rp.long(), rc.long(), rv,
                                          size=(rows, ncols))
            calls["library"] = lambda: csr @ x
            # each call in a trace of its own: one trace for several calls
            # has counted a call's device events for the call before it
            ms = {k: device_ms_each({k: fn})[k] for k, fn in calls.items()}
            lib = ms.pop("library")
            out["library"].append((dt, rows, K, lib))
            for key, t in ms.items():
                form, g = key.split()
                g = int(g)
                nbytes = ell.ell_bytes(form, rows, ncols, K, nnz, itemsize)
                mark = " (plan)" if plan[form] == g else ""
                log(f"K2 {dt} rows={rows} K={K} W={width} nnz={nnz} "
                    f"x={ncols} {form} G={g}: device {t:.5f} ms, "
                    f"{nbytes / 1e6:.2f} MB, "
                    f"{nbytes / (t * 1e-3) / 1e9:.1f} GB/s{mark}")
                out["rows"].append((dt, rows, K, nnz, form, g, t,
                                    bool(mark)))
                if mark:
                    got[form].append((nbytes, ell.ell_stages(
                        form, rows, K, nnz, width), t * 1e-3))
            log(f"K2 {dt} rows={rows} K={K} nnz={nnz}: library (torch.sparse "
                f"CSR) device {lib:.5f} ms")
        for form, runs in got.items():
            floor = runs[0][2]
            rate = runs[1][0] / (runs[1][2] - floor)
            round_s = (runs[-1][2] - floor) / runs[-1][1]
            out["model"][form][itemsize] = (rate, floor, round_s)
            log(f"K2 {form} f{8 * itemsize}: rate {rate / 1e12:.3f} TB/s, "
                f"floor {floor * 1e3:.5f} ms, round {round_s * 1e3:.5f} ms "
                f"({runs[-1][1]} rounds at the last shape)")
    model = {f: {s: tuple(float(f"{v:.4g}") for v in c)
                 for s, c in by.items()} for f, by in out["model"].items()}
    log(f"K2_MODEL = SPMV_MODEL['ell'] = {model} ({card_line()})")
    return out


# the builds of K2 that --k2-sum compares, by how an f32 row is summed
# (csrc/ell_spmv.cu:TPUSOLVE_K2_F32_SUM); "port" is the port's build
K2_SUMS = {"f32": ("TPUSOLVE_K2_F32_SUM=0",),
           "double": ("TPUSOLVE_K2_F32_SUM=1",),
           "compensated": ("TPUSOLVE_K2_F32_SUM=2",),
           "port": ()}


def _gate4_operator(side: int, device):
    """Gate 4's matrix at side^3 as the CLI's RCM run assembles it (the
    momentum fixture, seed 11, skew 0.35, RCM) on ``device`` in f64, and
    its host CSR."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from tpusolve_torch.fixtures import make_system
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    rows, cols, vals, _, n = make_system(side, side, side, seed=11,
                                         nonsym=0.35)
    pat = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                        shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(pat + pat.T,
                                            symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    r, c = inv[rows], inv[cols]
    return (ShardedMatrix.from_coo((n, n), r, c, vals, device=device),
            sp.csr_matrix((vals, (r, c)), shape=(n, n)))


def _k2_sum_ops(device) -> list:
    """(name, (vals, cols, rowptr), k) of the f32 K2 launches --k2-sum
    times: the weak-scaling YAML's hierarchy at 128^3 (set up and solved by
    the CLI on ``device``) and its bf16 twin's, and gate 4's ``A_lo`` at
    96^3 for 1 and 3 columns."""
    import tempfile
    import numpy as np
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import cli
    ops = []
    with tempfile.TemporaryDirectory() as d:
        for bf16 in (False, True):
            keep = []
            if cli.main([fixtures.write_weakscale(d, 128, bf16=bf16),
                         "--device", device.type], keep=keep) != 0:
                raise RuntimeError("calibrate: the weak-scaling run failed")
            levels = keep[0]._precond.levels
            if bf16:
                ops.append(("weakscale 128^3 level 1 A bf16 twin",
                            levels[1].A_relax.ell_arrays, 1))
            else:
                ops += [(f"weakscale 128^3 level {i} {key}",
                         getattr(levels[i], key).ell_arrays, 1)
                        for i, key in ((0, "P"), (0, "R"), (1, "A"))]
            keep[0].destroy_system()
    A = _gate4_operator(96, device)[0].astype(np.float32)
    ops += [("gate-4 96^3 A_lo", A.ell_arrays, 1),
            ("gate-4 96^3 A_lo 3 columns", A.ell_arrays, 3)]
    return ops


def sweep_k2_sum(device=None, log=print) -> list:
    """Each operator of :func:`_k2_sum_ops` through each build of
    ``K2_SUMS`` (the port's K2 wrapper on that build's library): device
    time (each call in a trace of its own) and time per call, and the
    error against the f64 product, relative to its largest entry, on a
    random x and on a smooth x (1 + 1e-3 noise, on which a Laplacian row
    cancels to its small part).  Returns [{"op", "sum", "device_ms",
    "call_ms", "err_random", "err_smooth"}]."""
    import functools
    from concurrent.futures import ThreadPoolExecutor
    from tpusolve_torch.kernels import build, ell
    device = device or torch.device("cuda", torch.cuda.current_device())
    with ThreadPoolExecutor(len(K2_SUMS)) as pool:
        list(pool.map(functools.partial(build.compile_library, "ell_spmv"),
                      K2_SUMS.values()))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    port_fns = ell._kernel_fns
    out = []
    try:
        for name, (vals, cols, rowptr), k in _k2_sum_ops(device):
            n = int(cols.max()) + 1
            shape = (k, n) if k > 1 else (n,)
            xr = torch.randn(shape, generator=gen, device=device)
            xs = 1 + 1e-3 * torch.randn(shape, generator=gen, device=device)
            exact = {}
            for key, x in (("random", xr), ("smooth", xs)):
                cols_of = [x] if k == 1 else list(x)
                exact[key] = torch.stack([ell.ell_spmv(
                    vals.double().cpu(), cols.cpu(), xc.double().cpu(),
                    rowptr=None if rowptr is None else rowptr.cpu())
                    for xc in cols_of])
            for sum_name, defines in K2_SUMS.items():
                ell._kernel_fns = functools.partial(port_fns, defines)
                call = functools.partial(ell.ell_spmv, vals, cols, xr,
                                         rowptr=rowptr)
                errs = {}
                for key, x in (("random", xr), ("smooth", xs)):
                    y = ell.ell_spmv(vals, cols, x, rowptr=rowptr)
                    y = y.double().cpu().reshape(exact[key].shape)
                    errs[key] = float((y - exact[key]).abs().max()
                                      / exact[key].abs().max())
                dev = device_ms_each({"k2": call})["k2"]
                row = dict(op=name, sum=sum_name, device_ms=dev,
                           call_ms=time_ms(call), err_random=errs["random"],
                           err_smooth=errs["smooth"])
                log(f"K2 {name} ({'padded' if rowptr is None else 'rowptr'}"
                    f", {vals.dtype}), rows summed in {sum_name}: device "
                    f"{dev:.5f} ms, per call {row['call_ms']:.5f} ms; error "
                    f"against f64, random x {errs['random']:.3e}, smooth x "
                    f"{errs['smooth']:.3e}")
                out.append(row)
    finally:
        ell._kernel_fns = port_fns
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


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
    if sys.argv[1:] == ["--k5"]:
        print(card_line(), flush=True)
        print(json.dumps(sweep_k5()), flush=True)
        sys.exit(0)
    if sys.argv[1:] == ["--k1"]:
        sweep_k1()
        sys.exit(0)
    if sys.argv[1:] == ["--fused"]:
        print(card_line(), flush=True)
        print(json.dumps(sweep_fused()), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--retrace"] and len(sys.argv) == 3:
        print(json.dumps({"device_ms": retrace(sys.argv[2])}), flush=True)
        sys.exit(0)
    if sys.argv[1:] == ["--k2-sum"]:
        print(card_line(), flush=True)
        print(json.dumps(sweep_k2_sum()), flush=True)
        sys.exit(0)
    if sys.argv[1:] == ["--k2"]:
        print(json.dumps(sweep_k2()), flush=True)
        sys.exit(0)
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        print(json.dumps(measure()), flush=True)
