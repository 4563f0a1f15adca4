#!/usr/bin/env python3
"""Smoke run of tpusolve_torch on one CUDA card.

    python3 chip_smoke.py [--side N] [--side3 N]

From the root of a checkout, on a machine with one NVIDIA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

1. prints the card's name and power limit, and the PyYAML version;
2. builds every kernel of ``tpusolve_torch/csrc`` (one nvcc per source, all
   at once) and prints the seconds;
3. holds the BDIA SpMV kernels K4 and K5, overflow list included, and the
   BELL SpMV kernel K6 against their plain PyTorch versions, in float32 and
   float64, and K5 against K4 bit for bit, once on an x that is not 16-byte
   aligned, and K4's launch plans (a small launch of wide blocks run as
   chunks, an operator of 640 slots) against K5 bit for bit; the padded-ELL
   SpMV kernel K2 against its plain version on square and rectangular
   operators of K = 1, 8, 40, 131 and 638 slots, in f32 and f64, at every
   threads-a-row count and in every update form, in place too;
4. gate 4: writes the momentum fixture at N^3 rows (``--side``, default
   96^3 = 884,736 rows, 23.4M nonzeros) and runs it through the port's CLI
   (``tpusolve_torch.harness.cli.main``): HYPRE-IJ files read by the native
   parser, RCM, BDIA assembly in f64 with an f32 twin, Chow-Patel ILU(0)
   whose factors run K4 or K5 as the time model prices them, BiCGSTAB in
   f32 inside f64 iterative refinement, golden check (at 96^3 exactly the
   port's 54 iterations); then at the four operator shapes of that run (A,
   A_lo, L, U) times K4, K5 where a step plan fits, the plain version, the
   library's CSR SpMV (``torch.sparse``) and the bound;
5. gate 3: writes the pressure fixture at N^3 rows (``--side3``, default
   64^3 = 262,144 rows, 6.86M nonzeros) and runs it through the CLI:
   MatrixMarket files, RCM, BoomerAMG host setup (PMIS, extended+i,
   l1-Jacobi; the native setup kernels of ``csrc/spkernels.cpp``) with
   BDIA, BELL and ELL levels and ELL transfers (K2), GMRES(20) in f64,
   golden check; prints each level's layout and the timer rows, then at
   every BELL level times K6, its plain version, K4 on the BDIA layout of
   the same operator, the plain ELL SpMV and the library's SpMV, against
   the layout model's prediction and K6's bound, at every BDIA level K4,
   K5, plain and library, at every ELL operator (A, P and R by level) K2,
   plain, library and bound, K2 on an ELL copy of the low-fill BDIA level
   1 beside K4, and the warm-solve profile; then the same fixture with
   ``coarsen_type: 6`` (Falgout, run as serial RS): its hierarchy, timer
   rows and, at 64^3, tpusolve's 11 iterations;
6. gate 1: ``examples/gate1_64cube_pcg_amg.yaml`` as it is (64^3 =
   262,144 rows, ``mixed``) through the CLI: the 27-point stencil as box
   DIA, the PFMG-style structured hierarchy (DIA-algebra RAP, the K3 box
   transfers, l1-Jacobi, dense coarse solve), PCG in f32 inside f64
   refinement, golden check; then K1 against its plain version on every
   level in f32 and f64, in the plain form and each update form
   ``c + w * s * (b - A x)`` of the cycle, and the same bits in two runs;
   at each level (and on the f64 A) K1's time, the plain version's, the
   library's CSR SpMV and the bound; the 32^3 level cold (L2 flushed) and
   warm; K3 (prolongation with its add, restriction) against its plain
   versions on every transition in f32 and f64, the adjoint identity on
   the card, and each kernel's time, the plain version's, the library's
   (``interpolate``, trilinear, for the prolongation, and its backward,
   ``upsample_trilinear3d_backward``, for the restriction) and the bound;
   then one warm solve under
   ``torch.profiler``: device operations and device time by kernel class
   (K1, K3, ...), K1's launches by form, and the device's idle share;
7. gate 2: ``examples/gate2_weakscale_gmres_cheby.yaml`` as it is (128^3 =
   2,097,152 rows, ``single``, GMRES(20) + Chebyshev-smoothed PFMG) through
   the CLI, then the same K1 and K3 checks and timings at its five levels
   and four transitions, its warm-solve profile, and K1 on a 4-wide coarse
   box against the exact CSR product;
8. (run right after step 3's checks, before gate 4) the device AMG setup
   against the host pipeline: level 0 of the 32^3
   stencil in f64 set up on the card (``amg/device_setup.py``, its row
   floor forced) for classical-modified and direct interpolation, held
   against the port's host pipeline on the same operator (the C/F split
   equal, P, R and the coarse A to 1e-12 relative), with each stage's
   seconds;
9. the weak-scaling BoomerAMG path:
   ``examples/weakscale_pcg_boomeramg_devsetup.yaml`` as it is (128^3 =
   2,097,152 rows, ``single``, PCG + BoomerAMG: PMIS, classical-modified
   interpolation, theta 0.57, l1-Jacobi, ``max_coarse_size`` 512) through
   the CLI: level 0 set up on the card (it fails unless the hierarchy
   carries ``amg/builder.py``'s device note), the host pipeline below, golden check; the seconds of
   each setup stage and of the host levels, each level's layout, the
   timer rows, K1, K4 and K6 against their plain versions at the levels
   that run them with their times, K2 at every ELL operator, K2 on ELL
   copies of the BDIA levels 2 and 3 beside K4, the launch counts (it
   fails unless each operator's layout launched its kernel) and the
   warm-solve profile;
10. measures the constants of the time model (``kernels/calibrate.py``)
   beside the ones in the code.

Every kernel time is given twice: device time (the kernels' durations in a
``torch.profiler`` trace, ``calibrate.device_ms``) and time per call
between CUDA events (``calibrate.time_ms``), which on a small launch is
the host's.  Each path's kernel launches are counted from 0 just before its
CLI run and read just after; a path that launched none of its kernels
fails, and gate 4 fails unless each of its operators runs the kernel the
model prices faster (K4 on all four at 96^3 since the register-stage K4;
K5 is then held by the checks of step 3 and the timings alone).  The
second-to-last line is a JSON object with one entry per kernel (launches,
device and per-call times, plain, library and bound); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines, as does a machine without CUDA or a directory without
the ``tpusolve_torch`` package.  Gates 1 and 2 fail unless K1 and both K3
kernels ran during their run and no other SpMV kernel did (every operator
of the structured path is box DIA).  ``profile_solves.py`` profiles the
warm solves of gates 1 and 2 alone, also of an earlier checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# max |kernel - plain| / max |plain| allowed: summation order differs
# (slot order in the kernel, torch's reduction in the plain version)
RTOL = {"float32": 1e-5, "float64": 1e-12}
# tpusolve on CPU, gate-4 fixture 96^3, precision mixed: BiCGSTAB
# iterations summed over the refinement passes; the port's count on the
# card (31 + 23), the same whether BDIA runs K4 or K5 (equal bit for bit)
TPUSOLVE_ITERS_96 = 56
PORT_ITERS_96 = 54
# tpusolve on CPU, gate-3 fixture 64^3, precision double: GMRES iterations
TPUSOLVE_GATE3_ITERS_64 = 12
# tpusolve on CPU, examples/gate1_64cube_pcg_amg.yaml as it is (64^3,
# mixed): PCG iterations summed over the refinement passes
TPUSOLVE_GATE1_ITERS = 14
# tpusolve on CPU, examples/gate2_weakscale_gmres_cheby.yaml as it is
# (128^3, single): GMRES iterations, printed for reference only.  Its f32
# projection h = V @ w under XLA on the CPU is 450x less accurate than
# torch's, and its GMRES stalls; with that projection in f64, or with
# cgs: 2, tpusolve takes 6 at 64^3 (tests/test_torch_gmres_projection.py,
# ROADMAP.md Queue 3).  The gate holds the port to 6, its count on the card
TPUSOLVE_GATE2_ITERS = 22
PORT_GATE2_ITERS = 6
# tpusolve on CPU, examples/weakscale_pcg_boomeramg_devsetup.yaml as it is
# (128^3, single, its level 0 set up by its device setup on the CPU, host
# PMIS ranks: TPUSOLVE_PMIS_HOST_RANK=1): PCG iterations, relres 5.474e-07;
# the port is held within one of it
TPUSOLVE_WEAKSCALE_ITERS = 23
# tpusolve on CPU, gate-3 fixture 64^3 with coarsen_type 6 (Falgout, run as
# serial RS by its native kernel), precision double: GMRES iterations,
# relres 1.417e-09, eight levels (262144 ... 53 rows)
TPUSOLVE_GATE3_RS_ITERS_64 = 11
# the start of the note the builder records for a device level 0
DEVICE_NOTE = "level 0 setup on device"


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi listed no GPU")
    return out[0]


def rel_err(y, y_ref) -> float:
    scale = float(y_ref.abs().max())
    return float((y - y_ref).abs().max()) / (scale if scale > 0 else 1.0)


def banded_check(device) -> tuple:
    """K4 and K5 against their plain versions on a banded matrix whose
    clipped boundary blocks spill to the overflow list, K5 against K4 bit
    for bit (also on an x that is not 16-byte aligned), and the whole SpMV
    against scipy.  Returns the largest relative error of K4 and of K5."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch.kernels.bdia import (
        bdia_spmv, bdia_spmv_plain, bdia_spmv_xl, bdia_spmv_xl_plain)
    from tpusolve_torch.matrix import sharded
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(5)
    n = 200_000
    rr = np.arange(n, dtype=np.int64)
    rows = np.concatenate([rr] * 10)
    cols = np.concatenate([np.clip(rr + base + dd, 0, n - 1)
                           for base in (-600, 0, 600) for dd in (-1, 0, 1)]
                          + [rr])
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    worst4 = worst5 = 0.0
    for dtype in (np.float32, np.float64):
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=device,
                                   dtype=dtype)
        if not A.uses_bdia or A.bdia_ovf_vals is None:
            fail(f"banded check: expected BDIA with overflow, got {A.layout}")
        x = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=device)
        args = (A.bdia_vals, A.bdia_starts, x, A.bdia_xpad, A.bdia_xlen,
                A.row_pad, A.bdia_ovf)
        y4 = bdia_spmv(*args)
        err = rel_err(y4, bdia_spmv_plain(*args))
        y = spmv(A, x).double().cpu().numpy()
        y_ref = S.astype(dtype) @ x.cpu().numpy()
        err_sp = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        name = str(A.dtype).replace("torch.", "")
        print(f"K4 banded n={n} {name} {A.layout}: kernel vs plain "
              f"rel err {err:.3e} (limit {RTOL[name]:.0e}); SpMV vs scipy "
              f"{err_sp:.3e}", flush=True)
        if not err <= RTOL[name] or not err_sp <= 10 * RTOL[name]:
            fail(f"banded check {name} out of tolerance")
        worst4 = max(worst4, err)
        # K5 on the same layout, on the step plan the model prices best
        # (whether or not it would beat K4 there)
        _, B, D, R = A.bdia_vals.shape
        itemsize = A.bdia_vals.element_size()
        plan = sharded.plan_xl(A.bdia_starts.cpu().numpy(), R, A.bdia_xpad,
                               itemsize, sharded.bdia_bytes(
                                   B, D, R, int(A.bdia_ovf_ptr[0, -1]),
                                   itemsize))
        if plan is None:
            fail("banded check: no K5 step plan fits")
        gb, step_lo, panel = plan[0], torch.tensor(plan[1], device=device), \
            plan[2]
        xargs = (A.bdia_vals, A.bdia_starts, x, A.bdia_xpad, A.row_pad, gb,
                 step_lo, panel, A.bdia_ovf)
        y5 = bdia_spmv_xl(*xargs)
        err5 = rel_err(y5, bdia_spmv_xl_plain(*xargs))
        buf = torch.empty(n + 1, dtype=A.dtype, device=device)
        buf[1:] = x
        y5u = bdia_spmv_xl(A.bdia_vals, A.bdia_starts, buf[1:], A.bdia_xpad,
                           A.row_pad, gb, step_lo, panel, A.bdia_ovf)
        same, same_u = bool(torch.equal(y5, y4)), bool(torch.equal(y5u, y4))
        print(f"K5 banded n={n} {name} gb={gb} panel={panel} steps="
              f"{step_lo.shape[1]}: kernel vs plain rel err {err5:.3e} "
              f"(limit {RTOL[name]:.0e}); equal to K4: {same}; on an x at "
              f"a 16-byte misalignment ({buf[1:].data_ptr() % 16} bytes off "
              f"16): equal to K4: {same_u}", flush=True)
        if not err5 <= RTOL[name] or not (same and same_u):
            fail(f"banded check: K5 {name} out of tolerance or not K4's")
        worst5 = max(worst5, err5)
    return worst4, worst5


def k4_launch_check(device) -> float:
    """K4's launch plans against its plain version and K5 bit for bit, in
    both dtypes, overflow lists included: a small launch of wide blocks
    (5,000 rows in 10 blocks of R=512, run as chunks of 256 rows, deep
    register stages) and an operator of D=640 slots, like gate 3's level 1
    (688).  Returns the largest relative error against the plain
    version."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels import bdia
    from tpusolve_torch.matrix.sharded import _ovf_fields

    rng = np.random.default_rng(12)
    n = 5000
    rr = np.arange(n, dtype=np.int64)
    # a band of 9 random entries a row within 40 of the diagonal; and 12
    # entries a row drawn from 900 offsets per 128-row block within 2,000
    band = (np.repeat(rr, 9), np.clip(np.repeat(rr, 9) + rng.integers(
        -40, 41, size=9 * n), 0, n - 1))
    offs = rng.integers(-2000, 2001, size=(-(-n // 128), 900))
    wr = np.repeat(rr, 12)
    wide = (wr, np.clip(wr + offs[wr // 128, rng.integers(0, 900, wr.size)],
                        0, n - 1))
    worst = 0.0
    for what, (rows, cols), R, D in (("small launch", band, 512, 12),
                                     ("D=640", wide, 128, 640)):
        key = np.unique(np.concatenate([rows, rr]) * n
                        + np.concatenate([cols, rr]))
        r, c = key // n, key % n
        v = rng.standard_normal(key.size)
        for dtype in (np.float32, np.float64):
            st, fi, vo, o_r, o_c, o_v = bdia.compact(
                r, c, v, n, n, R, D, dtype=dtype, overflow=True)
            B = -(-n // R)
            vals = np.zeros(B * D * R, dtype)
            vals[fi] = vo
            starts, xpad, xlen = bdia.finalize_starts(st, n, R)
            f = _ovf_fields([(o_r, o_c, o_v)], n, n, dtype, device)
            ovf = (f["bdia_ovf_ptr"], f["bdia_ovf_cols"], f["bdia_ovf_vals"])
            vt = torch.tensor(vals.reshape(1, B, D, R), device=device)
            stt = torch.tensor(starts[None], device=device)
            x = torch.tensor(rng.standard_normal(n).astype(dtype),
                             device=device)
            args = (vt, stt, x, xpad, xlen, n, ovf)
            y4 = bdia.bdia_spmv(*args)
            err = rel_err(y4, bdia.bdia_spmv_plain(*args))
            gb, step_lo, panel = bdia.plan_steps(
                starts[None], R, xpad, vals.itemsize,
                lambda g, nsteps, panel: abs(g - 4))
            y5 = bdia.bdia_spmv_xl(vt, stt, x, xpad, n, gb, torch.tensor(
                step_lo, device=device), panel, ovf)
            rc, S, blocks, _ = bdia.k4_plan(1, B, D, R, vals.itemsize)
            name = np.dtype(dtype).name
            same = bool(torch.equal(y4, y5))
            print(f"K4 {what} n={n} {name} R={R} D={D} overflow="
                  f"{int(ovf[0][0, -1])}: {blocks} blocks of {rc} rows, "
                  f"S={S}; kernel vs plain rel err {err:.3e} (limit "
                  f"{RTOL[name]:.0e}); equal to K5 (gb={gb}): {same}",
                  flush=True)
            if not err <= RTOL[name] or not same:
                fail(f"K4 {what} {name} out of tolerance or not K5's")
            worst = max(worst, err)
    return worst


def bell_check(device) -> float:
    """K6 against its plain version on a blocked matrix with ragged groups
    and windows (1,501 rows: the last group and the last window are
    partial), in both dtypes; the whole SpMV against scipy.  Returns the
    largest relative error seen."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch.kernels.bell import bell_spmv, bell_spmv_plain
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(6)
    n, width = 1501, 40
    rows = np.repeat(np.arange(n, dtype=np.int64), 32)
    base = rng.integers(0, n - width, size=(n, 8)).repeat(4, axis=1)
    cols = base.reshape(-1) + rng.integers(0, width, size=rows.size)
    key = np.unique(np.concatenate([rows * n + cols, np.arange(n) * (n + 1)]))
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    worst = 0.0
    for dtype in (np.float32, np.float64):
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=device,
                                   dtype=dtype)
        if not A.uses_bell:
            fail(f"blocked check: expected BELL, got {A.layout}")
        x = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=device)
        args = (A.bell_vals, A.bell_ids, x, A.bell_nwin, A.row_pad)
        err = rel_err(bell_spmv(*args), bell_spmv_plain(*args))
        y = spmv(A, x).double().cpu().numpy()
        y_ref = S.astype(dtype) @ x.cpu().numpy()
        err_sp = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        name = str(A.dtype).replace("torch.", "")
        print(f"K6 blocked n={n} {name} {A.layout}: kernel vs plain rel err "
              f"{err:.3e} (limit {RTOL[name]:.0e}); SpMV vs scipy "
              f"{err_sp:.3e}", flush=True)
        if not err <= RTOL[name] or not err_sp <= 10 * RTOL[name]:
            fail(f"blocked check {name} out of tolerance")
        worst = max(worst, err)
    return worst


def library_spmv(M):
    """(call, x) of the PyTorch library's SpMV on operator ``M``: a CSR
    ``torch.sparse`` matvec (cuSPARSE) in M's dtype; the port never calls
    it.  ``x`` has M's unpadded width."""
    import torch
    H = M.to_scipy().tocsr()
    dev = M.device
    csr = torch.sparse_csr_tensor(
        torch.tensor(H.indptr, dtype=torch.int64, device=dev),
        torch.tensor(H.indices, dtype=torch.int64, device=dev),
        torch.tensor(H.data, dtype=M.dtype, device=dev), size=H.shape)
    x = torch.zeros(H.shape[1], dtype=M.dtype, device=dev)
    return (lambda: csr @ x), x


def bound_ms(nbytes: int, device_name: str) -> float:
    """The least time the card could take to move ``nbytes``: over its
    published HBM rate (``runtime.hbm_gbps``)."""
    from tpusolve_torch.runtime import hbm_gbps
    gbps = hbm_gbps(device_name)
    if gbps is None:
        fail(f"no published HBM rate for {device_name}")
    return nbytes / (gbps * 1e9) * 1e3


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def device_times(calls: dict, only: str | None = None) -> dict:
    """``calibrate.device_ms_each`` of ``calls`` (of the kernels named like
    ``only``, if given), or NaN for each where the profiler's traces held no
    device event (printed; the JSON line gives null): a time that was not
    measured fails no check."""
    from tpusolve_torch.kernels.calibrate import device_ms_each
    try:
        return device_ms_each(calls, only=only)
    except RuntimeError as err:
        print(f"device time not measured: {err}", flush=True)
        return {key: float("nan") for key in calls}


def no_nan(obj):
    """``obj`` with every NaN float replaced by None, for strict JSON."""
    if isinstance(obj, float) and obj != obj:
        return None
    if isinstance(obj, dict):
        return {k: no_nan(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [no_nan(v) for v in obj]
    return obj


def spmv_nbytes(M) -> int:
    """The bytes an SpMV of operator ``M`` must move, whatever its layout:
    each nonzero's value once, x once and y once.  A layout's padding and
    in-band zeros are not needed, and the DIA, BDIA and BELL layouts take a
    value's column from its diagonal or tile, so no index is counted; the
    layout's own bytes are reported beside the bound, not in it."""
    rows, cols = M.shape
    return (M.nnz + rows + cols) * M.diag.element_size()


def bdia_timings(ops, device_name: str, seed: int):
    """At each (name, BDIA operator) of ``ops``: the layout; K4, and K5
    where a step plan fits (the operator's own, else the model's best),
    each against its plain version, K5 against K4 bit for bit; the
    library's SpMV; the bound.  Returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.bdia import (
        bdia_spmv, bdia_spmv_plain, bdia_spmv_xl, bdia_spmv_xl_plain)
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.matrix import sharded

    rng = np.random.default_rng(seed)
    rows = []
    for name, M in ops:
        if not M.uses_bdia:
            fail(f"operator {name} is not BDIA ({M.layout})")
        dt = str(M.dtype).replace("torch.", "")
        _, B, D, R = M.bdia_vals.shape
        itemsize = M.bdia_vals.element_size()
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        args = (M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.bdia_xlen,
                M.row_pad, M.bdia_ovf)
        y4 = bdia_spmv(*args)
        y4p = bdia_spmv_plain(*args)
        err4 = rel_err(y4, y4p)
        if not err4 <= RTOL[dt]:
            fail(f"{name}: K4 vs plain rel err {err4:.3e} > {RTOL[dt]}")
        k = int(M.bdia_ovf_ptr[0, -1]) if M.bdia_ovf_ptr is not None else 0
        nbytes = sharded.bdia_bytes(B, D, R, k, itemsize)
        model4 = 1e3 * sharded.k4_model_s(itemsize, nbytes, 1, B, D, R)
        plan = sharded.plan_xl(M.bdia_starts.cpu().numpy(), R, M.bdia_xpad,
                               itemsize, nbytes)
        model5 = None if plan is None else 1e3 * plan[3]
        if M.uses_bdia_xl:
            plan = (M.bdia_gb, M.bdia_step_lo, M.bdia_panel)
        elif plan is not None:
            plan = (plan[0], torch.tensor(plan[1], device=M.device), plan[2])
        xargs = None if plan is None else (
            M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.row_pad, *plan,
            M.bdia_ovf)
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        err_lib = rel_err(lib_call(), y4p[:xlib.numel()])
        row = dict(op=name, dtype=dt, layout=M.layout, B=B, D=D, R=R,
                   overflow=k, rel_err=err4, max_abs_err=float(
                       (y4 - y4p).abs().max()), lib_rel_err=err_lib,
                   model_k4_ms=model4, model_k5_ms=model5)
        if xargs is not None:
            y5 = bdia_spmv_xl(*xargs)
            y5p = bdia_spmv_xl_plain(*xargs)
            err5 = rel_err(y5, y5p)
            if not err5 <= RTOL[dt] or not torch.equal(y5, y4):
                fail(f"{name}: K5 vs plain rel err {err5:.3e} or not equal "
                     "to K4")
            row.update(gb=plan[0], panel=plan[2], steps=plan[1].shape[1],
                       xl_rel_err=err5, xl_max_abs_err=float(
                           (y5 - y5p).abs().max()))
        # alternate plain, kernels, library, kernels, plain on the card
        plain = (lambda: bdia_spmv_xl_plain(*xargs)) if M.uses_bdia_xl \
            else (lambda: bdia_spmv_plain(*args))
        calls = [("plain", plain), ("k4", lambda: bdia_spmv(*args))]
        if xargs is not None:
            calls.append(("k5", lambda: bdia_spmv_xl(*xargs)))
        calls.append(("lib", lib_call))
        runs = {key: [] for key, _ in calls}
        for key, call in calls + calls[::-1]:
            runs[key].append(time_ms(call))
        for key, ts in runs.items():
            row[key + "_ms"] = min(ts)
            row[key + "_runs"] = ts
        for key, ms in device_times(dict(calls)).items():
            row[key + "_dev_ms"] = ms
        row["bound_ms"] = bound_ms(spmv_nbytes(M), device_name)
        row["layout_mb"] = nbytes / 1e6
        row["ms"] = row["k5_ms" if M.uses_bdia_xl else "k4_ms"]
        k5 = (f"K5 gb={row['gb']} panel={row['panel']} device "
              f"{row['k5_dev_ms']:.5f} ms, per call {row['k5_ms']:.5f} ms "
              f"(runs {row['k5_runs'][0]:.5f}, {row['k5_runs'][1]:.5f}; "
              f"model {model5:.5f}), rel err {row['xl_rel_err']:.3e}, equal "
              f"to K4; " if xargs is not None else "K5: no step plan fits; ")
        print(f"{name} {dt} {M.layout}: K4 device {row['k4_dev_ms']:.5f} ms, "
              f"per call {row['k4_ms']:.5f} ms (runs "
              f"{row['k4_runs'][0]:.5f}, {row['k4_runs'][1]:.5f}; model "
              f"{model4:.5f}), rel err "
              f"{err4:.3e}; {k5}plain device {row['plain_dev_ms']:.5f} ms, "
              f"per call {row['plain_ms']:.5f} ms; library (torch.sparse "
              f"CSR) device {row['lib_dev_ms']:.5f} ms, per call "
              f"{row['lib_ms']:.5f} ms (rel err {err_lib:.1e}); bound "
              f"{row['bound_ms']:.5f} ms ({M.nnz} nnz, x, y; the layout "
              f"stores {row['layout_mb']:.3f} MB)", flush=True)
        rows.append(row)
    return rows


def run_cli(yaml_path: str, counters) -> tuple:
    """Run the port's CLI on ``yaml_path`` with every launch counter set to
    0 just before; returns (exit code, LinearSystem, wall seconds,
    {counter name: launches}); a counter's ``launches_by_form`` (K1's
    launches by form) is set to {} with it."""
    from tpusolve_torch.harness import cli
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "launches_by_form"):
            fn.launches_by_form = {}
    systems = []
    t0 = time.perf_counter()
    rc = cli.main([yaml_path, "--device", "cuda"], keep=systems)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    return rc, (systems[0] if systems else None), wall, launches


def check_solve(system, rc: int, what: str, tol: float = 1e-8):
    """Fail unless the run passed its golden check with relres <= ``tol``
    (the run's tolerance) and a finite solution of the padded shape."""
    import torch
    if rc != 0:
        fail(f"the {what} run failed (cli exit {rc})")
    res = system.solve_results[0]
    relres = float(res.relres)
    if not (relres <= tol and bool(res.converged)):
        fail(f"{what}: relres {relres:.3e} above {tol:g} or not converged")
    x = system.sln[0]
    if not bool(torch.isfinite(x).all()) or x.shape != (system.A.row_pad,):
        fail(f"{what}: solution is not finite or has the wrong shape")
    return res


def model_takes_xl(M) -> bool:
    """Whether the time model puts BDIA operator ``M`` on K5."""
    from tpusolve_torch.matrix import sharded
    _, B, D, R = M.bdia_vals.shape
    itemsize = M.bdia_vals.element_size()
    k = 0 if M.bdia_ovf_ptr is None else int(M.bdia_ovf_ptr[0, -1])
    return sharded.choose_xl(M.bdia_starts.cpu().numpy(), R, M.bdia_xpad,
                             itemsize, sharded.bdia_bytes(
                                 B, D, R, k, itemsize)) is not None


def gate4_phase(side: int, device_name: str, counters):
    """The gate-4 path; returns (launches, K4/K5 timing rows)."""
    from tpusolve_torch import fixtures
    work = os.path.join(REPO, "build", f"gate4_{side}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        yaml_path = fixtures.write_gate4(work, side)
        print(f"gate-4 fixture {side}^3 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rc, system, wall, launches = run_cli(yaml_path, counters)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"gate-4 path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-4")
    pre = system._precond
    print(f"gate-4 layouts: A {system.A.layout}; A_lo {system.A_lo.layout}; "
          f"L {pre.L.layout}; U {pre.U.layout}", flush=True)
    if launches["bdia_spmv"] <= 0:
        fail("the gate-4 path launched no K4 (bdia_spmv)")
    # each operator runs the kernel the time model prices faster
    # (matrix/sharded.py:choose_xl): since the register-stage K4, K4 for
    # all four at 96^3 (tests/test_torch_bdia_xl.py)
    xl_ops = []
    for name, M in (("A", system.A), ("A_lo", system.A_lo), ("L", pre.L),
                    ("U", pre.U)):
        if M.uses_bdia_xl != model_takes_xl(M):
            fail(f"gate-4 {name} runs {M.layout}, not the model's kernel")
        xl_ops += [name] if M.uses_bdia_xl else []
    if bool(xl_ops) != (launches["bdia_spmv_xl"] > 0):
        fail(f"gate-4 launched K5 {launches['bdia_spmv_xl']} times with "
             f"BDIA-XL on {xl_ops}")
    print(f"gate-4 kernels, as the model prices them: K5 on "
          f"{xl_ops or 'none'}, K4 on the rest", flush=True)
    passes = res.passes or []
    print(f"gate-4 {side}^3: {res.iters} BiCGSTAB iterations over "
          f"{len(passes)} refinement passes {passes}, relres "
          f"{float(res.relres):.3e}, golden check PASSED", flush=True)
    if side == 96:
        gap = res.iters - TPUSOLVE_ITERS_96
        verdict = ("within one per pass" if abs(gap) <= len(passes)
                   else "MORE than one per pass")
        print(f"iterations: port {res.iters}, tpusolve (CPU, same fixture) "
              f"{TPUSOLVE_ITERS_96}: gap {gap:+d} over {len(passes)} passes, "
              f"{verdict}", flush=True)
        if res.iters != PORT_ITERS_96:
            fail(f"gate-4 took {res.iters} iterations, not the port's "
                 f"{PORT_ITERS_96}")
    rows = bdia_timings((("A", system.A), ("A_lo", system.A_lo),
                         ("L", pre.L), ("U", pre.U)), device_name, 9)
    system.destroy_system()
    return launches, rows


def bell_level_timings(pre, device_name: str) -> list:
    """At every BELL level of the hierarchy: K6 against its plain version,
    K4 on the BDIA layout of the same operator, K2 on its ELL layout and the
    library's SpMV; the layout model's prediction for K6 and K4, and K6's
    bound.  Returns one row per level."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.bdia import bdia_spmv
    from tpusolve_torch.kernels.bell import bell_spmv, bell_spmv_plain
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.matrix import sharded
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.kernels.ell import ell_spmv
    from tpusolve_torch.matrix.vectors import numpy_dtype

    rng = np.random.default_rng(10)
    rows = []
    for i, lev in enumerate(pre.levels):
        M = lev.A
        if not M.uses_bell:
            continue
        host = M.to_scipy()
        dt = str(M.dtype).replace("torch.", "")
        itemsize = M.bell_vals.element_size()
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        args = (M.bell_vals, M.bell_ids, x, M.bell_nwin, M.row_pad)
        y_plain = bell_spmv_plain(*args)
        err = rel_err(bell_spmv(*args), y_plain)
        abs_err = float((bell_spmv(*args) - y_plain).abs().max())
        if not err <= RTOL[dt]:
            fail(f"level {i}: K6 vs plain rel err {err:.3e} > {RTOL[dt]}")
        np_dt = numpy_dtype(M.dtype)
        Mb = ShardedMatrix.from_csr_host(host, device=M.device, dtype=np_dt,
                                         allow_dia=False, allow_bell=False)
        Me = ShardedMatrix.from_csr_host(host, device=M.device, dtype=np_dt,
                                         allow_dia=False, allow_bell=False,
                                         allow_bdia=False)
        if not Mb.uses_bdia:
            fail(f"level {i}: no BDIA layout to compare ({Mb.layout})")
        bargs = (Mb.bdia_vals, Mb.bdia_starts, x, Mb.bdia_xpad, Mb.bdia_xlen,
                 Mb.row_pad, Mb.bdia_ovf)
        err_b = rel_err(bdia_spmv(*bargs), y_plain)
        err_e = rel_err(ell_spmv(Me.diag_vals[0], Me.diag_cols[0], x),
                        y_plain)
        if not max(err_b, err_e) <= RTOL[dt]:
            fail(f"level {i}: K4 or ELL against K6's plain version "
                 f"{max(err_b, err_e):.3e} > {RTOL[dt]}")
        # alternate plain, kernel, kernel, plain on the same card
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        err_lib = rel_err(lib_call(), y_plain[:xlib.numel()])
        p1 = time_ms(lambda: bell_spmv_plain(*args))
        k1 = time_ms(lambda: bell_spmv(*args))
        b1 = time_ms(lambda: bdia_spmv(*bargs))
        ell = lambda: ell_spmv(Me.diag_vals[0], Me.diag_cols[0], x)
        e1 = time_ms(ell)
        l1 = time_ms(lib_call)
        l2 = time_ms(lib_call)
        e2 = time_ms(ell)
        b2 = time_ms(lambda: bdia_spmv(*bargs))
        k2 = time_ms(lambda: bell_spmv(*args))
        p2 = time_ms(lambda: bell_spmv_plain(*args))
        dev = device_times({
            "ms": lambda: bell_spmv(*args),
            "plain_ms": lambda: bell_spmv_plain(*args),
            "k4_ms": lambda: bdia_spmv(*bargs), "ell_ms": ell,
            "library_ms": lib_call})
        _, G, K = M.bell_ids.shape
        _, B, D, R = Mb.bdia_vals.shape
        bell_bytes = G * K * (8 * 128 * itemsize + 4)
        bdia_bytes = sharded.bdia_bytes(B, D, R, int(
            Mb.bdia_ovf_ptr[0, -1]) if Mb.bdia_ovf_ptr is not None else 0,
            itemsize)
        model_k6 = 1e3 * sharded.spmv_model_s(
            sharded.SPMV_MODEL["bell"], bell_bytes,
            sharded.bell_threads(G, K))
        model_k4 = 1e3 * sharded.spmv_model_s(
            sharded.SPMV_MODEL["bdia"], bdia_bytes,
            sharded.bdia_threads(B, R))
        row = dict(level=i, dtype=dt, rows=M.shape[0], nnz=M.nnz, G=G, K=K,
                   B=B, D=D, R=R, ms=min(k1, k2), plain_ms=min(p1, p2),
                   k4_ms=min(b1, b2), ell_ms=min(e1, e2),
                   library_ms=min(l1, l2), lib_rel_err=err_lib,
                   bound_ms=bound_ms(spmv_nbytes(M), device_name),
                   model_k6_ms=model_k6, model_k4_ms=model_k4,
                   bell_mb=bell_bytes / 1e6, bdia_mb=bdia_bytes / 1e6,
                   max_abs_err=abs_err, rel_err=err)
        row.update({k.replace("ms", "dev_ms"): v for k, v in dev.items()})
        agree = (dev["ms"] < dev["k4_ms"]) == (model_k6 < model_k4)
        print(f"gate-3 level {i} ({M.shape[0]} rows, {M.nnz} nnz) {dt}: "
              f"K6 BELL G={G} K={K} {bell_bytes / 1e6:.2f} MB: device "
              f"{dev['ms']:.5f} ms, per call {row['ms']:.5f} ms (runs "
              f"{k1:.5f}, {k2:.5f}; model {model_k6:.5f}); plain BELL device "
              f"{dev['plain_ms']:.5f} ms, per call {row['plain_ms']:.5f} ms "
              f"(runs {p1:.5f}, {p2:.5f}); K4 BDIA B={B} D={D} R={R} "
              f"{bdia_bytes / 1e6:.2f} MB: device {dev['k4_ms']:.5f} ms, per "
              f"call {row['k4_ms']:.5f} ms (runs {b1:.5f}, {b2:.5f}; model "
              f"{model_k4:.5f}); K2 ELL K={Me.diag_vals.shape[-1]} device "
              f"{dev['ell_ms']:.5f} ms, per call {row['ell_ms']:.5f} ms (runs "
              f"{e1:.5f}, {e2:.5f}); library (torch.sparse CSR) device "
              f"{dev['library_ms']:.5f} ms, per call {row['library_ms']:.5f} "
              f"ms (runs {l1:.5f}, {l2:.5f}; rel err {err_lib:.1e}); bound "
              f"{row['bound_ms']:.5f} ms ({M.nnz} nnz, x, y); layout model "
              f"{'agrees' if agree else 'DISAGREES'} with the measurement; "
              f"K6 rel err {err:.3e}", flush=True)
        rows.append(row)
    return rows


def check_launched(pre, launches: dict, what: str) -> None:
    """Fail unless every layout the cycle of hierarchy ``pre`` applies
    launched its kernel in the run: each level's A, and P and R where they
    are sparse operators (an algebraic hierarchy's are padded ELL, K2)."""
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
    from tpusolve_torch.kernels.bell import bell_spmv
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv
    by_layout = {"DIA": (dia_spmv,), "BDIA": (bdia_spmv, bdia_spmv_xl),
                 "BDIA-XL": (bdia_spmv_xl,), "BELL": (bell_spmv,),
                 "ELL": (ell_spmv,)}
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is None:
                continue
            fns = by_layout[M.layout.split()[0]]
            if not sum(launches[fn.__name__] for fn in fns):
                fail(f"{what}: level {i}'s {key} ({M.layout}) launched no "
                     f"{fns[0].__name__}")


def print_timers(system, what: str) -> dict:
    """Print the run's timer rows on one line; returns them."""
    timers = system.timers.as_dict()
    print(f"{what} timer rows (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in timers.items()), flush=True)
    return timers


def run_gate3(side: int, counters, what: str, edit=None):
    """Write the gate-3 fixture at side^3 (its YAML passed through
    ``edit``) and run it through the CLI; returns :func:`run_cli`'s
    (exit code, system, wall, launches)."""
    from tpusolve_torch import fixtures
    work = os.path.join(REPO, "build", f"gate3_{side}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        yaml_path = fixtures.write_gate3(work, side)
        if edit is not None:
            with open(yaml_path) as fh:
                text = edit(fh.read())
            with open(yaml_path, "w") as fh:
                fh.write(text)
        print(f"{what} fixture {side}^3 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return run_cli(yaml_path, counters)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def gate3_phase(side: int, device_name: str, counters):
    """The gate-3 path; returns a dict of its launches, K6 timing rows,
    K4/K5 timing rows of the BDIA levels, K2 rows of its ELL operators,
    K2 on an ELL copy of its low-fill BDIA level 1, timer rows and warm
    solve profile."""
    rc, system, wall, launches = run_gate3(side, counters, "gate-3")
    print(f"gate-3 path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-3")
    pre = system._precond
    for line in pre.layouts():
        print(f"gate-3 {line}", flush=True)
    timers = print_timers(system, "gate-3")
    if launches["bell_spmv"] <= 0:
        fail("the gate-3 path launched no BELL kernel")
    check_launched(pre, launches, "gate-3")
    print(f"gate-3 {side}^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; Preconditioner "
          f"setup {timers['Preconditioner setup']:.3f} s", flush=True)
    if side == 64:
        print(f"iterations: port {res.iters}, tpusolve (CPU, same fixture) "
              f"{TPUSOLVE_GATE3_ITERS_64}", flush=True)
        if res.iters != TPUSOLVE_GATE3_ITERS_64:
            fail(f"gate-3 took {res.iters} GMRES iterations, tpusolve "
                 f"{TPUSOLVE_GATE3_ITERS_64}")
    rows = bell_level_timings(pre, device_name)
    if not rows:
        fail("the gate-3 hierarchy has no BELL level")
    bdia_rows = bdia_timings([(f"level {i}", lev.A)
                              for i, lev in enumerate(pre.levels)
                              if lev.A.uses_bdia], device_name, 11)
    k2_rows = ell_timings(ell_ops(pre, "gate-3"), device_name, 25)
    copy_rows = ell_copy_timings([("gate-3 level 1", pre.levels[1].A)]
                                 if pre.levels[1].A.uses_bdia else [],
                                 device_name, 26)
    prof = solve_profile(system, "gate-3")
    system.destroy_system()
    return dict(launches=launches, k6_rows=rows, k4_rows=bdia_rows,
                k2_rows=k2_rows, copy_rows=copy_rows, timers=timers,
                profile=prof, iters=int(res.iters))


def gate3_rs_phase(side: int, counters) -> dict:
    """Gate 3 with ``coarsen_type: 6`` (Falgout, run as serial RS by the
    native kernel): the same fixture through the CLI, every layout of the
    hierarchy launched, and at 64^3 tpusolve's iteration count."""
    rc, system, wall, launches = run_gate3(
        side, counters, "gate-3 RS",
        lambda t: t.replace("coarsen_type: 8", "coarsen_type: 6"))
    print(f"gate-3 RS path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-3 RS")
    pre = system._precond
    if not any("serial RS" in n for n in pre.notes):
        fail("gate-3 RS: the hierarchy was not coarsened by serial RS")
    for line in pre.describe().splitlines()[1:] + pre.layouts():
        print(f"gate-3 RS {line}", flush=True)
    timers = print_timers(system, "gate-3 RS")
    check_launched(pre, launches, "gate-3 RS")
    print(f"gate-3 RS {side}^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; Preconditioner "
          f"setup {timers['Preconditioner setup']:.3f} s; tpusolve (CPU, "
          f"same fixture and settings) {TPUSOLVE_GATE3_RS_ITERS_64} at 64^3",
          flush=True)
    if side == 64 and res.iters != TPUSOLVE_GATE3_RS_ITERS_64:
        fail(f"gate-3 RS took {res.iters} GMRES iterations, tpusolve "
             f"{TPUSOLVE_GATE3_RS_ITERS_64}")
    out = dict(launches=launches, timers=timers, iters=int(res.iters),
               relres=float(res.relres), levels=[lev.n for lev in pre.levels],
               layouts=pre.layouts())
    system.destroy_system()
    return out


def dia_check(ops, seed: int) -> tuple:
    """K1 against its plain version on each (name, DIA operator) of ``ops``
    in the operator's dtype and cast to the other one.  Returns (largest
    relative error, largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain

    rng = np.random.default_rng(seed)
    worst = worst_abs = 0.0
    for name, M in ops:
        if not M.uses_dia or M.device.type != "cuda":
            fail(f"operator {name} is not box DIA on the card ({M.layout})")
        for dt in (np.float32, np.float64):
            Mc = M.astype(dt)
            x = torch.tensor(rng.standard_normal(Mc.col_pad), dtype=Mc.dtype,
                             device=Mc.device)
            y = dia_spmv(Mc.dia_vals, Mc.dia_offsets, x)
            y_p = dia_spmv_plain(Mc.dia_vals, Mc.dia_offsets, x)
            err = rel_err(y, y_p)
            key = np.dtype(dt).name
            if not err <= RTOL[key]:
                fail(f"{name} {key}: K1 vs plain rel err {err:.3e} > "
                     f"{RTOL[key]}")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((y - y_p).abs().max()))
    return worst, worst_abs


def four_wide_check(device) -> float:
    """K1 on the 4^3 coarse level of the structured hierarchy at 16^3 (125
    planes; tpusolve's flat offsets collide there) against the exact CSR
    product of its DIA dict, in both dtypes.  Returns the largest relative
    error."""
    import numpy as np
    import torch
    from tpusolve_torch.amg import structured
    from tpusolve_torch.amg.dia_rap import dia_rap
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.stencil import laplace27_host_parts

    dia, box = laplace27_host_parts(1, 16, 16, 16)[0], (16, 16, 16)
    for _ in range(2):
        dia, box = dia_rap(dia, box)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    H = structured._structured_to_csr(dia, box, [empty], 1)
    x = np.random.default_rng(13).standard_normal(H.shape[0])
    y_ref = H @ x
    worst = 0.0
    for dt in (np.float32, np.float64):
        M = structured._dia_matrix(dia, [empty], box, 1, device, dt)
        y = dia_spmv(M.dia_vals, M.dia_offsets, torch.tensor(
            x, dtype=M.dtype, device=device)).double().cpu().numpy()
        err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        key = np.dtype(dt).name
        limit = 1e-14 if dt == np.float64 else RTOL[key]
        print(f"K1 4-wide box {box} D={len(M.dia_offsets)} {key}: against "
              f"the exact CSR product rel err {err:.3e} (limit {limit:.0e})",
              flush=True)
        if not err <= limit:
            fail(f"K1 on the 4-wide box {key} out of tolerance")
        worst = max(worst, err)
    return worst


def spmv_timings(ops, device_name: str, seed: int, key: str, kernel, plain,
                 layout) -> list:
    """At each (name, operator) of ``ops``: the kernel ``kernel(M, x)``
    (``key`` names it: ``"k1"``, ``"k6"``) against its plain version
    ``plain(M, x)``, its device and per-call time, the plain version's, the
    library's CSR SpMV and the bound (:func:`spmv_nbytes` over the card's
    HBM rate), beside the bytes the layout stores (the tensors
    ``layout(M)``).  Returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.calibrate import time_ms

    rng = np.random.default_rng(seed)
    rows = []
    for name, M in ops:
        dt = str(M.dtype).replace("torch.", "")
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        y = kernel(M, x)
        y_p = plain(M, x)
        err = rel_err(y, y_p)
        if not err <= RTOL[dt]:
            fail(f"{name}: {key.upper()} vs plain rel err {err:.3e} > "
                 f"{RTOL[dt]}")
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        y_lib = lib_call()
        err_lib = rel_err(y_lib, y_p[:y_lib.numel()])
        calls = [("plain", lambda: plain(M, x)), (key, lambda: kernel(M, x)),
                 ("lib", lib_call)]
        runs = {k: [] for k, _ in calls}
        for k, call in calls + calls[::-1]:
            runs[k].append(time_ms(call))
        row = dict(op=name, dtype=dt, layout=M.layout, rows=M.shape[0],
                   nnz=M.nnz, rel_err=err,
                   max_abs_err=float((y - y_p).abs().max()),
                   lib_rel_err=err_lib,
                   bound_ms=bound_ms(spmv_nbytes(M), device_name),
                   layout_mb=nbytes_of(*layout(M)) / 1e6)
        dev = device_times(dict(calls))
        for k, ts in runs.items():
            row[k + "_ms"] = min(ts)
            row[k + "_runs"] = ts
            row[k + "_dev_ms"] = dev[k]
        print(f"{name} {dt} {M.layout} ({M.shape[0]} rows, {M.nnz} nnz): "
              f"{key.upper()} device {row[key + '_dev_ms']:.5f} ms, per call "
              f"{row[key + '_ms']:.5f} ms (runs {ts_str(row[key + '_runs'])})"
              f", rel err {err:.3e}; plain device {row['plain_dev_ms']:.5f} "
              f"ms, per call {row['plain_ms']:.5f} ms; library (torch.sparse "
              f"CSR) device {row['lib_dev_ms']:.5f} ms, per call "
              f"{row['lib_ms']:.5f} ms (rel err {err_lib:.1e}); bound "
              f"{row['bound_ms']:.5f} ms (nnz, x, y; the layout stores "
              f"{row['layout_mb']:.3f} MB)", flush=True)
        rows.append(row)
    return rows


def dia_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K1 on DIA operators."""
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain
    return spmv_timings(
        ops, device_name, seed, "k1",
        lambda M, x: dia_spmv(M.dia_vals, M.dia_offsets, x),
        lambda M, x: dia_spmv_plain(M.dia_vals, M.dia_offsets, x),
        lambda M: (M.dia_vals,))


def bell_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K6 on BELL operators."""
    from tpusolve_torch.kernels.bell import bell_spmv, bell_spmv_plain
    args = lambda M, x: (M.bell_vals, M.bell_ids, x, M.bell_nwin, M.row_pad)
    return spmv_timings(
        ops, device_name, seed, "k6",
        lambda M, x: bell_spmv(*args(M, x)),
        lambda M, x: bell_spmv_plain(*args(M, x)),
        lambda M: (M.bell_vals, M.bell_ids))


def ell_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K2 on padded-ELL operators."""
    from tpusolve_torch.kernels.ell import ell_spmv, ell_spmv_plain
    return spmv_timings(
        ops, device_name, seed, "k2",
        lambda M, x: ell_spmv(M.diag_vals[0], M.diag_cols[0], x),
        lambda M, x: ell_spmv_plain(M.diag_vals[0], M.diag_cols[0], x),
        lambda M: (M.diag_vals, M.diag_cols))


def ell_ops(pre, what: str) -> list:
    """(name, operator) of every padded-ELL operator of hierarchy ``pre``
    that its cycle applies: each level's A, P and R on that layout."""
    ops = []
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is not None and M.uses_ell:
                ops.append((f"{what} level {i} {key}", M))
    return ops


# K2 check shapes: (rows, x length, K); square and rectangular, K as on the
# BoomerAMG paths (1 and 8 as P, 40 as the weak-scaling level 1, 131 and
# 638 as gate 3's level-3 A and level-2 R)
K2_CHECKS = ((50_000, 50_000, 1), (200_000, 25_000, 8),
             (30_000, 30_000, 40), (3_000, 24_000, 131), (700, 6_000, 638))


def ell_check(device) -> tuple:
    """K2 against its plain version on random padded-ELL operators
    (``K2_CHECKS``, a quarter of each row's slots padded, the last rows all
    padding) in f32 and f64, at every threads-a-row count G, in the plain
    form and every update form, the accumulate form into ``c`` in place
    too; the same bits in two runs.  Returns (largest relative error,
    largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels import ell

    rng = np.random.default_rng(13)
    forms = (("Ax", {}), ("b-Ax", dict(b=1)), ("c+w*s*(b-Ax)",
             dict(b=1, s=1, c=1, w=0.8)), ("s*(b-Ax)", dict(b=1, s=1)),
             ("c-s*Ax", dict(s=1, c=1)), ("c+Ax", dict(c=1, w=-1.0)))
    worst = worst_abs = 0.0
    for rows, ncols, K in K2_CHECKS:
        cols = rng.integers(0, ncols, (rows, K))
        pad = rng.random((rows, K)) < 0.25
        pad[-max(1, rows // 64):] = True
        cols[pad] = 0
        vals = rng.standard_normal((rows, K))
        vals[pad] = 0
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            V = torch.tensor(vals, dtype=dtype, device=device)
            C = torch.tensor(cols, dtype=torch.int32, device=device)
            vec = lambda n: torch.tensor(rng.standard_normal(n), dtype=dtype,
                                         device=device)
            x, b, s, c = vec(ncols), vec(rows), vec(rows), vec(rows)
            errs = []
            for form, kw in forms:
                kw = {k: (v if k == "w" else dict(b=b, s=s, c=c)[k])
                      for k, v in kw.items()}
                ref = ell.ell_spmv_plain(V, C, x, **kw)
                for g in ell.GROUPS:
                    y = ell.ell_spmv(V, C, x, **kw, groups=g)
                    errs.append(rel_err(y, ref))
                    worst_abs = max(worst_abs, float((y - ref).abs().max()))
                    if not torch.equal(y, ell.ell_spmv(V, C, x, **kw,
                                                       groups=g)):
                        fail(f"K2 {form} G={g} gave other bits on a rerun")
                if "c" in kw:
                    out = c.clone()
                    ell.ell_spmv(V, C, x, **dict(kw, c=out), out=out)
                    errs.append(rel_err(out, ref))
            torch.cuda.synchronize()
            err = max(errs)
            print(f"K2 check rows={rows} x={ncols} K={K} {dt}: every G "
                  f"{ell.GROUPS} and form ({len(forms)}, in place into c "
                  f"too) against the plain version: max rel err {err:.3e} "
                  f"(limit {RTOL[dt]:.0e}); plan G={ell.k2_plan(rows, K)}",
                  flush=True)
            if not err <= RTOL[dt]:
                fail(f"K2 check rows={rows} K={K} {dt} out of tolerance")
            worst = max(worst, err)
    return worst, worst_abs


def ell_copy_timings(ops, device_name: str, seed: int) -> list:
    """At each (name, BDIA operator) of ``ops``: K2 on a padded-ELL copy of
    the operator beside K4 on its BDIA layout and the library's CSR SpMV,
    device and per-call times, against the same bound.  Data for the
    layout choice at low slot fill; the layouts the solves use stay as
    they are.  Returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.kernels.ell import ell_spmv
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv
    from tpusolve_torch.matrix.vectors import numpy_dtype

    rng = np.random.default_rng(seed)
    rows = []
    for name, M in ops:
        dt = str(M.dtype).replace("torch.", "")
        Me = ShardedMatrix.from_csr_host(
            M.to_scipy(), device=M.device, dtype=numpy_dtype(M.dtype),
            allow_dia=False, allow_bdia=False, allow_bell=False)
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        k2 = lambda: ell_spmv(Me.diag_vals[0], Me.diag_cols[0], x)
        k4 = lambda: spmv(M, x)
        err = rel_err(k2(), k4())
        if not err <= RTOL[dt]:
            fail(f"{name}: K2 on the ELL copy vs K4 rel err {err:.3e}")
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        calls = [("k2", k2), ("k4", k4), ("lib", lib_call)]
        runs = {k: [] for k, _ in calls}
        for k, call in calls + calls[::-1]:
            runs[k].append(time_ms(call))
        dev = device_times(dict(calls))
        K = Me.diag_vals.shape[-1]
        row = dict(op=name, dtype=dt, layout=M.layout, ell_k=K,
                   rows=M.shape[0], nnz=M.nnz, rel_err=err,
                   bound_ms=bound_ms(spmv_nbytes(M), device_name),
                   ell_mb=nbytes_of(Me.diag_vals, Me.diag_cols) / 1e6,
                   bdia_mb=nbytes_of(M.bdia_vals, M.bdia_starts) / 1e6)
        for k, ts in runs.items():
            row[k + "_ms"], row[k + "_runs"] = min(ts), ts
            row[k + "_dev_ms"] = dev[k]
        print(f"{name} {dt} ({M.shape[0]} rows, {M.nnz} nnz) as ELL K={K} "
              f"({row['ell_mb']:.3f} MB): K2 device {row['k2_dev_ms']:.5f} "
              f"ms, per call {row['k2_ms']:.5f} ms; K4 on {M.layout} "
              f"({row['bdia_mb']:.3f} MB) device {row['k4_dev_ms']:.5f} ms, "
              f"per call {row['k4_ms']:.5f} ms; library (torch.sparse CSR) "
              f"device {row['lib_dev_ms']:.5f} ms, per call "
              f"{row['lib_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms; K2 "
              f"vs K4 rel err {err:.1e}", flush=True)
        rows.append(row)
    return rows


# K1's update forms in the V-cycle: (keyword arguments, weight); the
# Jacobi form updates the x it multiplies, as the smoother does
K1_FORMS = (("residual b - A x", ("b",), 1.0),
            ("Jacobi x + w s (b - A x)", ("b", "s", "x"), 0.9),
            ("Chebyshev s (b - A x)", ("b", "s"), 1.0),
            ("Chebyshev r - s A d", ("s", "c"), 1.0))


def dia_mode_check(ops, seed: int) -> tuple:
    """K1 against its plain version on each (name, DIA operator) of ``ops``
    in f32 and f64, in the plain form and in each update form of
    ``K1_FORMS``, and each launch's output the same bits in a second run.
    Returns (largest relative error, largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain

    rng = np.random.default_rng(seed)
    worst = worst_abs = 0.0
    for name, M in ops:
        for dt in (np.float32, np.float64):
            Mc = M.astype(dt)
            vec = {k: torch.tensor(rng.standard_normal(Mc.col_pad),
                                   dtype=Mc.dtype, device=Mc.device)
                   for k in ("x", "b", "s", "c")}
            key = np.dtype(dt).name
            for form, names, w in (("A x", (), 1.0),) + K1_FORMS:
                kw = {("c" if k == "x" else k): vec[k] for k in names}
                args = (Mc.dia_vals, Mc.dia_offsets, vec["x"])
                y = dia_spmv(*args, w=w, **kw)
                again = dia_spmv(*args, w=w, **kw)
                y_p = dia_spmv_plain(*args, w=w, **kw)
                err = rel_err(y, y_p)
                if not err <= RTOL[key] or not torch.equal(y, again):
                    fail(f"{name} {key} K1 {form}: rel err {err:.3e} > "
                         f"{RTOL[key]} or not the same bits twice")
                worst = max(worst, err)
                worst_abs = max(worst_abs, float((y - y_p).abs().max()))
    return worst, worst_abs


def cold_warm(name: str, M, device_name: str) -> dict:
    """K1's device time on operator ``M`` warm (the loop keeps its planes
    in the 50 MB L2 where they fit), cold (256 MB written between calls
    flushes the L2, as the solve's larger level evicts it) and warm but
    spaced (a kernel that spins about as long as the flush, touching no
    memory, between calls), in one call."""
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv
    x = torch.randn(M.col_pad, dtype=M.dtype, device=M.device)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=M.device)
    call = lambda: dia_spmv(M.dia_vals, M.dia_offsets, x)
    out = device_times({
        "warm_ms": call, "cold_ms": lambda: (flush.zero_(), call()),
        "spaced_ms": lambda: (torch.cuda._sleep(200_000), call())},
        only="dia_spmv")
    out.update(op=name, bound_ms=bound_ms(spmv_nbytes(M), device_name))
    print(f"{name} K1 device warm {out['warm_ms']:.5f} ms, cold (L2 flushed "
          f"before each call) {out['cold_ms']:.5f} ms, warm and spaced (a "
          f"spin kernel between calls) {out['spaced_ms']:.5f} ms; bound "
          f"{out['bound_ms']:.5f} ms", flush=True)
    return out


# K3's library yardsticks: one PyTorch call each that computes the same
# function (the port calls neither)
LIBRARY = {"prolong": "torch.nn.functional.interpolate (trilinear; P xc "
                      "alone)",
           "restrict": "torch.ops.aten.upsample_trilinear3d_backward"}


def transfer_check(pre, what: str, device_name: str, seed: int) -> list:
    """K3 on every transition of the structured hierarchy ``pre``: the
    prolongation with its add and the restriction against their plain
    versions in f32 and f64 (relative error under RTOL; whether equal bit
    for bit), the adjoint identity <P u, v> = <u, P^T v> on the card in f64,
    the library's prolongation (``interpolate``, trilinear,
    ``align_corners=False``) and restriction (that interpolation's
    backward, ``upsample_trilinear3d_backward``: its adjoint) against the
    plain ones, and in the level's dtype each kernel's device and per-call
    time beside the plain version's, the library's and the bound (the
    coarse vector read, the fine one read and written, or the fine read and
    the coarse written, over the card's HBM rate).  Returns one row per
    (transition, kernel)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_restrict, prolong_plain, restrict_plain)

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(len(pre.levels) - 1):
        fine = tuple(pre.levels[i].A.dia_shape)
        coarse = tuple(pre.levels[i + 1].A.dia_shape)
        nf, nc = int(np.prod(fine)), int(np.prod(coarse))
        dev = pre.levels[i].A.device
        name = (f"{what} transfer {i}->{i + 1} ({'x'.join(map(str, fine))}"
                f" <-> {'x'.join(map(str, coarse))})")

        def vec(n, dt):
            return torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)
        errs = {"prolong": [], "restrict": []}
        for dt in (torch.float32, torch.float64):
            xc, rf, x = vec(nc, dt), vec(nf, dt), vec(nf, dt)
            key = str(dt).replace("torch.", "")
            for kind, y, y_p in (
                    ("prolong", box_prolong(fine, coarse, xc, x),
                     prolong_plain(fine, coarse, xc, x)),
                    ("restrict", box_restrict(fine, coarse, rf),
                     restrict_plain(fine, coarse, rf))):
                err = rel_err(y, y_p)
                if not err <= RTOL[key]:
                    fail(f"{name} {key}: K3 {kind} vs plain rel err "
                         f"{err:.3e} > {RTOL[key]}")
                errs[kind].append((err, float((y - y_p).abs().max()),
                                   bool(torch.equal(y, y_p))))
        u, v = vec(nc, torch.float64), vec(nf, torch.float64)
        lhs = float(torch.dot(box_prolong(fine, coarse, u), v))
        rhs = float(torch.dot(u, box_restrict(fine, coarse, v)))
        adj = abs(lhs - rhs) / abs(rhs)
        if not adj <= 1e-12:
            fail(f"{name}: <P u, v> - <u, P^T v> relative {adj:.3e}")
        dt = pre.levels[i].A.dtype
        xc, rf, x = vec(nc, dt), vec(nf, dt), vec(nf, dt)
        lib = lambda: F.interpolate(xc.reshape((1, 1) + coarse),
                                    scale_factor=2, mode="trilinear",
                                    align_corners=False)
        lib_t = lambda: torch.ops.aten.upsample_trilinear3d_backward(
            rf.reshape((1, 1) + fine), list(fine), [1, 1] + list(coarse),
            False, 2.0, 2.0, 2.0)
        err_lib = {"prolong": rel_err(lib().reshape(-1),
                                      prolong_plain(fine, coarse, xc)),
                   "restrict": rel_err(lib_t().reshape(-1),
                                       restrict_plain(fine, coarse, rf))}
        item = xc.element_size()
        calls = {"prolong": [
            ("plain", lambda: prolong_plain(fine, coarse, xc, x)),
            ("kernel", lambda: box_prolong(fine, coarse, xc, x, out=x)),
            ("lib", lib)],
            "restrict": [
            ("plain", lambda: restrict_plain(fine, coarse, rf)),
            ("kernel", lambda: box_restrict(fine, coarse, rf)),
            ("lib", lib_t)]}
        nbytes = {"prolong": (nc + 2 * nf) * item,
                  "restrict": (nf + nc) * item}
        dev = device_times({f"{kind} {k}": call
                              for kind, cl in calls.items() for k, call in cl})
        for kind, cl in calls.items():
            runs = {k: [] for k, _ in cl}
            for k, call in cl + cl[::-1]:
                runs[k].append(time_ms(call))
            row = dict(op=name, kernel=kind, dtype=str(dt).replace(
                "torch.", ""), fine=fine, coarse=coarse,
                rel_err=max(e[0] for e in errs[kind]),
                max_abs_err=max(e[1] for e in errs[kind]),
                equal_to_plain=all(e[2] for e in errs[kind]),
                adjoint_rel=adj, lib_rel_err=err_lib[kind],
                bound_ms=bound_ms(nbytes[kind], device_name))
            for k, ts in runs.items():
                row[k + "_ms"] = min(ts)
                row[k + "_runs"] = ts
                row[k + "_dev_ms"] = dev[f"{kind} {k}"]
            lib_note = (f"library ({LIBRARY[kind]}; rel err "
                        f"{err_lib[kind]:.1e}) device "
                        f"{row['lib_dev_ms']:.5f} ms, per call "
                        f"{row['lib_ms']:.5f} ms")
            print(f"{name} {row['dtype']} K3 {kind}: device "
                  f"{row['kernel_dev_ms']:.5f} ms, per call "
                  f"{row['kernel_ms']:.5f} ms (runs "
                  f"{ts_str(row['kernel_runs'])}); plain device "
                  f"{row['plain_dev_ms']:.5f} ms, per call "
                  f"{row['plain_ms']:.5f} ms; {lib_note}; bound "
                  f"{row['bound_ms']:.5f} ms; vs plain rel err "
                  f"{row['rel_err']:.3e} (f32 and f64), equal bit for bit: "
                  f"{row['equal_to_plain']}; adjoint rel {adj:.1e}",
                  flush=True)
            rows.append(row)
    return rows


def ts_str(ts) -> str:
    return ", ".join(f"{t:.5f}" for t in ts)


# kernel-name classes of the solve profile, first match wins
PROFILE_CLASSES = (("K4 and K5", ("bdia_spmv",)),
                   ("K1", ("dia_spmv",)),
                   ("K3", ("box_prolong", "box_restrict")),
                   ("K6", ("bell_spmv",)),
                   ("K2", ("ell_spmv",)),
                   ("ELL gathers", ("scatter_gather", "indexselect")),
                   ("coarse matmul", ("gemv", "gemm", "cublas", "sm90_")),
                   ("reductions", ("reduce",)),
                   ("copies and cat", ("copy", "cat", "memcpy", "memset")),
                   ("elementwise", ("elementwise",)))


def solve_profile(system, what: str) -> dict:
    """One warm solve of ``system`` (its solver as the run built it): the
    wall time (host clock, synchronised), then the same solve under
    ``torch.profiler``: its device operations (kernel launches, copies and
    sets) and their device time, in all and by kernel class, the device's
    idle share of the wall time, K1's and K2's launches by form in that
    solve, and the names of the kernels in the "ELL gathers" class."""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpusolve_torch.kernels import dia

    # an earlier package (profile_solves.py) counts no launches by form,
    # or has no K2
    forms = getattr(dia, "launches_by_mode", dict)
    try:
        k2 = importlib.import_module("tpusolve_torch.kernels.ell").ell_spmv
        k2_forms = lambda: dict(k2.launches_by_form)
    except ImportError:
        k2_forms = dict
    solver, b = system._solver, system.rhs[0]
    solver(b)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * min(walls)
    before, before2 = forms(), k2_forms()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver(b)
        torch.cuda.synchronize()
    k1_modes = {k: n - before.get(k, 0) for k, n in forms().items()
                if n > before.get(k, 0)}
    k2_modes = {k: n - before2.get(k, 0) for k, n in k2_forms().items()
                if n > before2.get(k, 0)}
    by_class, ops, by_name, gathers = {}, {}, {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        cls = next((c for c, keys in PROFILE_CLASSES
                    if any(k in low for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        ops[cls] = ops.get(cls, 0) + 1
        if cls == "ELL gathers":
            gathers[e.name] = gathers.get(e.name, 0) + 1
    busy_ms = sum(by_class.values()) / 1e3
    out = dict(wall_ms=wall_ms, walls_ms=[1e3 * w for w in walls],
               iters=int(res.iters), busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               device_ops=sum(ops.values()),
               by_class_ms={k: v / 1e3 for k, v in sorted(
                   by_class.items(), key=lambda kv: -kv[1])},
               ops_by_class=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
               k1_launches_by_form=k1_modes, k2_launches_by_form=k2_modes,
               gathers=gathers,
               top=[(n, us / 1e3) for n, us in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:8]])
    print(f"{what} warm solve: {out['iters']} iterations, wall "
          f"{wall_ms:.3f} ms (runs {ts_str(out['walls_ms'])}); device busy "
          f"{busy_ms:.3f} ms in the profiled solve, idle share "
          f"{out['idle_share']:.3f}; {out['device_ops']} device operations "
          f"(kernel launches, copies, sets); by class, ms (operations): "
          + ", ".join(f"{k} {v:.3f} ({ops[k]})"
                      for k, v in out["by_class_ms"].items())
          + f"; K1 launches by form {k1_modes}; K2 launches by form "
          f"{k2_modes}; gathers {gathers}; top kernels "
          + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in out["top"]),
          flush=True)
    return out


def structured_phase(what: str, yaml_name: str, tol: float, device_name,
                     counters, seed: int):
    """Gate 1 or 2 (``examples/<yaml_name>`` as it is) through the CLI;
    returns (launches, K1's launches by form, system, result, K1 check
    errors, K1 timing rows, K3 rows).  The system is left for the caller
    to destroy."""
    from tpusolve_torch.kernels.dia import dia_spmv, launches_by_mode
    from tpusolve_torch.kernels.transfer import box_prolong, box_restrict
    yaml_path = os.path.join(REPO, "examples", yaml_name)
    rc, system, wall, launches = run_cli(yaml_path, counters)
    by_form = launches_by_mode()
    print(f"{what} path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}; K1 by form {by_form}", flush=True)
    res = check_solve(system, rc, what, tol)
    pre = system._precond
    for line in pre.layouts():
        print(f"{what} {line}", flush=True)
    path = (dia_spmv, box_prolong, box_restrict)
    for fn in path:
        if launches[fn.__name__] <= 0:
            fail(f"the {what} path launched no {fn.__name__}")
    if launches[box_prolong.__name__] != launches[box_restrict.__name__]:
        fail(f"the {what} path restricted and prolonged unequally")
    other = {k: v for k, v in launches.items()
             if k not in {fn.__name__ for fn in path}}
    if any(other.values()):
        fail(f"the {what} path launched other SpMV kernels: {other}")
    ops = [(f"{what} level {i}", lev.A) for i, lev in enumerate(pre.levels)]
    if system.A_lo is not None:
        ops.append((f"{what} A", system.A))
    errs = dia_check(ops, seed)
    mode_errs = dia_mode_check(ops, seed + 2)
    errs = (max(errs[0], mode_errs[0]), max(errs[1], mode_errs[1]))
    rows = dia_timings(ops, device_name, seed + 1)
    k3_rows = transfer_check(pre, what, device_name, seed + 3)
    return launches, by_form, system, res, errs, rows, k3_rows


def gate1_phase(device_name, counters):
    launches, by_form, system, res, errs, rows, k3_rows = structured_phase(
        "gate-1", "gate1_64cube_pcg_amg.yaml", 1e-8, device_name, counters,
        14)
    passes = res.passes or []
    gap = res.iters - TPUSOLVE_GATE1_ITERS
    print(f"gate-1 64^3: {res.iters} PCG iterations over {len(passes)} "
          f"refinement passes {passes}, relres {float(res.relres):.3e}, "
          f"golden check PASSED; tpusolve (CPU, same YAML) "
          f"{TPUSOLVE_GATE1_ITERS}: gap {gap:+d}", flush=True)
    if not passes or abs(gap) > len(passes):
        fail(f"gate-1 took {res.iters} iterations, more than one per pass "
             f"from tpusolve's {TPUSOLVE_GATE1_ITERS}")
    cold = cold_warm("gate-1 level 1", system._precond.levels[1].A,
                     device_name)
    prof = solve_profile(system, "gate-1")
    system.destroy_system()
    return launches, by_form, errs, rows, k3_rows, prof, cold


def gate2_phase(device_name, counters):
    launches, by_form, system, res, errs, rows, k3_rows = structured_phase(
        "gate-2", "gate2_weakscale_gmres_cheby.yaml", 1e-6, device_name,
        counters, 16)
    print(f"gate-2 128^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; the port's count "
          f"{PORT_GATE2_ITERS}; tpusolve (CPU, same YAML, its f32 "
          f"projection stalls) {TPUSOLVE_GATE2_ITERS}", flush=True)
    if abs(res.iters - PORT_GATE2_ITERS) > 1:
        fail(f"gate-2 took {res.iters} iterations, not within one of the "
             f"port's {PORT_GATE2_ITERS}")
    prof = solve_profile(system, "gate-2")
    system.destroy_system()
    return launches, by_form, errs, rows, k3_rows, prof


def rel_sparse(M, M_ref) -> float:
    """max |M - M_ref| / max |M_ref| of two scipy matrices."""
    d = abs(M - M_ref)
    return (d.max() if d.nnz else 0.0) / max(abs(M_ref).max(), 1e-300)


def device_setup_check(device) -> list:
    """Level 0 of the 32^3 stencil in f64 set up on the card
    (``device_setup.device_level0``, the row floor forced) for interp types
    0 and 3, against the port's host pipeline on the same operator: the C/F
    split equal, P, R and the coarse A to 1e-12 relative.  Returns one row
    per interp type, with the seconds of each stage."""
    import numpy as np
    import torch
    from tpusolve_torch.amg import builder, device_setup
    from tpusolve_torch.config import BoomerAMGConfig
    from tpusolve_torch.stencil import laplace27

    A, _, _ = laplace27(32, 32, 32, device=device, dtype=np.float64)
    rows = []
    for itype in (0, 3):
        # CF order keeps the host pipeline's split on its level 0
        cfg = BoomerAMGConfig(max_coarse_size=64, interp_type=itype,
                              relax_order=1)
        if not device_setup.eligible(A, cfg, min_n=1):
            fail("device setup check: the 32^3 stencil is not eligible")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = device_setup.device_level0(A, cfg)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        pre_h = builder.boomeramg_setup(A, cfg, device_min_n=None)
        t_host = time.perf_counter() - t0
        lev0, lev1 = pre_h.levels[0], pre_h.levels[1]
        same_split = bool(torch.equal(res["Cmask"], lev0.cmask))
        errs = {key: rel_sparse(res[key].to_scipy(), M.to_scipy())
                for key, M in (("P", lev0.P), ("R", lev0.R),
                               ("Ac", lev1.A))}
        print(f"device setup 32^3 float64 interp_type {itype} on the card: "
              f"{res['nc']} C points, split equal to the host pipeline's: "
              f"{same_split}; rel err P {errs['P']:.2e}, R {errs['R']:.2e}, "
              f"coarse A {errs['Ac']:.2e} (limit 1e-12); {t_dev:.3f} s "
              "(stages: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     res["seconds"].items())
              + f"), host pipeline's whole setup {t_host:.3f} s", flush=True)
        if not same_split or not max(errs.values()) <= 1e-12:
            fail(f"device setup interp_type {itype} differs from the host "
                 "pipeline")
        rows.append(dict(interp_type=itype, nc=res["nc"],
                         same_split=same_split, stages=res["seconds"],
                         device_s=t_dev, host_pipeline_s=t_host, **errs))
    return rows


def weakscale_phase(device_name: str, counters):
    """``examples/weakscale_pcg_boomeramg_devsetup.yaml`` as it is through
    the CLI; returns a dict of its launches, setup seconds, K1, K6, K4 and
    K2 rows, K2 on ELL copies of its BDIA levels, warm-solve profile, timer
    rows and layouts."""
    yaml_path = os.path.join(REPO, "examples",
                             "weakscale_pcg_boomeramg_devsetup.yaml")
    rc, system, wall, launches = run_cli(yaml_path, counters)
    print(f"weakscale path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "weakscale", tol=1e-6)
    pre = system._precond
    note = next((n for n in pre.notes if n.startswith(DEVICE_NOTE)), None)
    if note is None:
        fail("weakscale: level 0 was not set up on the device")
    print(f"weakscale note: {note}", flush=True)
    for line in pre.describe().splitlines()[1:]:
        print(f"weakscale hierarchy {line}", flush=True)
    layouts = pre.layouts()
    for line in layouts:
        print(f"weakscale {line}", flush=True)
    stages = dict(pre.setup_seconds)
    print("weakscale setup seconds (the card's level-0 stages, then the "
          "host levels): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stages.items()),
          flush=True)
    timers = print_timers(system, "weakscale")
    setup = timers["Preconditioner setup"]
    print(f"weakscale Preconditioner setup {setup:.3f} s, of it the host "
          f"levels {stages.get('host levels', 0.0):.3f} s", flush=True)
    check_launched(pre, launches, "weakscale")
    ls = system.config.linear_system
    print(f"weakscale {ls.nx}x{ls.ny}x{ls.nz}: {res.iters} PCG iterations, "
          f"relres "
          f"{float(res.relres):.3e}, golden check PASSED; tpusolve (CPU, same "
          f"YAML) {TPUSOLVE_WEAKSCALE_ITERS}; kernel "
          f"launches: K1 {launches['dia_spmv']}, K2 {launches['ell_spmv']}"
          f", K4 {launches['bdia_spmv']}, K5 {launches['bdia_spmv_xl']}, K6 "
          f"{launches['bell_spmv']}", flush=True)
    if abs(res.iters - TPUSOLVE_WEAKSCALE_ITERS) > 1:
        fail(f"weakscale took {res.iters} PCG iterations, not within one of "
             f"tpusolve's {TPUSOLVE_WEAKSCALE_ITERS}")
    dia_ops = [(f"weakscale level {i}", lev.A)
               for i, lev in enumerate(pre.levels) if lev.A.uses_dia]
    errs = dia_check(dia_ops, 21)
    rows1 = dia_timings(dia_ops, device_name, 22)
    rows6 = bell_timings([(f"weakscale level {i}", lev.A)
                          for i, lev in enumerate(pre.levels)
                          if lev.A.uses_bell], device_name, 24)
    bdia_ops = [(f"weakscale level {i}", lev.A)
                for i, lev in enumerate(pre.levels) if lev.A.uses_bdia]
    rows4 = bdia_timings(bdia_ops, device_name, 23)
    rows2 = ell_timings(ell_ops(pre, "weakscale"), device_name, 27)
    copy_rows = ell_copy_timings(bdia_ops, device_name, 28)
    prof = solve_profile(system, "weakscale")
    system.destroy_system()
    return dict(launches=launches, stages=stages, k1_rows=rows1,
                k1_errs=errs, k6_rows=rows6, k4_rows=rows4, k2_rows=rows2,
                copy_rows=copy_rows, profile=prof, timers=timers,
                layouts=layouts, iters=int(res.iters),
                relres=float(res.relres))


def model_constants():
    """Measured layout-model constants beside the ones in the code."""
    from tpusolve_torch.kernels import calibrate
    from tpusolve_torch.matrix import sharded
    got = calibrate.measure(log=lambda s: print(f"calibrate {s}",
                                                flush=True))
    for k, by_size in got["rate"].items():
        for size, rate in sorted(by_size.items()):
            if k in sharded.SPMV_MODEL:
                code = sharded.SPMV_MODEL[k]
                print(f"layout model {k} f{8 * size}: rate "
                      f"{rate / 1e12:.3f} TB/s (code {code[0] / 1e12:.3f}), "
                      f"threads_full {got['threads_full'][k][size]:.0f} "
                      f"(code {code[1]})", flush=True)
            else:
                code = sharded.BAND_RATE[k.replace("_band", ""), size]
                print(f"band model {k} f{8 * size}: rate {rate / 1e12:.3f} "
                      f"TB/s (code {code / 1e12:.3f})", flush=True)
    return got


def k3_entry(name: str, kind: str, line: int, rows: list,
             launches: dict) -> dict:
    """The ``kernels`` line's entry of K3's ``kind`` kernel: its launches,
    errors and, at gate 1's first transition (64^3 <-> 32^3, f32), its
    times; every transition's row under ``shapes``."""
    rs = [r for r in rows if r["kernel"] == kind]
    hl = rs[0]
    return dict(name=name, route="cuda",
                source="tpusolve_torch/csrc/box_transfer.cu",
                replaces=f"tpusolve/amg/structured.py:{line}", **launches,
                max_abs_err=max(r["max_abs_err"] for r in rs),
                ms=hl["kernel_ms"], device_ms=hl["kernel_dev_ms"],
                plain_ms=hl["plain_ms"], plain_device_ms=hl["plain_dev_ms"],
                bound_ms=hl["bound_ms"], bound_by="bytes",
                library_ms=hl["lib_ms"], library_device_ms=hl["lib_dev_ms"],
                library=LIBRARY[kind],
                shape=hl["op"], max_rel_err=max(r["rel_err"] for r in rs),
                equal_to_plain=all(r["equal_to_plain"] for r in rs),
                shapes=rs)


def main(argv) -> int:
    t_start = time.perf_counter()
    sides = {"--side": 96, "--side3": 64}
    it = iter(argv)
    for a in it:
        if a not in sides:
            print("usage: python3 chip_smoke.py [--side N] [--side3 N]",
                  file=sys.stderr)
            return 1
        sides[a] = int(next(it, "0"))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tpusolve_torch")):
        print("chip_smoke: no tpusolve_torch package beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpusolve_torch.kernels import build

    card = card_line()
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(device)
    print(card, flush=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{device_name}", flush=True)
    import yaml
    print(f"PyYAML {yaml.__version__}", flush=True)

    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
    from tpusolve_torch.kernels.bell import bell_spmv
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv
    from tpusolve_torch.kernels.transfer import box_prolong, box_restrict
    worst4, worst5 = banded_check(device)
    worst4 = max(worst4, k4_launch_check(device))
    worst6 = bell_check(device)
    worst2 = ell_check(device)

    worst1 = four_wide_check(device)
    dev_rows = device_setup_check(device)

    counters = (bdia_spmv, bdia_spmv_xl, bell_spmv, dia_spmv, box_prolong,
                box_restrict, ell_spmv)
    l4, rows4 = gate4_phase(sides["--side"], device_name, counters)
    g3 = gate3_phase(sides["--side3"], device_name, counters)
    l3, rows3, bdia_rows3 = g3["launches"], g3["k6_rows"], g3["k4_rows"]
    if l3["bdia_spmv"] + l3["bdia_spmv_xl"] <= 0:
        fail("the gate-3 path launched no BDIA kernel")
    rs = gate3_rs_phase(sides["--side3"], counters)
    l1, forms1, errs1, rows1, k3_rows1, prof1, cold1 = gate1_phase(
        device_name, counters)
    l2, forms2, errs2, rows2, k3_rows2, prof2 = gate2_phase(device_name,
                                                            counters)
    ws = weakscale_phase(device_name, counters)
    model_constants()

    paths = {"gate4": l4, "gate3": l3, "gate3_rs": rs["launches"],
             "gate1": l1, "gate2": l2, "weakscale": ws["launches"]}
    rows1_all = rows1 + rows2 + ws["k1_rows"]
    rows4_all = rows4 + bdia_rows3 + ws["k4_rows"]
    rows6_all = rows3 + ws["k6_rows"]
    rows2_all = g3["k2_rows"] + ws["k2_rows"]

    def launches(name):
        return dict(launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()})

    # headline shapes: K4 on A_lo (or A), K5 on L, K6 on the largest BELL
    k4 = next(r for r in sorted(rows4, key=lambda r: r["op"] != "A_lo")
              if not r["layout"].startswith("BDIA-XL"))
    k5 = next(r for r in rows4 if r["op"] == "L")
    k6 = max(rows3, key=lambda r: r["G"] * r["K"])
    k1 = rows1[0]            # gate 1 level 0, the f32 stencil
    # K2's headline: the weak-scaling ELL operator with the largest bound
    k2 = max(ws["k2_rows"], key=lambda r: r["bound_ms"])
    kernels = [
        dict(name="dia_spmv", route="cuda",
             source="tpusolve_torch/csrc/dia_spmv.cu",
             replaces="tpusolve/matrix/spmv.py:79", **launches("dia_spmv"),
             max_abs_err=max([errs1[1], errs2[1], ws["k1_errs"][1]]
                             + [r["max_abs_err"] for r in rows1_all]),
             ms=k1["k1_ms"], device_ms=k1["k1_dev_ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by="bytes", library_ms=k1["lib_ms"],
             library_device_ms=k1["lib_dev_ms"], shape=k1["op"],
             max_rel_err=max([worst1, errs1[0], errs2[0], ws["k1_errs"][0]]
                             + [r["rel_err"] for r in rows1_all]),
             launches_by_form={"gate1": forms1, "gate2": forms2},
             shapes=rows1_all, cold_warm=cold1, gate1_profile=prof1,
             gate2_profile=prof2, weakscale_profile=ws["profile"]),
        k3_entry("box_prolong", "prolong", 122, k3_rows1 + k3_rows2,
                 launches("box_prolong")),
        k3_entry("box_restrict", "restrict", 129, k3_rows1 + k3_rows2,
                 launches("box_restrict")),
        dict(name="bdia_spmv", route="cuda",
             source="tpusolve_torch/csrc/bdia_spmv.cu",
             replaces="tpusolve/kernels/bdia.py:252", **launches("bdia_spmv"),
             max_abs_err=max(r["max_abs_err"] for r in rows4_all),
             ms=k4["k4_ms"], device_ms=k4["k4_dev_ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by="bytes", library_ms=k4["lib_ms"],
             library_device_ms=k4["lib_dev_ms"], shape=k4["op"],
             max_rel_err=max([worst4] + [r["rel_err"] for r in rows4_all]),
             shapes=rows4_all),
        dict(name="bdia_spmv_xl", route="cuda",
             source="tpusolve_torch/csrc/bdia_spmv_xl.cu",
             replaces="tpusolve/kernels/bdia.py:336",
             **launches("bdia_spmv_xl"),
             max_abs_err=max(r["xl_max_abs_err"] for r in rows4_all
                             if "xl_max_abs_err" in r),
             ms=k5["k5_ms"], device_ms=k5["k5_dev_ms"],
             plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
             bound_by="bytes", library_ms=k5["lib_ms"],
             library_device_ms=k5["lib_dev_ms"], shape=k5["op"],
             held_by="banded_check, k4_launch_check, bdia_timings",
             max_rel_err=max([worst5] + [r["xl_rel_err"] for r in rows4_all
                                         if "xl_rel_err" in r])),
        dict(name="bell_spmv", route="cuda",
             source="tpusolve_torch/csrc/bell_spmv.cu",
             replaces="tpusolve/kernels/bell.py:159", **launches("bell_spmv"),
             max_abs_err=max(r["max_abs_err"] for r in rows6_all),
             ms=k6["ms"], device_ms=k6["dev_ms"], plain_ms=k6["plain_ms"],
             bound_ms=k6["bound_ms"], bound_by="bytes",
             library_ms=k6["library_ms"],
             library_device_ms=k6["library_dev_ms"],
             shape=f"level {k6['level']}",
             max_rel_err=max([worst6] + [r["rel_err"] for r in rows6_all]),
             shapes=rows6_all),
        dict(name="ell_spmv", route="cuda",
             source="tpusolve_torch/csrc/ell_spmv.cu",
             replaces="tpusolve/matrix/spmv.py:74", **launches("ell_spmv"),
             max_abs_err=max([worst2[1]] + [r["max_abs_err"]
                                            for r in rows2_all]),
             ms=k2["k2_ms"], device_ms=k2["k2_dev_ms"],
             plain_ms=k2["plain_ms"], plain_device_ms=k2["plain_dev_ms"],
             bound_ms=k2["bound_ms"], bound_by="bytes",
             library_ms=k2["lib_ms"], library_device_ms=k2["lib_dev_ms"],
             shape=k2["op"],
             max_rel_err=max([worst2[0]] + [r["rel_err"] for r in rows2_all]),
             launches_by_form_warm_solve={
                 "gate3": g3["profile"]["k2_launches_by_form"],
                 "weakscale": ws["profile"]["k2_launches_by_form"]},
             shapes=rows2_all,
             ell_copies_of_bdia=g3["copy_rows"] + ws["copy_rows"],
             gate3_profile=g3["profile"],
             weakscale_profile=ws["profile"])]
    print(json.dumps(no_nan({"weakscale": {
        k: ws[k] for k in ("iters", "relres", "stages", "timers", "layouts",
                           "launches")}, "gate3": {
        k: g3[k] for k in ("iters", "timers", "launches")}, "gate3_rs": rs,
        "device_setup_32": dev_rows})), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(no_nan({"kernels": kernels})), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
