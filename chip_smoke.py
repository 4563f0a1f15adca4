#!/usr/bin/env python3
"""Smoke run of tpusolve_torch on one CUDA card.

    python3 chip_smoke.py [--side N]

From the root of a checkout, on a machine with one NVIDIA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

1. prints the card's name and power limit, and the PyYAML version;
2. builds every kernel of ``tpusolve_torch/csrc`` and prints the seconds;
3. holds the BDIA SpMV kernel, overflow list included, against its plain
   PyTorch version on a banded matrix, in float32 and float64;
4. writes the gate-4 momentum fixture at N^3 rows (default 96^3 = 884,736
   rows, 23.4M nonzeros) and runs it through the port's CLI
   (``tpusolve_torch.harness.cli.main``): HYPRE-IJ files, RCM, BDIA
   assembly in f64 with an f32 twin, Chow-Patel ILU(0), BiCGSTAB in f32
   inside f64 iterative refinement, golden check;
5. shows that run's kernel launches, then times the kernel and its plain
   version at the four operator shapes of that run (A, A_lo, L, U).

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before those lines, as does a machine without CUDA or a directory
without the ``tpusolve_torch`` package.
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
# iterations summed over the refinement passes
TPUSOLVE_ITERS_96 = 56


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


def time_ms(fn, reps: int = 50, warmup: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` calls between CUDA events.
    The warm-up calls also bring the card's clocks back up after host-only
    phases, during which it idles."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def banded_check(device) -> float:
    """K4 against its plain version on a banded matrix whose clipped
    boundary blocks spill to the overflow list; the whole SpMV against
    scipy.  Returns the largest relative error seen."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_plain
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
    worst = 0.0
    for dtype in (np.float32, np.float64):
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=device,
                                   dtype=dtype)
        if not A.uses_bdia or A.bdia_ovf_vals is None:
            fail(f"banded check: expected BDIA with overflow, got {A.layout}")
        x = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=device)
        args = (A.bdia_vals, A.bdia_starts, x, A.bdia_xpad, A.bdia_xlen,
                A.row_pad, A.bdia_ovf)
        err = rel_err(bdia_spmv(*args), bdia_spmv_plain(*args))
        y = spmv(A, x).double().cpu().numpy()
        y_ref = S.astype(dtype) @ x.cpu().numpy()
        err_sp = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        name = str(A.dtype).replace("torch.", "")
        print(f"K4 banded n={n} {name} {A.layout}: kernel vs plain "
              f"rel err {err:.3e} (limit {RTOL[name]:.0e}); SpMV vs scipy "
              f"{err_sp:.3e}", flush=True)
        if not err <= RTOL[name] or not err_sp <= 10 * RTOL[name]:
            fail(f"banded check {name} out of tolerance")
        worst = max(worst, err)
    return worst


def operator_timings(system, device_name: str):
    """Kernel against plain at the four operator shapes of the main path's
    run; returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_plain
    from tpusolve_torch.runtime import hbm_gbps

    pre = system._precond
    ops = (("A", system.A), ("A_lo", system.A_lo), ("L", pre.L),
           ("U", pre.U))
    peak = hbm_gbps(device_name)
    rng = np.random.default_rng(9)
    rows = []
    for name, M in ops:
        if not M.uses_bdia:
            fail(f"operator {name} is not BDIA ({M.layout})")
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        args = (M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.bdia_xlen,
                M.row_pad, M.bdia_ovf)
        err = rel_err(bdia_spmv(*args), bdia_spmv_plain(*args))
        abs_err = float((bdia_spmv(*args) - bdia_spmv_plain(*args))
                        .abs().max())
        dt = str(M.dtype).replace("torch.", "")
        if not err <= RTOL[dt]:
            fail(f"{name}: kernel vs plain rel err {err:.3e} > {RTOL[dt]}")
        # alternate plain, kernel, kernel, plain on the same card
        p1 = time_ms(lambda: bdia_spmv_plain(*args))
        k1 = time_ms(lambda: bdia_spmv(*args))
        k2 = time_ms(lambda: bdia_spmv(*args))
        p2 = time_ms(lambda: bdia_spmv_plain(*args))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        _, B, D, R = M.bdia_vals.shape
        # the matrix's bytes: slot values, then the overflow list's row
        # pointer, columns and values
        stream = sum(t.numel() * t.element_size()
                     for t in (M.bdia_vals,) + (M.bdia_ovf or ()))
        gbps = stream / (ms * 1e-3) / 1e9
        share = f"{gbps / peak:.3f}" if peak else "not known"
        print(f"K4 {name:5s} {dt} B={B} D={D} R={R}: kernel {ms:.4f} ms "
              f"(runs {k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
              f"(runs {p1:.4f}, {p2:.4f}); matrix stream {stream / 1e6:.1f} "
              f"MB -> {gbps:.1f} GB/s, share of HBM peak {share} "
              f"({M.layout}); rel err {err:.3e}", flush=True)
        rows.append(dict(op=name, dtype=dt, B=B, D=D, R=R, ms=ms,
                         plain_ms=plain_ms, max_abs_err=abs_err,
                         rel_err=err))
    return rows


def main(argv) -> int:
    side = 96
    if argv[:1] == ["--side"] and len(argv) == 2:
        side = int(argv[1])
    elif argv:
        print("usage: python3 chip_smoke.py [--side N]", file=sys.stderr)
        return 1
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
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels import build
    from tpusolve_torch.kernels.bdia import bdia_spmv

    card = card_line()
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(device)
    print(card, flush=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{device_name}", flush=True)
    import yaml
    print(f"PyYAML {yaml.__version__}", flush=True)

    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    worst = banded_check(device)

    work = os.path.join(REPO, "build", f"gate4_{side}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        yaml_path = fixtures.write_gate4(work, side)
        print(f"gate-4 fixture {side}^3 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        systems = []
        bdia_spmv.launches = 0
        t0 = time.perf_counter()
        rc = cli.main([yaml_path, "--device", "cuda"], keep=systems)
        wall = time.perf_counter() - t0
        launches = bdia_spmv.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"main path: cli exit {rc}, {wall:.1f} s wall, bdia_spmv "
          f"launches {launches}", flush=True)
    if rc != 0:
        fail(f"the gate-4 run failed (cli exit {rc})")
    if launches <= 0:
        fail("the main path launched no BDIA kernel")
    system = systems[0]
    res = system.solve_results[0]
    relres = float(res.relres)
    if not (relres <= 1e-8 and bool(res.converged)):
        fail(f"relres {relres:.3e} above 1e-8 or not converged")
    x = system.sln[0]
    if not bool(torch.isfinite(x).all()) or x.shape != (system.A.row_pad,):
        fail("solution is not finite or has the wrong shape")
    passes = res.passes or []
    print(f"gate-4 {side}^3: {res.iters} BiCGSTAB iterations over "
          f"{len(passes)} refinement passes {passes}, relres {relres:.3e}, "
          f"golden check PASSED", flush=True)
    if side == 96:
        gap = res.iters - TPUSOLVE_ITERS_96
        verdict = ("within one per pass" if abs(gap) <= len(passes)
                   else "MORE than one per pass")
        print(f"iterations: port {res.iters}, tpusolve (CPU, same fixture) "
              f"{TPUSOLVE_ITERS_96}: gap {gap:+d} over {len(passes)} passes, "
              f"{verdict}", flush=True)

    rows = operator_timings(system, device_name)
    lo = next(r for r in rows if r["op"] == "A_lo")
    kernels = [dict(
        name="bdia_spmv", route="cuda",
        source="tpusolve_torch/csrc/bdia_spmv.cu",
        replaces="tpusolve/kernels/bdia.py:252", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=lo["ms"], plain_ms=lo["plain_ms"],
        max_rel_err=max([worst] + [r["rel_err"] for r in rows]),
        shapes=rows)]
    system.destroy_system()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
