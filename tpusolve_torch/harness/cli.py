"""Command-line entry point (the port of ``tpusolve/harness/cli.py``)::

    python -m tpusolve_torch INPUT.yaml [--device cuda|cpu] [--parts N]
    python -m torch.distributed.run --nproc-per-node R -m tpusolve_torch \
        INPUT.yaml --parts N [--dist-backend nccl|gloo] [--device cpu]

Mirrors the reference's main() (src/main.cpp:31-229): per test, construct ->
setup solver -> load -> solve -> check -> output -> timers, repeated
``num_tests`` times with deterministic seeding (src/main.cpp:169) and an
optional cross-test CSV profile (src/main.cpp:195-216),
``reuse_preconditioner`` across the tests and, with
``solver_settings: check_memory: true``, the device-memory probe after
loading and after solving.  The device defaults
to ``cuda`` and the run fails when CUDA is absent; ``--device cpu`` runs the
plain PyTorch versions of the kernels.  ``--parts N`` (default 1) splits the
rows over N parts stacked on the one device, ``tpusolve``'s mesh of N
devices (``LinearSystem``'s ``nparts``).

Launched as R processes (``torch.distributed.run`` sets ``WORLD_SIZE``),
the CLI joins them (``dist.init_distributed``, the reference's ``MPI_Init``,
src/main.cpp:33-35) on ``--dist-backend`` (``nccl`` by default on CUDA,
``gloo`` on the CPU; gloo also runs ranks that share one card) and each
rank holds N / R of the parts on its own device (``cuda:(LOCAL_RANK %
device_count)``): ``--parts`` must be a multiple of R.  Every rank runs the
lifecycle and prints its timers and its check, and, after each test, one
``tpusolve_torch rank r/R: {...}`` JSON line (:func:`rank_line`); the exit
code is that of the verdict over every rank.
"""

from __future__ import annotations

import sys
import time

import json

import numpy as np
import torch

from tpusolve_torch import dist

USAGE = ("ERROR!! Usage: python -m tpusolve_torch INPUT_FILE "
         "[--device cuda|cpu] [--parts N] [--dist-backend nccl|gloo]")


def _parse(argv):
    """(yaml path, device name, parts, backend or None) or None on a usage
    error; ``--parts`` must be a multiple of the processes started
    (``WORLD_SIZE``)."""
    args, opts = [], {"--device": "cuda", "--parts": "1",
                      "--dist-backend": None}
    it = iter(argv)
    for a in it:
        name, eq, val = a.partition("=")
        if name in opts:
            opts[name] = val if eq else next(it, None)
        else:
            args.append(a)
    device, parts = opts["--device"], opts["--parts"]
    backend = opts["--dist-backend"]
    if len(args) != 1 or device not in ("cuda", "cpu") \
            or not (parts or "").isdigit() or int(parts) < 1 \
            or int(parts) % dist.env_world() \
            or backend not in (None, "nccl", "gloo"):
        return None
    return args[0], device, int(parts), backend


def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``; raises for ``cuda`` without a
    usable CUDA device (there is no silent CPU fallback)."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: CUDA is not available "
                               "(run with --device cpu for the plain "
                               "PyTorch path)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def main(argv=None, *, keep: list | None = None) -> int:
    """Run the lifecycle for the YAML file in ``argv``; 0 when every golden
    check passed, 2 when one failed, 1 on a usage error.  With ``keep`` (a
    list), each test's LinearSystem is appended to it instead of being
    destroyed, for callers that inspect its operators afterwards; across
    ranks such a caller leaves the group itself (``dist.destroy``), after
    its last collective."""
    argv = sys.argv[1:] if argv is None else argv
    parsed = _parse(argv)
    if parsed is None:
        print(USAGE, file=sys.stderr)
        if dist.env_world() > 1:
            print(f"  --parts must be a multiple of the {dist.env_world()} "
                  "processes", file=sys.stderr)
        return 1
    path, device_name, nparts, backend = parsed

    from tpusolve_torch.config import load_config
    cfg = load_config(path)
    grp = dist.init_distributed(device_name, backend)
    try:
        return _lifecycle(cfg, grp, device_name, nparts, keep)
    finally:
        if keep is None:
            dist.destroy()


def _lifecycle(cfg, grp, device_name, nparts, keep) -> int:
    from tpusolve_torch.harness.memory import allocated_bytes, check_memory
    from tpusolve_torch.harness.system import LinearSystem
    from tpusolve_torch.timers import CsvProfile

    device = resolve_device(device_name) if grp is None else grp.device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    if grp is None:
        print(f"tpusolve_torch: 1 device(s): ['{device} ({name})']"
              + (f", {nparts} parts" if nparts > 1 else ""), flush=True)
    else:
        print(f"tpusolve_torch: {grp.world} device(s) across {grp.world} "
              f"processes, {nparts} parts ({nparts // grp.world} a rank): "
              f"rank {grp.rank} on ['{device} ({name})'], backend "
              f"{grp.backend}", flush=True)
    label = None if grp is None else f"rank {grp.rank}"

    # device-memory probe at lifecycle boundaries (ref checkMemory,
    # src/HypreSystem.cpp:638-671)
    probe_memory = bool(cfg.solver.extra.get("check_memory", False))
    num_tests = cfg.solver.num_tests
    profile = CsvProfile()
    ok = True
    # reuse_preconditioner (etc/hypre_app.yaml:21): one cache across the
    # test loop; the first test builds, later tests reuse the
    # preconditioner and solver
    reuse_cache = {} if cfg.solver.reuse_preconditioner else None
    t_start = time.perf_counter()
    for test in range(num_tests):
        if num_tests > 1:
            print(f"\n=== test {test + 1}/{num_tests} ===", flush=True)
        # deterministic per-test seeding (ref: src/main.cpp:169)
        np.random.seed(1234)
        torch.manual_seed(1234)
        sys_ = LinearSystem(cfg, device, nparts=nparts,
                            reuse_cache=reuse_cache)
        sys_.setup_precon_and_solver()
        sys_.load()
        if probe_memory:
            check_memory(device, label)
        memory = {"after load": allocated_bytes(device)}
        sys_.solve()
        if probe_memory:
            check_memory(device, label)
        memory["after solve"] = allocated_bytes(device)
        passed = sys_.check_solution()
        ok &= passed
        sys_.output_linear_system()
        sys_.summarize_timers()
        sys_.retrieve_timers(profile)
        if grp is not None:
            print(rank_line(sys_, grp, name, passed, memory), flush=True)
        if keep is not None:
            keep.append(sys_)
        else:
            sys_.destroy_system()

    total = time.perf_counter() - t_start
    print(f"\nTotal time: {total:.6f} s", flush=True)
    if cfg.solver.csv_profile_file:
        # rank 0 writes the file, rank r > 0 the file with ".rank<r>"
        csv = cfg.solver.csv_profile_file + (
            "" if dist.rank() == 0 else f".rank{dist.rank()}")
        profile.write(csv)
        print(f"Wrote CSV profile: {csv}")
    return 0 if ok else 2


def rank_line(system, grp, device_name: str, passed: bool,
              memory: dict | None = None) -> str:
    """A rank's one-line JSON summary of a test: its device, the backend,
    the rows, matrix entries and files it read, its operators' layouts,
    the launches of each kernel since the process started (K2's by storage
    form and on offd blocks apart), its timers (the stencil's build apart,
    where it was generated), the bytes of the box-DIA planes it holds, the
    bytes allocated on its device after loading and after solving
    (``memory``, ``harness/memory.py``; None on the CPU), each solve's count
    and passes, and the check (the verdict over every rank)."""
    from tpusolve_torch.kernels import transfer
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
    from tpusolve_torch.kernels.bell import bell_spmv
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv, pack_columns
    launches = {fn.__name__: fn.launches for fn in (
        dia_spmv, ell_spmv, bdia_spmv, bdia_spmv_xl, bell_spmv, pack_columns,
        transfer.box_prolong, transfer.box_restrict,
        transfer.box_restrict_residual, transfer.box_prolong_update)}
    for form in ("padded", "rowptr"):
        launches[f"ell_spmv {form}"] = ell_spmv.launches_by_layout.get(form,
                                                                       0)
    launches["ell_spmv offd"] = ell_spmv.launches_offd
    launches["ell_spmv ghost prolong"] = ell_spmv.launches_ghost_prolong
    A, res = system.A, system.solve_results
    return f"tpusolve_torch rank {grp.rank}/{grp.world}: " + json.dumps(dict(
        rank=grp.rank, world=grp.world, device=device_name,
        backend=grp.backend, parts=[A.part_lo, A.part_lo + A.nparts],
        rows=system.rows_read, entries=system.entries_read,
        files=system.files_read, layouts=layouts(system),
        launches=launches, timers=system.timers.as_dict(),
        stencil_build_s=system.timers.as_dict().get(
            "Build 27Pt Stencil HYPRE matrix"),
        planes_bytes=system.planes_bytes, memory=memory or {},
        iters=[int(r.iters) for r in res], passes=[r.passes for r in res],
        relres=[float(r.relres) for r in res],
        check="PASSED" if passed else "FAILED"))


def layouts(system) -> dict:
    """The layout of each operator of the run: A (and A_lo), ILU's L and U,
    each AMG level's A, P and R."""
    out = {"A": system.A.layout}
    if system.A_lo is not None:
        out["A_lo"] = system.A_lo.layout
    pre = system._precond
    if hasattr(pre, "L"):
        out.update(L=pre.L.layout, U=pre.U.layout)
    for i, lev in enumerate(getattr(pre, "levels", [])):
        out[f"level {i} A"] = lev.A.layout
        if lev.P is not None:
            out.update({f"level {i} P": lev.P.layout,
                        f"level {i} R": lev.R.layout})
    return out


if __name__ == "__main__":
    sys.exit(main())
