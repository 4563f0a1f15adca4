"""Command-line entry point (the port of ``tpusolve/harness/cli.py``)::

    python -m tpusolve_torch INPUT.yaml [--device cuda|cpu] [--parts N]

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
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

USAGE = ("ERROR!! Usage: python -m tpusolve_torch INPUT_FILE "
         "[--device cuda|cpu] [--parts N]")


def _parse(argv):
    """(yaml path, device name, parts) or None on a usage error."""
    args, opts = [], {"--device": "cuda", "--parts": "1"}
    it = iter(argv)
    for a in it:
        name, eq, val = a.partition("=")
        if name in opts:
            opts[name] = val if eq else next(it, None)
        else:
            args.append(a)
    device, parts = opts["--device"], opts["--parts"]
    if len(args) != 1 or device not in ("cuda", "cpu") \
            or not (parts or "").isdigit() or int(parts) < 1:
        return None
    return args[0], device, int(parts)


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
    destroyed, for callers that inspect its operators afterwards."""
    argv = sys.argv[1:] if argv is None else argv
    parsed = _parse(argv)
    if parsed is None:
        print(USAGE, file=sys.stderr)
        return 1
    path, device_name, nparts = parsed

    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.memory import check_memory
    from tpusolve_torch.harness.system import LinearSystem
    from tpusolve_torch.timers import CsvProfile

    cfg = load_config(path)
    device = resolve_device(device_name)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"tpusolve_torch: 1 device(s): ['{device} ({name})']"
          + (f", {nparts} parts" if nparts > 1 else ""), flush=True)

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
            check_memory(device)
        sys_.solve()
        if probe_memory:
            check_memory(device)
        ok &= sys_.check_solution()
        sys_.output_linear_system()
        sys_.summarize_timers()
        sys_.retrieve_timers(profile)
        if keep is not None:
            keep.append(sys_)
        else:
            sys_.destroy_system()

    total = time.perf_counter() - t_start
    print(f"\nTotal time: {total:.6f} s", flush=True)
    if cfg.solver.csv_profile_file:
        profile.write(cfg.solver.csv_profile_file)
        print(f"Wrote CSV profile: {cfg.solver.csv_profile_file}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
