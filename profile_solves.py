#!/usr/bin/env python3
"""Warm-solve profiles of gates 1 and 2 on one CUDA card.

    python3 profile_solves.py [ROOT]

Runs ``examples/gate1_64cube_pcg_amg.yaml`` and
``examples/gate2_weakscale_gmres_cheby.yaml`` as they are through the CLI of
the ``tpusolve_torch`` package under ROOT (default: this script's
directory), fails unless each passes its golden check, and profiles one
warm solve of each as ``chip_smoke.py`` does (``chip_smoke.solve_profile``:
wall time, device operations and device time by kernel class, the device's
idle share).  It uses nothing of that package but its kernel build and its
CLI, so ROOT may be an earlier checkout, unpacked with ``git archive`` into
a directory ``.gitignore`` lists (``build/parent``), profiled in the same
call as this one.  Prints the profiles as one JSON line.  It holds no kernel
against its plain version and prints no ``ok`` line: ``chip_smoke.py`` is
the smoke run.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GATES = (("gate-1", "gate1_64cube_pcg_amg.yaml", 1e-8),
         ("gate-2", "gate2_weakscale_gmres_cheby.yaml", 1e-6))


def main(argv) -> int:
    if len(argv) > 1:
        print("usage: python3 profile_solves.py [ROOT]", file=sys.stderr)
        return 1
    root = os.path.abspath(argv[0]) if argv else HERE
    import torch
    if not torch.cuda.is_available():
        print("profile_solves: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(root, "tpusolve_torch")):
        print(f"profile_solves: no tpusolve_torch package under {root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke             # this checkout's, before ROOT's path
    sys.path.insert(0, root)
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels import build

    print(chip_smoke.card_line(), flush=True)
    print(f"package {os.path.dirname(cli.__file__)}; kernel build "
          f"{build.build_all():.3f} s", flush=True)
    out = {}
    for what, name, tol in GATES:
        systems = []
        rc = cli.main([os.path.join(HERE, "examples", name), "--device",
                       "cuda"], keep=systems)
        res = chip_smoke.check_solve(systems[0] if systems else None, rc,
                                     what, tol)
        print(f"{what}: {res.iters} iterations, relres "
              f"{float(res.relres):.3e}, golden check PASSED", flush=True)
        out[what] = chip_smoke.solve_profile(systems[0], what)
        systems[0].destroy_system()
    print(json.dumps({"profiles": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
