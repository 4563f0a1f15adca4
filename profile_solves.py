#!/usr/bin/env python3
"""Warm-solve profiles and setup rows of the port's paths on one CUDA card.

    python3 profile_solves.py [ROOT] [--only NAME[,NAME...]]
    python3 profile_solves.py [ROOT] --only coupled,kcols

Runs ``examples/gate1_64cube_pcg_amg.yaml``,
``examples/gate2_weakscale_gmres_cheby.yaml``,
``examples/weakscale_pcg_boomeramg_devsetup.yaml`` as they are, the
gate-3 pressure fixture at 64^3 (``tools/gatefix.py:GATE3_YAML``, written
by the package's ``fixtures.write_gate3``) and the gate-4 momentum fixture
at 96^3 (``GATE4_YAML``, ``fixtures.write_gate4``; BiCGSTAB + ILU(0),
whose factors run K5 or K4) through the CLI of the
``tpusolve_torch`` package under ROOT (default: this script's directory),
fails unless each passes its golden check, prints its timer rows (the
setup's among them) and the weak-scaling setup's stages, and profiles one
warm solve of each as ``chip_smoke.py`` does (``chip_smoke.solve_profile``:
wall time, device operations and device time by kernel class, the device's
idle share).  ``--only`` runs just the named paths (``gate-1``,
``gate-2``, ``weakscale``, ``gate-3``, ``gate-4``, and two that run only
when named: ``coupled``, ``chip_smoke.py``'s (h), gate 4's three
components at 64^3 solved coupled, whose warm solve it profiles as
``chip_smoke.profile_call`` does (K2's and K5's device time in it), and
``kcols``, K2's and K5's k-column forms on gate 4's A, A_lo, L and U at
96^3, each column checked against the single kernel bit for bit and timed
at k = 3 as ``chip_smoke.columns_check`` does).  It uses nothing of that
package but its kernel build, its fixture writers, its CLI and, for
``kcols``, the operators and calls that package has had since its
k-column forms (``kernels/calibrate.py:_gate4_operator``,
``ilu/ilu.py:ilu_setup``, ``matrix/spmv.py``), so ROOT may be an earlier
checkout, unpacked with ``git archive`` into a directory ``.gitignore``
lists (``build/parent``), profiled in the same call as this one.  Prints
the profiles as one JSON line.  It holds no kernel against its plain
version but in ``kcols``, and prints no ``ok`` line: ``chip_smoke.py`` is
the smoke run.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, example YAML or fixture writer's name, tolerance, fixture side)
GATES = (("gate-1", "gate1_64cube_pcg_amg.yaml", 1e-8, None),
         ("gate-2", "gate2_weakscale_gmres_cheby.yaml", 1e-6, None),
         ("weakscale", "weakscale_pcg_boomeramg_devsetup.yaml", 1e-6, None),
         ("gate-3", "write_gate3", 1e-8, 64),
         ("gate-4", "write_gate4", 1e-8, 96))
# the paths run only when --only names them
EXTRA = ("coupled", "kcols")
COUPLED_SIDE = 64      # chip_smoke.py: COUPLED_SIDE
KCOLS_SIDE = 96
USAGE = "usage: python3 profile_solves.py [ROOT] [--only NAME[,NAME...]]"


def main(argv) -> int:
    names = [g[0] for g in GATES]
    only, rest = names, []
    it = iter(argv)
    for a in it:
        if a == "--only":
            only = next(it, "").split(",")
        else:
            rest.append(a)
    if len(rest) > 1 or not set(only) <= set(names) | set(EXTRA):
        print(USAGE, file=sys.stderr)
        return 1
    root = os.path.abspath(rest[0]) if rest else HERE
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
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels import build

    print(chip_smoke.card_line(), flush=True)
    print(f"package {os.path.dirname(cli.__file__)}; kernel build "
          f"{build.build_all():.3f} s", flush=True)
    out = {}
    work = os.path.join(HERE, "build", "profile_fixture")
    for what, name, tol, side in GATES:
        if what not in only:
            continue
        systems = []
        if side is not None:
            shutil.rmtree(work, ignore_errors=True)
            path = getattr(fixtures, name)(work, side)
        else:
            path = os.path.join(HERE, "examples", name)
        try:
            rc = cli.main([path, "--device", "cuda"], keep=systems)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        system = systems[0] if systems else None
        res = chip_smoke.check_solve(system, rc, what, tol)
        print(f"{what}: {res.iters} iterations, relres "
              f"{float(res.relres):.3e}, golden check PASSED", flush=True)
        timers = chip_smoke.print_timers(system, what)
        stages = dict(getattr(system._precond, "setup_seconds", None) or {})
        if stages:
            print(f"{what} setup stages (s): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
        out[what] = dict(chip_smoke.solve_profile(system, what),
                         timers=timers, setup_stages=stages)
        system.destroy_system()
    if "coupled" in only:
        out["coupled"] = coupled(chip_smoke, fixtures, cli, work)
    if "kcols" in only:
        out["kcols"] = kcols(chip_smoke)
    print(json.dumps({"profiles": out}, default=str), flush=True)
    return 0


def coupled(chip_smoke, fixtures, cli, work) -> dict:
    """(h): gate 4's three components at ``COUPLED_SIDE``^3, solved in one
    call (``segregated_solve: no``, RCM), the golden check on each, and
    the warm coupled solve's profile."""
    import torch
    shutil.rmtree(work, ignore_errors=True)
    try:
        base = fixtures.write_gate4_3comp(work, COUPLED_SIDE)
        with open(base) as fh:
            text = fixtures.with_settings(
                fh.read(), linear_system={"segregated_solve": False},
                solver_settings={"matrix_ordering": "rcm"})
        path = os.path.join(work, "coupled.yaml")
        with open(path, "w") as fh:
            fh.write(text)
        systems = []
        rc = cli.main([path, "--device", "cuda"], keep=systems)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    system = systems[0] if systems else None
    chip_smoke.check_components(system, rc, "coupled")
    counts = [int(r.iters) for r in system.solve_results]
    print(f"coupled gate-4 {COUPLED_SIDE}^3: counts {counts}", flush=True)
    rhs = torch.stack(system.rhs)
    out = dict(chip_smoke.profile_call(lambda: system._solver(rhs),
                                       "coupled warm solve"), iters=counts)
    system.destroy_system()
    return out


def kcols(chip_smoke) -> list:
    """K2's and K5's k-column forms on gate 4's A (f64), A_lo (f32), L and U
    (the f32 ILU(0) factors) at ``KCOLS_SIDE``^3, laid out as the package's
    model chooses: ``chip_smoke.columns_check`` with its timings."""
    import numpy as np
    import torch
    from tpusolve_torch.ilu.ilu import ilu_setup
    from tpusolve_torch.kernels.calibrate import _gate4_operator
    A, H = _gate4_operator(KCOLS_SIDE, torch.device("cuda", 0))
    A_lo = A.astype(np.float32)
    pre = ilu_setup(A_lo, A_host=H)
    ops = {"A": A, "A_lo": A_lo, "L": pre.L, "U": pre.U}
    print("kcols layouts: " + "; ".join(f"{k} {M.layout}"
                                        for k, M in ops.items()), flush=True)
    return chip_smoke.columns_check(ops, chip_smoke.card_line(), 15,
                                    timed=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
