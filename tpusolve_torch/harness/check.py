"""Golden-solution checker.

Reference semantics (src/HypreSystem.cpp:771-845): element-wise comparison

    |x - xref| < max(rtol * max(|x|, |xref|), atol)

with up to 20 offenders printed and a global all-pass verdict.  Two
reference quirks are deliberately fixed (SURVEY.md "Known reference
quirks"): the verdict reduces the *actual* pass flag (the reference's
``MPI_Reduce`` has src/dst transposed, :827-832) and offenders print on the
root rather than rank 1 (:820).
"""

from __future__ import annotations

import numpy as np

MAX_OFFENDERS = 20


def check_solution(x: np.ndarray, xref: np.ndarray, rtol: float = 1.0e-6,
                   atol: float = 1.0e-8, verbose: bool = True,
                   row0: int = 0, verdict: bool = True):
    """Returns (passed: bool, num_bad: int).  ``row0``: the global row of
    ``x[0]`` (a rank's rows), for the offenders' lines; ``verdict=False``
    prints no verdict line (a rank's, which the caller reduces first)."""
    x = np.asarray(x)
    xref = np.asarray(xref)
    tol = np.maximum(rtol * np.maximum(np.abs(x), np.abs(xref)), atol)
    bad = np.abs(x - xref) >= tol
    nbad = int(bad.sum())
    if verbose and nbad:
        idx = np.flatnonzero(bad)[:MAX_OFFENDERS]
        for i in idx:
            print(f"  check failed at row {row0 + i}: x={x[i]:.16e} "
                  f"xref={xref[i]:.16e} |diff|={abs(x[i]-xref[i]):.3e}")
    passed = nbad == 0
    if verbose and verdict:
        print("Check solution: PASSED" if passed
              else f"Check solution: FAILED ({nbad} rows)")
    return passed, nbad
