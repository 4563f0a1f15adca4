"""Gates 3 and 4 at 16^3 on 2 ranks x 4 parts against one process and
against ``tpusolve``.

Each case runs the port's CLI as two CPU processes joined on gloo
(``tests/torch_dist_worker.py:launch``) with ``--parts 8`` on the gate's
fixture YAML (``matrix_ordering: rcm``, which every rank skips with
``tpusolve``'s note, no rank holding the global pattern), and holds it to
the port's one-process 8-part run and to ``tpusolve`` on ``mesh8``, both on
the same YAML with ``matrix_ordering: none``: the golden check passes on
both ranks, the count is exact in ``double`` and within one a refinement
pass in ``mixed``, the solution (written by rank 0 through ``fetch_host``)
within ``TOL_X`` of both, and each rank parsed only its own part files.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

from tpusolve_torch import fixtures  # noqa: E402
from tpusolve_torch.formats import ij  # noqa: E402

CPU = torch.device("cpu")
P8 = 8
SIDE = 16
TOL_X = 1e-6      # solutions, relative to the largest entry
RCM_NOTE = ("note: matrix_ordering: rcm skipped (global pattern not local "
            "to this host)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rank_lines(runs) -> list:
    """Each rank's JSON summary line (``tpusolve_torch rank r/R: {...}``),
    after checking every rank exited 0."""
    out = []
    for r, (rc, text) in enumerate(runs):
        assert rc == 0, f"rank {r} exit {rc}:\n{text[-4000:]}"
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"tpusolve_torch rank {r}/"))
        out.append(json.loads(line.split(": ", 1)[1]))
    return out


def run_ranks(yaml_path: str, cwd, extra=()) -> tuple:
    """(rank summaries, outputs) of the CLI on 2 ranks x 4 parts."""
    runs = worker.launch(["cli", *extra, "--", yaml_path, "--device", "cpu",
                          "--parts", P8, "--dist-backend", "gloo"], cwd=cwd)
    return rank_lines(runs), [t for _, t in runs]


def one_process(path: str, port: bool):
    """(counts, passes, solutions, check) of one package's run on 8 parts
    (the port's stacked on the CPU, ``tpusolve``'s on ``mesh8``)."""
    if port:
        from tpusolve_torch.config import load_config
        from tpusolve_torch.harness.system import LinearSystem
        from tpusolve_torch.matrix.vectors import from_device_vector
        s = LinearSystem(load_config(path), CPU, nparts=P8, verbose=False)
    else:
        pytest.importorskip("jax")
        from tpusolve.config import load_config
        from tpusolve.harness.system import LinearSystem
        from tpusolve.matrix.vectors import from_device_vector
        from tpusolve.mesh import make_mesh
        s = LinearSystem(make_mesh(P8), load_config(path), verbose=False)
    s.setup_precon_and_solver()
    s.load()
    s.solve()
    ok = s.check_solution()
    res = s.solve_results
    passes = [None if getattr(r, "passes", None) is None
              else [int(p) for p in np.asarray(r.passes)] for r in res]
    xs = [np.asarray(from_device_vector(r.x, s.A.row_offsets, s.A.row_pad),
                     np.float64) for r in res]
    return [int(r.iters) for r in res], passes, xs, ok


def none_yaml(path: str) -> str:
    """The YAML ``path`` with ``matrix_ordering: none``."""
    text = open(path).read().replace("matrix_ordering: rcm",
                                     "matrix_ordering: none")
    out = path.replace(".yaml", "_none.yaml")
    with open(out, "w") as fh:
        fh.write(text)
    return out


def gate_yaml(d: str, gate: int, precision: str, nfiles: int) -> str:
    sol = {"linear_system": {"write_solution": True}}
    if gate == 3:
        return fixtures.write_gate3(d, SIDE, solver_settings={
            "precision": precision}, **sol)
    return fixtures.write_gate4(d, SIDE, nfiles=nfiles, precision=precision,
                                **sol)


@pytest.mark.parametrize("gate, precision, nfiles", [
    (3, "double", 1), (4, "double", 2), (4, "mixed", 2), (4, "double", 8),
    (4, "mixed", 8)])
def test_gate_on_two_ranks(tmp_path, gate, precision, nfiles):
    path = gate_yaml(str(tmp_path), gate, precision, nfiles)
    lines, outs = run_ranks(path, tmp_path)
    none = none_yaml(path)
    it1, passes1, xs1, ok1 = one_process(none, True)
    it_t, _, xs_t, ok_t = one_process(none, False)
    assert ok1 and ok_t
    n = xs1[0].size
    x = ij.read_dense_vector(str(tmp_path / "IJV0.sln"), P8, n)
    slack = 0 if precision == "double" else len(passes1[0] or [1])
    for r, (ln, out) in enumerate(zip(lines, outs)):
        assert RCM_NOTE in out and "Check solution: PASSED" in out
        assert ln["check"] == "PASSED" and ln["parts"] == [4 * r, 4 * r + 4]
        assert ln["backend"] == "gloo" and ln["world"] == 2
        assert abs(ln["iters"][0] - it1[0]) <= slack, (ln, it1, passes1)
        assert abs(ln["iters"][0] - it_t[0]) <= slack, (ln, it_t)
        # the rows it read, and (IJ) only its own part files
        lo, hi = ln["rows"]
        assert (lo, hi) == ((0, n // 2 - 1) if r == 0 else (n // 2, n - 1))
        if gate == 4:
            per = nfiles // 2
            own = range(r * per, (r + 1) * per)
            names = {os.path.basename(f) for f in ln["files"]}
            assert names == {f"{stem}.{p:05d}" for p in own for stem in (
                "momentum.IJ.mat", "momentum_rhs.IJ.vec",
                "momentum_sln.IJ.vec")}
    assert lines[0]["iters"] == lines[1]["iters"]
    assert lines[0]["relres"] == lines[1]["relres"]
    for ref in (xs1[0], xs_t[0]):
        assert np.abs(x - ref).max() <= TOL_X * np.abs(ref).max()
