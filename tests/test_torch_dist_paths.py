"""The other paths of the port across 2 CPU ranks: ``tpusolve``'s own
two-process input, the block-Jacobi device ILU, the coupled solve, the paths
that raise (ROADMAP.md Queue 1 item 19's remainder), and the one-process run
unchanged.
"""

import functools
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402
from test_torch_dist_gates import (  # noqa: E402
    P8, none_yaml, one_process, run_ranks)

from tpusolve_torch import fixtures  # noqa: E402

ITEM = "ROADMAP.md Queue 1 item 19"

# tests/test_multiprocess.py:YAML, tpusolve's two-process input
TWO_PROCESS_YAML = """\
linear_system:
  type: matrix_market
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
solver_settings:
  method: gmres
  preconditioner: boomeramg
  tolerance: 1.0e-8
  max_iterations: 200
  kspace: 20
boomeramg_settings:
  coarsen_type: 8
  interp_type: 6
  strong_threshold: 0.25
  max_coarse_size: 64
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tpusolve_two_process_input(tmp_path):
    """``tpusolve``'s two-process YAML (the pressure system at 10^3,
    GMRES + BoomerAMG with a 64-row coarsest level) on 2 ranks x 4 parts:
    PASSED on both, the count ``tpusolve``'s on ``mesh8``."""
    m, r, s, _ = fixtures.write_pressure_mm(str(tmp_path), 10, 10, 10)
    y = tmp_path / "run.yaml"
    y.write_text(TWO_PROCESS_YAML.format(mat=m, rhs=r, sln=s))
    lines, outs = run_ranks(str(y), tmp_path)
    it_t, _, _, ok_t = one_process(str(y), False)
    assert ok_t
    for ln, out in zip(lines, outs):
        assert ln["check"] == "PASSED" and ln["iters"] == it_t
        assert "2 device(s) across 2 processes, 8 parts (4 a rank)" in out


COMPLEX_YAML = """\
linear_system:
  type: matrix_market
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
  complex_numbers: true
solver_settings:
  method: gmres
  preconditioner: none
  tolerance: 1.0e-10
  max_iterations: 300
  kspace: 30
"""


def test_complex_matrix_market_on_two_ranks(tmp_path):
    """A complex MatrixMarket system (its real form, 2n rows) on 2 ranks:
    each rank keeps its rows of the real form, the ranks' entries adding up
    to it; the one-process 8-part count, PASSED on both."""
    import numpy as np
    import scipy.sparse as sp
    from tpusolve_torch.formats import mmio
    rng = np.random.default_rng(9)
    n = 300
    A = sp.random(n, n, density=0.02, random_state=9, dtype=np.float64)
    A = (A + 1j * sp.random(n, n, density=0.02, random_state=10)
         + sp.eye(n) * 4).tocoo()
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    paths = [str(tmp_path / f) for f in ("a.mm", "b.mm", "x.mm")]
    mmio.write_matrix(paths[0], A.row, A.col, A.data, (n, n))
    mmio.write_vector(paths[1], A @ x)
    mmio.write_vector(paths[2], x)
    y = tmp_path / "complex.yaml"
    y.write_text(COMPLEX_YAML.format(mat=paths[0], rhs=paths[1],
                                     sln=paths[2]))
    lines, _ = run_ranks(str(y), tmp_path)
    it1, _, _, ok1 = one_process(str(y), True)
    assert ok1
    real = 4 * A.nnz                    # the real form's entries
    assert sum(ln["entries"] for ln in lines) == real
    for r, ln in enumerate(lines):
        assert ln["check"] == "PASSED" and ln["iters"] == it1
        assert ln["rows"] == [r * n, (r + 1) * n - 1]
        assert 0 < ln["entries"] < real


def test_block_jacobi_device_ilu_on_two_ranks(tmp_path, monkeypatch):
    """Gate 4 in ``mixed`` from 2 files as scrambled, with the device ILU
    floor at one row: each rank factors its own parts' diag blocks
    (block-Jacobi, the notes of the one-process 8-part run, factors
    without offd blocks), the count within one a refinement pass of that
    run's."""
    from tpusolve_torch.harness import system
    path = none_yaml(fixtures.write_gate4(str(tmp_path), 16, nfiles=2))
    lines, outs = run_ranks(path, tmp_path, ["--ilu-device"])
    monkeypatch.setattr(system, "ilu_setup", functools.partial(
        system.ilu_setup, device_min_n=1))
    it1, passes1, _, ok1 = one_process(path, True)
    assert ok1
    for ln, out in zip(lines, outs):
        assert "note: multi-part: block-Jacobi ILU" in out
        ilu = next(row for row in out.splitlines() if "ILU L:" in row)
        assert "; U: ELL" in ilu and "offd" not in ilu
        assert ln["check"] == "PASSED"
        assert abs(ln["iters"][0] - it1[0]) <= len(passes1[0]), (ln, it1)


def test_coupled_solve_on_two_ranks(tmp_path):
    """Gate 4's three components solved coupled (one solver call on the
    stacked right-hand sides, each halo exchange carrying the three
    columns) in ``double`` on 2 ranks: the one-process 8-part counts."""
    path = fixtures.write_gate4_3comp(str(tmp_path), 12, nfiles=2,
                                      linear_system={"segregated_solve":
                                                     False},
                                      solver_settings={"precision":
                                                       "double"})
    lines, _ = run_ranks(path, tmp_path)
    it1, _, _, ok1 = one_process(path, True)
    assert ok1 and len(it1) == 3
    for ln in lines:
        assert ln["check"] == "PASSED" and ln["iters"] == it1


@pytest.mark.parametrize("case", ["stencil", "device amg setup"])
def test_remainder_raises_on_two_ranks(tmp_path, case):
    """A path of item 19's remainder raises ``NotImplementedError`` naming
    it on every rank, and the run fails: BoomerAMG set up on the card over
    the 8 parts of the generated stencil (the lattice branch, the
    weak-scaling YAML at 32^3 a part, which each rank generates, then
    refused by the builder), and a device AMG setup of a file-loaded
    operator (both floors at one row)."""
    if case == "stencil":
        src = os.path.join(worker.ROOT, "examples",
                           "weakscale_pcg_boomeramg_devsetup.yaml")
        path = tmp_path / "weakscale.yaml"
        path.write_text(open(src).read().replace(": 128\n", ": 32\n"))
        extra = []
    else:
        path = fixtures.write_gate3(str(tmp_path), 12, solver_settings={
            "matrix_ordering": "none"})
        extra = ["--amg-device"]
    runs = worker.launch(["cli", *extra, "--", path, "--device", "cpu",
                          "--parts", P8], cwd=tmp_path)
    for rc, out in runs:
        assert rc != 0 and "NotImplementedError" in out and ITEM in out
        assert "the device AMG setup of level 0" in out


def test_one_process_run_unchanged(tmp_path, capsys):
    """``--parts 8`` in one process: gate 4 at 16^3 from 2 files takes
    its 21 iterations (9 + 12) with RCM applied, as before the ranks came,
    and joins no group."""
    from tpusolve_torch import dist
    from tpusolve_torch.harness import cli
    path = fixtures.write_gate4(str(tmp_path), 16, nfiles=2)
    keep = []
    assert cli.main([path, "--device", "cpu", "--parts", "8"],
                    keep=keep) == 0
    out = capsys.readouterr().out
    assert "rcm applied" in out and "tpusolve_torch rank" not in out
    res = keep[0].solve_results[0]
    assert int(res.iters) == 21 and res.passes == [9, 12]
    assert dist.group() is None and not keep[0].A.is_slice
