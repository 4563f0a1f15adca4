"""The lifecycle's output, reuse and memory steps: tpusolve_torch's CLI
against tpusolve's (on one part) on the gate-3 fixture at 12^3 in double.

``write_outputs``, ``write_solution`` and ``write_amg_matrices``: the
matrix, right-hand side and level-0 files equal tpusolve's byte for byte,
with and without ``matrix_ordering: rcm``, the coarse levels' files line for
line with their values to 1e-12 and the solution's to 1e-10; the port's own reader reads the files back as the system (in the
original numbering).  ``num_tests: 2`` with ``reuse_preconditioner``: the
second test reuses the first's setup, as in tpusolve.  ``check_memory``:
on the CPU the probe prints that no statistics exist, as tpusolve's does;
on the card (a CUDA case, skipped without one) it prints the allocator's
and the CUDA runtime's figures.
"""

import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp

from tpusolve_torch import fixtures
from tpusolve_torch.formats import ij, mmio
from test_torch_gate1 import _run_tpusolve
from test_torch_slice import _run_port

SIDE = 12
WRITE = {"write_outputs": True, "write_solution": True,
         "write_amg_matrices": True}


def _written(d) -> dict:
    """{file name: bytes} of the IJ files a run wrote into ``d``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(d, "IJ*"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


@pytest.mark.parametrize("ordering", ["rcm", "none"])
def test_written_files_equal_tpusolve(tmp_path, monkeypatch, capsys,
                                      ordering):
    path = fixtures.write_gate3(
        str(tmp_path / "fix"), SIDE, linear_system=WRITE,
        solver_settings={"matrix_ordering": ordering})
    runs = {}
    for who, run in (("tpusolve", _run_tpusolve), ("port", _run_port)):
        d = tmp_path / who
        d.mkdir()
        monkeypatch.chdir(d)
        args = (path, monkeypatch, capsys) if who == "tpusolve" \
            else (path, capsys)
        rc, out = run(*args)[:2]
        assert rc == 0 and "Check solution: PASSED" in out, out[-800:]
        runs[who] = _written(d), out
    (mine, out), (theirs, out_t) = runs["port"], runs["tpusolve"]
    names = sorted(mine)
    assert names == sorted(theirs)
    assert {"IJM.mat.00000", "IJV0.rhs.00000", "IJV0.sln.00000",
            "IJM.mat_level_0.00000", "IJM.mat_level_1.00000"} <= set(names)
    for name in names:
        if ".sln" in name or "level_0" not in name and "level" in name:
            # the solution and the Galerkin coarse operators (their sums
            # ordered differently): the same lines, numbers to roundoff
            head, *body = mine[name].splitlines()
            head_t, *body_t = theirs[name].splitlines()
            assert head == head_t
            a, b = np.loadtxt(body, ndmin=2), np.loadtxt(body_t, ndmin=2)
            np.testing.assert_array_equal(a[:, :-1], b[:, :-1])
            tol = 1e-10 if ".sln" in name else 1e-12
            np.testing.assert_allclose(a[:, -1], b[:, -1], rtol=0,
                                       atol=tol * np.abs(b[:, -1]).max())
        else:
            assert mine[name] == theirs[name], name
    rows = lambda o: [ln.split()[0] for ln in o.splitlines()
                      if ln.startswith("    ") and ("Output system" in ln
                                                   or "Write AMG" in ln)]
    assert rows(out) == rows(out_t) == ["Write", "Output"]


def test_files_read_back_as_the_system(tmp_path, monkeypatch, capsys):
    """The port's IJ reader gives back the fixture's matrix and right-hand
    side, to the 16 digits written, and the solution, in the original
    numbering under RCM."""
    d = tmp_path / "fix"
    path = fixtures.write_gate3(str(d), SIDE, linear_system=WRITE)
    monkeypatch.chdir(tmp_path)
    rc, out, x, perm, res = _run_port(path, capsys)
    assert rc == 0 and perm is not None
    r, c, v, shape = mmio.read_matrix(str(d / "pressure.mm"))
    A = sp.csr_matrix((v, (r, c)), shape=shape)
    # the files hold 16 significant digits (``%.15e``)
    r2, c2, v2 = ij.read_matrix("IJM.mat", 1)
    B = sp.csr_matrix((v2, (r2, c2)), shape=shape)
    assert (B != 0).nnz == (A != 0).nnz
    assert abs(B - A).max() <= 1e-15 * abs(A).max()
    b = mmio.read_vector(str(d / "pressure_rhs.mm"))
    np.testing.assert_allclose(ij.read_dense_vector("IJV0.rhs", 1), b,
                               rtol=1e-15)
    xs = ij.read_dense_vector("IJV0.sln", 1)
    np.testing.assert_allclose(xs[perm], x, rtol=1e-14)
    assert np.abs(A @ xs - b).max() <= 1e-6 * np.abs(b).max()


def test_reuse_preconditioner(tmp_path, monkeypatch, capsys):
    """Two tests with ``reuse_preconditioner``: the second reuses the first
    test's setup (its setup row well under 1 % of the first's) and takes
    the same count, as tpusolve does."""
    path = fixtures.write_gate3(
        str(tmp_path), SIDE, solver_settings={"num_tests": 2,
                                              "reuse_preconditioner": True})
    from tpusolve_torch.harness import cli
    keep = []
    assert cli.main([path, "--device", "cpu"], keep=keep) == 0
    out = capsys.readouterr().out
    rc_t, out_t = _run_tpusolve(path, monkeypatch, capsys)[:2]
    assert rc_t == 0
    for o in (out, out_t):
        assert o.count("Reusing preconditioner/solver from previous test") \
            == 1
    first, second = (s.timers.as_dict()["Preconditioner setup"]
                     for s in keep)
    assert second < 0.01 * first
    assert keep[1]._precond is keep[0]._precond
    solves = lambda o: [ln for ln in o.splitlines()
                        if ln.startswith("Solve 0")]
    assert solves(out) == solves(out_t) and len(solves(out)) == 2


def test_check_memory_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``check_memory`` probes after loading and after solving; on the CPU
    it says no statistics exist, as tpusolve's probe does there."""
    from tpusolve_torch.harness.memory import memory_report
    path = fixtures.write_gate3(str(tmp_path), SIDE,
                                solver_settings={"check_memory": True})
    rc, out = _run_port(path, capsys)[:2]
    rc_t, out_t = _run_tpusolve(path, monkeypatch, capsys)[:2]
    assert rc == rc_t == 0
    assert out.count("Device memory:") == out_t.count("Device memory:") == 2
    assert out.count("cpu: memory stats unavailable") == 2
    assert out_t.count("memory stats unavailable") >= 2
    assert memory_report("cpu") == ("Device memory:\n"
                                    "  cpu: memory stats unavailable")


@pytest.mark.cuda
def test_check_memory_on_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe reads the card")
    from tpusolve_torch.harness.memory import memory_report
    x = torch.ones(1 << 20, device="cuda")
    rep = memory_report("cuda:0")
    assert "in_use=" in rep and "free=" in rep and "limit=" in rep
    del x
