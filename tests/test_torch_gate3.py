"""The gate-3 slice end to end: tpusolve_torch's CLI against tpusolve's.

The gate-3 pressure fixture at 32^3 (MatrixMarket files, RCM, GMRES(20)
with BoomerAMG: PMIS, extended+i, l1-Jacobi) through both CLIs on the CPU
in ``double``: the iteration counts are equal, the solutions agree to 1e-10
relative and the timer rows have the same names.  Also: the fixture writer
and the MatrixMarket reader and writers against tpusolve's.
"""

import io
import os
import sys

import numpy as np
import pytest

from tpusolve_torch import fixtures
from tpusolve_torch.formats import mmio
from test_torch_slice import _iters, _run_port, _run_tpusolve, _timer_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 32


@pytest.fixture(scope="module")
def gate3(tmp_path_factory):
    """Path of the 32^3 gate-3 YAML."""
    return fixtures.write_gate3(str(tmp_path_factory.mktemp("gate3")), SIDE)


def test_both_clis_agree_in_double(gate3, monkeypatch, capsys):
    rc_t, out_t, x_t, perm_t = _run_tpusolve(gate3, monkeypatch, capsys)
    rc, out, x, perm, res = _run_port(gate3, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert _iters(out) == _iters(out_t) == res.iters
    assert float(res.relres) <= 1e-8
    np.testing.assert_array_equal(perm, perm_t)
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())
    # the timer rows tpusolve prints, in its order, less its XLA compile row
    assert _timer_names(out) == [n for n in _timer_names(out_t)
                                 if not n.startswith("Compile")]
    table = out.split("AMG hierarchy:")[1].split("Solve 0:")[0]
    assert table.split("  AMG level 0")[0].strip() == \
        out_t.split("AMG hierarchy:")[1].split("Solve 0:")[0].strip()
    layouts = [ln for ln in out.splitlines() if ln.startswith("  AMG level")]
    # K2 priced beside K4 and K6: every level above the 1-D DIA coarsest
    # runs K2 (test_torch_amg.py holds the BELL level with K2 priced out)
    assert [ln.split()[4] for ln in layouts] == ["ELL", "ELL-RP", "ELL",
                                                 "DIA"]


def test_fixture_files_equal_gatefix(tmp_path):
    """The port's gate-3 writer writes tools/gatefix.py's files and YAML
    byte for byte."""
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import gatefix
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    ours = fixtures.write_pressure_mm(str(tmp_path / "ours"), 5, 6, 4)
    theirs = gatefix.write_pressure_mm(str(tmp_path / "theirs"), 5, 6, 4)
    assert ours[3] == theirs[3] == 120
    for a, b in zip(ours[:3], theirs[:3]):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    assert fixtures.GATE3_YAML == gatefix.GATE3_YAML
    path = fixtures.write_gate3(str(tmp_path / "g"), 3)
    with open(path) as fh:
        assert fh.read() == gatefix.GATE3_YAML.format(
            mat=str(tmp_path / "g" / "pressure.mm"),
            rhs=str(tmp_path / "g" / "pressure_rhs.mm"),
            sln=str(tmp_path / "g" / "pressure_sln.mm"))


MM_FILES = {
    "general real": ("%%MatrixMarket matrix coordinate real general\n"
                     "% comment\n3 3 4\n1 1 2.5\n2 1 -1\n3 3 4e-3\n1 3 7\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "3 3 3\n1 1 2\n2 1 -1\n3 2 0.5\n"),
    "skew": ("%%MatrixMarket matrix coordinate integer skew-symmetric\n"
             "3 3 2\n2 1 3\n3 1 -4\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "2 3 3\n1 1\n2 3\n1 2\n"),
    "complex hermitian": ("%%MatrixMarket matrix coordinate complex "
                          "hermitian\n2 2 2\n1 1 1 0\n2 1 0.5 -2\n"),
}


@pytest.mark.parametrize("name", sorted(MM_FILES))
def test_mmio_reads_what_tpusolve_reads(name, tmp_path):
    pytest.importorskip("jax")
    from tpusolve.formats import mmio as tp_mmio
    path = tmp_path / "m.mm"
    path.write_text(MM_FILES[name])
    ours = mmio.read_matrix(str(path))
    theirs = tp_mmio.read_matrix(str(path))
    assert ours[3] == theirs[3]
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a, b)
    assert vars(mmio.read_info(str(path))) == vars(
        tp_mmio.read_info(str(path)))
    if name == "complex hermitian":
        for a, b in zip(mmio.expand_complex_to_real(*ours),
                        tp_mmio.expand_complex_to_real(*theirs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vec", [np.array([1.5, -2.0, 3e-7]),
                                 np.array([1 + 2j, -0.5j])])
def test_mmio_vectors_and_writers_equal_tpusolve(vec, tmp_path):
    pytest.importorskip("jax")
    from tpusolve.formats import mmio as tp_mmio
    ours, theirs = io.StringIO(), io.StringIO()
    mmio.write_vector(ours, vec, comment="c")
    tp_mmio.write_vector(theirs, vec, comment="c")
    assert ours.getvalue() == theirs.getvalue()
    np.testing.assert_array_equal(
        mmio.read_vector(io.StringIO(ours.getvalue())),
        tp_mmio.read_vector(io.StringIO(theirs.getvalue())))
    rows, cols = np.array([0, 2, 1]), np.array([1, 0, 2])
    vals = np.resize(vec, 3)
    ours, theirs = io.StringIO(), io.StringIO()
    mmio.write_matrix(ours, rows, cols, vals, (3, 3), comment="a\nb")
    tp_mmio.write_matrix(theirs, rows, cols, vals, (3, 3), comment="a\nb")
    assert ours.getvalue() == theirs.getvalue()
    coord = ("%%MatrixMarket matrix coordinate real general\n4 1 2\n"
             "2 1 5\n4 1 -1\n")
    np.testing.assert_array_equal(mmio.read_vector(io.StringIO(coord)),
                                  tp_mmio.read_vector(io.StringIO(coord)))


def test_mmio_rejects_bad_files():
    with pytest.raises(mmio.MMError, match="banner"):
        mmio.read_info(io.StringIO("%%Matrix matrix coordinate real\n"))
    with pytest.raises(mmio.MMError, match="expected 2"):
        mmio.read_matrix(io.StringIO(
            "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n"))
    with pytest.raises(mmio.MMError, match="coordinate"):
        mmio.read_matrix(io.StringIO(
            "%%MatrixMarket matrix array real general\n2 1\n1\n2\n"))


def test_ilu_smoothers_equal_tpusolve_cli(gate3, tmp_path, monkeypatch,
                                          capsys):
    """ILU smoothers (``smooth_type: 9`` on the two finest levels) under
    GMRES on the 32^3 fixture: the port's count, relres and notes are
    tpusolve's and both pass the golden check."""
    text = open(gate3).read().replace(
        "relax_type: 18", "relax_type: 18\n  smooth_type: 9\n"
        "  smooth_num_levels: 2")
    path = tmp_path / "st9.yaml"
    path.write_text(text)
    rc_t, out_t, x_t, _ = _run_tpusolve(str(path), monkeypatch, capsys)
    rc, out, x, _, res = _run_port(str(path), capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    pick = lambda o: [ln for ln in o.splitlines()
                      if ln.startswith("Solve 0") or "smooth_type" in ln]
    assert pick(out) == pick(out_t) and len(pick(out)) == 2
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())


def test_unported_paths_raise(gate3, tmp_path, monkeypatch, capsys):
    """The bfloat16 smoother twin (here with AMG as the solver, which itself
    runs), refused before it was ported, runs: ``tpusolve``'s count and
    its check in ``double``.  RS coarsening runs
    (``test_torch_native_setup.py::test_gate3_rs_equals_tpusolve_cli``)
    and ILU smoothers too (:func:`test_ilu_smoothers_equal_tpusolve_cli`)."""
    text = open(gate3).read()
    for swap in ({"method: gmres": "method: boomeramg",
                  "max_levels: 20": "max_levels: 20\n"
                  "  smoother_dtype: bfloat16"},):
        path = tmp_path / "c.yaml"
        edited = text
        for old, new in swap.items():
            edited = edited.replace(old, new)
        path.write_text(edited)
        rc_t, out_t, _, _ = _run_tpusolve(str(path), monkeypatch, capsys)
        rc, out, _, _, res = _run_port(str(path), capsys)
        assert rc == rc_t == 0 and "PASSED" in out
        assert "bf16 twin" in out
        assert _iters(out) == _iters(out_t)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cli_on_cuda_runs_k6(cuda, tmp_path, monkeypatch):
    """Needs only the card: the 24^3 gate-3 run on CUDA passes and launches
    K6 on its BELL level, with K2 priced out of the layout choice
    (tests/test_torch_ell_rowptr.py runs it with K2 priced)."""
    from test_torch_sharded import k2_priced_out
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels.bell import bell_spmv
    k2_priced_out(monkeypatch)
    path = fixtures.write_gate3(str(tmp_path), 24)
    keep = []
    bell_spmv.launches = 0
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[0].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    assert bell_spmv.launches > 0
