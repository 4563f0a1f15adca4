"""The gate-4 slice end to end: tpusolve_torch's CLI against tpusolve's.

The gate-4 momentum fixture at 16^3 (IJ files, RCM, BiCGSTAB + ILU(0))
through both CLIs on the CPU.  In ``double`` the iteration counts are equal
and the solutions agree to 1e-10 relative; in ``mixed`` both pass the golden
check with total iterations within one per refinement pass.  Also: the
fixture writer, the config loader, the CUDA default, and that the port never
imports JAX.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from tpusolve_torch import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 16


@pytest.fixture(scope="module")
def gate4(tmp_path_factory):
    """Directory with the 16^3 gate-4 fixture and one YAML per precision."""
    d = tmp_path_factory.mktemp("gate4")
    m, r, s, _ = fixtures.write_momentum_ij(str(d), SIDE, SIDE, SIDE)
    paths = {}
    for prec in ("double", "mixed"):
        text = fixtures.GATE4_YAML.format(mat=m, rhs=r, sln=s, nfiles=2)
        p = d / f"gate4_{prec}.yaml"
        p.write_text(text.replace("precision: mixed", f"precision: {prec}"))
        paths[prec] = str(p)
    return paths


def _run_tpusolve(path, monkeypatch, capsys):
    """tpusolve's CLI; returns (exit code, output, solution, permutation)."""
    pytest.importorskip("jax")
    from tpusolve.harness import cli
    from tpusolve.harness.system import LinearSystem
    from tpusolve.matrix.vectors import from_device_vector
    seen = {}
    destroy = LinearSystem.destroy_system

    def keep_solution(self):
        seen["x"] = from_device_vector(self.sln[0], self.A.row_offsets,
                                       self.A.row_pad)
        seen["perm"] = self._perm
        destroy(self)

    monkeypatch.setattr(LinearSystem, "destroy_system", keep_solution)
    rc = cli.main([path])
    return rc, capsys.readouterr().out, seen["x"], seen["perm"]


def _run_port(path, capsys):
    from tpusolve_torch.harness import cli
    from tpusolve_torch.matrix.vectors import from_device_vector
    keep = []
    rc = cli.main([path, "--device", "cpu"], keep=keep)
    sys_ = keep[0]
    x = from_device_vector(sys_.sln[0], sys_.A.row_offsets, sys_.A.row_pad)
    return rc, capsys.readouterr().out, x, sys_._perm, sys_.solve_results[0]


def _iters(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("Solve 0:"))
    return int(line.split("iters=")[1].split()[0])


def test_double_equal_iterations_and_solution(gate4, monkeypatch, capsys):
    rc_t, out_t, x_t, perm_t = _run_tpusolve(gate4["double"], monkeypatch,
                                             capsys)
    rc, out, x, perm, res = _run_port(gate4["double"], capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out and "A: ELL" in out
    assert "Check solution: PASSED" in out_t
    assert _iters(out) == _iters(out_t)
    np.testing.assert_array_equal(perm, perm_t)
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())
    # the timer rows tpusolve prints, in its order (less its XLA compile
    # row: the port reports a measured "Kernel build" row on a card instead)
    assert _timer_names(out) == [n for n in _timer_names(out_t)
                                 if not n.startswith("Compile")]


def _timer_names(out):
    table = out.split("Timing summary:")[1].split("Total time:")[0]
    return [ln[4:44].strip() for ln in table.splitlines()[3:]
            if ln.startswith("    ") and "---" not in ln
            and not ln[4:].startswith("Total")]


def test_mixed_both_pass(gate4, monkeypatch, capsys):
    rc_t, out_t, _, _ = _run_tpusolve(gate4["mixed"], monkeypatch, capsys)
    rc, out, x, _, res = _run_port(gate4["mixed"], capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert float(res.relres) <= 1e-8 and res.passes
    assert abs(_iters(out) - _iters(out_t)) <= len(res.passes)
    assert np.isfinite(x).all() and x.shape == (SIDE ** 3,)


def test_cuda_default_without_cuda_exits_nonzero(gate4):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "tpusolve_torch",
                           gate4["mixed"]], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_card_or_package(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and in a directory that holds nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as src, \
                open(script, "w") as dst:
            dst.write(src.read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script],
                          cwd=os.path.dirname(script), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys, tpusolve_torch\n"
        "for m in pkgutil.walk_packages(tpusolve_torch.__path__, "
        "'tpusolve_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpusolve'))\n"
        "assert not bad, bad\n"
        "print('modules', len([m for m in sys.modules "
        "if m.startswith('tpusolve_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_fixture_files_equal_gatefix(tmp_path):
    """The port's fixture writer writes tools/gatefix.py's files byte for
    byte."""
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import gatefix
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    ours = fixtures.write_momentum_ij(str(tmp_path / "ours"), 5, 6, 4)
    theirs = gatefix.write_momentum_ij(str(tmp_path / "theirs"), 5, 6, 4)
    assert ours[3] == theirs[3]
    for a, b in zip(ours[:3], theirs[:3]):
        for part in range(2):
            with open(f"{a}.{part:05d}") as fa, open(f"{b}.{part:05d}") as fb:
                assert fa.read() == fb.read()


def _yaml_texts():
    texts = {os.path.basename(p): open(p).read()
             for p in sorted(glob.glob(os.path.join(REPO, "examples",
                                                    "*.yaml")))}
    fill = dict(mat="m.IJ", rhs="r.IJ", sln="s.IJ", nfiles=2, rhs0="r0",
                rhs1="r1", rhs2="r2", sln0="s0", sln1="s1", sln2="s2")
    texts["port GATE4_YAML"] = fixtures.GATE4_YAML.format(**fill)
    gatefix_src = open(os.path.join(REPO, "tools", "gatefix.py")).read()
    for name in ("GATE3_YAML", "GATE4_YAML", "GATE4_YAML_3COMP"):
        body = gatefix_src.split(f'{name} = """\\\n')[1].split('"""')[0]
        texts[f"gatefix {name}"] = body.format(**fill)
    return texts


@pytest.mark.parametrize("name", sorted(_yaml_texts()))
def test_config_reader_matches_pyyaml(name, tmp_path):
    """The port's load_config gives tpusolve's configuration, section by
    section, on every config of the repository."""
    pytest.importorskip("jax")
    import dataclasses
    from tpusolve import config as tp_config
    from tpusolve_torch import config
    path = tmp_path / "c.yaml"
    path.write_text(_yaml_texts()[name])
    ours, theirs = config.load_config(str(path)), tp_config.load_config(
        str(path))
    assert ours.raw == theirs.raw
    for section in ("linear_system", "solver", "boomeramg", "ilu"):
        assert dataclasses.asdict(getattr(ours, section)) == \
            dataclasses.asdict(getattr(theirs, section)), section


def test_config_extra_keys_and_components():
    from tpusolve_torch.config import parse_config
    cfg = parse_config({
        "linear_system": {"type": "hypre_ij", "rhs_file": "r", "odd": 1},
        "solver_settings": {"method": "bicg", "ilu_fill_level": 0,
                            "ilu_lower_jacobi_iters": 3}})
    assert cfg.linear_system.rhs_files == ["r"]
    assert cfg.linear_system.extra == {"odd": 1}
    assert cfg.ilu.ilu_lower_jacobi_iters == 3
    assert cfg.solver.extra == {"ilu_fill_level": 0,
                                "ilu_lower_jacobi_iters": 3}
    with pytest.raises(ValueError, match="rhs_file1"):
        parse_config({"linear_system": {"num_components": 2,
                                        "rhs_file0": "r0"}})


def test_natural_numbering_device_ilu_equals_tpusolve(tmp_path, monkeypatch,
                                                      capsys):
    """The gate-4 fixture at 24^3 as written (``matrix_ordering: none``) in
    double, tpusolve on one part: tpusolve stores it ELL, so both packages
    factor ILU(0) on the device by the ELL path (the row floor at 1 row),
    the factors ELL (K2 on the card); count and relres are tpusolve's."""
    import functools
    from test_torch_gate1 import _run_tpusolve as run_one_part
    from tpusolve_torch.harness import system
    monkeypatch.setenv("TPUSOLVE_ILU_DEVICE_MIN_N", "1")
    monkeypatch.setattr(system, "ilu_setup", functools.partial(
        system.ilu_setup, device_min_n=1))
    path = fixtures.write_gate4(str(tmp_path), 24, precision="double",
                                solver_settings={"matrix_ordering": "none"})
    rc_t, out_t, x_t = run_one_part(path, monkeypatch, capsys)
    rc, out, x, perm, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0 and perm is None, out[-800:]
    assert "Check solution: PASSED" in out and "A: ELL K=27" in out
    note = "note: ILU(0) setup on device (generic-ELL Chow-Patel, 5 sweeps"
    assert note in out and note in out_t
    solve = lambda o: [ln for ln in o.splitlines() if ln.startswith("Solve 0")]
    assert solve(out) == solve(out_t)
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())
