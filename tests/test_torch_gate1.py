"""The structured main path end to end: tpusolve_torch's CLI against
tpusolve's, gates 1 and 2 at 16^3.

``examples/gate1_64cube_pcg_amg.yaml`` (PCG + PFMG-style V-cycle,
``mixed``) and ``examples/gate2_weakscale_gmres_cheby.yaml`` (GMRES(20) +
Chebyshev-smoothed PFMG, ``single``), each with its box cut to 16^3 and
written to a temporary directory, through both CLIs on the CPU, tpusolve on
one part: both pass the golden check; gate 1 within one iteration per
refinement pass of tpusolve's, gate 2 within one iteration; in ``double``
PCG + PFMG takes tpusolve's iterations and x agrees to 1e-10 relative.
The timer rows and the hierarchy table are tpusolve's.
"""

import os

import numpy as np
import pytest

from test_torch_slice import _iters, _timer_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 16


def _yaml(tmp_path, name, side=SIDE, **replace):
    src = os.path.join(REPO, "examples", name)
    with open(src) as fh:
        text = fh.read()
    full = "64" if "gate1" in name else "128"
    for axis in ("nx", "ny", "nz"):
        text = text.replace(f"{axis}: {full}", f"{axis}: {side}")
    for old, new in replace.items():
        text = text.replace(old, new)
    path = tmp_path / f"{name[:5]}_{side}.yaml"
    path.write_text(text)
    return str(path)


def _run_tpusolve(path, monkeypatch, capsys):
    """tpusolve's CLI on one part; returns (exit code, output, solution)."""
    pytest.importorskip("jax")
    import tpusolve.mesh
    from tpusolve.harness import cli
    from tpusolve.harness.system import LinearSystem
    from tpusolve.matrix.vectors import from_device_vector
    one = tpusolve.mesh.make_mesh
    monkeypatch.setattr(tpusolve.mesh, "make_mesh",
                        lambda *a, **k: one(1))
    seen = {}
    destroy = LinearSystem.destroy_system

    def keep_solution(self):
        seen["x"] = from_device_vector(self.sln[0], self.A.row_offsets,
                                       self.A.row_pad)
        destroy(self)

    monkeypatch.setattr(LinearSystem, "destroy_system", keep_solution)
    rc = cli.main([path])
    return rc, capsys.readouterr().out, seen["x"]


def _run_port(path, capsys):
    from tpusolve_torch.harness import cli
    from tpusolve_torch.matrix.vectors import from_device_vector
    keep = []
    rc = cli.main([path, "--device", "cpu"], keep=keep)
    sys_ = keep[0]
    x = from_device_vector(sys_.sln[0], sys_.A.row_offsets, sys_.A.row_pad)
    return rc, capsys.readouterr().out, x, sys_.solve_results[0]


def _table(out):
    return out.split("AMG hierarchy:")[1].split("  AMG level 0")[0] \
        .split("Solve 0:")[0].strip()


def test_gate1_mixed(tmp_path, monkeypatch, capsys):
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml")
    rc_t, out_t, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert float(res.relres) <= 1e-8 and res.passes
    assert abs(_iters(out) - _iters(out_t)) <= len(res.passes)
    assert np.isfinite(x).all() and x.shape == (SIDE ** 3,)
    assert _timer_names(out) == [n for n in _timer_names(out_t)
                                 if not n.startswith("Compile")]
    assert _table(out) == _table(out_t)
    assert f"A: DIA D=27 box={SIDE}x{SIDE}x{SIDE}" in out
    assert "AMG level 1: A DIA D=125 box=8x8x8" in out


def test_gate2_single(tmp_path, monkeypatch, capsys):
    path = _yaml(tmp_path, "gate2_weakscale_gmres_cheby.yaml")
    rc_t, out_t, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, _, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert float(res.relres) <= 1e-6
    assert abs(_iters(out) - _iters(out_t)) <= 1
    assert _table(out) == _table(out_t)


def test_pcg_pfmg_double_equal(tmp_path, monkeypatch, capsys):
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml",
                 **{"precision: mixed": "precision: double",
                    "max_coarse_size: 512": "max_coarse_size: 64"})
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert _iters(out) == _iters(out_t) == res.iters
    assert "AMG level 2: A DIA D=125 box=4x4x4" in out
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())


@pytest.mark.parametrize("swap", [
    {"preconditioner: pfmg": "preconditioner: ilu",
     "max_levels: 6": "max_levels: 6\n"
     "ilu_preconditioner_settings:\n  ilu_fill_level: 1"},
    {"method: cg": "method: boomeramg",
     "max_levels: 6": "max_levels: 6\n  smooth_type: 5\n"
     "  smooth_num_levels: 1"}], ids=["ilu_fill_level", "smooth_type"])
def test_ilu_stencil_paths_equal_tpusolve(tmp_path, monkeypatch, capsys,
                                          swap):
    """ILU(1) as PCG's preconditioner and the ILU smoother on AMG's finest
    level (AMG as the solver) on the 16^3 stencil in double: the port's
    count is tpusolve's, its relres too to the printed digits (1e-3), and
    both pass the golden check."""
    swap = dict(swap, **{"precision: mixed": "precision: double"})
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", SIDE, **swap)
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert _iters(out) == _iters(out_t) > 1
    relres = lambda o: float(o.split("Solve 0:")[1].split("relres=")[1]
                             .split()[0])
    assert relres(out) == pytest.approx(relres(out_t), rel=1e-3)
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())


def test_stencil_device_ilu_equals_tpusolve(tmp_path, monkeypatch, capsys):
    """``fixtures.STENCIL_ILU_YAML`` at 16^3 (BiCGSTAB + ILU(0), double)
    with the device row floor at 1 row in both packages: ILU(0) factored
    on the device over the DIA band, the factors DIA (K1 on the card), the
    count and relres tpusolve's."""
    import functools
    from tpusolve_torch import fixtures
    from tpusolve_torch.harness import system
    monkeypatch.setenv("TPUSOLVE_ILU_DEVICE_MIN_N", "1")
    monkeypatch.setattr(system, "ilu_setup", functools.partial(
        system.ilu_setup, device_min_n=1))
    path = fixtures.write_stencil_ilu(str(tmp_path), SIDE)
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    note = "note: ILU(0) setup on device (DIA Chow-Patel, 5 sweeps"
    assert note in out and note in out_t
    assert f"ILU L: DIA D=13 box={SIDE}x{SIDE}x{SIDE}" in out
    solve = lambda o: [ln for ln in o.splitlines() if ln.startswith("Solve 0")]
    assert solve(out) == solve(out_t)
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())


def test_unported_stencil_paths_raise(tmp_path, monkeypatch, capsys):
    """BoomerAMG and ILU on the stencil run, ILU(k > 0) and ILU smoothers
    too (:func:`test_ilu_stencil_paths_equal_tpusolve`); the bfloat16
    smoother twin, refused before it was ported, runs too: BoomerAMG on the
    stencil with ``smoother_dtype: bfloat16`` gives ``tpusolve``'s count
    (``mixed``: within one a refinement pass) and passes its check.  What
    is still refused raises: pfmg on a box too small to coarsen."""
    amg = "max_levels: 6\n  smoother_dtype: bfloat16"
    for swap in ({"preconditioner: pfmg": "preconditioner: boomeramg",
                  "max_levels: 6": amg},):
        path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", 8, **swap)
        rc_t, out_t, _ = _run_tpusolve(path, monkeypatch, capsys)
        rc, out, _, res = _run_port(path, capsys)
        assert rc == rc_t == 0 and "PASSED" in out
        assert "bf16 twin" in out
        it_t = int(out_t.split("Solve 0: iters=")[1].split()[0])
        assert abs(int(res.iters) - it_t) <= len(res.passes or [1])
    # pfmg on a box too small to coarsen
    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.system import LinearSystem
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", 6)
    with open(path) as fh:
        text = fh.read().replace("nz: 6", "nz: 5")
    with open(path, "w") as fh:
        fh.write(text)
    sys_ = LinearSystem(load_config(path), "cpu", verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    with pytest.raises(ValueError, match="pfmg requires"):
        sys_.solve()


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cli_on_cuda_runs_k1(cuda, tmp_path):
    """Needs only the card: gate 1 at 32^3 on CUDA passes, every level is
    box DIA, K1 runs every SpMV of the solve and every transfer rides in a
    K1 launch (the fused kernels; the standalone K3 kernels run none)."""
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels import bdia, bell
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_prolong_update, box_restrict, box_restrict_residual)
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", 32)
    keep = []
    for fn in (dia_spmv, bdia.bdia_spmv, bdia.bdia_spmv_xl, bell.bell_spmv,
               box_prolong, box_restrict, box_restrict_residual,
               box_prolong_update):
        fn.launches = 0
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[0].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    assert all(lev.A.uses_dia for lev in keep[0]._precond.levels)
    assert dia_spmv.launches > 0
    assert box_restrict_residual.launches == box_prolong_update.launches > 0
    assert box_prolong.launches == box_restrict.launches == 0
    assert bdia.bdia_spmv.launches == bdia.bdia_spmv_xl.launches == \
        bell.bell_spmv.launches == 0
