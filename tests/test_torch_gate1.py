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


def test_unported_stencil_paths_raise(tmp_path):
    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.system import LinearSystem
    for old, new in (("preconditioner: pfmg", "preconditioner: boomeramg"),
                     ("preconditioner: pfmg", "preconditioner: ilu"),
                     ("method: cg", "method: boomeramg")):
        path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", 8, **{old: new})
        sys_ = LinearSystem(load_config(path), "cpu", verbose=False)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sys_.setup_precon_and_solver()
            sys_.load()
    # pfmg on a box too small to coarsen
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
    box DIA, K1 runs every SpMV of the solve and K3 every transfer."""
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels import bdia, bell
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.transfer import box_prolong, box_restrict
    path = _yaml(tmp_path, "gate1_64cube_pcg_amg.yaml", 32)
    keep = []
    for fn in (dia_spmv, bdia.bdia_spmv, bdia.bdia_spmv_xl, bell.bell_spmv,
               box_prolong, box_restrict):
        fn.launches = 0
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[0].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    assert all(lev.A.uses_dia for lev in keep[0]._precond.levels)
    assert dia_spmv.launches > 0
    assert box_prolong.launches == box_restrict.launches > 0
    assert bdia.bdia_spmv.launches == bdia.bdia_spmv_xl.launches == \
        bell.bell_spmv.launches == 0
