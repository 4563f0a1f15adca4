"""BoomerAMG and ILU on the generated 27-point stencil: tpusolve_torch's CLI
and setup against tpusolve's.

``examples/stencil_pcg_amg.yaml`` (PCG) and ``examples/stencil_gmres_amg.yaml``
(GMRES + Chebyshev) at 16^3 in f64 through both CLIs on the CPU (tpusolve
on one part): both pass the golden check in tpusolve's iterations with
tpusolve's hierarchy table.  The four CPU fixtures of ``tools/parity.py``
(its ``run_fixture`` for tpusolve on one part, the same steps in the port):
equal iteration counts.  A 64^3 ``single`` copy of
``examples/weakscale_pcg_boomeramg_devsetup.yaml``: both set level 0 up on
the device (tpusolve with ``TPUSOLVE_PMIS_HOST_RANK=1``) and the port's
count is within one of tpusolve's.  PCG + ILU(0) on the stencil takes
tpusolve's count.  The stencil's branches keep a host CSR only where a host
setup needs one.  The CUDA cases run the 16^3 YAMLs on the card.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg.builder import boomeramg_setup
from tpusolve_torch.config import BoomerAMGConfig, load_config
from tpusolve_torch.harness.system import LinearSystem
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.krylov.gmres import gmres_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.stencil import laplace27
from test_torch_gate1 import _run_port, _run_tpusolve, _table
from test_torch_slice import _iters, _timer_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEVICE_NOTE = "note: level 0 setup on device"


def _copy(tmp_path, name, **replace):
    with open(os.path.join(REPO, "examples", name)) as fh:
        text = fh.read()
    for old, new in replace.items():
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name", ["stencil_pcg_amg.yaml",
                                  "stencil_gmres_amg.yaml"])
def test_example_equals_tpusolve(tmp_path, monkeypatch, capsys, name):
    path = os.path.join(REPO, "examples", name)
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert _iters(out) == _iters(out_t) == res.iters
    assert float(res.relres) <= 1e-8
    assert _table(out) == _table(out_t)
    assert _timer_names(out) == [n for n in _timer_names(out_t)
                                 if not n.startswith("Compile")]
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())
    assert "A: DIA D=27 box=16x16x16" in out
    assert "AMG level 0: A DIA D=27 box=16x16x16; P ELL" in out
    assert DEVICE_NOTE not in out           # 4,096 rows: the host pipeline


def _fixtures():
    with open(os.path.join(REPO, "tools", "parity_expected.json")) as fh:
        return [fx for fx in json.load(fh)["fixtures"]
                if not fx.get("tpu_only")]


def run_fixture_port(fx: dict):
    """``tools/parity.py:run_fixture`` on the port: (iterations,
    converged, level-0 layout)."""
    s = fx["settings"]
    sweeps = 2 if "V(2,2)" in s.get("cycle", "V(1,1)") else 1
    if fx["name"].startswith("laplace27"):
        A, b, _ = laplace27(*fx.get("dims", [8, 8, 8]), device=CPU,
                            dtype=np.float64)
        A_host = None
    else:
        n2 = 64
        lap1 = sp.diags([-np.ones(n2 - 1), 2 * np.ones(n2),
                         -np.ones(n2 - 1)], [-1, 0, 1])
        A_host = (sp.kron(sp.eye(n2), lap1) + sp.kron(lap1, sp.eye(n2))
                  ).tocsr()
        A_host.eliminate_zeros()
        A = ShardedMatrix.from_csr_host(A_host, device=CPU, dtype=np.float64)
        b = torch.from_numpy(A_host @ np.ones(A_host.shape[0]))
    extra = {k: s[k] for k in ("relax_type", "cheby_order",
                               "cheby_variant", "relax_order") if k in s}
    cfg = BoomerAMGConfig(strong_threshold=float(s.get("strong_threshold",
                                                       0.25)),
                          num_sweeps=sweeps,
                          interp_type=int(s.get("interp_type", 0)),
                          max_coarse_size=64, **extra)
    pre = boomeramg_setup(A, cfg, A_host=A_host)
    tol = float(s.get("tolerance", 1e-8))
    if fx["solver"].startswith("gmres"):
        solve = gmres_setup(A, pre.apply, tol=tol, restart=20, maxiter=200)
    else:
        solve = pcg_setup(A, pre.apply, tol=tol, maxiter=200)
    res = solve(b)
    return int(res.iters), bool(res.converged), A.layout


@pytest.mark.parametrize("fx", _fixtures(), ids=lambda fx: fx["name"])
def test_parity_fixture_equals_tpusolve(fx, mesh1):
    pytest.importorskip("jax")
    from tools.parity import run_fixture
    iters_t, conv_t = run_fixture(fx, mesh1)
    iters, conv, layout = run_fixture_port(fx)
    assert conv and conv_t
    assert iters == iters_t <= fx["budget_iters"]
    # the 27-point box, or the 5-point operator assembled as 1-D DIA
    assert layout.startswith("DIA")


def test_weakscale_64_single(tmp_path, monkeypatch, capsys):
    """The weak-scaling YAML at 64^3 (262,144 rows, ``single``): level 0
    set up on the device in both packages, the same hierarchy table, the
    port within one PCG iteration of tpusolve."""
    path = _copy(tmp_path, "weakscale_pcg_boomeramg_devsetup.yaml",
                 **{f"{a}: 128": f"{a}: 64" for a in ("nx", "ny", "nz")})
    monkeypatch.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
    rc_t, out_t, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert DEVICE_NOTE in out and DEVICE_NOTE in out_t
    assert _table(out) == _table(out_t)
    assert abs(_iters(out) - _iters(out_t)) <= 1
    assert float(res.relres) <= 1e-6 and np.isfinite(x).all()
    assert "AMG level 0: A DIA D=27 box=64x64x64; P ELL" in out
    assert "AMG level 1: A ELL" in out


def test_pcg_ilu_on_stencil_equals_tpusolve(tmp_path, monkeypatch, capsys):
    path = _copy(tmp_path, "stencil_pcg_amg.yaml",
                 **{"preconditioner: boomeramg": "preconditioner: ilu"})
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert _iters(out) == _iters(out_t) == res.iters
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())


@pytest.mark.parametrize("case, host_csr, device_amg", [
    ({}, True, False),
    ({"nx: 16": "nx: 64", "ny: 16": "ny: 64", "nz: 16": "nz: 16"},
     False, True),
    ({"nx: 16": "nx: 64", "ny: 16": "ny: 64", "interp_type: 0":
      "interp_type: 6"}, True, False),
    ({"preconditioner: boomeramg": "preconditioner: none"}, False, False),
    ({"preconditioner: boomeramg": "preconditioner: none",
      "method: cg": "method: ilu"}, True, False),
    ({"preconditioner: boomeramg": "preconditioner: pfmg"}, False, False)])
def test_stencil_branches(tmp_path, case, host_csr, device_amg):
    """tpusolve's order: PFMG's payload; device AMG (65,536 rows or more,
    eligible config) with no host CSR; the host CSR for other host setups;
    else the operator alone."""
    sys_ = LinearSystem(load_config(_copy(tmp_path, "stencil_pcg_amg.yaml",
                                          **case)), "cpu", verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    assert sys_._device_amg() == device_amg
    assert (sys_.A_host is not None) == host_csr
    assert (sys_._host_parts is not None) == ("pfmg" in str(case))
    if host_csr:
        assert abs(sys_.A_host - sys_.A.to_scipy()).max() == 0.0


@pytest.mark.parametrize("allow_dia", [True, False])
def test_loaded_system_dia_candidacy(tmp_path, allow_dia):
    """A loaded system takes the DIA-first candidacy unless
    ``spmv_use_dia`` is off (``tpusolve``'s switch)."""
    from tpusolve_torch.formats import mmio
    H = laplace27(6, 6, 6, device=CPU, dtype=np.float64)[0].to_scipy()
    mat, rhs = tmp_path / "A.mtx", tmp_path / "b.mtx"
    Hc = H.tocoo()
    mmio.write_matrix(str(mat), Hc.row, Hc.col, Hc.data, H.shape)
    mmio.write_vector(str(rhs), H @ np.ones(H.shape[0]))
    path = tmp_path / "s.yaml"
    path.write_text(
        f"linear_system:\n  type: matrix_market\n  matrix_file: {mat}\n"
        f"  rhs_file: {rhs}\nsolver_settings:\n  method: cg\n"
        f"  preconditioner: none\n  spmv_use_dia: {allow_dia}\n")
    sys_ = LinearSystem(load_config(str(path)), "cpu", verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    assert sys_.A.uses_dia == allow_dia
    assert abs(sys_.A.to_scipy() - H).max() == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stencil_pcg_amg.yaml",
                                  "stencil_gmres_amg.yaml"])
def test_example_on_cuda(cuda, name):
    """Needs only the card: both 16^3 YAMLs pass on CUDA, K1 running the
    DIA levels' SpMVs, in the CPU run's iterations."""
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels.dia import dia_spmv
    path = os.path.join(REPO, "examples", name)
    keep = []
    assert cli.main([path, "--device", "cpu"], keep=keep) == 0
    dia_spmv.launches = 0
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[1].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    assert res.iters == keep[0].solve_results[0].iters
    assert dia_spmv.launches > 0
