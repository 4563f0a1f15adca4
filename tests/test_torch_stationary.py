"""The stationary solvers of tpusolve_torch against tpusolve's.

``krylov/stationary.py`` (x <- x + M(b - A x)) on one system in f64 takes
tpusolve's iterations and x to 1e-12; ``method: boomeramg`` (AMG as the
solver) and ``method: ilu`` (ILU as the solver), both that iteration with
the preconditioner as M, on the 16^3 stencil, written to ``tmp_path``, run through both CLIs
(tpusolve on one part) and take tpusolve's iterations in f64; AMG as the
solver inside f64 refinement (``mixed``) passes within one iteration a
pass.  The CUDA cases run both methods on the card.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg.builder import boomeramg_setup
from tpusolve_torch.config import BoomerAMGConfig, ILUConfig
from tpusolve_torch.ilu import ilu
from tpusolve_torch.krylov.stationary import stationary_solve_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.stencil import laplace27
from test_torch_gate1 import _run_port, _run_tpusolve
from test_torch_slice import _iters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _stencil_yaml(tmp_path, name, **replace):
    """examples/stencil_pcg_amg.yaml (16^3, double) with ``replace``."""
    with open(os.path.join(REPO, "examples", "stencil_pcg_amg.yaml")) as fh:
        text = fh.read()
    for old, new in replace.items():
        text = text.replace(old, new)
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def _system(n=30):
    """A 2-D Laplacian of n^2 rows and a random right-hand side."""
    lap = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                   [-1, 0, 1])
    H = (sp.kron(sp.eye(n), lap) + sp.kron(lap, sp.eye(n))).tocsr()
    b = np.random.default_rng(4).standard_normal(n * n)
    return H, b


@pytest.mark.parametrize("tol, atol, maxiter, with_x0", [
    (1e-6, 0.0, 2000, False), (0.0, 1e-3, 2000, True),
    (1e-12, 0.0, 25, False)])
def test_stationary_solve_equals_tpusolve(mesh1, tol, atol, maxiter,
                                          with_x0):
    """Damped Jacobi as M on a 2-D Laplacian: the iterations, x and relres
    of tpusolve's ``stationary_solve_setup``, to a tolerance, to an atol
    from an x0, and cut at ``maxiter``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from tpusolve.krylov.stationary import stationary_solve_setup as tp_setup
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    H, b = _system()
    dinv = 0.8 / H.diagonal()
    x0 = np.full(b.size, 0.5)
    At = TpMatrix.from_csr_host(mesh1, H, dtype=np.float64)
    d_t = jnp.asarray(dinv)
    res_t = tp_setup(At, lambda r: d_t * r, tol=tol, atol=atol,
                     maxiter=maxiter)(jnp.asarray(b),
                                      jnp.asarray(x0) if with_x0 else None)
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64)
    d = torch.from_numpy(dinv)
    res = stationary_solve_setup(A, lambda r: d * r, tol=tol, atol=atol,
                                 maxiter=maxiter)(
        torch.from_numpy(b), torch.from_numpy(x0) if with_x0 else None)
    assert res.iters == int(res_t.iters) > 0
    assert bool(res.converged) == bool(res_t.converged)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_t.x), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(res_t.x)).max())
    np.testing.assert_allclose(float(res.relres), float(res_t.relres),
                               rtol=1e-10)


@pytest.mark.parametrize("method", ["boomeramg", "ilu"])
def test_method_on_stencil_equals_tpusolve(tmp_path, monkeypatch, capsys,
                                           method):
    """AMG and ILU as the solver on the 16^3 stencil in f64: both pass the
    golden check in tpusolve's iterations, with the same solution."""
    swap = {"method: cg": f"method: {method}"}
    if method == "ilu":
        swap["preconditioner: boomeramg"] = "preconditioner: none"
    path = _stencil_yaml(tmp_path, method, **swap)
    rc_t, out_t, x_t = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert "Check solution: PASSED" in out_t
    assert _iters(out) == _iters(out_t) == res.iters > 1
    assert float(res.relres) <= 1e-8
    np.testing.assert_allclose(x, x_t, rtol=0,
                               atol=1e-10 * np.abs(x_t).max())
    if method == "ilu":
        assert "ILU L: DIA D=13 box=1x1x4096" in out
    else:
        assert "AMG hierarchy:" in out


def test_amg_as_solver_mixed(tmp_path, monkeypatch, capsys):
    """AMG as the solver in f32 inside f64 refinement: both pass, the
    port within one iteration a refinement pass of tpusolve."""
    path = _stencil_yaml(tmp_path, "mixed", **{
        "method: cg": "method: boomeramg",
        "precision: double": "precision: mixed"})
    rc_t, out_t, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, _, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out
    assert res.passes and float(res.relres) <= 1e-8
    assert abs(_iters(out) - _iters(out_t)) <= len(res.passes)


@pytest.mark.parametrize("method", ["boomeramg", "ilu"])
def test_stationary_step_is_one_application(method):
    """AMG (a V-cycle) and ILU as M of the stationary iteration the harness
    builds for ``method: boomeramg | ilu``: one step from zero is one
    application of M, and the iteration converges on the 8^3 stencil."""
    A, b, _ = laplace27(8, 8, 8, device=CPU, dtype=np.float64)
    if method == "boomeramg":
        pre = boomeramg_setup(A, BoomerAMGConfig(max_coarse_size=32))
    else:
        pre = ilu.ilu_setup(A, ILUConfig())
        assert pre.notes == []
    one = stationary_solve_setup(A, pre.apply, tol=0.0, maxiter=1)(b)
    assert one.iters == 1
    torch.testing.assert_close(one.x, pre.apply(b), rtol=0, atol=0)
    res = stationary_solve_setup(A, pre.apply, tol=1e-8, maxiter=500)(b)
    assert bool(res.converged) and float(res.relres) <= 1e-8


def test_ilu_device_note():
    """From 65,536 rows, tpusolve factors a DIA operator (main and both
    off-diagonal sides) or a narrow ELL one on the device, and so does the
    port, saying so in its note; not below, nor for BDIA, nor for a DIA
    operator with one side only."""
    from tpusolve_torch.ilu import device_setup
    n = device_setup.MIN_DEVICE_N
    cfg = ILUConfig()
    H = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64)
    assert A.uses_dia
    pre = ilu.ilu_setup(A, cfg, A_host=H)
    assert len(pre.notes) == 1 and "on device (DIA" in pre.notes[0]
    assert pre.L.uses_dia and pre.U.uses_dia
    E = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                    allow_dia=False, allow_bdia=False,
                                    allow_bell=False)
    assert device_setup.device_path(E, cfg) == "ell"
    Bd = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                     allow_dia=False, allow_bell=False)
    assert Bd.uses_bdia and device_setup.device_path(Bd, cfg) is None
    Lw = ShardedMatrix.from_csr_host(sp.tril(H).tocsr(), device=CPU)
    assert Lw.uses_dia and device_setup.device_path(Lw, cfg) is None
    small = ShardedMatrix.from_csr_host(H[:1000, :1000], device=CPU)
    assert device_setup.device_path(small, cfg) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["boomeramg", "ilu"])
def test_method_on_cuda(cuda, tmp_path, method):
    """Needs only the card: AMG and ILU as the solver on the 16^3 stencil
    on CUDA pass, with K1 running the DIA SpMVs."""
    from tpusolve_torch.harness import cli
    from tpusolve_torch.kernels.dia import dia_spmv
    swap = {"method: cg": f"method: {method}"}
    if method == "ilu":
        swap["preconditioner: boomeramg"] = "preconditioner: none"
    path = _stencil_yaml(tmp_path, method, **swap)
    keep = []
    dia_spmv.launches = 0
    assert cli.main([path, "--device", "cuda"], keep=keep) == 0
    res = keep[0].solve_results[0]
    assert bool(res.converged) and float(res.relres) <= 1e-8
    assert dia_spmv.launches > 0
