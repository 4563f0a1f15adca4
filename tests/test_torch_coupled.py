"""The coupled multi-component solve (``segregated_solve: false``) against
``tpusolve``'s ``vmap`` path, ``tpusolve`` on one part.

The same YAML runs through both packages' ``LinearSystem``:

* the inputs of ``tests/test_harness.py``'s coupled test (PCG, no
  preconditioner, two components, ``double``): each component's count
  equals ``tpusolve``'s and x agrees to 1e-10 relative;
* gate 4's three momentum components (``GATE4_YAML_3COMP``, BiCGSTAB and
  ILU(0)) with RCM at 16^3 in ``double``: counts equal (14, 14, 13) and x
  to 1e-10 (in natural order at 24^3: ``tests/test_torch_coupled_24.py``);
* gate 3's fixture with two more right-hand sides, GMRES + BoomerAMG and
  BoomerAMG as the solver, in ``double``: equal.

A column that starts converged stays at 0 iterations while the others
run, and the port's coupled solve equals its segregated one per component
in ``double`` (counts, and x to 1e-10).
"""

import numpy as np
import pytest

from tpusolve_torch import fixtures

TOL_X = 1e-10


def _solutions(sys_, from_device_vector):
    """Each component's solution in the original numbering."""
    out = []
    for x in sys_.sln:
        v = from_device_vector(x, sys_.A.row_offsets, sys_.A.row_pad)
        if sys_._perm is not None:
            w = np.empty_like(v)
            w[sys_._perm] = v
            v = w
        out.append(np.asarray(v, np.float64))
    return out


def run_port(path):
    """(counts, refinement passes, solutions, check) of the port's run."""
    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.system import LinearSystem
    from tpusolve_torch.matrix.vectors import from_device_vector
    sys_ = LinearSystem(load_config(str(path)), "cpu", verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    sys_.solve()
    ok = sys_.check_solution()
    res = sys_.solve_results
    return ([int(r.iters) for r in res], [r.passes for r in res],
            _solutions(sys_, from_device_vector), ok)


def run_tpusolve(path):
    """The same of ``tpusolve``'s run on one part."""
    pytest.importorskip("jax")
    from tpusolve.config import load_config
    from tpusolve.harness.system import LinearSystem
    from tpusolve.matrix.vectors import from_device_vector
    from tpusolve.mesh import make_mesh
    sys_ = LinearSystem(make_mesh(1), load_config(str(path)), verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    sys_.solve()
    ok = sys_.check_solution()
    res = sys_.solve_results
    passes = [None if getattr(r, "passes", None) is None
              else [int(p) for p in np.asarray(r.passes)] for r in res]
    return ([int(r.iters) for r in res], passes,
            _solutions(sys_, from_device_vector), ok)


def assert_close(xs, ys, tol=TOL_X):
    for x, y in zip(xs, ys):
        assert np.abs(x - y).max() <= tol * np.abs(y).max()


def test_pcg_coupled_equals_tpusolve(tmp_path):
    """``tests/test_harness.py``'s coupled inputs: the 8x8 Laplacian, two
    random solutions, PCG without a preconditioner."""
    from tpusolve_torch.formats import mmio
    import scipy.sparse as sp
    n = 64
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(8, 8))
    A = (sp.kron(sp.identity(8), T) + sp.kron(T, sp.identity(8))).tocoo()
    mmio.write_matrix(str(tmp_path / "A.mm"), A.row, A.col, A.data, A.shape)
    rng = np.random.default_rng(0)
    for i in range(2):
        x = rng.standard_normal(n)
        mmio.write_vector(str(tmp_path / f"b{i}.mm"), A @ x)
        mmio.write_vector(str(tmp_path / f"x{i}.mm"), x)
    path = tmp_path / "c.yaml"
    path.write_text(f"""
linear_system:
  type: matrix_market
  matrix_file: "{tmp_path}/A.mm"
  num_components: 2
  segregated_solve: false
  rhs_file0: "{tmp_path}/b0.mm"
  rhs_file1: "{tmp_path}/b1.mm"
  sln_file0: "{tmp_path}/x0.mm"
  sln_file1: "{tmp_path}/x1.mm"
solver_settings:
  method: cg
  preconditioner: none
  tolerance: 1.0e-11
  max_iterations: 500
  precision: double
""")
    it_p, _, x_p, ok_p = run_port(path)
    it_t, _, x_t, ok_t = run_tpusolve(path)
    assert ok_p and ok_t
    assert it_p == it_t
    assert_close(x_p, x_t)


def gate4_3comp(tmp_path, side, precision, rcm, segregated=False):
    solver = {"precision": precision}
    if rcm:
        solver["matrix_ordering"] = "rcm"
    return fixtures.write_gate4_3comp(
        str(tmp_path), side, linear_system={"segregated_solve": segregated},
        solver_settings=solver)


def test_gate4_rcm_16_double_equals_tpusolve(tmp_path):
    path = gate4_3comp(tmp_path, 16, "double", rcm=True)
    it_p, _, x_p, ok_p = run_port(path)
    it_t, _, x_t, ok_t = run_tpusolve(path)
    assert ok_p and ok_t
    assert it_p == it_t == [14, 14, 13]
    assert_close(x_p, x_t)


def gate3_3comp(tmp_path, side, method):
    """Gate 3's fixture at side^3 with two more right-hand sides (random
    solutions), ``method`` (``gmres`` or ``boomeramg``), coupled."""
    from tpusolve_torch.formats import mmio
    import scipy.sparse as sp
    m, r, s, n = fixtures.write_pressure_mm(str(tmp_path), side, side, side)
    rows, cols, vals, _ = mmio.read_matrix(m)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    rng = np.random.default_rng(3)
    rhs, sln = [r], [s]
    for i in (1, 2):
        x = 1.0 + 0.1 * rng.standard_normal(n)
        rhs.append(str(tmp_path / f"b{i}.mm"))
        sln.append(str(tmp_path / f"x{i}.mm"))
        mmio.write_vector(rhs[-1], A @ x)
        mmio.write_vector(sln[-1], x)
    text = fixtures.GATE3_YAML.format(mat=m, rhs=r, sln=s)
    text = text.replace(f"  rhs_file: {r}\n  sln_file: {s}\n", "".join(
        f"  rhs_file{i}: {rhs[i]}\n  sln_file{i}: {sln[i]}\n"
        for i in range(3)) + "  num_components: 3\n"
        "  segregated_solve: false\n")
    text = text.replace("method: gmres", f"method: {method}")
    path = tmp_path / f"gate3_{method}.yaml"
    path.write_text(fixtures.with_settings(
        text, solver_settings={"precision": "double"}))
    return path


@pytest.mark.parametrize("method", ["gmres", "boomeramg"])
def test_gate3_coupled_equals_tpusolve(tmp_path, method):
    path = gate3_3comp(tmp_path, 16, method)
    it_p, _, x_p, ok_p = run_port(path)
    it_t, _, x_t, ok_t = run_tpusolve(path)
    assert ok_p and ok_t
    assert it_p == it_t
    assert_close(x_p, x_t, 1e-8)


def test_converged_column_stays_at_zero(tmp_path):
    """A zero right-hand side meets its stop test at the start: it stays at
    0 iterations and x = 0 while the other columns run to their counts."""
    import torch
    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.system import LinearSystem
    path = gate4_3comp(tmp_path, 12, "double", rcm=True)
    sys_ = LinearSystem(load_config(path), "cpu", verbose=False)
    sys_.setup_precon_and_solver()
    sys_.load()
    sys_.rhs[1] = torch.zeros_like(sys_.rhs[1])
    sys_.solve()
    res = sys_.solve_results
    assert int(res[1].iters) == 0 and not bool(sys_.sln[1].any())
    assert int(res[0].iters) > 0 and int(res[2].iters) > 0
    seg = LinearSystem(load_config(path), "cpu", verbose=False)
    seg.segregated = True
    seg.setup_precon_and_solver()
    seg.load()
    seg.solve()
    assert [int(r.iters) for r in res[::2]] == \
        [int(r.iters) for r in seg.solve_results[::2]]


@pytest.mark.parametrize("method", ["bicg", "gmres", "fgmres"])
def test_coupled_equals_segregated(tmp_path, method):
    """The port's coupled solve against its segregated one, component by
    component, in ``double``: the same counts and x to 1e-10."""
    path = gate4_3comp(tmp_path, 12, "double", rcm=True)
    text = open(path).read().replace("method: bicg", f"method: {method}")
    for seg in (False, True):
        p = tmp_path / f"{method}_{seg}.yaml"
        p.write_text(text.replace("segregated_solve: false",
                                  f"segregated_solve: {str(seg).lower()}"))
    it_c, _, x_c, _ = run_port(tmp_path / f"{method}_False.yaml")
    it_s, _, x_s, _ = run_port(tmp_path / f"{method}_True.yaml")
    assert it_c == it_s
    assert_close(x_c, x_s)
