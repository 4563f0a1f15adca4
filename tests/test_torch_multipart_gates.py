"""Gates 1, 3 and 4 on 8 parts through both harnesses, and the device setups
that raise on more than one part.

``tpusolve`` runs on its mesh of 8 virtual devices, the port on 8 parts
stacked on the CPU (``LinearSystem(..., nparts=8)``): the counts are equal
in ``double`` and within one a refinement pass in ``mixed``, both golden
checks pass, and the solutions agree to the stated tolerance.  Gate 1 at
8^3 a part (PFMG, the offd shells through the fused transfers), gate 3 at
16^3 (host BoomerAMG), gate 4 at 16^3 from two files (host Chow-Patel ILU
with offd blocks in both factors, and with the device floor at one row the
block-Jacobi device ILU, whose 8-part factors equal ``tpusolve``'s).  The
multi-part device AMG setups and generator (item 18) raise
``NotImplementedError`` rather than run one part or the host setup.
"""

import os

import numpy as np
import pytest
import torch

from tpusolve_torch import fixtures

CPU = torch.device("cpu")
P8 = 8
TOL_X = 1e-6      # solutions, relative to the largest entry


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's many small CPU operations (the
    suite runs several workers on the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gate1(tmp_path, precision, twin=False):
    src = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "gate1_64cube_pcg_amg.yaml")
    text = open(src).read().replace(": 64\n", ": 8\n").replace(
        "precision: mixed", f"precision: {precision}")
    if twin:
        text = text.replace("relax_type: 6", "relax_type: 6\n"
                            "  smoother_dtype: bfloat16")
    path = tmp_path / "gate1.yaml"
    path.write_text(text)
    return str(path)


def _run(path, port):
    """(counts, passes, solutions, check) of one harness's run on 8
    parts."""
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
    if port:
        assert s.A.nparts == P8
    return [int(r.iters) for r in res], passes, xs, ok


def _compare(path, precision):
    it, passes, xs, ok = _run(path, True)
    it_t, _, xs_t, ok_t = _run(path, False)
    assert ok and ok_t
    slack = 0 if precision == "double" else len(passes[0] or [1])
    assert abs(it[0] - it_t[0]) <= slack, (it, it_t, passes)
    for x, y in zip(xs, xs_t):
        assert np.abs(x - y).max() <= TOL_X * np.abs(y).max()
    return it, it_t


@pytest.mark.parametrize("precision, twin", [("double", False),
                                              ("mixed", False),
                                              ("mixed", True)])
def test_gate1_8_parts_equals_tpusolve(tmp_path, precision, twin):
    """Gate 1 on 8 parts; with ``smoother_dtype: bfloat16`` the twin's
    offd block is bf16 too (``astype``), as ``tpusolve``'s."""
    _compare(_gate1(tmp_path, precision, twin), precision)


def test_gate3_8_parts_equals_tpusolve(tmp_path):
    path = fixtures.write_gate3(str(tmp_path), 16, solver_settings={
        "precision": "double"})
    _compare(path, "double")


@pytest.mark.parametrize("precision", ["double", "mixed"])
def test_gate4_8_parts_equals_tpusolve(tmp_path, precision):
    path = fixtures.write_gate4(str(tmp_path), 16, nfiles=2,
                                precision=precision)
    _compare(path, precision)


def test_cli_parts_flag(tmp_path, capsys):
    """``--parts 8``: the CLI's Shard lines and an 8-part operator."""
    from tpusolve_torch.harness import cli
    path = fixtures.write_gate4(str(tmp_path), 8, nfiles=2)
    keep = []
    assert cli.main([path, "--device", "cpu", "--parts", "8"],
                    keep=keep) == 0
    out = capsys.readouterr().out
    assert "Shard    7:: iLower" in out and "8 parts" in out
    assert keep[0].A.nparts == P8 and keep[0].A.has_offd
    assert cli._parse([path, "--parts", "0"]) is None


# ----------------------------------------------------------------------
# the device ILU on 8 parts, and the device setups of item 18, which raise

def _stencil8(side=4):
    from tpusolve_torch.stencil import laplace27
    return laplace27(side, side, side, device=CPU, nparts=P8)


@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_device_ilu_on_8_parts_equals_tpusolve(monkeypatch, mesh8, layout):
    """Where ``tpusolve`` factors ILU(0) on its devices, the port factors
    each part's diag block on its device too (block-Jacobi, no offd
    block): the 8-part factors, ``udiag_inv`` and notes equal
    ``tpusolve``'s on ``mesh8``."""
    monkeypatch.setenv("TPUSOLVE_ILU_DEVICE_MIN_N", "1")
    import scipy.sparse as sp
    from tpusolve.config import ILUConfig as TpILUConfig
    from tpusolve.ilu.ilu import ilu_setup as tp_ilu_setup
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.stencil import laplace27 as tp_laplace27
    from tpusolve_torch.config import ILUConfig
    from tpusolve_torch.ilu.ilu import ilu_setup
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    if layout == "dia":
        A = _stencil8(8)[0]
        At = tp_laplace27(mesh8, 8, 8, 8, dtype=np.float64)[0]
    else:
        r, c, v, _, n = fixtures.make_system(8, 8, 8, seed=11, nonsym=0.35)
        H = sp.csr_matrix((v, (r, c)), shape=(n, n))
        kw = dict(allow_dia=False, allow_bdia=False, allow_bell=False)
        A = ShardedMatrix.from_csr_host(H, device=CPU, nparts=P8, **kw)
        At = TpMatrix.from_csr_host(mesh8, H, dtype=np.float64, **kw)
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    pre_t = tp_ilu_setup(At, TpILUConfig())
    assert pre.notes == pre_t.notes and "block-Jacobi" in pre.notes[1]
    assert pre.L.nparts == P8 and not (pre.L.has_offd or pre.U.has_offd)
    assert (pre.L.uses_dia if layout == "dia" else pre.L.uses_ell)
    for M, M_t in ((pre.L, pre_t.L), (pre.U, pre_t.U)):
        D = abs(M.to_scipy() - M_t.to_scipy())
        assert (D.max() if D.nnz else 0.0) <= 1e-12 * abs(M_t.to_scipy()).max()
    np.testing.assert_allclose(pre.udiag_inv.numpy(),
                               np.asarray(pre_t.udiag_inv), rtol=1e-12,
                               atol=0)


def test_gate4_8_parts_device_ilu_equals_tpusolve(tmp_path, monkeypatch):
    """Gate 4 in ``mixed`` on 8 parts as scrambled (no RCM: ELL in both
    packages) with both packages' device ILU floor at one row: the
    block-Jacobi device factors on both sides, the counts within one a
    refinement pass."""
    import functools
    from tpusolve_torch.harness import system
    from tpusolve_torch.ilu import device_setup
    monkeypatch.setenv("TPUSOLVE_ILU_DEVICE_MIN_N", "1")
    monkeypatch.setattr(system, "ilu_setup", functools.partial(
        system.ilu_setup, device_min_n=1))
    calls = []
    setup = device_setup.ilu_setup_device_ell
    monkeypatch.setattr(device_setup, "ilu_setup_device_ell",
                        lambda A, cfg: calls.append(A.nparts)
                        or setup(A, cfg))
    path = fixtures.write_gate4(str(tmp_path), 16, nfiles=2,
                                precision="mixed", solver_settings={
                                    "matrix_ordering": "none"})
    _compare(path, "mixed")
    assert calls == [P8]


def test_device_amg_setups_raise_on_8_parts():
    from tpusolve_torch.amg import device_setup_ell
    from tpusolve_torch.amg.builder import boomeramg_setup
    from tpusolve_torch.config import BoomerAMGConfig
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    import scipy.sparse as sp
    A, _, _ = _stencil8()
    with pytest.raises(NotImplementedError, match="item 18"):
        boomeramg_setup(A, BoomerAMGConfig(), lattice_parts={})
    M = sp.random(512, 512, density=0.01, random_state=3, format="csr") \
        + sp.identity(512, format="csr") * 4.0
    E = ShardedMatrix.from_csr_host(M, device=CPU, nparts=P8,
                                    allow_dia=False, allow_bdia=False,
                                    allow_bell=False)
    with pytest.raises(NotImplementedError, match="item 18"):
        device_setup_ell.eligible(E, BoomerAMGConfig(coarsen_type=8,
                                                     interp_type=6),
                                  min_n=1)


def test_device_generation_raises_on_8_parts(tmp_path):
    from tpusolve_torch import stencil
    from tpusolve_torch.config import load_config
    from tpusolve_torch.harness.system import LinearSystem
    with pytest.raises(NotImplementedError, match="item 18"):
        stencil.laplace27(4, 4, 4, device=CPU, nparts=P8, on_device=True)
    with pytest.raises(NotImplementedError, match="item 18"):
        stencil.laplace27(4, 4, 4, device=CPU, nparts=P8, with_lattice=True)
    path = fixtures.write_weakscale(str(tmp_path), 32)
    s = LinearSystem(load_config(path), CPU, nparts=P8, verbose=False)
    s.setup_precon_and_solver()
    with pytest.raises(NotImplementedError, match="item 18"):
        s.load()
