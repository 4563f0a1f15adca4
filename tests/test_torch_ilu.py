"""tpusolve_torch's host ILU against tpusolve's.

The host Chow-Patel factors, with and without fill, and the fill pattern,
ILUT's drop and cap and the RCM permutation are identical to 1e-14;
``ilu_apply`` on the factors tpusolve stored (carried over by
``from_arrays``) equals tpusolve's application to 1e-12 relative in f64, as
``ilu_setup`` with each option does; on the gate-4 fixture both CLIs take
the same count with each option.  The device ILU(0):
``test_torch_ilu_device.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.config import ILUConfig
from tpusolve_torch.fixtures import make_system
from tpusolve_torch.ilu.ilu import chow_patel_ilu, ilu_apply, ilu_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import to_device_vector
from test_torch_sharded import tpusolve_fields

CPU = torch.device("cpu")


def momentum(side=14):
    """Gate-4-shaped momentum operator (RCM-ordered, so BDIA applies)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    r, c, v, _, n = make_system(side, side, side, seed=11, nonsym=0.35)
    S = sp.csr_matrix((v, (r, c)), shape=(n, n))
    perm = reverse_cuthill_mckee(S + S.T, symmetric_mode=True)
    return S[perm][:, perm].tocsr()


@pytest.fixture(scope="module")
def tpi():
    pytest.importorskip("jax")
    from tpusolve.ilu import ilu as tp_ilu
    from tpusolve.mesh import make_mesh
    return tp_ilu, make_mesh(1)


def test_factors_identical(tpi):
    tp_ilu, _ = tpi
    S = momentum(10)
    L, d, U = chow_patel_ilu(S.copy(), sweeps=5)
    Lt, dt, Ut = tp_ilu.chow_patel_ilu(S.copy(), sweeps=5)
    assert abs(L - Lt).max() <= 1e-14 * abs(Lt).max()
    assert abs(U - Ut).max() <= 1e-14 * abs(Ut).max()
    np.testing.assert_allclose(d, dt, rtol=1e-14, atol=0)
    # L is strictly lower, U strictly upper
    assert (sp.triu(L).nnz, sp.tril(U).nnz) == (0, 0)


def test_apply_on_tpusolve_factors(tpi):
    """tpusolve's factors in tpusolve's BDIA layout: the port's ilu_apply
    equals tpusolve's ilu_apply on them."""
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix.vectors import to_device_vector as tp_vec
    tp_ilu, mesh = tpi
    S = momentum()
    n = S.shape[0]
    Lh, d, Uh = tp_ilu.chow_patel_ilu(S.copy(), sweeps=5)
    ro = np.array([0, n])
    tri = []
    for M in (Lh.tocoo(), Uh.tocoo()):
        Mt = TpMatrix.from_coo(mesh, S.shape, M.row, M.col, M.data,
                               dtype=np.float64, allow_dia=False,
                               allow_bell=False)
        assert Mt.uses_bdia
        tri.append((Mt, ShardedMatrix.from_arrays(*tpusolve_fields(Mt),
                                                  device=CPU)))
    (Lt, L), (Ut, U) = tri
    dinv_t = tp_vec(mesh, 1.0 / d, ro, n)
    r = np.random.default_rng(4).standard_normal(n)
    z_t = np.asarray(tp_ilu.ilu_apply(Lt, Ut, dinv_t, tp_vec(mesh, r, ro, n),
                                      5, 5))
    z = ilu_apply(L, U, torch.from_numpy(1.0 / d), torch.from_numpy(r),
                  5, 5).numpy()
    np.testing.assert_allclose(z, z_t, rtol=0, atol=1e-12 * np.abs(z_t).max())


def test_setup_on_port_layout(tpi):
    """ilu_setup through each package: the port stores its factors in the
    layout its model prices fastest (ELL, K2, at this size),
    tpusolve picks its own layouts; the applications agree."""
    from tpusolve.config import ILUConfig as TpILUConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix.vectors import to_device_vector as tp_vec
    tp_ilu, mesh = tpi
    S = momentum().tocoo()
    n = S.shape[0]
    A = ShardedMatrix.from_coo(S.shape, S.row, S.col, S.data, device=CPU)
    pre = ilu_setup(A, ILUConfig(), A_host=S.tocsr())
    assert pre.L.uses_ell and pre.U.uses_ell
    At = TpMatrix.from_coo(mesh, S.shape, S.row, S.col, S.data,
                           dtype=np.float64)
    pre_t = tp_ilu.ilu_setup(At, TpILUConfig(), A_host=S.tocsr())
    r = np.random.default_rng(4).standard_normal(n)
    z_t = np.asarray(pre_t.apply(tp_vec(mesh, r, At.row_offsets, At.row_pad)))
    z = pre.apply(to_device_vector(r, A.row_offsets, A.row_pad, CPU)).numpy()
    np.testing.assert_allclose(z, z_t, rtol=0, atol=1e-12 * np.abs(z_t).max())


def test_host_helpers_equal_tpusolve(tpi):
    """The fill pattern, ILU(k) factors, ILUT's drop and cap and the RCM
    permutation, each against tpusolve's on the same matrix."""
    from tpusolve_torch.ilu import ilu as port
    tp_ilu, _ = tpi
    S = momentum(8)
    for k in (1, 2):
        Pp, Pt = port._fill_pattern(S, k), tp_ilu._fill_pattern(S, k)
        assert Pp.nnz == Pt.nnz > S.nnz and abs(Pp - Pt).max() == 0
        L, d, U = chow_patel_ilu(S.copy(), sweeps=5, fill_level=k)
        Lt, dt, Ut = tp_ilu.chow_patel_ilu(S.copy(), sweeps=5, fill_level=k)
        assert abs(L - Lt).max() <= 1e-14 * abs(Lt).max()
        assert abs(U - Ut).max() <= 1e-14 * abs(Ut).max()
        np.testing.assert_allclose(d, dt, rtol=1e-14, atol=0)
    L, _, _ = chow_patel_ilu(S.copy(), sweeps=5, fill_level=1)
    for tol in (0.0, 0.02, 0.2):
        Dp, Dt = port._drop_small(L, tol), tp_ilu._drop_small(L, tol)
        assert Dp.nnz == Dt.nnz and abs(Dp - Dt).max() == 0
    assert port._drop_small(L, 0.2).nnz < L.nnz
    for cap in (0, 4, 10, 100):
        Cp, Ct = port._cap_row_nnz(L, cap), tp_ilu._cap_row_nnz(L, cap)
        assert Cp.nnz == Ct.nnz and abs(Cp - Ct).max() == 0
    assert port._cap_row_nnz(L, 4).nnz < L.nnz
    np.testing.assert_array_equal(port._rcm_permutation(S),
                                  tp_ilu._rcm_permutation(S))


@pytest.mark.parametrize("cfg", [dict(ilu_type=1), dict(ilu_fill_level=1),
                                 dict(ilu_local_reordering=1)])
def test_options_equal_tpusolve(tpi, cfg):
    """ILUT, ILU(1) and RCM local reordering through ilu_setup in each
    package: the same notes, and the applications agree to 1e-12."""
    from tpusolve.config import ILUConfig as TpILUConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix.vectors import to_device_vector as tp_vec
    tp_ilu, mesh = tpi
    S = momentum(8).tocoo()
    n = S.shape[0]
    A = ShardedMatrix.from_coo(S.shape, S.row, S.col, S.data, device=CPU)
    pre = ilu_setup(A, ILUConfig(**cfg), A_host=S.tocsr())
    At = TpMatrix.from_coo(mesh, S.shape, S.row, S.col, S.data,
                           dtype=np.float64)
    pre_t = tp_ilu.ilu_setup(At, TpILUConfig(**cfg), A_host=S.tocsr())
    assert pre.notes == pre_t.notes
    assert abs(pre.L.to_scipy() - pre_t.L.to_scipy()).max() \
        <= 1e-14 * abs(pre_t.L.to_scipy()).max()
    r = np.random.default_rng(5).standard_normal(n)
    z_t = np.asarray(pre_t.apply(tp_vec(mesh, r, At.row_offsets, At.row_pad)))
    z = pre.apply(to_device_vector(r, A.row_offsets, A.row_pad, CPU)).numpy()
    np.testing.assert_allclose(z, z_t, rtol=0, atol=1e-12 * np.abs(z_t).max())


@pytest.mark.parametrize("option", ["fill1", "ilut", "rcm"])
def test_gate4_options_count_equals_tpusolve(tmp_path, monkeypatch, capsys,
                                             option):
    """The RCM'd gate-4 fixture at 16^3 in double with each host ILU option
    (``fixtures.ILU_OPTIONS``) through both CLIs: the same count and
    relres, both golden checks passed."""
    from tpusolve_torch import fixtures
    from test_torch_slice import _run_port, _run_tpusolve
    path = fixtures.write_gate4(
        str(tmp_path), 16, precision="double",
        ilu_preconditioner_settings=fixtures.ILU_OPTIONS[option])
    rc_t, out_t, x_t, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, x, _, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    solve = [ln for ln in out.splitlines() if ln.startswith("Solve 0:")]
    assert solve == [ln for ln in out_t.splitlines()
                     if ln.startswith("Solve 0:")]
    assert "Check solution: PASSED" in out_t
    np.testing.assert_allclose(x, x_t, rtol=0, atol=1e-10 * np.abs(x_t).max())
