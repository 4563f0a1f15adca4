"""tpusolve_torch BoomerAMG host setup and V-cycle against tpusolve's.

On the gate-3 pressure fixture (the 27-pt SPD system of tools/gatefix.py
after RCM, as the harness orders it) both packages build the hierarchy of
gate 3's settings: PMIS, extended+i, strength threshold 0.25, l1-Jacobi.
The PMIS splittings are equal level by level; strength, P and the Galerkin
operators agree to 1e-12 relative (both packages run the same native C++
kernels, each built with its own compiler flags).  One V-cycle on
operators carried over from tpusolve agrees to 1e-12 relative in f64.
Also: the main-diagonal repair for rectangular operators, the RS coarsen
codes, and the interpolation, smoother and truncation options.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import builder, coarsen, galerkin, interp, strength
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.fixtures import make_system
from tpusolve_torch.matrix.sharded import ShardedMatrix
from test_torch_sharded import k2_priced_out, tpusolve_fields

CPU = torch.device("cpu")
GATE3 = dict(coarsen_type=8, interp_type=6, strong_threshold=0.25,
             relax_type=18, max_levels=20)
TOL = 1e-12


def gate3_csr(side: int) -> sp.csr_matrix:
    """The gate-3 pressure matrix at side^3 in the harness's RCM order."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    rows, cols, vals, _, n = make_system(side, side, side, seed=7)
    pat = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                        shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(pat + pat.T, symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    A = sp.csr_matrix((vals, (inv[rows], inv[cols])), shape=(n, n))
    A.sum_duplicates()
    return A


def rel_diff(X, Y) -> float:
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return abs(X - Y).max() / max(abs(Y).max(), 1e-300)


def pattern(M) -> set:
    M = sp.csr_matrix(M).copy()
    M.eliminate_zeros()
    Mc = M.tocoo()
    return set(zip(Mc.row.tolist(), Mc.col.tolist()))


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve.amg import builder as tb
    from tpusolve.amg import coarsen as tc
    from tpusolve.amg import galerkin as tg
    from tpusolve.amg import interp as ti
    from tpusolve.amg import strength as ts
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix import vectors as tpv
    from tpusolve.mesh import make_mesh
    return dict(builder=tb, coarsen=tc, galerkin=tg, interp=ti, strength=ts,
                Config=TpConfig, Matrix=TpMatrix, vec=tpv,
                mesh=make_mesh(1))


@pytest.fixture(scope="module")
def A32():
    return gate3_csr(32)


@pytest.fixture(scope="module")
def A16():
    return gate3_csr(16)


@pytest.fixture(scope="module")
def hierarchies(tp, A32):
    """(tpusolve's, the port's) gate-3 hierarchies at 32^3 in f64."""
    At = tp["Matrix"].from_csr_host(tp["mesh"], A32, dtype=np.float64)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**GATE3),
                                          A_host=A32)
    A = ShardedMatrix.from_csr_host(A32, device=CPU, dtype=np.float64)
    pre = builder.boomeramg_setup(A, BoomerAMGConfig(**GATE3), A_host=A32)
    return pre_t, pre


class TestSetupPieces:
    def test_level_by_level_equal_tpusolve(self, tp, A32):
        """Strength, PMIS, extended+i P and RAP of both packages on each
        level's operator, down the port's hierarchy."""
        Ah, lvl, nlev = A32, 0, 0
        while Ah.shape[0] > 64:
            S = strength.classical_strength(Ah, 0.25)
            S_t = tp["strength"].classical_strength(Ah, 0.25)
            assert pattern(S) == pattern(S_t)
            split = coarsen.pmis(S, seed=1234 + lvl)
            np.testing.assert_array_equal(
                split, tp["coarsen"].pmis(S_t, seed=1234 + lvl))
            P = interp.extended_i_interpolation(Ah, S, split)
            P_t = tp["interp"].extended_i_interpolation(Ah, S_t, split)
            assert pattern(P) == pattern(P_t)
            assert rel_diff(P, P_t) <= TOL
            Ac = galerkin.rap(Ah, P)
            assert rel_diff(Ac, tp["galerkin"].rap(Ah, P_t)) <= TOL
            Ah, lvl, nlev = Ac, lvl + 1, nlev + 1
        assert nlev >= 2

    @pytest.mark.parametrize("itype", [0, 3, 4, 6, 8])
    def test_interpolation_types_equal_tpusolve(self, tp, A16, itype):
        S = strength.classical_strength(A16, 0.25)
        split = coarsen.pmis(S)
        P, note = interp.build_interpolation(A16, S, split, itype)
        P_t, note_t = tp["interp"].build_interpolation(A16, S, split, itype)
        assert note == note_t
        assert P.shape == P_t.shape and rel_diff(P, P_t) <= TOL

    @pytest.mark.parametrize("trunc, pmax", [(0.2, 0), (0.0, 4), (0.1, 3)])
    def test_truncation_equal_tpusolve(self, tp, A16, trunc, pmax):
        S = strength.classical_strength(A16, 0.25)
        split = coarsen.pmis(S)
        P = interp.extended_i_interpolation(A16, S, split)
        out = interp.truncate(P, trunc, pmax)
        out_t = tp["interp"].truncate(P, trunc, pmax)
        assert pattern(out) == pattern(out_t)
        assert rel_diff(out, out_t) <= TOL

    @pytest.mark.parametrize("code", [0, 7, 8, 10, 21])
    def test_pmis_codes_equal_tpusolve(self, tp, A16, code):
        S = strength.classical_strength(A16, 0.25)
        split, note = coarsen.coarsen(S, code, seed=99)
        split_t, note_t = tp["coarsen"].coarsen(S, code, seed=99)
        np.testing.assert_array_equal(split, split_t)
        assert note == note_t

    @pytest.mark.parametrize("code", [1, 3, 6])
    def test_rs_codes_raise(self, tp, A16, code):
        """The RS codes raised until the native kernels were ported; now
        they run serial RS, and the split and note equal tpusolve's."""
        S = strength.classical_strength(A16, 0.25)
        split, note = coarsen.coarsen(S, code)
        split_t, note_t = tp["coarsen"].coarsen(S, code)
        np.testing.assert_array_equal(split, split_t)
        assert note == note_t
        assert 0 < split.sum() < split.size

    def test_aggressive_pmis_equal_tpusolve(self, tp, A16):
        S = strength.classical_strength(A16, 0.25)
        np.testing.assert_array_equal(
            coarsen.aggressive_pmis(S, seed=5),
            tp["coarsen"].aggressive_pmis(S, seed=5))

    def test_nongalerkin_equal_tpusolve(self, tp, A16):
        out = galerkin.nongalerkin_sparsify(A16, 0.3)
        assert rel_diff(out, tp["galerkin"].nongalerkin_sparsify(A16, 0.3)) \
            <= TOL


class TestHierarchy:
    def test_levels_equal_tpusolve(self, hierarchies):
        pre_t, pre = hierarchies
        assert pre.num_levels == pre_t.num_levels >= 3
        for lev, lev_t in zip(pre.levels, pre_t.levels):
            assert (lev.n, lev.nnz) == (lev_t.n, lev_t.nnz)
            assert rel_diff(lev.A.to_scipy(), lev_t.A.to_scipy()) <= TOL
            if lev_t.P is not None:
                assert rel_diff(lev.P.to_scipy(), lev_t.P.to_scipy()) <= TOL
                assert rel_diff(lev.R.to_scipy(), lev_t.R.to_scipy()) <= TOL
                assert not lev.P.uses_bell and not lev.P.uses_bdia
            np.testing.assert_allclose(lev.dinv_l1.numpy(),
                                       np.asarray(lev_t.dinv_l1), rtol=TOL)
        np.testing.assert_allclose(pre.coarse_inv.numpy(),
                                   np.asarray(pre_t.coarse_inv), rtol=0,
                                   atol=TOL * np.abs(pre.coarse_inv.numpy())
                                   .max())
        assert pre.describe() == pre_t.describe()

    def test_hierarchy_holds_a_bell_level(self, A32, monkeypatch):
        """With K2 priced out of the choice (tpusolve's candidates), the
        gate-3 hierarchy at 32^3 runs K4 on level 0 and K6 on a coarse level
        (tests/test_torch_ell_rowptr.py holds the choice with K2 priced)."""
        k2_priced_out(monkeypatch)
        A = ShardedMatrix.from_csr_host(A32, device=CPU, dtype=np.float64)
        pre = builder.boomeramg_setup(A, BoomerAMGConfig(**GATE3),
                                      A_host=A32)
        layouts = pre.layouts()
        assert any(lev.A.uses_bell for lev in pre.levels), layouts
        assert pre.levels[0].A.uses_bdia, layouts
        assert len(layouts) == pre.num_levels

    def test_one_cycle_on_carried_operators(self, tp, hierarchies):
        """tpusolve's own operators (BDIA, BELL, ELL and a DIA coarsest
        level, as scipy) carried into the port: one V-cycle agrees."""
        pre_t, _ = hierarchies
        pre = carried(pre_t, GATE3)
        layouts = {lev.A.layout.split()[0] for lev in pre.levels}
        assert {"BDIA", "BELL"} <= layouts
        check_cycle(tp, pre_t, pre, seed=3)

    def test_cycle_equals_tpusolve_on_own_setup(self, tp, hierarchies):
        pre_t, pre = hierarchies
        check_cycle(tp, pre_t, pre, seed=4)


def carried(pre_t, cfg_kw):
    """The port's preconditioner on tpusolve's hierarchy, via
    hierarchy_from_arrays."""
    def op(M):
        if M is None:
            return None
        return M.to_scipy() if M.uses_dia else tpusolve_fields(M)
    vec = lambda a: None if a is None else np.asarray(a)
    levels = [dict(A=op(lev.A), P=op(lev.P), R=op(lev.R),
                   dinv=vec(lev.dinv), dinv_l1=vec(lev.dinv_l1),
                   cmask=vec(lev.cmask), cheby_bounds=lev.cheby_bounds)
              for lev in pre_t.levels]
    return builder.hierarchy_from_arrays(
        levels, np.asarray(pre_t.coarse_inv), BoomerAMGConfig(**cfg_kw), CPU)


def check_cycle(tp, pre_t, pre, seed):
    A0 = pre_t.levels[0].A
    r = np.random.default_rng(seed).standard_normal(A0.shape[0])
    z_t = np.asarray(pre_t.apply(tp["vec"].to_device_vector(
        tp["mesh"], r, A0.row_offsets, A0.row_pad)))
    z = pre.apply(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(z, z_t, rtol=0,
                               atol=TOL * np.abs(z_t).max())


@pytest.mark.parametrize("extra", [dict(relax_type=0),
                                   dict(relax_type=16),
                                   dict(relax_type=16, cheby_variant=4),
                                   dict(relax_order=1),
                                   dict(cycle_type=2),
                                   dict(relax_coarse=18)])
def test_cycle_options_on_carried_operators(tp, A16, extra):
    """Jacobi, both Chebyshev kinds, CF order, the W-cycle and coarse
    relaxation: one cycle on tpusolve's operators agrees."""
    kw = dict(GATE3, **extra)
    At = tp["Matrix"].from_csr_host(tp["mesh"], A16, dtype=np.float64)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**kw),
                                          A_host=A16)
    check_cycle(tp, pre_t, carried(pre_t, kw), seed=5)


def test_rectangular_diag_equals_tpusolve(tp, A16):
    """A rectangular one-part operator (P of the AMG fixture) has no main
    diagonal: its ``diag`` equals tpusolve's, where the square A's is A's
    diagonal."""
    S = strength.classical_strength(A16, 0.25)
    split = coarsen.pmis(S)
    P = interp.extended_i_interpolation(A16, S, split)
    n, nc = P.shape
    ro, co = np.array([0, n]), np.array([0, nc])
    Pp = ShardedMatrix.from_csr_host(P, device=CPU, dtype=np.float64,
                                     row_offsets=ro, col_offsets=co,
                                     allow_bdia=False, allow_bell=False)
    Pt = tp["Matrix"].from_csr_host(tp["mesh"], P, dtype=np.float64,
                                    row_offsets=ro, col_offsets=co,
                                    allow_bell=False, allow_bdia=False)
    np.testing.assert_array_equal(Pp.diag.numpy(), np.asarray(Pt.diag))
    assert not Pp.diag.any()
    A = ShardedMatrix.from_csr_host(A16, device=CPU, dtype=np.float64)
    np.testing.assert_array_equal(A.diag.numpy()[0], A16.diagonal())


@pytest.mark.parametrize("smooth", [
    dict(smooth_type=5, smooth_num_levels=1),
    dict(smooth_type=9, smooth_num_levels=2, smooth_num_sweeps=2),
    dict(smooth_type=6, smooth_num_levels=1),
    dict(smooth_type=8, smooth_num_levels=1)])
def test_ilu_smoothers_equal_tpusolve(tp, A16, smooth):
    """ILU smoothers on the finest levels (``smooth_type`` 5, 6, 7, 9; 8
    leaves the relaxation and says so): each package sets its hierarchy up;
    the notes are the same, the levels carry ILU factors equal to
    tpusolve's and one cycle agrees."""
    kw = dict(GATE3, **smooth)
    At = tp["Matrix"].from_csr_host(tp["mesh"], A16, dtype=np.float64)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**kw),
                                          A_host=A16)
    A = ShardedMatrix.from_csr_host(A16, device=CPU, dtype=np.float64)
    pre = builder.boomeramg_setup(A, BoomerAMGConfig(**kw), A_host=A16)
    assert pre.notes == pre_t.notes
    assert any(f"smooth_type {smooth['smooth_type']}" in n for n in pre.notes)
    for lev, lev_t in zip(pre.levels, pre_t.levels):
        assert (lev.ilu_L is None) == (lev_t.ilu_L is None)
        if lev.ilu_L is not None:
            for M, M_t in ((lev.ilu_L, lev_t.ilu_L), (lev.ilu_U, lev_t.ilu_U)):
                d = abs(M.to_scipy() - M_t.to_scipy())
                assert d.max() <= 1e-14 * abs(M_t.to_scipy()).max()
    assert sum(lev.ilu_L is not None for lev in pre.levels) == (
        smooth["smooth_num_levels"] if smooth["smooth_type"] != 8 else 0)
    check_cycle(tp, pre_t, pre, seed=6)


@pytest.mark.parametrize("cfg, match", [
    (dict(smoother_dtype="bfloat16"), "bfloat16")])
def test_unported_options_raise(tp, A16, cfg, match):
    """The bfloat16 smoother twin, refused before it was ported, now runs:
    its twins sit on the levels where ``tpusolve`` has one, in bf16, and
    one cycle equals ``tpusolve``'s to 1e-12 (the same bf16 values, summed
    in f64 in another order).  A lattice dict given with a one-part
    operator, which raised before the multi-part setup was ported, is left
    unused, as ``tpusolve`` leaves it (its sharded setup takes N parts)."""
    A = ShardedMatrix.from_csr_host(A16, device=CPU, dtype=np.float64)
    pre = builder.boomeramg_setup(A, BoomerAMGConfig(**cfg), A_host=A16)
    At = tp["Matrix"].from_csr_host(tp["mesh"], A16, dtype=np.float64)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**cfg),
                                          A_host=A16)
    twins = [lev.A_relax is not None for lev in pre.levels]
    assert twins == [lev.A_relax is not None for lev in pre_t.levels]
    assert any(twins), match
    assert all(lev.A_relax.dtype == torch.bfloat16
               for lev in pre.levels if lev.A_relax is not None)
    check_cycle(tp, pre_t, pre, seed=6)
    lat = builder.boomeramg_setup(A, BoomerAMGConfig(), A_host=A16,
                                  lattice_parts=object())
    lat_t = tp["builder"].boomeramg_setup(At, tp["Config"](), A_host=A16,
                                          lattice_parts=object())
    assert lat.describe() == lat_t.describe() and not lat.device_setups
