"""tpusolve_torch's level-0 device setup (amg/device_setup.py) against
tpusolve's ``device_level0`` and against the port's own host pipeline.

On the 27-point stencil at 8^3, 12^3 and 16^3 in f64, for direct (3) and
classical-modified (0) interpolation, the port's stages on the CPU give
tpusolve's C/F split exactly and its P, R and coarse operator to 1e-12
relative, each recording tpusolve's layout for them, ELL (tpusolve on the ``mesh1`` fixture with
``TPUSOLVE_PMIS_HOST_RANK=1`` and ``TPUSOLVE_DEVICE_SETUP_MIN_N=1``, set by
``monkeypatch``).  The hierarchy the port builds with its device level 0 is
the one its host pipeline builds, on the box form and on an assembled 1-D
DIA operator (with ``device_min_n=1`` the levels below recurse on the
device by the generic-ELL setup, as ``tpusolve``'s do under
``TPUSOLVE_DEVICE_SETUP_MIN_N=1``); ineligible configs and operators take
the host pipeline, as in ``tests/test_device_setup.py``.  The CUDA cases
hold the card's device setup against the host pipeline at 16^3 and 32^3,
and the weak-scaling YAML's PCG count at 128^3 to the same 23 with either
setup of level 0, in f32 and f64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import builder, device_setup, device_setup_ell
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.stencil import laplace27

CPU = torch.device("cpu")
TOL = 1e-12
DEVICE_NOTE = ("level 0 setup on device (DIA offset algebra: "
               "strength/PMIS/interp/RAP as shifted streaming ops)")
RECURSION_NOTE = "coarse levels recursed on device (generic ELL setup)"


def rel_diff(X, Y) -> float:
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return abs(X - Y).max() / max(abs(Y).max(), 1e-300)


def pattern(M) -> set:
    M = sp.csr_matrix(M).copy()
    M.eliminate_zeros()
    Mc = M.tocoo()
    return set(zip(Mc.row.tolist(), Mc.col.tolist()))


@pytest.fixture
def tp(monkeypatch, mesh1):
    pytest.importorskip("jax")
    from tpusolve.amg import device_setup as tds
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.stencil import laplace27 as tp_laplace27
    monkeypatch.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
    monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
    return dict(ds=tds, Config=TpConfig, laplace27=tp_laplace27, mesh=mesh1)


@pytest.mark.parametrize("interp_type", [0, 3])
@pytest.mark.parametrize("side", [8, 12, 16])
def test_level0_equals_tpusolve(tp, side, interp_type):
    At, _, _ = tp["laplace27"](tp["mesh"], side, side, side,
                               dtype=np.float64)
    cfg_t = tp["Config"](max_coarse_size=64, interp_type=interp_type)
    assert tp["ds"].eligible(At, cfg_t)
    res_t = tp["ds"].device_level0(At, cfg_t)
    A, _, _ = laplace27(side, side, side, device=CPU, dtype=np.float64)
    cfg = BoomerAMGConfig(max_coarse_size=64, interp_type=interp_type)
    assert device_setup.eligible(A, cfg, min_n=1)
    assert not device_setup.eligible(A, cfg)     # below MIN_DEVICE_N
    res = device_setup.device_level0(A, cfg)
    assert res["nc"] == res_t["nc"] > 0
    np.testing.assert_array_equal(res["Cmask"].numpy(),
                                  np.asarray(res_t["Cmask"]))
    for key in ("P", "R", "Ac"):
        # tpusolve's _ell_sharded makes them ELL; the port records that
        assert not (res_t[key].uses_dia or res_t[key].uses_bdia
                    or res_t[key].uses_bell)
        assert res[key].uses_ell and res[key].tpusolve_layout == "ell", key
        M, M_t = res[key].to_scipy(), res_t[key].to_scipy()
        assert M.shape == M_t.shape
        assert pattern(M) == pattern(M_t), key
        assert rel_diff(M, M_t) <= TOL, key
        assert res[key].nnz == res_t[key].nnz
    Ah, Ah_t = res["Ah_c_fn"](), res_t["Ah_c_fn"]()
    assert Ah.has_sorted_indices and rel_diff(Ah, Ah_t) <= TOL
    for key in ("dinv", "dinv_l1"):
        np.testing.assert_allclose(res[key].numpy(),
                                   np.asarray(res_t[key]).reshape(-1),
                                   rtol=TOL)
    assert set(res["seconds"]) == {"strength+PMIS", "interpolation",
                                   "P/R compaction", "galerkin RAP",
                                   "coarse A compaction"}


def _hierarchies(A, cfg):
    """(device, all host) hierarchies of the port on ``A``: with
    ``device_min_n=1`` level 0 is set up by the DIA setup and the levels
    below it by the generic-ELL one."""
    return (builder.boomeramg_setup(A, cfg, device_min_n=1),
            builder.boomeramg_setup(A, cfg, device_min_n=None))


def check_same_hierarchy(pre_d, pre_h, tol=TOL):
    assert pre_d.num_levels == pre_h.num_levels >= 3
    for d, h in zip(pre_d.levels, pre_h.levels):
        assert (d.n, d.nnz) == (h.n, h.nnz)
        assert rel_diff(d.A.to_scipy(), h.A.to_scipy()) <= tol
        if h.P is not None:
            assert rel_diff(d.P.to_scipy(), h.P.to_scipy()) <= tol
            assert rel_diff(d.R.to_scipy(), h.R.to_scipy()) <= tol
    assert pre_d.notes == pre_h.notes + [DEVICE_NOTE, RECURSION_NOTE]
    assert pre_h.setup_seconds == {}
    assert "host levels" in pre_d.setup_seconds
    assert "level 1 strength+PMIS" in pre_d.setup_seconds


@pytest.mark.parametrize("interp_type", [0, 3])
def test_hierarchy_equals_host_pipeline(interp_type):
    """At 16^3 the device level 0 gives the host pipeline's hierarchy, its
    coarse A an ELL operator (as tpusolve's), and PCG the same count."""
    cfg = BoomerAMGConfig(max_coarse_size=64, interp_type=interp_type,
                          relax_type=18)
    A, b, _ = laplace27(16, 16, 16, device=CPU, dtype=np.float64)
    pre_d, pre_h = _hierarchies(A, cfg)
    check_same_hierarchy(pre_d, pre_h)
    assert pre_d.layouts()[1].startswith("AMG level 1: A ELL")
    assert pre_d.levels[0].P.layout.startswith("ELL")
    res_d = pcg_setup(A, pre_d.apply, tol=1e-8, maxiter=60)(b)
    res_h = pcg_setup(A, pre_h.apply, tol=1e-8, maxiter=60)(b)
    assert bool(res_d.converged) and res_d.iters == res_h.iters
    np.testing.assert_allclose(res_d.x.numpy(), res_h.x.numpy(), rtol=0,
                               atol=1e-10)


def test_cf_order_takes_the_device_split():
    """CF-ordered relaxation takes the device setup's C mask: one cycle
    agrees with the host pipeline's."""
    cfg = BoomerAMGConfig(max_coarse_size=64, relax_order=1)
    A, _, _ = laplace27(12, 12, 12, device=CPU, dtype=np.float64)
    pre_d, pre_h = _hierarchies(A, cfg)
    torch.testing.assert_close(pre_d.levels[0].cmask, pre_h.levels[0].cmask,
                               rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(A.shape[0]))
    z_d, z_h = pre_d.apply(r), pre_h.apply(r)
    torch.testing.assert_close(z_d, z_h, rtol=0,
                               atol=1e-10 * float(z_h.abs().max()))


def test_power_lambda_equals_tpusolve(tp):
    """Chebyshev on a device level 0 takes lambda_max(D^-1 A) by power
    iteration on the device, from tpusolve's start vector: tpusolve's
    ``power_lambda`` to f32 roundoff (in f64 it raises: its f32 start vector
    meets f64 planes in its loop carry; ROADMAP Queue 3); the level's bounds
    are built from it."""
    At, _, _ = tp["laplace27"](tp["mesh"], 12, 12, 12, dtype=np.float32)
    res_t = tp["ds"].device_level0(At, tp["Config"](max_coarse_size=64,
                                                    interp_type=3))
    lam_t = tp["ds"].power_lambda(At, res_t["dinv"])
    A, _, _ = laplace27(12, 12, 12, device=CPU, dtype=np.float32)
    cfg = BoomerAMGConfig(max_coarse_size=64, interp_type=3, relax_type=16)
    res = device_setup.device_level0(A, cfg)
    lam = device_setup.power_lambda(A, res["dinv"])
    assert abs(lam - lam_t) <= 1e-5 * lam_t
    pre = builder.boomeramg_setup(A, cfg, device_min_n=1)
    assert pre.levels[0].cheby_bounds == (cfg.cheby_fraction * lam,
                                          1.1 * lam)


def test_one_dimensional_dia_operator():
    """A 2-D 5-point operator assembled from CSR is the 1-D DIA form
    (triples (0, 0, offset)); its device setup equals the host pipeline."""
    n = 48
    lap = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                   [-1, 0, 1])
    H = (sp.kron(sp.eye(n), lap) + sp.kron(lap, sp.eye(n))).tocsr()
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64)
    assert A.uses_dia and A.dia_shape is None
    assert A.dia_offsets == ((0, 0, -n), (0, 0, -1), (0, 0, 0), (0, 0, 1),
                             (0, 0, n))
    cfg = BoomerAMGConfig(max_coarse_size=32, strong_threshold=0.25)
    assert device_setup.eligible(A, cfg, min_n=1)
    pre_d, pre_h = _hierarchies(A, cfg)
    check_same_hierarchy(pre_d, pre_h)


def test_ineligible_configs_take_host_pipeline():
    """Mirrors tests/test_device_setup.py:99: aggressive coarsening,
    truncation, RS coarsening, extended+i, complex smoothers and a non-DIA
    operator are refused by ``eligible``; the setup then runs the host
    pipeline, with no device note and no stage seconds."""
    A, _, _ = laplace27(8, 8, 8, device=CPU, dtype=np.float64)
    for kw in (dict(agg_num_levels=1), dict(trunc_factor=0.2),
               dict(p_max_elmts=4), dict(coarsen_type=6),
               dict(interp_type=6), dict(smooth_type=5, smooth_num_levels=1),
               dict(non_galerkin_tol=0.1)):
        assert not device_setup.eligible(A, BoomerAMGConfig(**kw),
                                         min_n=1), kw
    assert device_setup.eligible(A, BoomerAMGConfig(), min_n=1)
    assert not device_setup.eligible(A, BoomerAMGConfig())
    for kw in (dict(trunc_factor=0.2), dict(interp_type=6)):
        pre = builder.boomeramg_setup(
            A, BoomerAMGConfig(max_coarse_size=32, **kw), device_min_n=1)
        assert DEVICE_NOTE not in pre.notes
        assert "strength+PMIS" not in pre.setup_seconds
        assert pre.num_levels >= 2
        # extended+i is the generic-ELL setup's: level 1, an ELL operator
        # with its host CSR, is set up on the device (tpusolve's recursion)
        assert (RECURSION_NOTE in pre.notes) == ("interp_type" in kw)
        assert (pre.setup_seconds == {}) == ("trunc_factor" in kw)
    B = ShardedMatrix.from_csr_host(A.to_scipy(), device=CPU,
                                    dtype=np.float64, allow_dia=False)
    assert not B.uses_dia
    assert not device_setup.eligible(B, BoomerAMGConfig(), min_n=1)


def test_ell_setup_note():
    """The generic-ELL device setup's eligibility (``tpusolve``'s
    ``device_setup_ell.eligible``) on the operators where the host pipeline
    used to stand in: a DIA operator of 2^19 rows is eligible with its host
    CSR (tpusolve stores it DIA, so its ELL source is the CSR), not without
    one, nor for multipass interpolation; below the row floor only with a
    floor lowered, and never with the floor off."""
    cfg = BoomerAMGConfig()
    n = device_setup_ell.MIN_DEVICE_N
    H = sp.diags([-1.0, 2.5, -1.0], [-7, 0, 7], shape=(n, n)).tocsr()
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64)
    assert A.uses_dia and A.tpusolve_layout == "dia"
    assert device_setup_ell.eligible(A, cfg, H)
    assert not device_setup_ell.eligible(A, cfg, None)
    assert not device_setup_ell.eligible(
        A, BoomerAMGConfig(interp_type=4), H)
    assert not device_setup_ell.eligible(A, cfg, H, min_n=None)
    small = ShardedMatrix.from_csr_host(H[:1000, :1000], device=CPU)
    assert not device_setup_ell.eligible(small, cfg, H[:1000, :1000])
    assert device_setup_ell.eligible(small, cfg, H[:1000, :1000], min_n=1)


def test_pmis_rank_and_keys():
    """The ranks are the inverse permutation of the host randoms' order
    (padding rows rank 0); a key orders by influence, then rank."""
    rank = device_setup.pmis_rank(7, 5, 8)
    r = np.random.default_rng(7).random(5)
    assert list(rank[:5]) == list(np.argsort(np.argsort(r)))
    assert list(rank[5:]) == [0, 0, 0]
    infl = torch.tensor([2.0, 2.0, 0.0, 1.0])
    keys = device_setup._pmis_keys(infl, torch.tensor([3, 0, 1, 2]))
    assert keys.tolist() == [2 * 4 + 4, 2 * 4 + 1, 2, 4 + 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("side", [16, 32])
def test_device_setup_on_cuda_equals_host(cuda, side):
    """Needs only the card: the device setup of the card at 16^3 and 32^3
    in f64 gives the host pipeline's split, P, R and coarse A to 1e-12,
    with K1 running the level-0 SpMVs of the cycle."""
    from tpusolve_torch.kernels.dia import dia_spmv
    cfg = BoomerAMGConfig(max_coarse_size=64, relax_type=18)
    A, b, _ = laplace27(side, side, side, device=cuda, dtype=np.float64)
    res = device_setup.device_level0(A, cfg)
    pre_h = builder.boomeramg_setup(A, cfg, device_min_n=None)
    assert res["nc"] == pre_h.levels[1].n
    for key, M_h in (("P", pre_h.levels[0].P), ("R", pre_h.levels[0].R),
                     ("Ac", pre_h.levels[1].A)):
        assert rel_diff(res[key].to_scipy(), M_h.to_scipy()) <= TOL, key
    pre_d = builder.boomeramg_setup(A, cfg, device_min_n=1)
    dia_spmv.launches = 0
    res_d = pcg_setup(A, pre_d.apply, tol=1e-8, maxiter=60)(b)
    res_h = pcg_setup(A, pre_h.apply, tol=1e-8, maxiter=60)(b)
    assert dia_spmv.launches > 0 and bool(res_d.converged)
    assert res_d.iters == res_h.iters


# PCG iterations of the weak-scaling YAML at 128^3: tpusolve's on the CPU
# (TPUSOLVE_PMIS_HOST_RANK=1) and the port's through the CLI on the card
WEAKSCALE_ITERS_128 = 23


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_weakscale_count_on_cuda_independent_of_setup(cuda, dtype):
    """Needs only the card: the settings of
    ``examples/weakscale_pcg_boomeramg_devsetup.yaml`` at 128^3 take the
    same PCG iterations with level 0 set up on the card and by the host
    pipeline, in f32 and in f64, so the count belongs to the method, not to
    the device setup or the precision.  Prints each setup's seconds (seen
    under ``pytest -s``)."""
    import os
    import time
    from tpusolve_torch.config import load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        repo, "examples", "weakscale_pcg_boomeramg_devsetup.yaml"))
    ls, s = cfg.linear_system, cfg.solver
    A, b, _ = laplace27(ls.nx, ls.ny, ls.nz, device=cuda, dtype=dtype)
    for where, min_n in (("card", (1, None)), ("host pipeline", None)):
        torch.cuda.synchronize(cuda)
        t0 = time.perf_counter()
        pre = builder.boomeramg_setup(A, cfg.boomeramg, device_min_n=min_n)
        torch.cuda.synchronize(cuda)
        t_setup = time.perf_counter() - t0
        res = pcg_setup(A, pre.apply, tol=s.tolerance,
                        maxiter=s.max_iterations)(b)
        print(f"weakscale {ls.nx}^3 {np.dtype(dtype).name}, level 0 set up "
              f"by the {where}: levels {[lev.n for lev in pre.levels]}, "
              f"setup {t_setup:.3f} s, {res.iters} PCG iterations, relres "
              f"{float(res.relres):.3e}")
        assert bool(res.converged) and res.iters == WEAKSCALE_ITERS_128
        del pre
