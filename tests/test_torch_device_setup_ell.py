"""tpusolve_torch's generic-ELL device setup (``amg/device_setup_ell.py``)
against tpusolve's (``tpusolve/amg/device_setup_ell.py``) and against the
port's own host pipeline.

The same numpy operators go through both packages on the CPU in f64.  On
the scrambled 2-D Laplacian of ``tests/test_device_setup_ell.py`` at 32^2,
with direct (3) and classical-modified (0) interpolation (extended+i:
``tests/test_torch_device_setup_ell_exti.py``), the port's hierarchy with
every level set up on the device (``device_min_n=1``) is tpusolve's
(``TPUSOLVE_PMIS_HOST_RANK=1``, ``TPUSOLVE_DEVICE_SETUP_MIN_N=1``) at every
level, to tpusolve's own tolerances: the C/F split identical, P within
1e-11, R = P^T exactly, the coarse A within 1e-10; the notes are the same
and PCG takes the same count.  tpusolve's setups run once a module.  The
port's device setup equals its host pipeline on tpusolve's classical sign
and lumping case and its direct Dirichlet case; ``eligible`` decides as
tpusolve's on an ELL operator, on operators the two packages lay out
differently, and at widths 128 and 129, with and without a host CSR.  The
CUDA cases run the setup on the card against the same code on the CPU, bit
for bit in f64, and again on the card; they skip without one.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import builder, device_setup_ell
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix

CPU = torch.device("cpu")
TOL_P, TOL_A = 1e-11, 1e-10
ELL_NOTE = ("level 0 setup on device (generic ELL: PMIS via gather/scatter "
            "rounds, RAP as sort-based SpGEMM)")
RECURSION_NOTE = "coarse levels recursed on device (generic ELL setup)"


def scrambled_laplace(n_side: int, seed: int = 0) -> sp.csr_matrix:
    """2-D 5-point Laplacian under a random symmetric permutation
    (``tests/test_device_setup_ell.py:28``)."""
    n = n_side * n_side
    L1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n_side, n_side))
    A2 = sp.kronsum(L1, L1, format="csr")
    perm = np.random.default_rng(seed).permutation(n)
    Pm = sp.csr_matrix((np.ones(n), (np.arange(n), perm)), shape=(n, n))
    A = (Pm @ A2 @ Pm.T).tocsr()
    A.sort_indices()
    return A


def tosp(M) -> sp.csr_matrix:
    return M.to_scipy().tocsr()


def maxdiff(X, Y) -> float:
    d = abs(sp.csr_matrix(X) - sp.csr_matrix(Y))
    return d.max() if d.nnz else 0.0


def port_matrix(H) -> ShardedMatrix:
    return ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                       allow_bell=False, allow_bdia=False)


def rhs(n: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(n)


def check_levels(levs, levs_ref, splits: bool = True):
    """Every level of the port's hierarchy against a reference one, each a
    list of dicts (n, cmask, P, R, A)."""
    assert [d["n"] for d in levs] == [d["n"] for d in levs_ref]
    for lvl, (d, h) in enumerate(zip(levs, levs_ref)):
        if lvl > 0:
            assert maxdiff(d["A"], h["A"]) < TOL_A, lvl
        if d["P"] is None:
            assert h["P"] is None
            continue
        if splits:
            np.testing.assert_array_equal(d["cmask"], h["cmask"])
        assert d["P"].shape == h["P"].shape
        assert maxdiff(d["P"], h["P"]) < TOL_P, lvl
        assert maxdiff(d["R"], h["R"]) < TOL_P, lvl
        # R = P^T exactly (the port's R against the port's P)
        assert maxdiff(d["R"], d["P"].T) == 0.0, lvl


def port_levels(pre) -> list:
    return [dict(n=lev.n, A=tosp(lev.A),
                 cmask=None if lev.cmask is None else lev.cmask.numpy(),
                 P=None if lev.P is None else tosp(lev.P),
                 R=None if lev.R is None else tosp(lev.R))
            for lev in pre.levels]


@pytest.fixture(scope="module")
def tp_setups():
    """tpusolve's hierarchy of the scrambled 32^2 Laplacian by interp type,
    with every level on its device (host ranks), built once: its levels,
    notes and PCG count."""
    pytest.importorskip("jax")
    from tpusolve.amg.builder import boomeramg_setup
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.krylov.cg import pcg_setup as tp_pcg
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix.vectors import to_device_vector
    from tpusolve.mesh import make_mesh
    mesh = make_mesh(1)
    H = scrambled_laplace(32)
    cache = {}

    def get(interp_type: int) -> dict:
        if interp_type in cache:
            return cache[interp_type]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
            mp.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
            At = TpMatrix.from_csr_host(mesh, H, dtype=np.float64,
                                        allow_bell=False, allow_bdia=False)
            pre = boomeramg_setup(At, config(interp_type), A_host=H)
        levs = [dict(n=lev.n, A=tosp(lev.A),
                     cmask=None if lev.cmask is None
                     else np.asarray(lev.cmask).reshape(-1)[:lev.n],
                     P=None if lev.P is None else tosp(lev.P),
                     R=None if lev.R is None else tosp(lev.R))
                for lev in pre.levels]
        b = to_device_vector(mesh, rhs(H.shape[0]), np.asarray(At.row_offsets),
                             At.row_pad, dtype=np.float64)
        res = tp_pcg(At, pre.apply, tol=1e-8, maxiter=80)(b)
        cache[interp_type] = dict(H=H, levels=levs, notes=list(pre.notes),
                                  iters=int(res.iters))
        return cache[interp_type]

    return get


def config(interp_type: int) -> BoomerAMGConfig:
    """The hierarchy tests' settings (CF-ordered relaxation keeps each
    level's C/F split on the level)."""
    return BoomerAMGConfig(interp_type=interp_type, max_coarse_size=64,
                           relax_order=1)


def hierarchy_case(tp_setups, interp_type):
    ref = tp_setups(interp_type)
    H = ref["H"]
    A = port_matrix(H)
    assert A.tpusolve_layout == "ell"
    assert device_setup_ell.eligible(A, config(interp_type), H, min_n=1)
    pre = builder.boomeramg_setup(A, config(interp_type), A_host=H,
                                  device_min_n=1)
    return ref, A, pre


@pytest.mark.parametrize("interp_type", [3, 0])
def test_hierarchy_equals_tpusolve(tp_setups, interp_type):
    ref, _, pre = hierarchy_case(tp_setups, interp_type)
    assert pre.num_levels >= 4 and pre.notes == ref["notes"]
    assert ELL_NOTE in pre.notes and RECURSION_NOTE in pre.notes
    check_levels(port_levels(pre), ref["levels"])
    # every level above the coarsest on the device, no host CSR fetched
    # but the coarsest's
    assert pre.host_fetches == [(pre.num_levels - 1, pre.levels[-1].n)]
    for lvl in range(1, pre.num_levels - 1):
        assert f"level {lvl} R@(AP)" in pre.setup_seconds
        assert pre.levels[lvl].A.tpusolve_layout == "ell"


@pytest.mark.parametrize("interp_type", [3, 0])
def test_pcg_count_equals_tpusolve(tp_setups, interp_type):
    ref, A, pre = hierarchy_case(tp_setups, interp_type)
    b = torch.from_numpy(rhs(A.shape[0]))
    res = pcg_setup(A, pre.apply, tol=1e-8, maxiter=80)(b)
    assert bool(res.converged) and res.iters == ref["iters"]


def host_and_device(H, cfg):
    """The port's hierarchies of ``H``: all on the device, all on the
    host."""
    A = port_matrix(H)
    return (builder.boomeramg_setup(A, cfg, A_host=H, device_min_n=1),
            builder.boomeramg_setup(A, cfg, A_host=H, device_min_n=None))


def sprinkled(seed_lap, seed_rows, nrows, seed_rand, density, value):
    """``tpusolve``'s sign and lumping operators
    (``tests/test_device_setup_ell.py:255``, ``:282``): the scrambled 30^2
    Laplacian with ``nrows`` identity rows and positive off-diagonal
    couplings, symmetrized."""
    Ah = scrambled_laplace(30, seed=seed_lap).tolil()
    rng = np.random.default_rng(seed_rows)
    for i in rng.integers(0, Ah.shape[0], size=nrows):
        Ah.rows[i] = [int(i)]
        Ah.data[i] = [1.0]
    Ah = Ah.tocsr()
    Ah = (Ah + sp.random(Ah.shape[0], Ah.shape[0], density=density,
                         random_state=seed_rand,
                         data_rvs=lambda k: value * np.ones(k))).tocsr()
    Ah = (Ah + Ah.T).tocsr() * 0.5
    Ah.sort_indices()
    return Ah


@pytest.mark.parametrize("case", ["classical_lump_and_sign",
                                  "direct_dirichlet_rows"])
def test_sign_and_lumping_equal_host_pipeline(case):
    """Classical interpolation's hat-entry sign filter and d_ik = 0
    lumping, and direct interpolation's alpha/beta/lump branches on
    identity rows and positive off-diagonals: the device setup's P and
    coarse A are the host pipeline's (tpusolve's 1e-12 and 1e-10)."""
    if case == "classical_lump_and_sign":
        H, itype = sprinkled(13, 6, 10, 3, 1e-3, 0.15), 0
    else:
        H, itype = sprinkled(11, 5, 12, 9, 5e-4, 0.1), 3
    pre_d, pre_h = host_and_device(H, BoomerAMGConfig(interp_type=itype,
                                                      max_coarse_size=32))
    assert ELL_NOTE in pre_d.notes and ELL_NOTE not in pre_h.notes
    assert maxdiff(tosp(pre_d.levels[0].P), tosp(pre_h.levels[0].P)) < 1e-12
    assert maxdiff(tosp(pre_d.levels[1].A), tosp(pre_h.levels[1].A)) < TOL_A
    check_levels(port_levels(pre_d), port_levels(pre_h), splits=False)


@pytest.mark.parametrize("interp_type", [3, 0, 6])
def test_chunks_give_the_same_bits(interp_type):
    """The chunked stages (the distance-2 interpolations' row chunks, in
    sigma order for classical, and the sparse products' expansions) give
    the same bits whatever the budget: at 1 KiB every chunk is 256 rows."""
    H = scrambled_laplace(32)
    A = port_matrix(H)
    cfg = BoomerAMGConfig(interp_type=interp_type)
    got = [device_setup_ell.device_level0_ell(A, cfg, A_host=H, budget=b)
           for b in (device_setup_ell.BUDGET, 1 << 10)]
    assert torch.equal(got[0]["Cmask"], got[1]["Cmask"])
    for key in ("P", "R", "Ac"):
        M0, M1 = (g[key] for g in got)
        assert M0.layout == M1.layout and M0.nnz == M1.nnz
        for a, b in ((M0.diag_vals, M1.diag_vals), (M0.diag_cols,
                                                    M1.diag_cols),
                     (M0.ell_vals, M1.ell_vals), (M0.ell_cols, M1.ell_cols)):
            assert (a is None and b is None) or torch.equal(a, b), key


# ----------------------------------------------------------------------
# eligibility against tpusolve's


def _width_coo(width: int, n: int = 4096):
    """An operator of 3 entries a row but one row of ``width``."""
    rng = np.random.default_rng(width)
    counts = np.full(n, 3)
    counts[rng.integers(0, n)] = width
    rows = np.repeat(np.arange(n), counts)
    cols = (rows + np.concatenate([np.arange(c) for c in counts])) % n
    return n, rows, cols, rng.standard_normal(rows.size)


def _momentum(side: int, rcm: bool):
    """The gate-4 fixture's entries at side^3, after RCM or scrambled."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from tpusolve_torch.fixtures import make_system
    r, c, v, _, n = make_system(side, side, side, seed=11, nonsym=0.35)
    if rcm:
        pat = sp.csr_matrix((np.ones(r.size, np.int8), (r, c)), shape=(n, n))
        perm = reverse_cuthill_mckee(pat + pat.T, symmetric_mode=True)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        r, c = inv[r], inv[c]
    return n, r, c, v


def _laplace_coo(n_side):
    H = scrambled_laplace(n_side).tocoo()
    return H.shape[0], H.row, H.col, H.data


# case: (entries, port keyword arguments, the layouts the two packages
# give it: port, tpusolve)
ELIGIBILITY = {
    "ell": (lambda: _laplace_coo(32), {}, ("ell", "ell")),
    "gate4_rcm_41": (lambda: _momentum(41, True), {}, ("ell", "bdia")),
    "scrambled_24_off_ell": (lambda: _momentum(24, False),
                             dict(allow_ell=False), ("bdia", "ell")),
    "width_128": (lambda: _width_coo(128), {}, ("ell", "ell")),
    "width_129": (lambda: _width_coo(129), {}, ("ell", "ell")),
}


@pytest.mark.parametrize("with_host", [False, True])
@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_eligible_equals_tpusolve(monkeypatch, case, with_host):
    pytest.importorskip("jax")
    from tpusolve.amg import device_setup_ell as tp_ell
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.mesh import make_mesh
    make, kw, (mine, theirs) = ELIGIBILITY[case]
    n, r, c, v = make()
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU,
                               dtype=np.float64, **kw)
    At = TpMatrix.from_coo(make_mesh(1), (n, n), r, c, v, dtype=np.float64)
    port_class = ("bdia" if A.uses_bdia else "bell" if A.uses_bell
                  else "dia" if A.uses_dia else "ell")
    tp_class = ("bdia" if At.uses_bdia else "bell" if At.uses_bell
                else "dia" if At.uses_dia else "ell")
    assert (port_class, tp_class) == (mine, theirs)
    assert A.tpusolve_layout == tp_class
    H = sp.csr_matrix((v, (r, c)), shape=(n, n)) if with_host else None
    for itype in (3, 0, 6, 4):
        monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
        want = tp_ell.eligible(At, TpConfig(interp_type=itype), H)
        assert device_setup_ell.eligible(
            A, BoomerAMGConfig(interp_type=itype), H, min_n=1) == want
        monkeypatch.delenv("TPUSOLVE_DEVICE_SETUP_MIN_N")
        # below tpusolve's floor of 2^19 rows neither sets it up
        assert not tp_ell.eligible(At, TpConfig(interp_type=itype), H)
        assert not device_setup_ell.eligible(
            A, BoomerAMGConfig(interp_type=itype), H)


def test_more_than_one_part_raises():
    """A multi-part operator that tpusolve sets up on its devices raises
    where its eligibility is asked, naming item 18 (it is never sent to the
    host pipeline in its place), and so does its setup."""
    H = scrambled_laplace(8)
    A = port_matrix(H)
    two = dataclasses.replace(A, row_offsets=(0, 32, 64))
    with pytest.raises(NotImplementedError, match="item 18"):
        device_setup_ell.eligible(two, BoomerAMGConfig(), H, min_n=1)
    with pytest.raises(NotImplementedError, match="item 18"):
        device_setup_ell.device_level0_ell(two, BoomerAMGConfig(), A_host=H)


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the setup on the card")
    return torch.device("cuda", torch.cuda.current_device())


def level_arrays(res) -> dict:
    """The setup's results as CPU tensors, each operator's arrays in its
    stored form."""
    out = {"Cmask": res["Cmask"], "dinv": res["dinv"],
           "dinv_l1": res["dinv_l1"]}
    for key in ("P", "R", "Ac"):
        M = res[key]
        if M.uses_ell_rowptr:
            arrs = (M.ell_rowptr, M.ell_vals, M.ell_cols)
        else:
            arrs = (M.diag_vals, M.diag_cols)
        for i, a in enumerate(arrs):
            out[f"{key}{i}"] = a
        out[f"{key}_diag"] = M.diag
    return {k: v.cpu() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("interp_type", [3, 0, 6])
def test_setup_on_cuda_equals_cpu(cuda, interp_type):
    """Needs only the card: the setup of the scrambled 64^2 Laplacian on the
    card gives the CPU's split, P, R and coarse A bit for bit in f64, and
    the same bits run again."""
    H = scrambled_laplace(64, seed=4)
    cfg = BoomerAMGConfig(interp_type=interp_type)
    got = []
    for dev in (CPU, cuda, cuda):
        A = ShardedMatrix.from_csr_host(H, device=dev, dtype=np.float64,
                                        allow_bell=False, allow_bdia=False)
        got.append(level_arrays(device_setup_ell.device_level0_ell(
            A, cfg, A_host=H)))
    for other in got[1:]:
        assert set(other) == set(got[0])
        for key, a in got[0].items():
            assert torch.equal(other[key], a), key
