"""tpusolve_torch's N-part generic-ELL setup (``amg/device_setup_ell_mp.py``)
against tpusolve's (``tpusolve/amg/device_setup_ell_mp.py``) on the
``mesh8`` fixture, and both CLIs on 8 parts with the device floors lowered.

The same numpy operators go through both packages on the CPU in f64: the
scrambled 2-D Laplacian of ``tests/test_device_setup_ell.py`` at 40^2 and
43^2 (a remainder decomposition) on 8 parts, with direct (3),
classical-modified (0) and extended+i (6) interpolation.  Level 0 set up by
each package's N-part pipeline (tpusolve with
``TPUSOLVE_PMIS_HOST_RANK=1``; its setups run once a module) gives the same
C/F split exactly, P within 1e-12 (P compared without tpusolve's padding),
the coarse operator within 1e-10, and R = P^T exactly; the stacked halo
primitives equal tpusolve's plan.  Through the CLIs, the weak-scaling YAML
at 16^3 a part and the gate-3 fixture at 16^3, each on 8 parts, print the
same ``AMG hierarchy:`` table and notes and take tpusolve's count.  The CUDA
cases hold the card's setup to the CPU's bits, twice.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch import fixtures
from tpusolve_torch.amg import device_setup, device_setup_ell
from tpusolve_torch.amg import device_setup_ell_mp as mp
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.matrix.sharded import ShardedMatrix

CPU = torch.device("cpu")
P8 = 8
TOL_P, TOL_A = 1e-12, 1e-10
# each interpolation on an even and a remainder decomposition; tier 1
# runs one case (tpusolve's 8-device compiles load the suite's workers),
# the CLI tests below and test_torch_multipart_gates.py the others on
# paths, the full gate the sweep
CASES = [(43, 6),
         pytest.param(40, 3, marks=pytest.mark.slow),
         pytest.param(43, 0, marks=pytest.mark.slow),
         pytest.param(43, 3, marks=pytest.mark.slow),
         pytest.param(40, 0, marks=pytest.mark.slow),
         pytest.param(40, 6, marks=pytest.mark.slow)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    return sp.csr_matrix(M.to_scipy())


def maxdiff(X, Y) -> float:
    d = abs(sp.csr_matrix(X) - sp.csr_matrix(Y))
    return d.max() if d.nnz else 0.0


def config(interp_type: int) -> BoomerAMGConfig:
    return BoomerAMGConfig(interp_type=interp_type, max_coarse_size=64)


def port_matrix(H, nparts=P8, device=CPU) -> ShardedMatrix:
    return ShardedMatrix.from_csr_host(H, device=device, dtype=np.float64,
                                       nparts=nparts, allow_bell=False,
                                       allow_bdia=False)


@pytest.fixture(scope="module")
def tp_level0(mesh8):
    """tpusolve's ``device_level0_ell_mp`` of each case on ``mesh8``, built
    once: the C/F split, P, R and the coarse operator."""
    pytest.importorskip("jax")
    from tpusolve.amg.device_setup_ell_mp import device_level0_ell_mp
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    cache = {}

    def get(side, interp_type):
        if (side, interp_type) not in cache:
            H = scrambled_laplace(side)
            At = TpMatrix.from_csr_host(mesh8, H, dtype=np.float64,
                                        allow_bell=False, allow_bdia=False)
            with pytest.MonkeyPatch.context() as m:
                m.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
                res = device_level0_ell_mp(At, TpConfig(
                    interp_type=interp_type, max_coarse_size=64), A_host=H)
            cache[side, interp_type] = dict(
                H=H, nc=res["nc"], Cmask=np.asarray(res["Cmask"]),
                P=tosp(res["P"]), R=tosp(res["R"]), Ac=tosp(res["Ac"]),
                offsets=np.asarray(res["coarse_row_offsets"]))
        return cache[side, interp_type]

    return get


@pytest.mark.parametrize("side, interp_type", CASES)
def test_level0_equals_tpusolve(tp_level0, side, interp_type):
    ref = tp_level0(side, interp_type)
    A = port_matrix(ref["H"])
    assert device_setup_ell.eligible(A, config(interp_type), ref["H"],
                                     min_n=1)
    res = device_setup_ell.device_level0_ell(A, config(interp_type),
                                             A_host=ref["H"])
    np.testing.assert_array_equal(res["Cmask"].numpy(), ref["Cmask"])
    assert res["nc"] == ref["nc"]
    np.testing.assert_array_equal(res["coarse_row_offsets"], ref["offsets"])
    P, R, Ac = tosp(res["P"]), tosp(res["R"]), tosp(res["Ac"])
    P.eliminate_zeros()
    assert P.shape == ref["P"].shape and P.nnz == ref["P"].nnz
    assert maxdiff(P, ref["P"]) <= TOL_P
    assert maxdiff(R, P.T) == 0.0
    assert maxdiff(Ac, ref["Ac"]) <= TOL_A
    for M in (res["P"], res["R"], res["Ac"]):
        assert M.nparts == P8 and M.has_offd and M.tpusolve_layout == "ell"
    assert res["Ac"].row_offsets == tuple(int(o) for o in ref["offsets"])


def test_halo_primitives_equal_plan():
    """The forward halo is ``matrix/spmv.py:halo_exchange`` (``tpusolve``'s
    gather and ``all_to_all``) row by row, on 1-D and 2-D payloads; the
    reverse halo adds (integers) or takes the max of each ghost's
    contribution into its owner, as ``tpusolve``'s ``_scatter_ghost``."""
    from tpusolve_torch.matrix.spmv import halo_exchange
    A = port_matrix(scrambled_laplace(20))
    vals, ecols, space, ghosts, rowcnt = mp._stage_ell_mp(A, None)
    P, R, G = space.P, space.R, space.G
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(P * R))
    want = halo_exchange(x, A.send_idx, A.ghost_slot)
    got = space.ext(x, 0.0).reshape(P, -1)[:, R:R + G]
    assert torch.equal(got, want)
    X = torch.from_numpy(rng.standard_normal((P * R, 3)))
    got2 = space.ext(X, 0.0).reshape(P, space.E, 3)[:, R:R + G]
    for j in range(3):
        assert torch.equal(got2[..., j],
                           halo_exchange(X[:, j], A.send_idx, A.ghost_slot))
    # the ghosts' global columns are the offd block's, by the plan
    H = tosp(A)
    for p in range(P):
        lo, hi = A.row_offsets[p], A.row_offsets[p + 1]
        cols = H[lo:hi].indices
        remote = np.unique(cols[(cols < lo) | (cols >= hi)])
        np.testing.assert_array_equal(ghosts[p][:remote.size], remote)
    # reverse: every ghost slot's contribution reaches its owner
    c = torch.from_numpy(rng.integers(0, 5, P * space.E))
    c.reshape(P, space.E)[:, R + G:] = 0
    out = space.reverse(c, "add").numpy()
    ref = c.reshape(P, space.E)[:, :R].reshape(-1).numpy().copy()
    np.add.at(ref, space.src.numpy(), c.reshape(P, space.E)[:, R:R + G]
              .reshape(-1).numpy())
    np.testing.assert_array_equal(out, ref)
    outm = space.reverse(c, "max").numpy()
    refm = c.reshape(P, space.E)[:, :R].reshape(-1).numpy().copy()
    np.maximum.at(refm, space.src.numpy(), c.reshape(P, space.E)[:, R:R + G]
                  .reshape(-1).numpy())
    np.testing.assert_array_equal(outm, refm)
    with pytest.raises(TypeError):
        space.reverse(c.double(), "add")


def test_eligibility_on_parts(mesh8, monkeypatch):
    """``eligible`` decides as ``tpusolve``'s on 8 parts for each
    interpolation, with and without the floor."""
    pytest.importorskip("jax")
    from tpusolve.amg import device_setup_ell as tp_ell
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    H = scrambled_laplace(24)
    A = port_matrix(H)
    At = TpMatrix.from_csr_host(mesh8, H, dtype=np.float64,
                                allow_bell=False, allow_bdia=False)
    for itype in (0, 3, 6, 4):
        monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
        want = tp_ell.eligible(At, TpConfig(interp_type=itype), H)
        assert device_setup_ell.eligible(A, config(itype), H,
                                         min_n=1) == want
        monkeypatch.delenv("TPUSOLVE_DEVICE_SETUP_MIN_N")
        assert not device_setup_ell.eligible(A, config(itype), H)
    # one part with an offd block is never set up here
    one = dataclasses.replace(port_matrix(H, nparts=1), has_offd=True)
    assert not device_setup_ell.eligible(one, config(0), H, min_n=1)


# ----------------------------------------------------------------------
# both CLIs on 8 parts, the device floors lowered

def run_cli(path, port: bool):
    """(hierarchy table, notes, counts, check) of one harness on 8 parts,
    every device setup's floor at one row (tpusolve:
    ``TPUSOLVE_DEVICE_SETUP_MIN_N=1``, host PMIS ranks)."""
    with pytest.MonkeyPatch.context() as m:
        if port:
            from tpusolve_torch.config import load_config
            from tpusolve_torch.harness import system
            m.setattr(device_setup, "MIN_DEVICE_N", 1)
            m.setattr(system, "boomeramg_setup", functools.partial(
                system.boomeramg_setup, device_min_n=1))
            s = system.LinearSystem(load_config(path), CPU, nparts=P8,
                                    verbose=False)
        else:
            pytest.importorskip("jax")
            from tpusolve.config import load_config
            from tpusolve.harness.system import LinearSystem
            from tpusolve.mesh import make_mesh
            m.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
            m.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
            s = LinearSystem(make_mesh(P8), load_config(path), verbose=False)
        s.setup_precon_and_solver()
        s.load()
        s.solve()
        ok = s.check_solution()
    pre = s._precond
    return dict(table=pre.describe(), notes=list(pre.notes),
                iters=[int(r.iters) for r in s.solve_results], ok=ok,
                setups=getattr(pre, "device_setups", None))


def test_gate3_cli_8_parts_equals_tpusolve(tmp_path):
    """The gate-3 fixture (extended+i, RCM, double) at 16^3 on 8 parts:
    level 0 and every level above the coarsest by the N-part ELL setup, the
    same hierarchy table, notes and GMRES count as tpusolve's."""
    path = fixtures.write_gate3(str(tmp_path), 16, solver_settings={
        "precision": "double"})
    got, want = run_cli(path, True), run_cli(path, False)
    assert got["ok"] and want["ok"]
    assert got["table"] == want["table"]
    assert got["iters"] == want["iters"]
    assert got["setups"][0] == (0, "ell", P8)
    assert any("generic ELL" in n for n in got["notes"])


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the N-part ELL setup on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("interp_type", [3, 0, 6])
def test_card_setup_gives_cpu_bits(cuda, interp_type):
    H = scrambled_laplace(43)
    cfg = config(interp_type)

    def run(device):
        res = device_setup_ell.device_level0_ell(port_matrix(H, device=device),
                                                 cfg, A_host=H)
        return [tosp(res[k]) for k in ("P", "R", "Ac")]

    cpu = run(CPU)
    for _ in range(2):
        for X, Y in zip(run(cuda), cpu):
            assert X.shape == Y.shape and (X != Y).nnz == 0
