"""tpusolve_torch's sharded lattice setup (``amg/device_setup_sharded.py``),
its halo and the N-part generator against tpusolve's
(``tpusolve/amg/device_setup_sharded.py``, ``tpusolve/stencil.py``) on the
``mesh8`` fixture.

The same stencil goes through both packages on the CPU in f64, parts of 8^3
on the process grids (2, 2, 2) and (1, 1, 8), with direct (3) and
classical-modified (0) interpolation: the C/F split is tpusolve's exactly,
P within 1e-12 and the coarse operator within 1e-10 of it, and R = P^T
exactly (tpusolve with ``TPUSOLVE_PMIS_HOST_RANK=1`` and
``TPUSOLVE_DEVICE_SETUP_MIN_N=1``; its setups run once a module).  The
stacked 3-D halo equals tpusolve's ``_mk_exchange``; the lattice stacks of
both generators, host and device, equal tpusolve's bit for bit.  On parts
of 4^3 the port's hierarchy is its own host pipeline's.  The CUDA cases
hold the card's setup to the CPU's bits, and to its own on a second run.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import builder, device_setup_sharded as dss
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.stencil import laplace27

CPU = torch.device("cpu")
P8 = 8
TOL_P, TOL_A = 1e-12, 1e-10
# each grid and each interpolation in tier 1; the full sweep in the full
# gate
CASES = [((2, 2, 2), 0), ((1, 1, 8), 3),
         pytest.param((2, 2, 2), 3, marks=pytest.mark.slow),
         pytest.param((1, 1, 8), 0, marks=pytest.mark.slow)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tosp(M) -> sp.csr_matrix:
    return sp.csr_matrix(M.to_scipy())


def maxdiff(X, Y) -> float:
    d = abs(sp.csr_matrix(X) - sp.csr_matrix(Y))
    return d.max() if d.nnz else 0.0


def config(interp_type: int) -> BoomerAMGConfig:
    """The settings of ``tests/test_device_setup.py``'s sharded cases, with
    CF-ordered relaxation, which keeps level 0's C/F split on the level,
    and two levels (level 1's operator is the setup's coarse one)."""
    return BoomerAMGConfig(max_coarse_size=64, interp_type=interp_type,
                           relax_order=1, max_levels=2)


def port_setup(pgrid, interp_type, side=8, device=CPU, min_n=1):
    A, _, _, lat = laplace27(side, side, side, device=device, pgrid=pgrid,
                             nparts=int(np.prod(pgrid)), with_lattice=True)
    pre = builder.boomeramg_setup(A, config(interp_type), lattice_parts=lat,
                                  device_min_n=(min_n, None))
    return A, lat, pre


@pytest.fixture(scope="module")
def tp_levels(mesh8):
    """tpusolve's hierarchy of each case (its level 0 by its sharded setup),
    built once: level 0's C/F split, P and R, level 1's A, the notes."""
    pytest.importorskip("jax")
    from tpusolve.amg.builder import boomeramg_setup
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.stencil import laplace27 as tp_laplace27
    cache = {}

    def get(pgrid, interp_type):
        key = (pgrid, interp_type)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
                mp.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
                mp.setenv("TPUSOLVE_ELL_SETUP", "0")
                At, _, _, lat = tp_laplace27(mesh8, 8, 8, 8,
                                             dtype=np.float64, pgrid=pgrid,
                                             with_lattice=True)
                pre = boomeramg_setup(At, TpConfig(
                    max_coarse_size=64, interp_type=interp_type,
                    relax_order=1, max_levels=2), lattice_parts=lat)
            l0, l1 = pre.levels[0], pre.levels[1]
            cache[key] = dict(
                cmask=np.asarray(l0.cmask).reshape(-1)
                if l0.cmask is not None else None,
                P=tosp(l0.P), R=tosp(l0.R), A1=tosp(l1.A),
                n=[lev.n for lev in pre.levels], notes=list(pre.notes))
        return cache[key]

    return get


@pytest.mark.parametrize("pgrid, interp_type", CASES)
def test_lattice_setup_equals_tpusolve(tp_levels, pgrid, interp_type):
    ref = tp_levels(pgrid, interp_type)
    A, lat, pre = port_setup(pgrid, interp_type)
    assert dss.eligible(A, config(interp_type), lat, min_n=1)
    assert pre.device_setups[0] == (0, "lattice", P8)
    assert pre.notes == ref["notes"]
    assert [lev.n for lev in pre.levels] == ref["n"]
    l0, l1 = pre.levels[0], pre.levels[1]
    P, R = tosp(l0.P), tosp(l0.R)
    # the split: P's columns at C rows are the identity
    assert P.shape == ref["P"].shape and P.nnz == ref["P"].nnz
    assert maxdiff(P, ref["P"]) <= TOL_P
    assert maxdiff(R, P.T) == 0.0
    assert maxdiff(tosp(l1.A), ref["A1"]) <= TOL_A
    # the operators are N-part, each part's seam entries in its offd block
    assert l0.P.nparts == l0.R.nparts == l1.A.nparts == P8
    assert l1.A.has_offd and l0.P.has_offd


@pytest.mark.parametrize("pgrid, interp_type", CASES)
def test_cf_split_equals_tpusolve(tp_levels, pgrid, interp_type):
    """The C/F split exactly, from the setup itself and on level 0."""
    ref = tp_levels(pgrid, interp_type)
    A, lat, pre = port_setup(pgrid, interp_type)
    res = dss.device_level0_sharded(A, config(interp_type), lat)
    np.testing.assert_array_equal(res["Cmask"].numpy(), ref["cmask"])
    np.testing.assert_array_equal(pre.levels[0].cmask.numpy(), ref["cmask"])
    assert res["nc"] == ref["P"].shape[1]
    np.testing.assert_array_equal(res["coarse_row_offsets"][-1], res["nc"])


def test_halo_equals_tpusolve(mesh8):
    """The stacked 3-D halo against tpusolve's ``_mk_exchange`` (ppermute
    under ``shard_map``) on random planes, widths 1 to 3, both grids."""
    pytest.importorskip("jax")
    from tpusolve.amg.device_setup_sharded import _mk_exchange
    from tpusolve.mesh import ROWS_AXIS, put_sharded
    from jax.sharding import PartitionSpec as PS
    rng = np.random.default_rng(5)
    for pgrid in ((2, 2, 2), (1, 1, 8), (2, 4, 1)):
        S = rng.standard_normal((P8, 2, 6, 5, 4))
        for h in (1, 2, 3):
            want = np.asarray(_mk_exchange(mesh8, ROWS_AXIS, pgrid, h)(
                put_sharded(S, mesh8, PS(ROWS_AXIS))))
            got = dss.halo(torch.from_numpy(S).transpose(0, 1), (h, h, h),
                           pgrid).transpose(0, 1)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("on_device", [False, True])
def test_lattice_generation_equals_tpusolve(mesh8, on_device):
    """The N-part lattice stacks (host branch, and the device generator run
    on the CPU) against tpusolve's ``_dia_box_lattice`` stacks and its
    device generator's lattice, box planes and RHS, bit for bit."""
    pytest.importorskip("jax")
    from tpusolve import stencil as tp_stencil
    from tpusolve.mesh import ROWS_AXIS
    nx, ny, nz, pgrid = 6, 5, 4, (2, 2, 2)
    A, b, _, lat = laplace27(nx, ny, nz, device=CPU, pgrid=pgrid, nparts=P8,
                             with_lattice=True, on_device=on_device)
    ref = np.stack([tp_stencil._dia_box_lattice(p, nx, ny, nz, pgrid,
                                                np.float64)[1]
                    for p in range(P8)])
    np.testing.assert_array_equal(lat["stack"].numpy(), ref)
    offs, lat_t, dia_t, rhs_t = tp_stencil._dia_box_device_sharded(
        mesh8, ROWS_AXIS, nx, ny, nz, pgrid, np.float64)
    np.testing.assert_array_equal(lat["stack"].numpy(), np.asarray(lat_t))
    np.testing.assert_array_equal(lat["offsets"], offs)
    np.testing.assert_array_equal(A.dia_vals.numpy(), np.asarray(dia_t))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rhs_t).reshape(-1))
    assert lat["pgrid"] == pgrid and lat["dims"] == (nz, ny, nx)


def test_four_wide_parts_equal_host_pipeline():
    """Parts of 4^3 (where flat offsets cannot name a triple one way only
    on the coarse lattice): the device hierarchy is the port's own host
    pipeline's, the split exactly."""
    for interp_type in (0, 3):
        A, lat, pre = port_setup((2, 2, 2), interp_type, side=4)
        host = builder.boomeramg_setup(A, config(interp_type),
                                       device_min_n=None)
        assert pre.device_setups[0][:2] == (0, "lattice")
        assert [lev.n for lev in pre.levels] == [lev.n for lev in host.levels]
        P, Ph = tosp(pre.levels[0].P), tosp(host.levels[0].P)
        assert P.nnz == Ph.nnz and maxdiff(P, Ph) <= TOL_P
        assert maxdiff(tosp(pre.levels[0].R), P.T) == 0.0
        assert maxdiff(tosp(pre.levels[1].A), tosp(host.levels[1].A)) \
            <= TOL_A


def test_eligibility():
    A, _, _, lat = laplace27(8, 8, 8, device=CPU, nparts=P8,
                             with_lattice=True)
    cfg = config(0)
    assert dss.eligible(A, cfg, lat, min_n=1)
    assert not dss.eligible(A, cfg, lat)            # below 2^16 rows
    assert not dss.eligible(A, cfg, None, min_n=1)
    assert not dss.eligible(A, cfg, lat, min_n=None)
    assert not dss.eligible(A, config(6), lat, min_n=1)
    A1, _, _, lat1 = laplace27(8, 8, 8, device=CPU, with_lattice=True)
    assert not dss.eligible(A1, cfg, lat1, min_n=1)  # one part: DIA setup
    # halo slabs wider than a part's box
    assert not dss.eligible(A, cfg, dict(lat, dims=(8, 8, 2)), min_n=1)


# ----------------------------------------------------------------------
# on the card


def _levels_bits(pre):
    out = []
    for lev in pre.levels[:2]:
        for M in (lev.A, lev.P, lev.R):
            if M is not None:
                out.append(tosp(M))
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded lattice setup on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("interp_type", [0, 3])
def test_card_setup_gives_cpu_bits(cuda, interp_type):
    cpu = _levels_bits(port_setup((2, 2, 2), interp_type, side=16)[2])
    for _ in range(2):
        card = _levels_bits(port_setup((2, 2, 2), interp_type, side=16,
                                       device=cuda)[2])
        for X, Y in zip(card, cpu):
            assert X.shape == Y.shape and (X != Y).nnz == 0


def test_weakscale_cli_8_parts_equals_tpusolve(tmp_path):
    """The weak-scaling YAML (``single``) at 16^3 a part on 8 parts through
    both CLIs, the device floors lowered: level 0 by the sharded lattice
    setup, the levels below by the N-part ELL setup, the same hierarchy
    table, notes and PCG count as tpusolve's (11)."""
    from tpusolve_torch import fixtures
    from test_torch_device_setup_ell_mp import run_cli
    path = fixtures.write_weakscale(str(tmp_path), 16)
    got, want = run_cli(path, True), run_cli(path, False)
    assert got["ok"] and want["ok"]
    assert got["table"] == want["table"]
    assert got["iters"] == want["iters"] == [11]
    assert [s[1] for s in got["setups"]] == ["lattice", "ell", "ell"]
    assert builder.DIA_NOTE in got["notes"]
    assert builder.RECURSION_NOTE in got["notes"]
