"""The port across processes (``tpusolve_torch/dist.py``): the readers'
``row_range``, the collectives, and the halo and SpMV of a rank's parts.

The IJ readers with a ``row_range`` equal ``tpusolve``'s on 2- and 8-file
fixtures and parse no part file outside the range.  Two CPU ranks joined
on gloo (``tests/torch_dist_worker.py``) each place their 4 parts of 8
(``dist.place``) of gate 3's and gate 4's operators at 16^3 (ELL, the
RCM-ordered BDIA, its f32 twin, the same on K5's step plan, and a
row-pointer ELL operator): their ghosts, ``spmv`` and ``spmv_update`` of a vector and of a
3-column batch equal the one-process 8-part operator's rows bit for bit,
``allgather_host_coo`` and ``fetch_host`` give the global arrays.  In one
process every collective is the identity; ``--parts`` not a multiple of
the processes is a usage error and ``nccl`` on the CPU raises.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

from tpusolve_torch import dist, fixtures  # noqa: E402
from tpusolve_torch.formats import ij  # noqa: E402
from tpusolve_torch.parts import row_decomposition  # noqa: E402

SIDE = 16
OPS = ("gate3", "gate4", "gate4 rcm", "gate4 rcm f32", "gate4 rcm xl",
       "rowptr")
RESULTS = ("ghosts", "ghosts batch", "spmv", "spmv batch", "spmv_update",
           "spmv_update batch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# row_range reads


@pytest.fixture(scope="module")
def ij_fixtures(tmp_path_factory):
    """Gate 4's IJ files at 8^3 in 2 and in 8 parts."""
    d = tmp_path_factory.mktemp("ij")
    return {k: fixtures.write_momentum_ij(str(d / str(k)), 8, 8, 8,
                                          nfiles=k) for k in (2, 8)}


@pytest.mark.parametrize("nfiles, rng", [
    (2, (0, 255)), (2, (256, 511)), (2, (100, 300)),
    (8, (0, 255)), (8, (256, 511)), (8, (130, 140))])
def test_row_range_reads_equal_tpusolve(ij_fixtures, nfiles, rng):
    """``read_matrix``, ``read_vector`` and ``read_dense_vector`` with a
    ``row_range`` equal ``tpusolve``'s, and parse only the part files whose
    rows meet the range."""
    pytest.importorskip("jax")
    from tpusolve.formats import ij as tp_ij
    m, r, s, n = ij_fixtures[nfiles]
    offsets = row_decomposition(n, nfiles)
    meet = [p for p in range(nfiles)
            if offsets[p] <= rng[1] and offsets[p + 1] > rng[0]]
    start = len(ij.PARSED)
    for got, want in zip(ij.read_matrix(m, nfiles, row_range=rng),
                         tp_ij.read_matrix(m, nfiles, row_range=rng)):
        np.testing.assert_array_equal(got, want)
    assert ij.PARSED[start:] == [ij.part_path(m, p) for p in meet]
    for got, want in zip(ij.read_vector(r, nfiles, row_range=rng),
                         tp_ij.read_vector(r, nfiles, row_range=rng)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ij.read_dense_vector(s, nfiles, n, row_range=rng),
        tp_ij.read_dense_vector(s, nfiles, n, row_range=rng))
    assert len(ij.PARSED) - start == 3 * len(meet)


def test_matrix_market_row_range(tmp_path):
    """The MatrixMarket reader keeps the rows of its range, as a filter of
    the whole read."""
    from tpusolve_torch.formats import mmio
    m, _, _, n = fixtures.write_pressure_mm(str(tmp_path), 6, 6, 6)
    rows, cols, vals, _ = mmio.read_matrix(m)
    keep = (rows >= 50) & (rows <= 120)
    got = mmio.read_matrix(m, row_range=(50, 120))
    for a, b in zip(got[:3], (rows[keep], cols[keep], vals[keep])):
        np.testing.assert_array_equal(a, b)
    assert got[3] == (n, n)


# ----------------------------------------------------------------------
# two ranks against one process


def _ops_data() -> dict:
    data = {}

    def put(name, r, c, v, n):
        data.update({f"{name} rows": r, f"{name} cols": c,
                     f"{name} vals": v, f"{name} n": np.array(n)})

    r, c, v, _, n = fixtures.make_system(SIDE, SIDE, SIDE, seed=7)
    put("gate3", r, c, v, n)
    r, c, v, _, n = fixtures.make_system(SIDE, SIDE, SIDE, seed=11,
                                         nonsym=0.35)
    put("gate4", r, c, v, n)
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    pat = sp.csr_matrix((np.ones(r.size), (r, c)), shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(pat + pat.T,
                                            symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    put("gate4 rcm", inv[r], inv[c], v, n)
    put("gate4 rcm f32", inv[r], inv[c], v, n)
    put("gate4 rcm xl", inv[r], inv[c], v, n)
    # an ELL operator of a few long rows among short ones, whose parts'
    # longest rows differ (60 entries on rank 0's, 20 on rank 1's): each
    # rank's plain row-pointer sums pad to the whole operator's width
    rng = np.random.default_rng(5)
    m, per = 3000, 375
    long = np.arange(0, m, 97)
    rr = np.repeat(long, np.where(long < m // 2, 60, 20))
    # half the long rows' entries in their own part (the diag block's
    # rows), half anywhere (the offd block's)
    own = rr // per * per + rng.integers(0, per, rr.size)
    cc = np.where(rng.random(rr.size) < 0.5, own,
                  rng.integers(0, m, rr.size))
    rr = np.concatenate([np.arange(m), rr])
    cc = np.concatenate([np.arange(m), cc])
    key = np.unique(rr * m + cc)
    put("rowptr", key // m, key % m, rng.standard_normal(key.size), m)
    g = np.random.default_rng(3)
    nmax = max(n, m)
    for k in ("x", "b", "s", "c"):
        data[k] = g.standard_normal(nmax)
    for k in ("X", "B", "C"):
        data[k] = g.standard_normal((3, nmax))
    return data


def _cut(data: dict, name: str) -> dict:
    """The vectors of ``data`` at operator ``name``'s size and dtype."""
    n = int(data[f"{name} n"])
    dt = np.float32 if name.endswith("f32") else np.float64
    return {k: data[k][..., :n].astype(dt) for k in ("x", "X", "b", "s",
                                                     "c", "B", "C")}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(data, each rank's results) of the ``ops`` case on 2 ranks."""
    d = tmp_path_factory.mktemp("ops")
    data = _ops_data()
    np.savez(d / "ops.npz", **data)
    runs = worker.launch(["ops", d], ranks=2, timeout=300)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    return data, [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def test_rank_parts_hold_the_layouts(two_ranks):
    """The operators take the layouts the cases are meant to cover (ELL,
    BDIA in f64 and f32, K5's BDIA-XL, the row-pointer form), each with an
    offd block."""
    _, res = two_ranks
    lay = {name: str(res[0][f"{name} layout"]) for name in OPS}
    assert lay["gate3"].startswith("ELL K=") and "offd" in lay["gate3"]
    assert lay["gate4 rcm"].startswith("BDIA ")
    assert lay["gate4 rcm f32"].startswith("BDIA ")
    assert lay["gate4 rcm xl"].startswith("BDIA-XL")
    assert lay["rowptr"].startswith("ELL-RP") and "offd ELL-RP" in \
        lay["rowptr"]
    assert all("x 4 parts" in s for s in lay.values())


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("what", RESULTS)
def test_two_ranks_equal_one_process(two_ranks, name, what):
    """Each rank's ghosts, ``spmv`` and ``spmv_update`` (a vector and a
    3-column batch) equal the one-process 8-part operator's rows of its
    parts bit for bit."""
    data, res = two_ranks
    A = worker.build(data, name)
    want = worker.products(A, _cut(data, name))[what].numpy()
    per = worker.N_OPS_PARTS // 2
    span = A.ghost_slot.shape[1] if what.startswith("ghosts") else A.row_pad
    for r in range(2):
        got = res[r][f"{name} {what}"]
        ref = want[..., r * per * span:(r + 1) * per * span]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref), (name, what, r)


def test_allgather_host_coo_and_fetch_host(two_ranks):
    """Each rank's rows gathered give the global COO in row-block order,
    and ``fetch_host`` the global vector, on both ranks."""
    data, res = two_ranks
    rows, cols, vals = (data[f"gate3 {k}"] for k in ("rows", "cols", "vals"))
    order = np.argsort(rows >= int(data["gate3 n"]) // 2, kind="stable")
    n = int(data["gate3 n"])
    for r in range(2):
        np.testing.assert_array_equal(res[r]["coo rows"], rows[order])
        np.testing.assert_array_equal(res[r]["coo cols"], cols[order])
        np.testing.assert_array_equal(res[r]["coo vals"], vals[order])
        np.testing.assert_array_equal(res[r]["fetch"], data["x"][:n])


# ----------------------------------------------------------------------
# one process, and usage errors


def test_one_process_collectives_are_the_identity():
    """With no group, every collective and placement returns its input:
    a one-process run keeps its bits."""
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    assert dist.group() is None and dist.world() == 1 and dist.rank() == 0
    t = torch.arange(5.0)
    assert dist.all_reduce(t) is t and dist.all_gather_cat(t) is t
    r = np.arange(4)
    assert dist.allgather_host_coo(r, r, r) == (r, r, r)
    M = ShardedMatrix.from_coo((4, 4), r, r, np.ones(4), device="cpu",
                               nparts=2)
    assert dist.place(M) is M and not M.is_slice and M.all_nparts == 2
    assert dist.staging("cpu") == torch.device("cpu")
    assert dist.host_row_range(np.array([0, 3, 7])) == (0, 6)
    assert dist.sum_int(3) == 3
    dist.refuse("anything")        # no-op in one process


def test_parts_not_a_multiple_of_ranks_is_a_usage_error(monkeypatch,
                                                         capsys):
    from tpusolve_torch.harness import cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert cli._parse(["x.yaml", "--parts", "3"]) is None
    assert cli._parse(["x.yaml", "--parts", "4", "--dist-backend",
                       "mpi"]) is None
    assert cli._parse(["x.yaml", "--parts", "4", "--dist-backend",
                       "gloo"]) == ("x.yaml", "cuda", 4, "gloo")
    assert cli.main(["x.yaml", "--parts", "3", "--device", "cpu"]) == 1
    assert "multiple of the 2 processes" in capsys.readouterr().err


def test_nccl_on_the_cpu_raises(monkeypatch):
    """``--dist-backend nccl`` with ``--device cpu`` raises before joining:
    nothing switches the backend."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="nccl backend needs"):
        dist.init_distributed("cpu", "nccl")
    assert dist.group() is None


def test_slice_fields_and_halo_plan():
    """A rank's slice of a 4-part operator over 2 ranks: its parts'
    arrays, the whole operator's offsets, and a halo plan whose send and
    receive counts match across the ranks."""
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    r, c, v, _, n = fixtures.make_system(6, 6, 6, seed=7)
    A = ShardedMatrix.from_coo((n, n), r, c, v, device="cpu", nparts=4)
    S = [A.rank_slice(k, 2, "cpu") for k in range(2)]
    for k, B in enumerate(S):
        assert B.is_slice and B.nparts == 2 and B.all_nparts == 4
        assert B.part_lo == 2 * k and B.row_pad == A.row_pad
        assert B.row_offsets == A.row_offsets[2 * k:2 * k + 3]
        assert B.has_offd and B.halo_src is None
        assert torch.equal(B.offd_vals, A.offd_vals[2 * k:2 * k + 2])
    assert S[0].rank_halo.send_splits == S[1].rank_halo.recv_splits[::-1]
    assert S[0].rank_halo.send_splits[0] == 0
    # each slice's rows of the global matrix, from its own arrays
    full = A.to_scipy()
    for k, B in enumerate(S):
        lo, hi = B.row_offsets[0], B.row_offsets[-1]
        assert abs(B.to_scipy()[lo:hi] - full[lo:hi]).max() == 0
    with pytest.raises(ValueError):
        S[0].rank_slice(0, 2, "cpu")
    with pytest.raises(ValueError):
        A.rank_slice(0, 3, "cpu")
