"""The 27-point stencil generated by rank, on 2 ranks x 4 parts.

Each rank of ``tests/torch_dist_worker.py``'s ``stencil`` case (two CPU
processes joined on gloo) generates its parts of the 8-part stencil at
``SIDE``^3 a part, by the host path and by the device generator's plain
path, in f64 and f32 (``stencil.laplace27``'s ``rank_parts``).  Its
operator equals ``rank_slice`` of the one-process 8-part operator field for
field, its halo plan and K2's pricing of the offd block included, bit for
bit; its right-hand side is the one-process run's rows; it holds its own
parts' planes alone; and its arrays equal those ``tpusolve``'s
``laplace27`` builds on ``mesh8`` for the same parts.  A rank's host CSR
(the host-setup branch) holds the one-process CSR's rows of its parts.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

from tpusolve_torch.stencil import laplace27  # noqa: E402

CPU = torch.device("cpu")
P8, RANKS, SIDE = 8, 2, 16
DTYPES = ("float64", "float32")
GENS = ("host", "device")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved generation (``rank<r>.npz``)."""
    d = tmp_path_factory.mktemp("stencil")
    np.savez(d / "stencil.npz", side=SIDE)
    runs = worker.launch(["stencil", str(d)])
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exit {rc}:\n{out[-4000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]


def one_process(dtype: str, gen: str):
    """(A, b, x_ref) of the one-process 8-part stencil."""
    return laplace27(SIDE, SIDE, SIDE, device=CPU, dtype=getattr(np, dtype),
                     nparts=P8, on_device=gen == "device")


@pytest.mark.parametrize("gen", GENS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_generation_by_rank_equals_rank_slice(ranks, dtype, gen):
    """Every field of a rank's generated operator is ``rank_slice``'s of
    the one-process operator (its offd block at the whole block's K2
    price); its right-hand side and reference solution are that run's rows
    of its parts; it holds 4 parts' planes, half the one-process run's."""
    A, b, x = one_process(dtype, gen)
    key = f"{dtype} {gen}"
    per = P8 // RANKS
    for r, got in enumerate(ranks):
        want = worker.fields(A.rank_slice(r, RANKS, CPU))
        mine = {k[len(key) + 1:]: v for k, v in got.items()
                if k.startswith(key + " ")}
        assert set(want) | {"b", "x_ref"} == set(mine)
        for name, v in want.items():
            assert mine[name].dtype == v.dtype and np.array_equal(
                mine[name], v), name
        rows = slice(r * per * A.row_pad, (r + 1) * per * A.row_pad)
        assert np.array_equal(mine["b"], b[rows].numpy())
        assert np.array_equal(mine["x_ref"], x[rows].numpy())
        assert mine["dia_vals"].shape[0] == per
        assert 2 * mine["dia_vals"].nbytes == A.dia_vals.numel() \
            * A.dia_vals.element_size()


@pytest.mark.parametrize("dtype", DTYPES)
def test_generation_by_rank_equals_tpusolve(ranks, mesh8, dtype):
    """A rank's planes, offd block, ghost slots and right-hand side are the
    arrays ``tpusolve``'s ``laplace27`` builds on ``mesh8`` for its parts,
    and its send lists ``tpusolve``'s whole plan."""
    pytest.importorskip("jax")
    from tpusolve.stencil import laplace27 as tp_laplace27
    At, bt, _ = tp_laplace27(mesh8, SIDE, SIDE, SIDE,
                             dtype=getattr(np, dtype))
    per = P8 // RANKS
    for r, got in enumerate(ranks):
        lo, hi = r * per, (r + 1) * per
        mine = lambda k: got[f"{dtype} host {k}"]
        planes = np.asarray(At.dia_vals).reshape(P8, 27, -1)[lo:hi]
        assert np.array_equal(mine("dia_vals").reshape(planes.shape), planes)
        for k in ("offd_vals", "offd_cols", "ghost_slot", "diag"):
            assert np.array_equal(mine(k),
                                  np.asarray(getattr(At, k))[lo:hi]), k
        assert np.array_equal(mine("send_idx"), np.asarray(At.send_idx))
        rows = np.asarray(bt).reshape(P8, -1)[lo:hi].reshape(-1)
        assert np.array_equal(mine("b"), rows)


@pytest.mark.parametrize("rank", range(RANKS))
def test_host_rows_by_rank(rank):
    """The host-setup branch's CSR of a rank holds the one-process CSR's
    rows of its parts and no other row (the ranks gather them,
    ``dist.gather_scipy``)."""
    per = P8 // RANKS
    *_, H = laplace27(SIDE, SIDE, SIDE, device=CPU, nparts=P8,
                      with_host=True)
    *_, Hr = laplace27(SIDE, SIDE, SIDE, device=CPU, nparts=P8,
                       with_host=True,
                       rank_parts=(rank * per, (rank + 1) * per, RANKS))
    box = SIDE ** 3
    lo, hi = rank * per * box, (rank + 1) * per * box
    assert Hr.shape == H.shape
    assert abs(Hr[lo:hi] - H[lo:hi]).max() == 0
    assert Hr[:lo].nnz == 0 and Hr[hi:].nnz == 0


def test_coo_path_and_bad_ranges_raise():
    """A rank's parts need the DIA fast path (a box of at least 3 x 3)
    and, on that path, its own parts' planes with every part's count."""
    with pytest.raises(ValueError, match="fast path"):
        laplace27(2, 2, 4, device=CPU, nparts=P8, rank_parts=(0, 4, 2))
    A = laplace27(4, 4, 4, device=CPU, nparts=P8)[0]
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    with pytest.raises(ValueError, match="entry count"):
        ShardedMatrix.from_dia_parts(
            A.shape, A.dia_offsets, A.dia_vals[:4], [
                (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)] * P8,
            device=CPU, dia_shape=(4, 4, 4), parts=(0, 4, 2))
