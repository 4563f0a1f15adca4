"""The process half of the row decomposition (the port of
``tpusolve/mesh.py:83-214``; ``parts.py`` is the numpy half).

The reference runs one MPI rank a GPU (``mpiexec -np R src/hypre_app``,
src/main.cpp:9-35).  The port runs R processes joined by
``torch.distributed``, launched by ``torch.distributed.run``::

    python -m torch.distributed.run --nproc-per-node R -m tpusolve_torch \\
        INPUT.yaml --parts N [--dist-backend nccl|gloo]

Rank r holds parts ``[r N/R, (r+1) N/R)`` of the N-part operator on its
own device (``cuda:(LOCAL_RANK % device_count)``, or the CPU), reads only
its rows from the files (:func:`host_row_range`), and joins the others in
the host setup (the global COO, :func:`allgather_host_coo`), the halo
(:func:`exchange`, one ``all_to_all_single``), every Krylov reduction
(:func:`all_reduce`, one ``all_reduce``), the coarsest dense solve
(:func:`all_gather_cat`) and the golden check's verdict.  Every collective
of the port goes through this module.

The group is joined only when ``WORLD_SIZE`` > 1 (``tpusolve`` joins when a
coordinator is named); a failure raises, and the run never continues in one
process.  With no group every function here is the one-process identity,
so a one-process run keeps its bits.  The backend is the caller's:
``nccl`` (the default on CUDA) needs one card a rank, and NCCL refuses two
ranks on one card with its own error; ``gloo`` (the default on the CPU)
takes CUDA tensors too and moves them through the host, as MPI without
GPU-aware transport moves HYPRE's.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

from tpusolve_torch.matrix.vectors import unpad_vector

ROADMAP_ITEM = "ROADMAP.md Queue 1 item 19"
TIMEOUT_S = 600     # seconds a collective waits for the other ranks


@dataclass(frozen=True)
class Group:
    rank: int
    world: int
    backend: str
    device: torch.device

    @property
    def wire(self) -> torch.device:
        """Where host arrays travel: the CPU under gloo, the rank's card
        under NCCL (which moves only CUDA tensors)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


_GROUP: Group | None = None


def env_world() -> int:
    """The ranks ``torch.distributed.run`` started (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device_name: str = "cuda",
                     backend: str | None = None) -> Group | None:
    """Join the process group when ``WORLD_SIZE`` > 1 (the reference's
    ``MPI_Init``, src/main.cpp:33-35); returns the group, or None in a
    one-process run.  The rank's device is ``cuda:(LOCAL_RANK %
    device_count)`` for ``device_name`` ``"cuda"``, else the CPU; the
    backend defaults to ``nccl`` on CUDA and ``gloo`` on the CPU.  Raises
    where the group cannot be joined, and for ``nccl`` on the CPU.  A
    process already in the group gets its group back."""
    global _GROUP
    world = env_world()
    if world <= 1 or _GROUP is not None:
        return _GROUP
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device_name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: CUDA is not available")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=device if backend == "nccl" else None)
    _GROUP = Group(rank, world, backend, device)
    return _GROUP


def destroy() -> None:
    """Leave the group (the end of a run)."""
    global _GROUP
    if _GROUP is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        _GROUP = None


def group() -> Group | None:
    return _GROUP


def world() -> int:
    return 1 if _GROUP is None else _GROUP.world


def rank() -> int:
    return 0 if _GROUP is None else _GROUP.rank


def refuse(what: str) -> None:
    """Raise ``NotImplementedError`` for a path that does not run across
    ranks yet, when there is more than one; a no-op in one process."""
    if world() > 1:
        raise NotImplementedError(
            f"{what} does not run across {world()} processes yet "
            f"({ROADMAP_ITEM})")


def rank_parts(nparts: int) -> tuple[int, int]:
    """The parts ``[lo, hi)`` this rank holds of ``nparts``, which the
    ranks must divide."""
    R = world()
    if nparts % R:
        raise ValueError(f"{nparts} parts do not split over {R} ranks")
    per = nparts // R
    return rank() * per, (rank() + 1) * per


def host_row_range(offsets) -> tuple[int, int]:
    """The inclusive global rows this rank owns under the part offsets
    ``offsets`` (``tpusolve``'s ``host_row_range``, the reference's
    overlap-filtered reads, src/HypreSystem.cpp:1147, 1203-1236): every
    row in one process."""
    lo, hi = rank_parts(len(offsets) - 1)
    return int(offsets[lo]), int(offsets[hi]) - 1


def place(M):
    """This rank's parts of a ``ShardedMatrix`` built over every part on
    :func:`staging` (``ShardedMatrix.rank_slice``), on the rank's device;
    ``M`` itself in one process."""
    if _GROUP is None:
        return M
    return M.rank_slice(_GROUP.rank, _GROUP.world, _GROUP.device)


def staging(device) -> torch.device:
    """Where an operator over every part is assembled before :func:`place`
    keeps this rank's: the CPU across ranks, ``device`` in one process."""
    return torch.device(device) if _GROUP is None else torch.device("cpu")


# ----------------------------------------------------------------------
# collectives


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank the same bits (one
    ``all_reduce``); ``t`` itself in one process."""
    if _GROUP is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    dist.all_reduce(t)
    return t


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along the
    last axis in rank order: a vector over the ranks' parts is the global
    padded vector.  ``t`` itself in one process."""
    if _GROUP is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(_GROUP.world)]
    dist.all_gather(out, t)
    return torch.cat(out, dim=-1)


def exchange(send: torch.Tensor, send_splits, recv_splits) -> torch.Tensor:
    """One ``all_to_all_single``: ``send`` (n,) or a batch (k, n) holds
    ``send_splits[q]`` entries for rank q in rank order; returns what the
    ranks sent this one, ``recv_splits[p]`` entries from rank p, in rank
    order (the halo exchange, ``tpusolve/matrix/spmv.py:60-70``)."""
    import torch.distributed as dist
    batch = send.dim() == 2
    buf = send.T.contiguous() if batch else send.contiguous()
    recv = torch.empty((sum(recv_splits),) + tuple(buf.shape[1:]),
                       dtype=buf.dtype, device=buf.device)
    dist.all_to_all_single(recv, buf, list(recv_splits), list(send_splits))
    return recv.T if batch else recv


def sum_int(n: int) -> int:
    """The sum of an integer over the ranks (the golden check's bad
    rows)."""
    if _GROUP is None:
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64, device=_GROUP.wire)
    return int(all_reduce(t)[0])


def _gather_host(a: np.ndarray) -> list:
    """Every rank's 1-D host array, of any length, in rank order."""
    import torch.distributed as dist
    g = _GROUP
    lens = [torch.zeros(1, dtype=torch.int64, device=g.wire)
            for _ in range(g.world)]
    dist.all_gather(lens, torch.tensor([a.size], dtype=torch.int64,
                                       device=g.wire))
    lens = [int(n[0]) for n in lens]
    pad = np.zeros(max(lens), a.dtype)
    pad[:a.size] = a
    t = torch.from_numpy(pad).to(g.wire)
    out = [torch.empty_like(t) for _ in range(g.world)]
    dist.all_gather(out, t)
    return [o[:n].cpu().numpy() for o, n in zip(out, lens)]


def allgather_host_coo(rows, cols, vals) -> tuple:
    """The global COO on every rank from each rank's rows (``tpusolve``'s
    ``allgather_host_coo``, ``tpusolve/mesh.py:176``): the host setups
    (AMG, ILU) and the assembly's layout choice see the whole operator, the
    reference's setup being distributed inside HYPRE
    (src/HypreSystem.cpp:600-636, 692).  The triples as given in one
    process."""
    if _GROUP is None:
        return rows, cols, vals
    parts = [_gather_host(np.ascontiguousarray(a, dt)) for a, dt in (
        (rows, np.int64), (cols, np.int64), (vals, np.float64))]
    return tuple(np.concatenate(p) for p in parts)


def gather_scipy(M):
    """The global scipy CSR of every rank's rows ``M`` (global shape, each
    rank's own rows set)."""
    import scipy.sparse as sp
    if _GROUP is None:
        return M.tocsr()
    C = M.tocoo()
    r, c, v = allgather_host_coo(C.row, C.col, C.data)
    return sp.csr_matrix((v, (r, c)), shape=M.shape)


def fetch_host(x: torch.Tensor, row_offsets) -> np.ndarray:
    """The global host vector of a padded vector ``x`` over this rank's
    parts (``tpusolve``'s ``fetch_host``, ``tpusolve/mesh.py:47``): every
    rank's padded slice gathered (one ``all_gather``), then unpadded by
    ``row_offsets``, the offsets of every part."""
    nparts = len(row_offsets) - 1
    full = all_gather_cat(x.detach())
    pad = full.shape[-1] // nparts
    return unpad_vector(full.cpu().numpy(), row_offsets, pad)
