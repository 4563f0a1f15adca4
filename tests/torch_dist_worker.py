"""A rank of the port's multi-process tests, and their launcher.

``launch(args, ranks)`` starts ``ranks`` processes of ``python
tests/torch_dist_worker.py ARGS`` (or of ``python -m tpusolve_torch ARGS``
with ``module=True``), joined by ``torch.distributed`` on gloo over a free
loopback port, one torch thread each, and returns each rank's exit code and
output; a run past its time limit has every process killed.  A worker runs
one case:

* ``ops DIR``: the operators of ``DIR/ops.npz`` (global COO, 8 parts)
  assembled over every part and placed as the rank's parts
  (``dist.place``); the rank's ghosts (``halo_gather``), ``spmv`` and
  ``spmv_update`` of a vector and a 3-column batch, ``allgather_host_coo``
  of its rows and ``fetch_host`` of a vector, saved to ``DIR/rank<r>.npz``;
* ``cli [--ilu-device] [--amg-device] -- CLI ARGS``: the port's CLI, with the
  device ILU floor (``--ilu-device``) or both device AMG floors
  (``--amg-device``) at one row.
"""

import functools
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OPS_PARTS = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, ranks: int = 2, module: bool = False, timeout: int = 240,
           cwd=None) -> list:
    """[(exit code, output)] of each rank."""
    port = _free_port()
    cmd = ([sys.executable, "-m", "tpusolve_torch"] if module
           else [sys.executable, os.path.abspath(__file__)])
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                       filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
        env.pop("PYTEST_XDIST_WORKER_COUNT", None)
        procs.append(subprocess.Popen(
            cmd + [str(a) for a in args], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd,
            start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def stage(A, v):
    """A global host vector (n,) or batch (k, n) as ``A``'s padded rows."""
    import numpy as np
    import torch
    from tpusolve_torch.matrix.vectors import pad_vector
    v = np.asarray(v)
    if v.ndim == 1:
        return torch.from_numpy(pad_vector(v, A.row_offsets, A.row_pad))
    return torch.from_numpy(np.stack([pad_vector(c, A.row_offsets, A.row_pad)
                                      for c in v]))


def products(A, data: dict) -> dict:
    """The ghosts, ``spmv`` and ``spmv_update`` of the vector and the
    batch of ``data`` on ``A`` (a whole operator or a rank's slice)."""
    from tpusolve_torch.matrix.spmv import halo_gather, spmv, spmv_update
    x, X = stage(A, data["x"]), stage(A, data["X"])
    kw = dict(b=stage(A, data["b"]), s=stage(A, data["s"]),
              c=stage(A, data["c"]), w=0.7)
    kwb = dict(kw, b=stage(A, data["B"]), c=stage(A, data["C"]))
    return {"ghosts": halo_gather(A, x), "ghosts batch": halo_gather(A, X),
            "spmv": spmv(A, x), "spmv batch": spmv(A, X),
            "spmv_update": spmv_update(A, x, **kw),
            "spmv_update batch": spmv_update(A, X, **kwb)}


def build(data: dict, name: str, device="cpu"):
    """Operator ``name`` of ``data`` over ``N_OPS_PARTS`` parts: in f32
    for a name ending ``f32``, run by K5 for one ending ``xl``, in K2's
    row-pointer form for ``rowptr``."""
    import numpy as np
    from tpusolve_torch.matrix import sharded
    n = int(data[f"{name} n"])
    keep = sharded.ell_form
    if name == "rowptr":
        # K2's row-pointer form on both blocks, which its model keeps for
        # larger operators
        sharded.ell_form = lambda *a, **k: ("rowptr", 1.0)
    try:
        A = sharded.ShardedMatrix.from_coo(
            (n, n), data[f"{name} rows"], data[f"{name} cols"],
            data[f"{name} vals"], device=device, dtype=np.float64,
            nparts=N_OPS_PARTS)
        A.offd_k2
    finally:
        sharded.ell_form = keep
    if name.endswith("xl"):
        # K5's step plan, where the model keeps K4 at this size
        from tpusolve_torch.matrix.sharded import plan_xl
        return A._with_xl(plan_xl(
            A.bdia_starts.numpy(), A.bdia_block, A.bdia_xpad,
            A.bdia_vals.element_size(), A.bdia_nbytes, A.bdia_live,
            A.xl_work())[:5])
    return A.astype(np.float32) if name.endswith("f32") else A


def _ops(out: str) -> None:
    import numpy as np
    from tpusolve_torch import dist
    data = dict(np.load(os.path.join(out, "ops.npz")))
    dist.init_distributed("cpu", "gloo")
    names = sorted({k.rsplit(" ", 1)[0] for k in data if k.endswith(" n")})
    res = {}
    for name in names:
        A = dist.place(build(data, name))
        cast = {k: data[k].astype(np.float32) if name.endswith("f32")
                else data[k] for k in ("x", "X", "b", "s", "c", "B", "C")}
        for key, t in products(A, cast).items():
            res[f"{name} {key}"] = t.numpy()
        res[f"{name} layout"] = np.array(A.layout)
    # the first operator's rows of this rank, gathered; a vector fetched
    A = dist.place(build(data, names[0]))
    lo, hi = A.row_offsets[0], A.row_offsets[-1]
    rows, cols, vals = (data[f"{names[0]} {k}"] for k in ("rows", "cols",
                                                            "vals"))
    own = (rows >= lo) & (rows < hi)
    g = dist.allgather_host_coo(rows[own], cols[own], vals[own])
    res.update({f"coo {k}": a for k, a in zip(("rows", "cols", "vals"), g)})
    res["fetch"] = dist.fetch_host(stage(A, data["x"]), A.all_row_offsets)
    np.savez(os.path.join(out, f"rank{dist.rank()}.npz"), **res)
    dist.destroy()


def _cli(argv) -> int:
    from tpusolve_torch.harness import cli, system
    sep = argv.index("--")
    flags, args = argv[:sep], argv[sep + 1:]
    if "--ilu-device" in flags:
        system.ilu_setup = functools.partial(system.ilu_setup,
                                             device_min_n=1)
    if "--amg-device" in flags:
        system.boomeramg_setup = functools.partial(system.boomeramg_setup,
                                                   device_min_n=1)
    return cli.main(args)


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    case, rest = sys.argv[1], sys.argv[2:]
    if case == "ops":
        _ops(rest[0])
        sys.exit(0)
    sys.exit(_cli(rest))
