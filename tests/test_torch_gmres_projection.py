"""Gate 2 in ``single``: why tpusolve's GMRES takes more iterations than the
port's.

``examples/gate2_weakscale_gmres_cheby.yaml`` (GMRES(20), one-step
classical Gram-Schmidt, Chebyshev-smoothed PFMG) is solved with tpusolve's
own operator A and preconditioner M on one part, four ways:

* tpusolve's GMRES as the CLI runs it (``cgs: 1``);
* tpusolve's GMRES with ``cgs: 2``;
* tpusolve's GMRES with its projection ``h = V @ w`` computed in f64 and
  rounded to f32 (everything else as it is);
* the port's GMRES (``tpusolve_torch/krylov/gmres.py``) on the same A and M.

It also reports the relative error of the first projection
``h0 = v0 . (A M v0)`` in f32 under XLA (jit, as tpusolve runs it) and under
torch (``torch.mv``, as the port runs it), against f64.

Run as a script for the numbers at one side (ROADMAP.md Queue 3 records
them at 64^3 and at the gate's own 128^3, which takes about 4 minutes and
9 GB of host memory on the CPU)::

    JAX_PLATFORMS=cpu python tests/test_torch_gmres_projection.py 128

Under pytest the same probe runs at 16^3, where all four agree within one
iteration and each projection error is below 1e-5.
"""

import importlib
import os
import sys
import tempfile
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ_OLD = "h = V @ w "
PROJ_F64 = ("h = (V.astype(jnp.float64) @ w.astype(jnp.float64))"
            ".astype(dtype) ")


def _gate2_yaml(side, directory):
    with open(os.path.join(REPO, "examples",
                           "gate2_weakscale_gmres_cheby.yaml")) as fh:
        text = fh.read()
    for axis in ("nx", "ny", "nz"):
        text = text.replace(f"{axis}: 128", f"{axis}: {side}")
    path = os.path.join(directory, f"gate2_{side}.yaml")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _tpusolve_operators(path):
    """(A, M, b, GMRES keywords) of tpusolve's gate-2 solve, one part."""
    import tpusolve.mesh
    from tpusolve.config import load_config
    from tpusolve.harness import system as tsys
    got = {}
    real = tsys.gmres_setup

    def grab(A, M, **kw):
        got.update(A=A, M=M, kw=kw)
        return real(A, M, **kw)
    tsys.gmres_setup = grab
    np.random.seed(1234)
    try:
        sys_ = tsys.LinearSystem(tpusolve.mesh.make_mesh(1),
                                 load_config(path))
        sys_.setup_precon_and_solver()
        sys_.load()
        sys_.solve()
    finally:
        tsys.gmres_setup = real
    return got["A"], got["M"], sys_.rhs[0], got["kw"]


def _gmres_f64_projection():
    """tpusolve's gmres module with its projection in f64 (needs x64)."""
    tg = importlib.import_module("tpusolve.krylov.gmres")
    with open(tg.__file__) as fh:
        src = fh.read()
    assert src.count(PROJ_OLD) == 1
    mod = types.ModuleType("gmres_f64_projection")
    exec(compile(src.replace(PROJ_OLD, PROJ_F64), tg.__file__, "exec"),
         mod.__dict__)
    return mod


def probe(side: int, directory: str) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from tpusolve.matrix.spmv import spmv as tspmv
    from tpusolve_torch.krylov.gmres import gmres_setup

    tg = importlib.import_module("tpusolve.krylov.gmres")
    A, M, b, kw = _tpusolve_operators(_gate2_yaml(side, directory))
    out = {"n": int(b.shape[0])}
    out["tpusolve_cgs1"] = int(tg.gmres_setup(A, M, **kw)(b).iters)
    out["tpusolve_cgs2"] = int(tg.gmres_setup(A, M, cgs=2, **kw)(b).iters)

    mv = jax.jit(lambda v: tspmv(A, v))
    pc = jax.jit(M.apply)

    def as_torch(a):
        return torch.from_numpy(np.array(a))

    def mv_t(v):
        return as_torch(mv(jnp.asarray(v.numpy())))

    def pc_t(v):
        return as_torch(pc(jnp.asarray(v.numpy())))
    b_t = as_torch(b)
    out["port_gmres"] = int(gmres_setup(mv_t, pc_t, **kw)(b_t).iters)

    # the first projection, h0 = v0 . w with w = A M v0
    v0 = b / jnp.linalg.norm(b)
    w = mv(pc(v0))
    exact = np.dot(np.asarray(v0, np.float64), np.asarray(w, np.float64))
    h_xla = float(jax.jit(lambda V, w: V @ w)(v0[None, :], w)[0])
    h_torch = float(torch.mv(as_torch(v0)[None, :], as_torch(w))[0])
    out["proj_err_xla"] = abs(h_xla - exact) / abs(exact)
    out["proj_err_torch"] = abs(h_torch - exact) / abs(exact)

    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        out["tpusolve_f64_projection"] = int(
            _gmres_f64_projection().gmres_setup(A, M, **kw)(b).iters)
    finally:
        jax.config.update("jax_enable_x64", was)
    return out


def test_gate2_projection_probe_small(tmp_path):
    pytest.importorskip("jax")
    got = probe(16, str(tmp_path))
    counts = [got[k] for k in ("tpusolve_cgs1", "tpusolve_cgs2",
                               "tpusolve_f64_projection", "port_gmres")]
    assert max(counts) - min(counts) <= 1 and min(counts) > 0, got
    assert got["proj_err_xla"] < 1e-5 and got["proj_err_torch"] < 1e-5, got


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as d:
        for key, val in probe(int(sys.argv[1]) if len(sys.argv) > 1 else 64,
                              d).items():
            print(f"{key}: {val}")
