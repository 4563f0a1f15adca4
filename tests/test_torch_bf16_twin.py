"""The bfloat16 smoother twin (``smoother_dtype: bfloat16``) against
``tpusolve``'s, ``tpusolve`` on one part.

The port's ``Level.A_relax`` is set on exactly the levels where
``tpusolve`` sets its own: on host hierarchies (gate 3's pressure operator,
where ``tpusolve`` stores level 0 BDIA and so has none there; the
RCM-ordered momentum operator, whose level 0 it stores BELL), on hierarchies set up on
the device (the stencil's DIA setup, the generic-ELL setup of the scrambled
32^2 Laplacian, ``TPUSOLVE_PMIS_HOST_RANK=1`` and
``TPUSOLVE_DEVICE_SETUP_MIN_N=1`` on ``tpusolve``'s side) and on the
structured one.  The plain bf16 SpMV on a twin equals ``tpusolve``'s twin
SpMV to 1e-12 relative in f64 (the same bf16 values, summed in another
order).  ``tpusolve``'s ``TestSmootherDtype`` cases (``tests/test_amg.py``)
run on both packages: the counts lie within one of ``tpusolve``'s in f32
and equal them in f64, and so do gate 3's at 16^3 through both harnesses.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.amg import builder, structured
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv
from tpusolve_torch.stencil import laplace27

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve.amg import builder as tb
    from tpusolve.amg import structured as tst
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.krylov.cg import pcg_setup as tp_pcg
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.matrix.spmv import spmv as tp_spmv
    from tpusolve.matrix.vectors import to_device_vector
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27 as tp_laplace27
    return dict(builder=tb, structured=tst, Config=TpConfig, pcg=tp_pcg,
                Matrix=TpMatrix, spmv=tp_spmv, vec=to_device_vector,
                laplace27=tp_laplace27, mesh=make_mesh(1))


def twins(pre) -> list:
    return [lev.A_relax is not None for lev in pre.levels]


def check_twins(pre, pre_t):
    """The same levels carry a twin; the port's are bf16, DIA or ELL."""
    assert twins(pre) == twins(pre_t)
    for lev in pre.levels:
        if lev.A_relax is not None:
            T = lev.A_relax
            assert T.dtype == torch.bfloat16 and (T.uses_dia or T.uses_ell)
            assert T.shape == lev.A.shape


def host_pair(tp, H, **cfg):
    """Both packages' host hierarchies of CSR ``H`` (f64, bf16 twins)."""
    cfg = dict(max_coarse_size=64, smoother_dtype="bfloat16", **cfg)
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64)
    pre = builder.boomeramg_setup(A, BoomerAMGConfig(**cfg), A_host=H,
                                  device_min_n=None)
    At = tp["Matrix"].from_csr_host(tp["mesh"], H, dtype=np.float64)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**cfg), A_host=H)
    return pre, pre_t


def test_twins_on_host_levels(tp):
    from test_torch_amg import gate3_csr
    from test_torch_ilu import momentum
    pre, pre_t = host_pair(tp, gate3_csr(12))
    check_twins(pre, pre_t)
    assert any(twins(pre))
    M = momentum(12)
    pre, pre_t = host_pair(tp, M)
    check_twins(pre, pre_t)
    # level 0: tpusolve stores it BELL (its Pallas kernel takes f32 only),
    # the port ELL: no twin on either side
    assert pre.levels[0].A.tpusolve_layout == "bell" and not twins(pre)[0]
    assert [lev.A.tpusolve_layout not in ("bdia", "bell")
            for lev in pre.levels] == twins(pre)


def test_plain_twin_spmv_equals_tpusolve(tp):
    from test_torch_amg import gate3_csr
    pre, pre_t = host_pair(tp, gate3_csr(12))
    rng = np.random.default_rng(9)
    assert any(twins(pre))
    for lev, lev_t in zip(pre.levels, pre_t.levels):
        A = lev_t.A_relax
        if A is None:
            continue
        x = rng.standard_normal(lev.A.shape[1])
        y_t = np.asarray(tp["spmv"](A, tp["vec"](
            tp["mesh"], x, np.asarray(A.col_offsets), A.col_pad,
            dtype=np.float64)))[:lev.n]
        xp = torch.zeros(lev.A_relax.col_pad, dtype=torch.float64)
        xp[:lev.n] = torch.from_numpy(x)
        y = spmv(lev.A_relax, xp).numpy()[:lev.n]
        assert np.abs(y - y_t).max() <= 1e-12 * np.abs(y_t).max()


def test_twins_on_dia_device_levels(tp, monkeypatch):
    monkeypatch.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
    monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
    cfg = dict(max_coarse_size=64, smoother_dtype="bfloat16")
    A = laplace27(12, 12, 12, device=CPU, dtype=np.float64)[0]
    pre = builder.boomeramg_setup(A, BoomerAMGConfig(**cfg), device_min_n=1)
    assert builder.DIA_NOTE in pre.notes
    At = tp["laplace27"](tp["mesh"], 12, 12, 12, dtype=np.float64)[0]
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**cfg))
    check_twins(pre, pre_t)
    assert pre.levels[0].A_relax.uses_dia


def test_twins_on_ell_device_levels(tp, monkeypatch):
    from test_torch_device_setup_ell import port_matrix, scrambled_laplace
    monkeypatch.setenv("TPUSOLVE_PMIS_HOST_RANK", "1")
    monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
    cfg = dict(max_coarse_size=64, smoother_dtype="bfloat16")
    H = scrambled_laplace(32)
    pre = builder.boomeramg_setup(port_matrix(H), BoomerAMGConfig(**cfg),
                                  A_host=H, device_min_n=1)
    assert builder.ELL_NOTE in pre.notes
    At = tp["Matrix"].from_csr_host(tp["mesh"], H, dtype=np.float64,
                                    allow_bell=False, allow_bdia=False)
    pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**cfg), A_host=H)
    check_twins(pre, pre_t)


def structured_pair(tp, side, dtype):
    cfg = dict(smoother_dtype="bfloat16")
    A, b, _, hp = laplace27(side, side, side, device=CPU, dtype=dtype,
                            with_parts=True)
    pre = structured.structured_mg_setup_fast(A, BoomerAMGConfig(**cfg),
                                              host_parts=hp)
    At, bt, _, hpt = tp["laplace27"](tp["mesh"], side, side, side,
                                     dtype=dtype, with_parts=True)
    pre_t = tp["structured"].structured_mg_setup_fast(
        At, tp["Config"](**cfg), host_parts=hpt)
    return (A, b, pre), (At, bt, pre_t)


def test_twins_on_structured_levels(tp):
    (_, _, pre), (_, _, pre_t) = structured_pair(tp, 16, np.float64)
    check_twins(pre, pre_t)
    assert all(twins(pre))


# tpusolve's TestSmootherDtype (tests/test_amg.py), on both packages

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_twin_converges(tp, dtype):
    A, b, _ = laplace27(12, 12, 12, device=CPU, dtype=dtype)
    At, bt, _ = tp["laplace27"](tp["mesh"], 12, 12, 12, dtype=dtype)
    counts = {}
    for twin in ("match", "bfloat16"):
        cfg = dict(max_coarse_size=64, smoother_dtype=twin)
        pre = builder.boomeramg_setup(A, BoomerAMGConfig(**cfg))
        pre_t = tp["builder"].boomeramg_setup(At, tp["Config"](**cfg))
        check_twins(pre, pre_t)
        res = pcg_setup(A, pre.apply, tol=1e-6, maxiter=60)(b)
        res_t = tp["pcg"](At, pre_t.apply, tol=1e-6, maxiter=60)(bt)
        assert bool(res.converged) and bool(res_t.converged)
        counts[twin] = int(res.iters), int(res_t.iters)
    (base, base_t), (lo, lo_t) = counts["match"], counts["bfloat16"]
    slack = 0 if dtype == np.float64 else 1
    assert abs(base - base_t) <= slack and abs(lo - lo_t) <= slack
    assert lo <= base + 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_structured(tp, dtype):
    (A, b, pre), (At, bt, pre_t) = structured_pair(tp, 16, dtype)
    assert pre.levels[0].A_relax.dia_vals.dtype == torch.bfloat16
    res = pcg_setup(A, pre.apply, tol=1e-6, maxiter=60)(b)
    res_t = tp["pcg"](At, pre_t.apply, tol=1e-6, maxiter=60)(bt)
    assert bool(res.converged) and bool(res_t.converged)
    slack = 0 if dtype == np.float64 else 1
    assert abs(int(res.iters) - int(res_t.iters)) <= slack


def test_yaml_key_parses(tmp_path):
    from tpusolve_torch.config import load_config
    y = tmp_path / "c.yaml"
    y.write_text("""
linear_system: {type: build_27pt_stencil, nx: 8, ny: 8, nz: 8}
solver_settings: {method: cg, preconditioner: boomeramg}
boomeramg_settings: {smoother_dtype: bfloat16}
""")
    assert load_config(str(y)).boomeramg.smoother_dtype == "bfloat16"


@pytest.mark.parametrize("precision", ["double", "single"])
def test_gate3_counts_equal_tpusolve(tmp_path, precision):
    """Gate 3's fixture at 16^3, GMRES + BoomerAMG with the twin, through
    both harnesses: the count equal in ``double``, within one in
    ``single``; the golden check passes in both precisions on both sides
    (in ``single`` the port's passes since K2 sums an f32 row in double)."""
    from test_torch_coupled import run_port, run_tpusolve
    from tpusolve_torch import fixtures
    path = fixtures.write_gate3(str(tmp_path), 16, solver_settings={
        "precision": precision}, boomeramg_settings={
        "smoother_dtype": "bfloat16"})
    it, _, _, ok = run_port(path)
    it_t, _, _, ok_t = run_tpusolve(path)
    assert ok_t and ok
    slack = 0 if precision == "double" else 1
    assert abs(it[0] - it_t[0]) <= slack, (it, it_t)
