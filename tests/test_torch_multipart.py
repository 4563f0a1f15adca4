"""tpusolve_torch's multi-part operators against tpusolve's on its 8-device
mesh and against scipy.

The same numpy inputs build ``tpusolve``'s ShardedMatrix on ``mesh8`` and
the port's on 8 parts stacked on the CPU: the offd block, the halo plan and
the diag blocks equal array for array, the port's one-gather halo equals
``tpusolve``'s exchange, and ``spmv``, every ``spmv_update`` form and a
3-column batch equal scipy and ``tpusolve``'s ``spmv`` to 1e-12 relative
in f64, on DIA, ELL (both forms), BDIA (K4), BDIA-XL (K5) and BELL.  The
cases are ``tests/test_spmv.py``'s: uneven rows, tall and wide rectangles,
empty rows, a block diagonal without ghosts and a dense column of ghosts.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.matrix import sharded
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import (
    halo_exchange, halo_gather, spmv, spmv_update)
from tpusolve_torch.matrix.vectors import (
    from_device_vector, to_device_vector)

CPU = torch.device("cpu")
RTOL = 1e-12
P8 = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's many small CPU operations (the
    suite runs several workers on the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(rng, n, m, per_row=5):
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rng.integers(0, m, rows.size)
    key = np.unique(np.concatenate([rows * m + cols,
                                    np.arange(min(n, m)) * (m + 1)]))
    return key // m, key % m, rng.standard_normal(key.size), (n, m)


def _band(rng, n):
    """A band of three offset clusters (post-RCM shape), enough entries for
    the tile layouts."""
    rr = np.arange(n, dtype=np.int64)
    rows, cols = [], []
    for base in (-120, 0, 120):
        for dd in (-1, 0, 1):
            c = rr + base + dd
            ok = (c >= 0) & (c < n)
            rows.append(rr[ok])
            cols.append(c[ok])
    key = np.unique(np.concatenate(rows) * n + np.concatenate(cols))
    return key // n, key % n, rng.standard_normal(key.size), (n, n)


def _case(name, rng):
    if name == "uneven":
        return _random(rng, 61, 61)
    if name == "tall":
        return _random(rng, 61, 37, 3)
    if name == "wide":
        return _random(rng, 37, 61, 7)
    if name == "empty_rows":
        return (np.array([0, 23]), np.array([0, 23]), np.array([2.0, 3.0]),
                (24, 24))
    if name == "block_diag":
        r = np.arange(32)
        return r, r, np.full(32, 5.0), (32, 32)
    if name == "dense_col":
        r = np.arange(40)
        return (np.concatenate([r, r]), np.concatenate([r, np.full(40, 37)]),
                rng.standard_normal(80), (40, 40))
    raise KeyError(name)


CASES = ("uneven", "tall", "wide", "empty_rows", "block_diag", "dense_col")


@pytest.fixture(scope="module")
def tp(mesh8):
    """tpusolve's matrix modules on the 8-device mesh (skips without
    jax)."""
    pytest.importorskip("jax")
    import importlib
    tsh = importlib.import_module("tpusolve.matrix.sharded")
    tvec = importlib.import_module("tpusolve.matrix.vectors")
    tspmv = importlib.import_module("tpusolve.matrix.spmv")
    return dict(mesh=mesh8, SM=tsh.ShardedMatrix, spmv=tspmv.spmv,
                halo=tspmv.halo_exchange, vec=tvec)


def _both(tp, rows, cols, vals, shape, **kw):
    A = ShardedMatrix.from_coo(shape, rows, cols, vals, device=CPU,
                               nparts=P8, **kw)
    At = tp["SM"].from_coo(tp["mesh"], shape, rows, cols, vals, **kw)
    return A, At


def _vec(A, x, rows=False):
    off, pad = ((A.row_offsets, A.row_pad) if rows
                else (A.col_offsets, A.col_pad))
    return to_device_vector(x, off, pad, CPU, dtype=np.float64)


def _host(A, y):
    return from_device_vector(y, A.row_offsets, A.row_pad)


def _tp_spmv(tp, At, x):
    v = tp["vec"]
    xd = v.to_device_vector(tp["mesh"], x, At.col_offsets, At.col_pad)
    return np.asarray(v.from_device_vector(tp["spmv"](At, xd),
                                           At.row_offsets, At.row_pad))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", CASES + ("stencil",))
def test_operator_equals_tpusolve(tp, rng, name):
    """The offd block, the halo plan, the padding and the diag block of the
    port's 8-part operator equal ``tpusolve``'s array for array."""
    if name == "stencil":
        from tpusolve.stencil import laplace27 as tp_laplace27
        from tpusolve_torch.stencil import laplace27
        A = laplace27(4, 4, 6, device=CPU, nparts=P8)[0]
        At = tp_laplace27(tp["mesh"], 4, 4, 6)[0]
    else:
        A, At = _both(tp, *_case(name, rng))
    for k in ("row_offsets", "col_offsets", "row_pad", "col_pad", "shape",
              "has_offd", "nnz"):
        assert getattr(A, k) == getattr(At, k), k
    assert A.has_offd == (name not in ("block_diag", "empty_rows"))
    for k in ("offd_vals", "offd_cols", "send_idx", "ghost_slot", "diag"):
        a, b = getattr(A, k).numpy(), np.asarray(getattr(At, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert A.uses_dia == At.uses_dia
    if A.uses_dia:
        a = A.dia_vals.numpy().reshape(P8, len(A.dia_offsets), -1)
        b = np.asarray(At.dia_vals).reshape(a.shape)
        assert np.array_equal(a, b)
    else:
        if A.uses_ell_rowptr:
            from tpusolve_torch.kernels.ell import rowptr_to_padded
            K = At.diag_vals.shape[-1]
            pv, pc = zip(*(rowptr_to_padded(A.ell_rowptr[p], A.ell_vals[p],
                                            A.ell_cols[p], K)
                           for p in range(P8)))
            dv, dc = torch.stack(pv).numpy(), torch.stack(pc).numpy()
        else:
            dv, dc = A.diag_vals.numpy(), A.diag_cols.numpy()
        assert np.array_equal(dv, np.asarray(At.diag_vals))
        assert np.array_equal(dc, np.asarray(At.diag_cols))
    assert abs(A.to_scipy() - At.to_scipy()).max() == 0.0


@pytest.mark.parametrize("name", CASES)
def test_halo_gather_equals_tpusolve_exchange(tp, rng, name):
    """The one gather at ``halo_src``, the plan's two steps
    (:func:`halo_exchange`) and ``tpusolve``'s ``all_to_all`` exchange give
    every part the same ghosts."""
    import jax
    from jax.sharding import PartitionSpec as PS
    try:
        shard_map = jax.shard_map
    except AttributeError:     # pragma: no cover
        from jax.experimental.shard_map import shard_map
    A, At = _both(tp, *_case(name, rng))
    x = rng.standard_normal(A.shape[1])
    xd = _vec(A, x)
    g = halo_gather(A, xd).reshape(P8, -1)
    assert torch.equal(g, halo_exchange(xd, A.send_idx, A.ghost_slot))
    v = tp["vec"]
    xt = v.to_device_vector(tp["mesh"], x, At.col_offsets, At.col_pad)
    fn = shard_map(lambda xl, s, gs: tp["halo"](xl, s[0], gs[0],
                                                 At.axis)[None],
                   mesh=tp["mesh"], in_specs=(PS(At.axis),) * 3,
                   out_specs=PS(At.axis))
    gt = np.asarray(fn(xt, At.send_idx, At.ghost_slot))
    assert np.array_equal(g.numpy(), gt)


def test_padded_x_entries_never_read(rng):
    """Ghosts come from real x entries only: NaN in every padded slot of x
    leaves the product of the real rows finite and right."""
    rows, cols, vals, shape = _random(rng, 61, 61)
    A = ShardedMatrix.from_coo(shape, rows, cols, vals, device=CPU,
                               nparts=P8)
    assert A.row_pad * P8 > shape[0]
    x = rng.standard_normal(shape[1])
    xd = _vec(A, x)
    for p in range(P8):
        n_p = A.col_offsets[p + 1] - A.col_offsets[p]
        xd[p * A.col_pad + n_p:(p + 1) * A.col_pad] = float("nan")
    y = _host(A, spmv(A, xd))
    S = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    _close(y, S @ x)


def _layouts(rng, monkeypatch, kind):
    """An 8-part operator with its diag block in layout ``kind``, and its
    scipy form; ``ell_padded`` and ``ell_rowptr`` also force K2's form of
    the offd block."""
    if kind in ("ell_padded", "ell_rowptr"):
        form = kind.split("_")[1]
        monkeypatch.setattr(sharded, "ell_form",
                            lambda *a, **k: (form, 1.0))
        r, c, v, shape = _random(rng, 203, 203, 6)
        A = ShardedMatrix.from_coo(shape, r, c, v, device=CPU, nparts=P8,
                                   allow_dia=False, allow_bdia=False,
                                   allow_bell=False)
        assert A.uses_ell_rowptr == (form == "rowptr")
        assert (A.offd_k2[2] is None) == (form == "padded")
    elif kind == "dia":
        from tpusolve_torch.stencil import laplace27
        A = laplace27(4, 6, 4, device=CPU, nparts=P8)[0]
        A = dataclasses.replace(A, dia_vals=A.dia_vals * torch.from_numpy(
            rng.uniform(0.5, 1.5, tuple(A.dia_vals.shape))))
        return A, A.to_scipy()
    else:
        r, c, v, shape = _band(rng, 4000)
        kw = dict(allow_ell=False, allow_dia=False)
        kw["allow_bell" if kind.startswith("bdia") else "allow_bdia"] = False
        A = ShardedMatrix.from_coo(shape, r, c, v, device=CPU, nparts=P8,
                                   **kw)
        if kind == "bdia":
            A = A._with_xl(None)
        elif kind == "bdia_xl":
            xl = sharded.plan_xl(A.bdia_starts.numpy(), A.bdia_block,
                                 A.bdia_xpad, 8, A.bdia_nbytes, A.bdia_live,
                                 A.xl_work())
            A = A._with_xl(xl[:5])
        assert {"bdia": A.uses_bdia and not A.uses_bdia_xl,
                "bdia_xl": A.uses_bdia_xl, "bell": A.uses_bell}[kind]
    return A, A.to_scipy()


LAYOUTS = ("dia", "ell_padded", "ell_rowptr", "bdia", "bdia_xl", "bell")


@pytest.mark.parametrize("kind", LAYOUTS)
def test_spmv_forms_on_every_layout(tp, rng, monkeypatch, kind):
    """``spmv``, the update forms (residual, Jacobi, Chebyshev's, the
    prolongation's add into ``c``) and a 3-column batch of each on an 8-part
    operator: scipy to 1e-12, and ``tpusolve``'s ``spmv`` on its operator of
    the same entries."""
    A, S = _layouts(rng, monkeypatch, kind)
    assert A.has_offd and A.nparts == P8
    n, m = S.shape
    x, b, s, c = (rng.standard_normal(k) for k in (m, n, n, n))
    xd, bd, sd, cd = _vec(A, x), _vec(A, b, True), _vec(A, s, True), \
        _vec(A, c, True)
    _close(_host(A, spmv(A, xd)), S @ x)
    Sc = S.tocoo()
    At = tp["SM"].from_coo(tp["mesh"], S.shape, Sc.row, Sc.col, Sc.data)
    _close(_host(A, spmv(A, xd)), _tp_spmv(tp, At, x))
    forms = [(dict(b=bd), b - S @ x),
             (dict(b=bd, s=sd), s * (b - S @ x)),
             (dict(b=bd, s=sd, c=cd, w=0.7), c + 0.7 * s * (b - S @ x)),
             (dict(s=sd, c=cd), c - s * (S @ x)),
             (dict(c=cd.clone(), w=-1.0), c + S @ x)]
    for kw, want in forms:
        _close(_host(A, spmv_update(A, xd, **kw)), want)
    out = cd.clone()
    spmv_update(A, xd, c=out, w=-1.0, out=out)
    _close(_host(A, out), c + S @ x)
    X = torch.stack([xd, 2.0 * xd, xd + 1.0])
    B = torch.stack([bd, bd - 1.0, 3.0 * bd])
    Y = spmv(A, X)
    R = spmv_update(A, X, b=B, s=sd)
    for j, xj in enumerate((x, 2.0 * x, x + 1.0)):
        _close(_host(A, Y[j]), S @ xj)
        bj = _host(A, B[j])
        _close(_host(A, R[j]), s * (bj - S @ xj))


def test_astype_casts_the_offd_block(rng):
    r, c, v, shape = _random(rng, 61, 61)
    A = ShardedMatrix.from_coo(shape, r, c, v, device=CPU, nparts=P8)
    A32 = A.astype(np.float32)
    assert A32.offd_vals.dtype == torch.float32
    assert torch.equal(A32.offd_cols, A.offd_cols)
    x = rng.standard_normal(shape[1])
    y = _host(A32, spmv(A32, _vec(A, x).float()))
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-5, atol=1e-5)


def test_flat_k2_arrays_rebase_each_part(rng):
    """The N-part diag and offd blocks each run as one K2 launch: rows of
    all parts in turn, part p's columns rebased by p * col_pad (ghost slots
    by p * G), equal to the per-part products."""
    from tpusolve_torch.kernels.ell import ell_spmv
    r, c, v, shape = _random(rng, 203, 203, 6)
    A = ShardedMatrix.from_coo(shape, r, c, v, device=CPU, nparts=P8,
                               allow_dia=False, allow_bdia=False,
                               allow_bell=False)
    x = rng.standard_normal(shape[1])
    xd = _vec(A, x)
    vals, cols, rowptr = A.ell_arrays
    assert int(cols.max()) < P8 * A.col_pad
    y = ell_spmv(vals, cols, xd, rowptr=rowptr)
    g = halo_gather(A, xd)
    ov, oc, orp = A.offd_k2
    assert int(oc.max()) < g.numel()
    y = y + ell_spmv(ov, oc, g, rowptr=orp)
    _close(_host(A, y), A.to_scipy() @ x)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["padded", "rowptr"])
@pytest.mark.parametrize("k", [1, 3])
def test_offd_k2_on_cuda_equals_cpu(monkeypatch, form, k):
    """K2 on the stacked offd block on the card, both forms, one and three
    columns: the CPU's plain version to 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    rng = np.random.default_rng(5)
    cuda = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setattr(sharded, "ell_form", lambda *a, **kw: (form, 1.0))
    r, c, v, shape = _random(rng, 2003, 2003, 6)
    A = ShardedMatrix.from_coo(shape, r, c, v, device=CPU, nparts=P8,
                               allow_dia=False, allow_bdia=False,
                               allow_bell=False)
    Ac = ShardedMatrix.from_coo(shape, r, c, v, device=cuda, nparts=P8,
                                allow_dia=False, allow_bdia=False,
                                allow_bell=False)
    X = torch.from_numpy(rng.standard_normal((k, P8 * A.col_pad)))
    for p in range(P8):
        X[:, p * A.col_pad + A.col_offsets[p + 1] - A.col_offsets[p]:
          (p + 1) * A.col_pad] = 0.0
    X = X[0] if k == 1 else X
    want = spmv(A, X)
    got = spmv(Ac, X.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
