"""The bfloat16 value forms of K1, K2 and the fused prolongation (the
smoother twin, ``smoother_dtype: bfloat16``).

A bf16 value widens exactly to f32 and f64, so every product of a bf16
value and an x entry, summed in x's dtype, is the full-precision
computation on the values rounded to bf16.  On the CPU the plain versions
with bf16 values equal the plain versions on the rounded values cast back,
bit for bit, in f32 and f64 and in every update form; the twin
(``amg/builder.py:_relax_twin``) keeps a DIA or ELL layout and lays a BDIA
or BELL operator out ELL where ``tpusolve`` keeps a twin.  On a card
(marked ``cuda``; no JAX, no conftest fixture) K1 at every threads-a-row
count, K2 in both forms and ``box_prolong_update`` on bf16 values equal
their f32 or f64 launches on the rounded values by ``torch.equal``, and the
plain version to 1e-5 (f32) and 1e-12 (f64) relative.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.amg.builder import _relax_twin
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.kernels import dia, ell, transfer
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update
from tpusolve_torch.stencil import laplace27

CPU = torch.device("cpu")
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
BF16 = BoomerAMGConfig(smoother_dtype="bfloat16")
# update forms as keyword arguments (vector names)
FORMS = {
    "Ax": {},
    "residual": dict(b="b"),
    "jacobi": dict(b="b", s="s", c="c", w=0.8),
    "chebyshev first": dict(b="b", s="s"),
    "chebyshev next": dict(s="s", c="c"),
}


def rounded(v: torch.Tensor, dtype) -> torch.Tensor:
    """Values rounded to bf16 and cast back to ``dtype``."""
    return v.to(torch.bfloat16).to(dtype)


def form_args(rng, n, dtype, device, form):
    vecs = {name: torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(
        device) for name in ("b", "s", "c")}
    return {k: (vecs[v] if isinstance(v, str) else v)
            for k, v in FORMS[form].items()}


@pytest.fixture
def gen():
    return np.random.default_rng(77)


def stencil_planes(rng, box, D=27):
    """(vals (1, D, *box) f64, offsets) of a random 27-point box-DIA."""
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1))[:D]
    return torch.from_numpy(rng.standard_normal((1, D) + box)), offs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_k1_plain_bf16_is_the_rounded_values(gen, dtype, form):
    vals, offs = stencil_planes(gen, (6, 5, 7))
    t = torch.float32 if dtype == np.float32 else torch.float64
    x = torch.from_numpy(gen.standard_normal(210).astype(dtype))
    kw = form_args(gen, 210, dtype, CPU, form)
    got = dia.dia_spmv(vals.to(torch.bfloat16), offs, x, **kw)
    want = dia.dia_spmv(rounded(vals, t), offs, x, **kw)
    assert got.dtype == t and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["padded", "rowptr"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_k2_plain_bf16_is_the_rounded_values(gen, dtype, storage, form):
    from test_torch_multi_rhs import ragged_ell
    vals, cols = ragged_ell(gen, 200, 150, 11, np.float64)
    t = torch.float32 if dtype == np.float32 else torch.float64
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    rowptr = None
    if storage == "rowptr":
        rowptr, v, c = ell.padded_to_rowptr(v, c)
    x = torch.from_numpy(gen.standard_normal(150).astype(dtype))
    kw = form_args(gen, 200, dtype, CPU, form)
    got = ell.ell_spmv(v.to(torch.bfloat16), c, x, rowptr=rowptr, **kw)
    want = ell.ell_spmv(rounded(v, t), c, x, rowptr=rowptr, **kw)
    assert got.dtype == t and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_prolong_update_plain_bf16_is_the_rounded_values(gen, dtype):
    fine, coarse = (8, 6, 10), (4, 3, 5)
    vals, offs = stencil_planes(gen, fine)
    t = torch.float32 if dtype == np.float32 else torch.float64
    vec = lambda n: torch.from_numpy(gen.standard_normal(n).astype(dtype))
    ec, x, b, s = vec(60), vec(480), vec(480), vec(480)
    got = transfer.box_prolong_update(fine, coarse, vals.to(torch.bfloat16),
                                      offs, ec, x, b, s, 0.7, True)
    want = transfer.box_prolong_update(fine, coarse, rounded(vals, t), offs,
                                       ec, x, b, s, 0.7, True)
    assert torch.equal(got, want)


def test_twin_keeps_dia_and_ell():
    """The stencil's DIA and an ELL operator keep their layout, their
    values rounded to bf16, and none is made without the key."""
    A = laplace27(6, 6, 6, device=CPU, dtype=np.float32)[0]
    assert _relax_twin(A, BoomerAMGConfig()) is None
    T = _relax_twin(A, BF16)
    assert T.uses_dia and T.dia_vals.dtype == torch.bfloat16
    assert torch.equal(T.dia_vals.float(), rounded(A.dia_vals, torch.float32))
    E = ShardedMatrix.from_csr_host(A.to_scipy(), device=CPU,
                                    dtype=np.float32, allow_dia=False,
                                    allow_bdia=False, allow_bell=False)
    TE = _relax_twin(E, BF16)
    assert TE.uses_ell and TE.layout == E.layout
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.col_pad).astype(np.float32))
    assert torch.equal(spmv(TE, x), spmv(TE.astype(torch.float32), x))


def test_twin_by_tpusolve_layout(monkeypatch):
    """A BDIA operator whose ``tpusolve`` layout is BDIA has no twin; one
    the port stores BDIA (K2 priced out) where ``tpusolve`` would store ELL
    gets an ELL twin of the same entries."""
    import dataclasses
    from test_torch_xl_segments import _port_factors
    L = _port_factors("bdia", monkeypatch)[0]
    assert L.uses_bdia
    assert _relax_twin(dataclasses.replace(L, tpusolve_layout="bdia"),
                       BF16) is None
    T = _relax_twin(dataclasses.replace(L, tpusolve_layout="ell"), BF16)
    assert T.uses_ell and T.dtype == torch.bfloat16
    want = L.to_scipy().toarray().astype(np.float32)
    got = T.astype(torch.float32).to_scipy().toarray()
    np.testing.assert_array_equal(got, torch.from_numpy(want).to(
        torch.bfloat16).float().numpy())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        L.col_pad))
    y = spmv_update(T, x, b=x)
    assert y.dtype == torch.float64 and torch.isfinite(y).all()


# ----------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_bf16_on_cuda(cuda, dtype):
    rng = np.random.default_rng(41)
    t = torch.float32 if dtype == np.float32 else torch.float64
    # even row counts take the warp-tile form at one thread a row, odd ones
    # (5 x 7 x 9, 1 x 1 x 301) the one-value form
    for box in ((64, 64, 64), (16, 16, 16), (1, 1, 300), (5, 7, 9),
                (1, 1, 301)):
        vals, offs = stencil_planes(rng, box)
        vb = vals.to(cuda).to(torch.bfloat16)
        vr = rounded(vals, t).to(cuda)
        n = int(np.prod(box))
        x = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(cuda)
        for form in FORMS:
            kw = form_args(rng, n, dtype, cuda, form)
            for g in dia.GROUPS:
                got = dia.dia_spmv(vb, offs, x, groups=g, **kw)
                want = dia.dia_spmv(vr, offs, x, groups=g, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (box, form, g)
            plain = dia.dia_spmv_plain(vr.cpu(), offs, x.cpu(), **{
                k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in kw.items()})
            assert rel(got.cpu(), plain) <= RTOL[t], (box, form)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["padded", "rowptr"])
def test_k2_bf16_on_cuda(cuda, dtype, storage):
    from test_torch_multi_rhs import ragged_ell
    rng = np.random.default_rng(42)
    t = torch.float32 if dtype == np.float32 else torch.float64
    for K, rows, ncols in ((27, 20000, 20000), (8, 3000, 9000)):
        vals, cols = ragged_ell(rng, rows, ncols, K, np.float64)
        v, c = (torch.from_numpy(a).to(cuda) for a in (vals, cols))
        rowptr = None
        if storage == "rowptr":
            rowptr, v, c = ell.padded_to_rowptr(v, c)
        x = torch.from_numpy(rng.standard_normal(ncols).astype(dtype)).to(
            cuda)
        for form in FORMS:
            kw = form_args(rng, rows, dtype, cuda, form)
            for g in ell.GROUPS:
                got = ell.ell_spmv(v.to(torch.bfloat16), c, x, rowptr=rowptr,
                                   groups=g, **kw)
                want = ell.ell_spmv(rounded(v, t), c, x, rowptr=rowptr,
                                    groups=g, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (K, form, g)
            plain = ell.ell_spmv(rounded(v, t).cpu(), c.cpu(), x.cpu(),
                                 rowptr=None if rowptr is None
                                 else rowptr.cpu(), **{
                                     k: (u.cpu() if torch.is_tensor(u) else u)
                                     for k, u in kw.items()})
            assert rel(got.cpu(), plain) <= RTOL[t], (K, form)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fine", [(64, 64, 64), (16, 16, 16)])
def test_prolong_update_bf16_on_cuda(cuda, dtype, fine):
    rng = np.random.default_rng(43)
    t = torch.float32 if dtype == np.float32 else torch.float64
    coarse = tuple(d // 2 for d in fine)
    vals, offs = stencil_planes(rng, fine)
    n = int(np.prod(fine))
    vec = lambda m: torch.from_numpy(rng.standard_normal(m).astype(
        dtype)).to(cuda)
    ec, x, b, s = vec(n // 8), vec(n), vec(n), vec(n)
    for c_is_xnew, w in ((True, 1.0), (False, 0.7)):
        xb, xr = torch.empty_like(x), torch.empty_like(x)
        got = transfer.box_prolong_update(
            fine, coarse, vals.to(cuda).to(torch.bfloat16), offs, ec, x, b,
            s, w, c_is_xnew, xb)
        want = transfer.box_prolong_update(
            fine, coarse, rounded(vals, t).to(cuda), offs, ec, x, b, s, w,
            c_is_xnew, xr)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(xb, xr)
        plain = transfer.prolong_update_plain(
            fine, coarse, rounded(vals, t), offs, ec.cpu(), x.cpu(), b.cpu(),
            s.cpu(), w, c_is_xnew)
        assert rel(got.cpu(), plain) <= RTOL[t]
