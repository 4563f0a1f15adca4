"""The structured V-cycle's transfers fused with K1 (``kernels/transfer.py``:
``box_restrict_residual``, ``box_prolong_update``; ``csrc/box_cycle.cu``).

On the CPU the wrappers run the plain versions, the compositions of the
pair each kernel replaces: they equal tpusolve's composition on every
transition of the 16^3 structured hierarchy, ``_restrict_local(b - A x)``
and ``x + _prolong_local(ec)`` followed by a Jacobi sweep or Chebyshev's
first step, to 1e-12 relative in f64 and 1e-5 in f32 (the tolerances
``tests/test_torch_structured.py`` holds level vectors to); on the 4-wide
box (125 slots, where tpusolve's flat DIA SpMV is faulty) they equal the
exact CSR product of the level's DIA dict to 1e-14.  One V-cycle of the
fused cycle equals tpusolve's at 16^3 for l1-Jacobi and Chebyshev, and
equals the pair-form cycle bit for bit.  The refusals are tried on ``meta``
tensors.  On the card (``cuda`` marker) each fused kernel equals the pair
of launches it replaces bit for bit, at boxes of K1's G = 1, 2, 4 and 16
threads a row, in f32 and f64, on one part and two, and twice the same.
"""

import itertools

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil
from tpusolve_torch.amg import structured
from tpusolve_torch.amg.dia_rap import dia_rap
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.kernels import dia, transfer
from tpusolve_torch.kernels.dia import dia_spmv, k1_plan
from tpusolve_torch.kernels.transfer import (
    box_prolong, box_prolong_update, box_restrict, box_restrict_residual,
    prolong_update_plain, restrict_residual_plain)

CPU = torch.device("cpu")
STENCIL = tuple(itertools.product((-1, 0, 1), repeat=3))
WIDE = tuple(itertools.product(range(-2, 3), repeat=3))
EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
# tests/test_torch_structured.py's tolerances for level vectors
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    import jax
    from tpusolve import stencil as ts
    from tpusolve.amg import structured as tst
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix.spmv import spmv as tspmv
    from tpusolve.matrix import vectors as tv
    from tpusolve.mesh import make_mesh
    return dict(jax=jax, stencil=ts, structured=tst, Config=TpConfig,
                spmv=tspmv, vec=tv, mesh=make_mesh(1))


def hierarchies(tp, dtype, **cfg):
    A, _, _, hp = stencil.laplace27(16, 16, 16, device=CPU, dtype=dtype,
                                    with_parts=True)
    pre = structured.structured_mg_setup_fast(A, BoomerAMGConfig(**cfg),
                                              host_parts=hp)
    At, _, _, hpt = tp["stencil"].laplace27(tp["mesh"], 16, 16, 16,
                                            dtype=dtype, with_parts=True)
    pre_t = tp["structured"].structured_mg_setup_fast(
        At, tp["Config"](**cfg), host_parts=hpt)
    return pre, pre_t


@pytest.fixture(scope="module", params=[np.float64, np.float32],
                ids=["f64", "f32"])
def h16(tp, request):
    return request.param, hierarchies(tp, request.param)


def transitions(pre):
    return [(i, tuple(pre.levels[i].A.dia_shape),
             tuple(pre.levels[i + 1].A.dia_shape))
            for i in range(len(pre.levels) - 1)]


@pytest.mark.parametrize("form", ["restrict", "jacobi", "chebyshev"])
def test_plain_equals_tpusolve_composition(tp, h16, form):
    """Every transition of the 16^3 hierarchy: the fused plain version (the
    CPU wrapper) against tpusolve's composition on its own level operator."""
    dtype, (pre, pre_t) = h16
    jnp = tp["jax"].numpy
    trans = transitions(pre)
    assert [t[1:] for t in trans] == [((16,) * 3, (8,) * 3),
                                      ((8,) * 3, (4,) * 3)]
    for i, fine, coarse in trans:
        lev, lev_t = pre.levels[i], pre_t.levels[i]
        A = lev.A
        rng = np.random.default_rng(20 + i)
        x, b = rng.standard_normal((2, lev.n)).astype(dtype)
        ec = rng.standard_normal(pre.levels[i + 1].n).astype(dtype)
        xt, bt, ect = (torch.from_numpy(v) for v in (x, b, ec))
        spmv_t = tp["jax"].jit(lambda v: tp["spmv"](lev_t.A, v))
        if form == "restrict":
            got = box_restrict_residual(fine, coarse, A.dia_vals,
                                        A.dia_offsets, xt, bt)
            ref = tp["structured"]._restrict_local(
                fine, coarse, jnp.asarray(b) - spmv_t(jnp.asarray(x)))
        else:
            dinv = (lev.dinv_l1 if form == "jacobi" else lev.dinv)
            dinv_t = jnp.asarray(dinv.numpy())
            xn = jnp.asarray(x) + tp["structured"]._prolong_local(
                fine, coarse, jnp.asarray(ec))
            r = dinv_t * (jnp.asarray(b) - spmv_t(xn))
            ref = xn + r if form == "jacobi" else r
            got = box_prolong_update(fine, coarse, A.dia_vals, A.dia_offsets,
                                     ect, xt, bt, dinv, 1.0,
                                     form == "jacobi")
        assert got.dtype == torch.from_numpy(x).dtype
        assert rel(got.numpy(), np.asarray(ref)) <= TOL[dtype]


@pytest.mark.parametrize("form", ["restrict", "jacobi", "chebyshev"])
def test_four_wide_box_equals_exact_product(form):
    """A 4-wide box under all 125 slots (the 8^3 -> 4^3 transition of a
    W-cycle's coarse levels): the exact CSR product of the DIA dict."""
    dia0, _ = stencil.laplace27_host_parts(1, 16, 16, 16)
    d, box = dia0, (16, 16, 16)
    for _ in range(2):
        d, box = dia_rap(d, box)
    assert box == (4, 4, 4) and len(d) == 125
    A = structured._dia_matrix(d, [EMPTY], box, 1, CPU, np.float64)
    H = structured._structured_to_csr(d, box, [EMPTY], 1)
    P = structured._p_box(box)
    coarse = (2, 2, 2)
    rng = np.random.default_rng(31)
    x, b, s = rng.standard_normal((3, 64))
    ec = rng.standard_normal(8)
    t = lambda v: torch.from_numpy(v)
    if form == "restrict":
        got = box_restrict_residual(box, coarse, A.dia_vals, A.dia_offsets,
                                    t(x), t(b))
        ref = P.T @ (b - H @ x)
    else:
        xn = x + P @ ec
        ref = s * (b - H @ xn) + (xn if form == "jacobi" else 0.0)
        got = box_prolong_update(box, coarse, A.dia_vals, A.dia_offsets,
                                 t(ec), t(x), t(b), t(s), 1.0,
                                 form == "jacobi")
    assert rel(got.numpy(), ref) <= 1e-14


@pytest.mark.parametrize("relax", [6, 16])
def test_one_vcycle_equals_tpusolve_and_the_pair(tp, relax):
    """One V-cycle at 16^3, l1-Jacobi (relax_type 6) and Chebyshev (16):
    against tpusolve's, and bit for bit against the pair-form cycle."""
    pre, pre_t = hierarchies(tp, np.float64, relax_type=relax)
    assert pre.cycle.fused == [(True, True), (True, True)]
    assert all("inside K1" in line for line in pre.layouts()[:-1])
    kinds = structured._resolve_kinds(pre.config)[:3]
    pair = structured._build_cycle(pre, *kinds[:2], pre.config,
                                   kind_coarse=kinds[2], fused=False)
    assert pair.fused == [(False, False), (False, False)]
    r = np.random.default_rng(40 + relax).standard_normal(pre.levels[0].n)
    A0 = pre_t.levels[0].A
    z_t = np.asarray(tp["jax"].jit(pre_t.apply)(tp["vec"].to_device_vector(
        tp["mesh"], r, A0.row_offsets, A0.row_pad, dtype=r.dtype)))
    z = pre.apply(torch.from_numpy(r))
    assert rel(z.numpy(), z_t) <= 1e-12
    assert torch.equal(z, pair(torch.from_numpy(r)))


def test_choice_shown_and_kept_on_other_cycles():
    """The fused forms are chosen at setup: without post-sweeps only the
    restriction fuses; an algebraic hierarchy keeps its K2 pairs."""
    A, _, _, hp = stencil.laplace27(8, 8, 8, device=CPU, with_parts=True)
    pre = structured.structured_mg_setup_fast(
        A, BoomerAMGConfig(num_up_sweeps=0), host_parts=hp)
    assert pre.cycle.fused == [(True, False)]
    assert pre.layouts()[0].endswith(
        "P, R box transfers inside K1 (restriction with the residual)")
    from tpusolve_torch.amg.builder import boomeramg_setup
    alg = boomeramg_setup(A, BoomerAMGConfig(max_coarse_size=64))
    assert all(lev.restrict_residual is None and lev.prolong_update is None
               for lev in alg.levels)
    assert not any(f for pair in alg.cycle.fused for f in pair)
    assert "inside K1" not in "".join(alg.layouts())


def test_cpu_launches_nothing():
    box, coarse = (8, 8, 8), (4, 4, 4)
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.standard_normal((1, 27) + box))
    x, b, s = (torch.from_numpy(rng.standard_normal(512)) for _ in range(3))
    ec = torch.from_numpy(rng.standard_normal(64))
    n = (box_restrict_residual.launches, box_prolong_update.launches)
    xn = torch.empty_like(x)
    y = box_prolong_update(box, coarse, vals, STENCIL, ec, x, b, s, 0.8,
                           True, xn)
    assert torch.equal(xn, transfer.prolong_plain(box, coarse, ec, x))
    assert torch.equal(y, dia.dia_spmv_plain(vals, STENCIL, xn, b, s, xn,
                                             0.8))
    assert torch.equal(
        box_restrict_residual(box, coarse, vals, STENCIL, x, b),
        transfer.restrict_plain(box, coarse,
                                dia.dia_spmv_plain(vals, STENCIL, x, b)))
    assert (box_restrict_residual.launches,
            box_prolong_update.launches) == n


def test_refusals():
    """Every check, tried on the meta device, where the device comes last."""
    box, coarse = (8, 8, 8), (4, 4, 4)
    meta = dict(device="meta", dtype=torch.float64)
    vals = torch.empty((1, 27) + box, **meta)
    x, b, s = (torch.empty(512, **meta) for _ in range(3))
    ec = torch.empty(64, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        box_restrict_residual(box, coarse, vals, STENCIL, x, b)
    with pytest.raises(ValueError, match="unsupported device"):
        box_prolong_update(box, coarse, vals, STENCIL, ec, x, b, s)
    with pytest.raises(ValueError, match="share memory"):
        box_prolong_update(box, coarse, vals, STENCIL, ec, x, b, s, out=x)
    with pytest.raises(ValueError, match="share memory"):
        box_prolong_update(box, coarse, vals, STENCIL, ec, x, b, s,
                           xnew_out=x)
    with pytest.raises(ValueError, match="share memory"):
        y = torch.empty(512, **meta)
        box_prolong_update(box, coarse, vals, STENCIL, ec, x, b, s,
                           xnew_out=y, out=y)
    with pytest.raises(ValueError, match="not twice"):
        box_restrict_residual(box, (4, 4, 3), vals, STENCIL, x, b)
    with pytest.raises(ValueError, match="fine box"):
        box_restrict_residual(box, coarse, torch.empty((1, 27, 8, 8, 6),
                                                       **meta), STENCIL, x, b)
    with pytest.raises(TypeError, match="dtype"):
        box_prolong_update(box, coarse, vals.to(torch.float32), STENCIL, ec,
                           x, b, s)
    with pytest.raises(TypeError, match="must be torch.float64"):
        box_restrict_residual(box, coarse, vals, STENCIL, x,
                              b.to(torch.float32))
    with pytest.raises(TypeError, match="dtype"):
        box_restrict_residual(box, coarse, vals.to(torch.int32), STENCIL,
                              x.to(torch.int32), b.to(torch.int32))
    with pytest.raises(TypeError, match="shape"):
        box_prolong_update(box, coarse, vals, STENCIL,
                           torch.empty(63, **meta), x, b, s)
    with pytest.raises(ValueError, match="offset triples"):
        box_restrict_residual(box, coarse, vals, STENCIL[:26], x, b)
    with pytest.raises(ValueError, match="contiguous"):
        box_restrict_residual(box, coarse, vals, STENCIL, x,
                              torch.empty(1024, **meta)[::2])


# ----------------------------------------------------------------------
# on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


# (fine box, slots): K1's G = 1, 2, 4, 16 threads a row
CARD_BOXES = [((64, 64, 64), STENCIL), ((64, 64, 64), WIDE),
              ((32, 32, 32), WIDE), ((16, 16, 16), WIDE), ((8, 8, 8), WIDE)]


def test_card_boxes_cover_every_g():
    assert [k1_plan(int(np.prod(box)), len(offs))
            for box, offs in CARD_BOXES] == [1, 2, 4, 16, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box, offsets", CARD_BOXES)
def test_fused_equal_the_pair_bit_for_bit(cuda, box, offsets, dtype):
    """Each fused kernel against the K1 -> K3 (K3 -> K1) pair, the Jacobi
    and Chebyshev forms of the prolongation, on one part and two; and the
    same bits twice."""
    coarse = tuple(d // 2 for d in box)
    n = int(np.prod(box))
    for parts in (1, 2):
        g = torch.Generator(device=cuda)
        g.manual_seed(parts)
        rand = lambda *shape: torch.randn(shape, generator=g, device=cuda,
                                          dtype=dtype)
        vals = rand(parts, len(offsets), *box)
        x, b, s = rand(parts * n), rand(parts * n), rand(parts * n)
        ec = rand(parts * n // 8)
        n0 = (box_restrict_residual.launches, box_prolong_update.launches)
        rc = box_restrict_residual(box, coarse, vals, offsets, x, b)
        xn = torch.empty_like(x)
        y_j = box_prolong_update(box, coarse, vals, offsets, ec, x, b, s,
                                 1.0, True)
        y_c = box_prolong_update(box, coarse, vals, offsets, ec, x, b, s,
                                 1.0, False, xn)
        again = (box_restrict_residual(box, coarse, vals, offsets, x, b),
                 box_prolong_update(box, coarse, vals, offsets, ec, x, b, s,
                                    1.0, True))
        torch.cuda.synchronize()
        assert (box_restrict_residual.launches,
                box_prolong_update.launches) == (n0[0] + 2, n0[1] + 3)
        assert torch.equal(rc, box_restrict(box, coarse, dia_spmv(
            vals, offsets, x, b=b)))
        xp = box_prolong(box, coarse, ec, x)
        assert torch.equal(xn, xp)
        assert torch.equal(y_j, dia_spmv(vals, offsets, xp, b, s, xp, 1.0))
        assert torch.equal(y_c, dia_spmv(vals, offsets, xp, b, s))
        assert torch.equal(again[0], rc) and torch.equal(again[1], y_j)
        # and the plain versions, to the summation order's roundoff
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        for got, plain in (
                (rc, restrict_residual_plain(box, coarse, vals.cpu(),
                                             offsets, x.cpu(), b.cpu())),
                (y_j, prolong_update_plain(box, coarse, vals.cpu(), offsets,
                                           ec.cpu(), x.cpu(), b.cpu(),
                                           s.cpu()))):
            assert rel(got.cpu().numpy(), plain.numpy()) <= tol
