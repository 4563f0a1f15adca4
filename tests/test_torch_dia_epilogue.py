"""K1's update form ``y = c + w * s * (b - A x)`` and the callers that use
it (``matrix/spmv.py:spmv_update``), against the eager expressions they
replace and against tpusolve's smoothers.

On the CPU the update's plain version is the eager chain it replaces, bit
for bit: the cycle residual ``b - A x``, the Jacobi sweep
``x + w * dinv * (b - A x)``, and Chebyshev's ``dinv * (b - A x)`` and
``r - dinv * A d``; the port's ``jacobi_sweeps``, ``chebyshev_sweeps`` and
``chebyshev4_sweeps`` give the bits of their earlier eager code.  Against
tpusolve's sweeps on the same box-DIA operators (the 16^3 structured
hierarchy in f64: 16^3 with D = 27, 8^3 with D = 125) they agree to 1e-14;
on its 4^3 level, where tpusolve's flat offsets are wrong (ROADMAP.md Queue
3), they agree with the exact CSR product instead.  On BDIA, BELL and ELL
operators ``spmv_update`` is ``spmv`` and the same eager chain.  K1's
launch plan (``k1_plan``) keeps one thread a row on the large boxes, and
takes more on the small ones.  The CUDA
cases hold every form at every threads-a-row count against the plain
version, and two runs to the same bits; they skip without a card.
"""

import itertools

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil
from tpusolve_torch.amg import smoothers, structured
from tpusolve_torch.amg.dia_rap import dia_rap
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.kernels import dia
from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update
from test_torch_bdia import banded
from test_torch_bell import blocky

CPU = torch.device("cpu")
STENCIL = tuple(itertools.product((-1, 0, 1), repeat=3))
WIDE = tuple(itertools.product(range(-2, 3), repeat=3))
EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
RTOL = {np.float32: 1e-5, np.float64: 1e-12}

# form: (keyword arguments of the update as names, the eager chain)
FORMS = {
    "residual": (dict(b="b"), lambda A, x, b, s, c: b - A(x)),
    "jacobi": (dict(b="b", s="s", c="x", w=1.0),
               lambda A, x, b, s, c: x + 1.0 * s * (b - A(x))),
    "weighted jacobi": (dict(b="b", s="s", c="x", w=0.8),
                        lambda A, x, b, s, c: x + 0.8 * s * (b - A(x))),
    "chebyshev first": (dict(b="b", s="s"),
                        lambda A, x, b, s, c: s * (b - A(x))),
    "chebyshev next": (dict(s="s", c="c"),
                       lambda A, x, b, s, c: c - s * A(x)),
}


def planes(box, offsets, dtype, seed):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal(
        (1, len(offsets)) + box).astype(dtype))
    n = int(np.prod(box))
    vecs = {k: torch.from_numpy(rng.standard_normal(n).astype(dtype))
            for k in ("x", "b", "s", "c")}
    return vals, vecs


def kwargs(form, vecs):
    spec, _ = FORMS[form]
    return {k: (v if k == "w" else vecs[v]) for k, v in spec.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("box, offsets", [((8, 8, 8), STENCIL),
                                          ((6, 8, 10), WIDE)])
def test_plain_form_is_the_eager_chain(box, offsets, form, dtype):
    vals, v = planes(box, offsets, dtype, 1)
    A = lambda x: dia_spmv_plain(vals, offsets, x)
    ref = FORMS[form][1](A, v["x"], v["b"], v["s"], v["c"])
    kw = kwargs(form, v)
    n0 = dia_spmv.launches
    assert torch.equal(dia_spmv_plain(vals, offsets, v["x"], **kw), ref)
    assert torch.equal(dia_spmv(vals, offsets, v["x"], **kw), ref)
    M = ShardedMatrix.from_dia_parts(
        (vals[0, 0].numel(),) * 2, offsets, vals.numpy(), [EMPTY],
        device=CPU, dtype=dtype, dia_shape=box)
    assert torch.equal(spmv_update(M, v["x"], **kw), ref)
    assert dia_spmv.launches == n0          # CPU tensors launch nothing


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    import jax
    from tpusolve import stencil as ts
    from tpusolve.amg import smoothers as tsm
    from tpusolve.amg import structured as tst
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.mesh import make_mesh
    return dict(jax=jax, stencil=ts, smoothers=tsm, structured=tst,
                Config=TpConfig, mesh=make_mesh(1))


@pytest.fixture(scope="module")
def h16(tp):
    """The port's and tpusolve's structured hierarchies at 16^3 in f64."""
    A, _, _, hp = stencil.laplace27(16, 16, 16, device=CPU, with_parts=True)
    pre = structured.structured_mg_setup_fast(A, BoomerAMGConfig(),
                                              host_parts=hp)
    At, _, _, hpt = tp["stencil"].laplace27(tp["mesh"], 16, 16, 16,
                                            with_parts=True)
    pre_t = tp["structured"].structured_mg_setup_fast(
        At, tp["Config"](), host_parts=hpt)
    return pre, pre_t, hp[0]


def sweeps(mod, name, A, dinv, b, x):
    """One call of smoother ``name`` of module ``mod``, as the cycle makes
    it (Chebyshev of order 3 on the bounds (0.4, 2.2))."""
    if name == "jacobi":
        return mod.jacobi_sweeps(A, dinv, b, x, 2, 0.9)
    if name == "chebyshev":
        return mod.chebyshev_sweeps(A, dinv, b, x, (0.4, 2.2), 3)
    return mod.chebyshev4_sweeps(A, dinv, b, x, 2.2, 3)


SMOOTHERS = ("jacobi", "chebyshev", "chebyshev4")


@pytest.mark.parametrize("name", SMOOTHERS)
@pytest.mark.parametrize("level", [0, 1])
def test_smoothers_equal_tpusolve(tp, h16, level, name):
    pre, pre_t, _ = h16
    lev, lev_t = pre.levels[level], pre_t.levels[level]
    assert lev.A.uses_dia and len(lev.A.dia_offsets) == (27, 125)[level]
    rng = np.random.default_rng(10 + level)
    b, x = rng.standard_normal((2, lev.n))
    got = sweeps(smoothers, name, lev.A, lev.dinv, torch.from_numpy(b),
                 torch.from_numpy(x)).numpy()
    jnp = tp["jax"].numpy
    fn = tp["jax"].jit(lambda b_, x_: sweeps(tp["smoothers"], name, lev_t.A,
                                             lev_t.dinv, b_, x_))
    ref = np.asarray(fn(jnp.asarray(b), jnp.asarray(x)))
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("name", SMOOTHERS)
def test_four_wide_smoothers_equal_exact_product(h16, name):
    """On the 4^3 level tpusolve's SpMV is the faulty one; the exact CSR
    product of the level's DIA dict is the reference."""
    pre, _, dia0 = h16
    lev = pre.levels[2]
    dia4, box = dia0, (16, 16, 16)
    for _ in range(2):
        dia4, box = dia_rap(dia4, box)
    H = structured._structured_to_csr(dia4, box, [EMPTY], 1)
    rng = np.random.default_rng(12)
    b, x = rng.standard_normal((2, lev.n))
    dinv = lev.dinv.numpy()
    got = sweeps(smoothers, name, lev.A, lev.dinv, torch.from_numpy(b),
                 torch.from_numpy(x)).numpy()
    ref = _numpy_sweeps(name, H, dinv, b, x)
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


def _numpy_sweeps(name, H, dinv, b, x):
    """:func:`sweeps` in numpy on a scipy operator."""
    if name == "jacobi":
        for _ in range(2):
            x = x + 0.9 * dinv * (b - H @ x)
        return x
    if name == "chebyshev":
        lower, upper = 0.4, 2.2
        theta, delta = 0.5 * (upper + lower), 0.5 * (upper - lower)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - H @ x)
        d = r / theta
        for _ in range(2):
            x = x + d
            r = r - dinv * (H @ d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return x + d
    r = dinv * (b - H @ x)
    d = (4.0 / 3.0) * r / 2.2
    for k in range(1, 3):
        x = x + d
        r = r - dinv * (H @ d)
        d = ((2.0 * k - 1.0) / (2.0 * k + 3.0) * d
             + (8.0 * k + 4.0) / ((2.0 * k + 3.0) * 2.2) * r)
    return x + d


def _eager_sweeps(name, A, dinv, b, x):
    """The smoothers' eager code before the update form, verbatim."""
    if name == "jacobi":
        for _ in range(2):
            x = x + 0.9 * dinv * (b - spmv(A, x))
        return x
    if name == "chebyshev":
        lower, upper = 0.4, 2.2
        theta = 0.5 * (upper + lower)
        delta = 0.5 * (upper - lower)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - spmv(A, x))
        d = r / theta
        for _ in range(2):
            x = x + d
            r = r - dinv * spmv(A, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return x + d
    r = dinv * (b - spmv(A, x))
    d = (4.0 / 3.0) * r / 2.2
    for k in range(1, 3):
        x = x + d
        r = r - dinv * spmv(A, d)
        a1 = (2.0 * k - 1.0) / (2.0 * k + 3.0)
        a2 = (8.0 * k + 4.0) / ((2.0 * k + 3.0) * 2.2)
        d = a1 * d + a2 * r
    return x + d


@pytest.mark.parametrize("name", SMOOTHERS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_smoothers_keep_their_cpu_bits(name, dtype):
    A, _, _, hp = stencil.laplace27(8, 8, 8, device=CPU, dtype=dtype,
                                    with_parts=True)
    pre = structured.structured_mg_setup_fast(A, BoomerAMGConfig(),
                                              host_parts=hp)
    for lev in pre.levels:
        rng = np.random.default_rng(13)
        b, x = (torch.from_numpy(v.astype(dtype))
                for v in rng.standard_normal((2, lev.n)))
        assert torch.equal(sweeps(smoothers, name, lev.A, lev.dinv, b, x),
                           _eager_sweeps(name, lev.A, lev.dinv, b, x))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("layout, n", [("BDIA", 5000), ("BELL", 1500),
                                       ("ELL", 1500)])
def test_update_on_other_layouts_is_the_composition(layout, n, form):
    rng = np.random.default_rng(14)
    r, c, v = blocky(rng, n, nblk=8, width=40) if layout == "BELL" \
        else banded(rng, n)
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
    assert A.layout.startswith(layout) and not A.uses_dia, A.layout
    vecs = {k: torch.from_numpy(rng.standard_normal(A.row_pad))
            for k in ("x", "b", "s", "c")}
    ref = FORMS[form][1](lambda x: spmv(A, x), vecs["x"], vecs["b"],
                         vecs["s"], vecs["c"])
    assert torch.equal(spmv_update(A, vecs["x"], **kwargs(form, vecs)), ref)


def test_modes_and_refusals():
    assert dia.epilogue_mode() == "Ax"
    assert dia.epilogue_mode(b=1) == "w*(b-Ax)"
    assert dia.epilogue_mode(b=1, s=1, c=1) == "c+w*s*(b-Ax)"
    assert dia.epilogue_mode(s=1, c=1) == "c+w*s*(-Ax)"
    vals, v = planes((4, 4, 4), STENCIL, np.float64, 2)
    M = ShardedMatrix.from_dia_parts((64, 64), STENCIL, vals.numpy(),
                                     [EMPTY], device=CPU, dia_shape=(4,) * 3)
    with pytest.raises(ValueError, match="give b, s or c"):
        spmv_update(M, v["x"])
    meta = dict(device="meta", dtype=torch.float64)
    mv = torch.empty((1, 27, 4, 4, 4), **meta)
    mx = torch.empty(64, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        dia_spmv(mv, STENCIL, mx, b=mx)
    with pytest.raises(TypeError, match="dtype and shape"):
        dia_spmv(mv, STENCIL, mx, b=torch.empty(63, **meta))
    with pytest.raises(TypeError, match="dtype and shape"):
        dia_spmv(mv, STENCIL, mx, s=torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(mv, STENCIL, mx, c=torch.empty(128, **meta)[::2])
    with pytest.raises(ValueError, match="groups"):
        dia_spmv(mv, STENCIL, mx, groups=3)


def test_launch_plan():
    """The structured levels' plans, and the rule: G doubles only while
    the launch is short of threads or a thread holds too many slots, and
    never past one stage of 8 slots a thread."""
    assert [dia.k1_plan(side ** 3, D) for side, D in (
        (128, 27), (64, 27), (64, 125), (32, 125), (16, 125), (8, 125))] \
        == [1, 1, 2, 4, 16, 16]
    for rows, D in itertools.product((512, 4096, 32768, 262144, 2097152),
                                     (27, 64, 125)):
        g = dia.k1_plan(rows, D)
        assert g in dia.GROUPS and g <= 2 ** (-(-D // 8) - 1).bit_length()
        h = g // 2
        assert g == 1 or (rows * h < dia.K1_FILL_THREADS
                          or -(-D // h) > dia.K1_THREAD_SLOTS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("box, offsets", [((8, 8, 8), WIDE),
                                          ((16, 16, 16), WIDE),
                                          ((32, 32, 32), STENCIL)])
def test_k1_forms_equal_plain(cuda, box, offsets, dtype):
    """Every form at every threads-a-row count against the plain version;
    the same bits in two runs."""
    vals, v = planes(box, offsets, dtype, 3)
    vals = vals.to(cuda)
    v = {k: t.to(cuda) for k, t in v.items()}
    for form in ["Ax"] + list(FORMS):
        kw = {} if form == "Ax" else kwargs(form, v)
        ref = dia_spmv_plain(vals, offsets, v["x"], **kw)
        scale = float(ref.abs().max())
        for g in dia.GROUPS:
            y = dia_spmv(vals, offsets, v["x"], groups=g, **kw)
            y2 = dia_spmv(vals, offsets, v["x"], groups=g, **kw)
            torch.cuda.synchronize()
            assert float((y - ref).abs().max()) <= RTOL[dtype] * scale
            assert torch.equal(y, y2)
    mode = dia.epilogue_mode(v["b"], v["s"], v["x"])
    n0 = dia.launches_by_mode().get(mode, 0)
    dia_spmv(vals, offsets, v["x"], **kwargs("jacobi", v))
    assert dia.launches_by_mode()[mode] == n0 + 1
