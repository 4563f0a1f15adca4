"""tpusolve_torch's box-DIA SpMV (K1's plain version) against tpusolve's.

Random planes (numpy seed) through ``dia_spmv_plain`` and tpusolve's
``dia_spmv_local`` on boxes (16, 16, 16) with the 27 stencil triples,
(8, 8, 8) with all 125 triples of [-2, 2]^3 and (6, 8, 10), in f32 and f64:
the same slot order, so f64 agrees to 1e-14 and f32 to 1e-5 relative to
max |y|.

The recorded fault of the reference (ROADMAP.md Queue 3): on the 4^3
coarsest level of the structured hierarchy at 16^3, tpusolve turns flat
offsets back into triples and 40 of the 125 planes collide, so its SpMV
there is off by 5e-3 to 1e-2 relative; the port, which keeps the triples,
equals the exact CSR product to 1e-14.  A flat offset that does not name
one triple raises ``ValueError``.  The CUDA cases hold K1 against the
plain version and skip without a card.
"""

import itertools

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil
from tpusolve_torch.amg import structured
from tpusolve_torch.amg.dia_rap import dia_rap
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain
from tpusolve_torch.matrix.sharded import ShardedMatrix, dia_triples
from tpusolve_torch.matrix.spmv import spmv
from test_torch_sharded import tpusolve_fields

CPU = torch.device("cpu")
RTOL = {np.float32: 1e-5, np.float64: 1e-14}
STENCIL = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1))
WIDE = tuple(itertools.product(range(-2, 3), repeat=3))
CASES = [((16, 16, 16), STENCIL), ((8, 8, 8), WIDE), ((6, 8, 10), STENCIL)]
EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve import stencil as ts
    from tpusolve.amg import structured as tst
    from tpusolve.config import BoomerAMGConfig as TpConfig
    from tpusolve.matrix import vectors as tv
    from tpusolve.matrix.spmv import dia_spmv_local, spmv as tp_spmv
    from tpusolve.mesh import make_mesh
    import jax
    # jitted: tpusolve's shard_map SpMV run op by op takes about 20 s
    return dict(stencil=ts, structured=tst, Config=TpConfig, vec=tv,
                local=dia_spmv_local, spmv=jax.jit(tp_spmv),
                mesh=make_mesh(1))


def flat(t, box):
    return (t[0] * box[1] + t[1]) * box[2] + t[2]


def planes(box, offsets, dtype, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((1, len(offsets)) + box).astype(dtype)
    x = rng.standard_normal(int(np.prod(box))).astype(dtype)
    return vals, x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("box, offsets", CASES)
def test_plain_equals_tpusolve(tp, box, offsets, dtype):
    vals, x = planes(box, offsets, dtype, 1)
    y = dia_spmv_plain(torch.from_numpy(vals), offsets, torch.from_numpy(x))
    y_t = np.asarray(tp["local"](vals[0], [flat(t, box) for t in offsets],
                                 box, x))
    assert y.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(y.numpy(), y_t, rtol=0,
                               atol=RTOL[dtype] * np.abs(y_t).max())


def test_plain_reads_zero_outside_the_box():
    """Against a dense product: a neighbour outside the box adds nothing."""
    box = (3, 4, 5)
    vals, x = planes(box, WIDE, np.float64, 2)
    dense = np.zeros((60, 60))
    for k, t in enumerate(WIDE):
        for i, (z, y_, x_) in enumerate(itertools.product(*map(range, box))):
            zz, yy, xx = z + t[0], y_ + t[1], x_ + t[2]
            if 0 <= zz < 3 and 0 <= yy < 4 and 0 <= xx < 5:
                dense[i, (zz * 4 + yy) * 5 + xx] += vals[0, k, z, y_, x_]
    y = dia_spmv_plain(torch.from_numpy(vals), WIDE, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=0,
                               atol=1e-14 * np.abs(dense @ x).max())


@pytest.fixture(scope="module")
def port16():
    """The port's structured hierarchy at 16^3 in f64 with the default
    config, and its 4^3 level's DIA dict."""
    A, _, _, hp = stencil.laplace27(16, 16, 16, device=CPU, with_parts=True)
    pre = structured.structured_mg_setup_fast(A, BoomerAMGConfig(),
                                              host_parts=hp)
    dia, box = hp[0], (16, 16, 16)
    for _ in range(2):
        dia, box = dia_rap(dia, box)
    return pre, dia


@pytest.fixture(scope="module")
def coarse16(tp, port16):
    """(the port's, tpusolve's) hierarchies of :func:`port16`, and the 4^3
    level's DIA dict."""
    At, _, _, hpt = tp["stencil"].laplace27(tp["mesh"], 16, 16, 16,
                                            with_parts=True)
    pre_t = tp["structured"].structured_mg_setup_fast(
        At, tp["Config"](), host_parts=hpt)
    return port16[0], pre_t, port16[1]


def test_four_wide_box_exact_and_tpusolve_differs(tp, coarse16):
    pre, pre_t, dia4 = coarse16
    A4, A4_t = pre.levels[-1].A, pre_t.levels[-1].A
    assert A4.dia_shape == A4_t.dia_shape == (4, 4, 4)
    assert len(A4.dia_offsets) == 125 == len(set(A4.dia_offsets))
    assert len(set(A4_t.dia_offsets)) == 85        # 40 flat offsets collide
    H = structured._structured_to_csr(dia4, (4, 4, 4), [EMPTY], 1)
    x = np.random.default_rng(3).standard_normal(64)
    y_ref = H @ x
    y = spmv(A4, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-14 * np.abs(y_ref).max())
    y_t = np.asarray(tp["spmv"](A4_t, tp["vec"].to_device_vector(
        tp["mesh"], x, A4_t.row_offsets, A4_t.row_pad)))
    err_t = np.abs(y_t - y_ref).max() / np.abs(y_ref).max()
    assert err_t > 1e-3                  # the recorded fault (1.3e-2 here)
    # one level up (8^3) tpusolve's decomposition is unambiguous
    A8, A8_t = pre.levels[1].A, pre_t.levels[1].A
    x8 = np.random.default_rng(4).standard_normal(512)
    y8_t = np.asarray(tp["spmv"](A8_t, tp["vec"].to_device_vector(
        tp["mesh"], x8, A8_t.row_offsets, A8_t.row_pad)))
    np.testing.assert_allclose(spmv(A8, torch.from_numpy(x8)).numpy(), y8_t,
                               rtol=0, atol=1e-14 * np.abs(y8_t).max())


def test_ambiguous_decomposition_raises(tp, coarse16):
    _, pre_t, _ = coarse16
    with pytest.raises(ValueError, match="flat offsets are equal"):
        ShardedMatrix.from_arrays(*tpusolve_fields(pre_t.levels[-1].A),
                                  device=CPU)
    with pytest.raises(ValueError, match="ambiguous"):
        dia_triples([-2], (4, 4, 4))
    with pytest.raises(ValueError, match="ambiguous"):
        dia_triples([4 * 8 - 4], (3, 8, 8))
    assert dia_triples([-2], (8, 8, 8)) == ((0, 0, -2),)
    assert dia_triples([-2, 5]) == ((0, 0, -2), (0, 0, 5))
    assert dia_triples([(1, -1), (0, 2, 0)]) == ((0, 1, -1), (0, 2, 0))
    # the unambiguous 8^3 level comes across whole
    A8 = ShardedMatrix.from_arrays(*tpusolve_fields(pre_t.levels[1].A),
                                   device=CPU)
    assert abs(A8.to_scipy() - pre_t.levels[1].A.to_scipy()).max() == 0.0


def test_from_dia_parts_keeps_input_and_casts(port16):
    pre, _ = port16
    A = pre.levels[1].A
    vals = A.dia_vals.clone()
    B = ShardedMatrix.from_dia_parts(A.shape, A.dia_offsets, vals, [EMPTY],
                                     device=CPU, dia_shape=A.dia_shape)
    assert torch.equal(vals, A.dia_vals)
    assert torch.equal(B.diag, A.diag) and B.nnz == A.nnz
    B32 = B.astype(np.float32)
    assert B32.dia_offsets is B.dia_offsets
    assert B32.dia_vals.dtype == torch.float32 == B32.diag.dtype
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShardedMatrix.from_dia_parts(
            A.shape, A.dia_offsets, vals,
            [(np.array([0]), np.array([1]), np.array([1.0]))], device=CPU,
            dia_shape=A.dia_shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("box, offsets", CASES + [((1, 1, 5000),
                                                    ((0, 0, -700), (0, 0, 0),
                                                     (0, 0, 3)))])
def test_k1_equals_plain(cuda, box, offsets, dtype):
    vals, x = planes(box, offsets, dtype, 5)
    v, xt = torch.from_numpy(vals).to(cuda), torch.from_numpy(x).to(cuda)
    n0 = dia_spmv.launches
    y = dia_spmv(v, offsets, xt)
    torch.cuda.synchronize()
    assert dia_spmv.launches == n0 + 1
    y_p = dia_spmv_plain(v, offsets, xt)
    scale = float(y_p.abs().max())
    assert float((y - y_p).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.cuda
def test_k1_four_wide_box_exact(cuda, port16):
    pre, dia4 = port16
    A = pre.levels[-1].A
    H = structured._structured_to_csr(dia4, (4, 4, 4), [EMPTY], 1)
    x = np.random.default_rng(6).standard_normal(64)
    y = dia_spmv(A.dia_vals.to(cuda), A.dia_offsets,
                 torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(y, H @ x, rtol=0,
                               atol=1e-14 * np.abs(H @ x).max())
