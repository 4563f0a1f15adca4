"""K5's segment mask, its update form, and the ILU sweeps through it.

The segment mask of a BDIA operator marks the 32-row (block, slot) pieces of
its values that hold a nonzero; K5 skips the others.  The plain version of
K5 with the mask equals it with every segment set (the skipped products are
exact zeros) and ``tpusolve``'s Pallas XL kernel, run in interpret mode on
the same staged inputs with the overflow list added after it (f32 to rtol
1e-5, f64 to 1e-12: the summation orders differ).  The update form ``c +
w * s * (b - A x)`` equals ``epilogue_plain`` of the product bit for bit,
and ``ilu_apply``, whose sweeps now run through ``spmv_update``, gives the
bits of the eager sweeps it replaces and ``tpusolve``'s application to
1e-12.  On a card (marked ``cuda``) K5 equals K4 by ``torch.equal`` with
the mask and with every segment set, on an x that is not 16-byte aligned
too, and its update form equals its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.ilu.ilu import ilu_apply
from tpusolve_torch.kernels import bdia
from tpusolve_torch.kernels.dia import epilogue_plain
from tpusolve_torch.matrix import sharded
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update
from test_torch_bdia_xl import banded, forced_plan, k4_priced_slow, staged

CPU = torch.device("cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
# share of 32-row pieces zeroed in the operators below (gate 4's L at 96^3
# has 32.1 % all-zero pieces)
ZERO_SHARE = 0.3


def zero_pieces(vals, rng, share=ZERO_SHARE):
    """``vals`` (P, B, D, R) with ``share`` of its 32-row pieces zeroed."""
    P, B, D, R = vals.shape
    keep = rng.random((P, B, D, R // 32)) >= share
    return vals * np.repeat(keep, 32, axis=-1).astype(vals.dtype)


def operator(rng, dtype, n=5000, R=128, D=12):
    """(vals, starts, xpad, xlen, ovf, (rows, cols, vals) of the overflow) of
    a banded operator with an overflow list and zeroed pieces."""
    r, c, v = banded(rng, n, bw=60, per_row=9)
    out = bdia.compact(r, c, v, n, n, R, D, dtype=dtype, overflow=True)
    vals, starts, xpad, xlen, ovf = staged(r, c, v, n, R, dtype, D=D,
                                           overflow=True)
    return zero_pieces(vals, rng), starts, xpad, xlen, ovf, out[3:]


def pieces_live(vals):
    """Numpy: which 32-row pieces of ``vals`` hold a nonzero."""
    P, B, D, R = vals.shape
    return (vals.reshape(P, B, D, R // 32, 32) != 0).any(axis=-1)


class TestMask:
    @pytest.mark.parametrize("R", [128, 256, 512, 2048])
    def test_mask_equals_the_nonzero_pieces(self, rng, R):
        vals = zero_pieces(rng.standard_normal((2, 3, 5, R)), rng, 0.5)
        vals[0, 1, 2, 40] = 0.0          # a piece with one zero stays live
        mask = bdia.segment_mask(torch.from_numpy(vals))
        W = bdia.mask_bytes(R)
        assert mask.dtype == torch.uint8 and mask.shape == (2, 3, 5, W)
        bits = np.unpackbits(mask.numpy(), axis=-1, bitorder="little")
        live = pieces_live(vals)
        np.testing.assert_array_equal(bits[..., :R // 32].astype(bool), live)
        assert not bits[..., R // 32:].any()
        assert bdia.live_segments(mask) == int(live.sum())

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_operator_carries_its_mask(self, rng, monkeypatch, dtype):
        """Every BDIA operator of the assembly carries the mask of its
        stored values; ``astype`` builds it again from the cast values (a
        value that rounds to zero leaves its piece), and the kernel choice
        is ``choose_xl``'s on the live segments."""
        from test_torch_bdia_xl import clustered
        k4_priced_slow(monkeypatch)
        n = 60_000
        r, c, v = clustered(rng, n)
        v[r == c] = 1e-60       # the diagonal's slot: 0 in f32
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU, dtype=dtype)
        assert A.uses_bdia
        assert torch.equal(A.bdia_mask, bdia.segment_mask(A.bdia_vals))
        assert A.bdia_live == int(pieces_live(A.bdia_vals.numpy()).sum())
        _, B, D, R = A.bdia_vals.shape
        want = sharded.choose_xl(A.bdia_starts.numpy(), R, A.bdia_xpad,
                                 A.bdia_vals.element_size(), A.bdia_nbytes,
                                 A.bdia_live)
        assert A.uses_bdia_xl == (want is not None)
        A32 = A.astype(np.float32)
        assert torch.equal(A32.bdia_mask, bdia.segment_mask(A32.bdia_vals))
        if dtype == np.float64:
            assert A32.bdia_live < A.bdia_live

    def test_xl_priced_on_the_bytes_it_reads(self, rng):
        """Fewer live segments price K5 lower, K4 not at all."""
        from test_torch_bdia_xl import clustered
        n = 60_000
        r, c, v = clustered(rng, n)
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU)
        _, B, D, R = A.bdia_vals.shape
        starts, nb = A.bdia_starts.numpy(), A.bdia_nbytes
        full = sharded.plan_xl(starts, R, A.bdia_xpad, 8, nb)
        assert sharded.plan_xl(starts, R, A.bdia_xpad, 8, nb,
                               B * D * R // 32)[5] == full[5]
        half = sharded.plan_xl(starts, R, A.bdia_xpad, 8, nb,
                               B * D * R // 64)
        assert half[5] < full[5]
        assert sharded.skipped_bytes(1, B, D, R, 8, B * D * R // 64) \
            == B * D * R * 4


@pytest.fixture(scope="module")
def tpb():
    pytest.importorskip("jax")
    from tpusolve.kernels import bdia as tp_bdia
    return tp_bdia


class TestPlain:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_masked_plain_equals_unmasked_and_pallas_xl(self, tpb, dtype):
        import jax
        import jax.numpy as jnp
        rng = np.random.default_rng(23)
        n, R = 3000, 256
        vals, starts, xpad, xlen, ovf, (o_r, o_c, o_v) = operator(
            rng, dtype, n, R, D=16)
        assert int(ovf[0][0, -1]) > 0
        x = rng.standard_normal(n).astype(dtype)
        rowstart, pxrows, xrows_min = tpb.plan_panels(starts[0], R)
        xrows = max((xlen + tpb.LANE - 1) // tpb.LANE + R // tpb.LANE + 1,
                    xrows_min)
        with jax.enable_x64(True):
            ref = np.asarray(tpb.bdia_spmv_pallas_xl(
                jnp.asarray(vals[0]), jnp.asarray(starts[0]),
                jnp.asarray(rowstart), pxrows, xrows, jnp.asarray(x), xpad,
                xlen, n, interpret=True)).astype(np.float64)
        keep = o_r < n
        np.add.at(ref, o_r[keep], o_v[keep].astype(np.float64)
                  * x[o_c[keep]].astype(np.float64))
        vt = torch.from_numpy(vals)
        mask = bdia.segment_mask(vt)
        assert bdia.live_segments(mask) < vals.size // 32
        args = (vt, torch.from_numpy(starts), torch.from_numpy(x))
        every = bdia.full_mask(*vals.shape)
        for gb in (1, 5):
            plan, kw = forced_plan(starts, R, xpad, np.dtype(dtype).itemsize,
                                   gb)
            y0 = bdia.bdia_spmv_xl_plain(*args, xpad, n, *plan, ovf,
                                         mask=every, **kw)
            y = bdia.bdia_spmv_xl_plain(*args, xpad, n, *plan, ovf, mask=mask,
                                        **kw)
            assert torch.equal(y, y0)
            np.testing.assert_allclose(y.numpy(), ref, rtol=RTOL[dtype],
                                       atol=RTOL[dtype] * np.abs(ref).max())

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("form", ["b", "b,s", "c,w", "b,s,c,w"])
    def test_update_form_equals_epilogue_of_the_product(self, rng, dtype,
                                                        form):
        n = 5000
        vals, starts, xpad, _, ovf, _ = operator(rng, dtype, n)
        vt, st = torch.from_numpy(vals), torch.from_numpy(starts)
        plan, kw = forced_plan(starts, 128, xpad, np.dtype(dtype).itemsize, 4)
        kw["mask"] = bdia.segment_mask(vt)
        x, b, s, c = (torch.from_numpy(rng.standard_normal(n).astype(dtype))
                      for _ in range(4))
        upd = dict(b=b if "b" in form else None, s=s if "s" in form else None,
                   c=c if "c" in form else None,
                   w=0.7 if "w" in form else 1.0)
        y = bdia.bdia_spmv_xl_plain(vt, st, x, xpad, n, *plan, ovf, **kw)
        want = epilogue_plain(y, **upd)
        before = bdia.bdia_spmv_xl.launches
        got = bdia.bdia_spmv_xl(vt, st, x, xpad, n, *plan, ovf, **kw, **upd)
        assert bdia.bdia_spmv_xl.launches == before
        assert torch.equal(got, want)
        out = torch.empty_like(x)
        got = bdia.bdia_spmv_xl(vt, st, x, xpad, n, *plan, ovf, **kw,
                                out=out, **upd)
        assert got is out and torch.equal(out, want)
        # the eager expressions the ILU sweeps and smoothers computed
        eager = {"b": lambda: b - y, "b,s": lambda: s * (b - y),
                 "c,w": lambda: c - 0.7 * y,
                 "b,s,c,w": lambda: c + (0.7 * s) * (b - y)}[form]()
        assert torch.equal(want, eager)


def _eager_apply(L, U, dinv, r, lower, upper):
    """The ILU apply as it was computed before the sweeps went through
    ``spmv_update``."""
    z = r
    for _ in range(lower):
        z = r - spmv(L, z)
    x = dinv * z
    for _ in range(upper):
        x = dinv * (z - spmv(U, x))
    return x


def _momentum(side=14):
    from test_torch_ilu import momentum
    return momentum(side)


def _port_factors(layout, monkeypatch, dtype=np.float64, device=CPU):
    """(L, U, dinv) of the momentum operator's ILU(0) in ``layout``: "xl"
    (BDIA run by K5 on its step plan), "bdia" (run by K4; K2 priced out for
    both) or "ell" (K2, the model's choice at this size)."""
    from test_torch_sharded import k2_priced_out
    from tpusolve_torch.ilu.ilu import chow_patel_ilu
    if layout != "ell":
        k2_priced_out(monkeypatch)
    S = _momentum()
    L, d, U = chow_patel_ilu(S.copy(), sweeps=5)
    mats = []
    for M in (L.tocoo(), U.tocoo()):
        A = ShardedMatrix.from_coo(S.shape, M.row, M.col, M.data,
                                   device=device, dtype=dtype,
                                   allow_dia=False, allow_bell=False)
        if layout != "ell":
            _, B, D, R = A.bdia_vals.shape
            xl = sharded.plan_xl(A.bdia_starts.cpu().numpy(), R, A.bdia_xpad,
                                 A.bdia_vals.element_size(), A.bdia_nbytes,
                                 A.bdia_live, A.xl_work())
            A = A._with_xl(xl[:5] if layout == "xl" else None)
        mats.append(A)
    dinv = torch.from_numpy((1.0 / d).astype(dtype)).to(device)
    return mats[0], mats[1], dinv


class TestIluApply:
    @pytest.mark.parametrize("layout", ["xl", "bdia", "ell"])
    @pytest.mark.parametrize("iters", [(5, 5), (2, 3), (1, 1)])
    def test_apply_gives_the_eager_bits(self, monkeypatch, layout, iters):
        L, U, dinv = _port_factors(layout, monkeypatch)
        want = {"xl": "BDIA-XL", "bdia": "BDIA R=", "ell": "ELL"}[layout]
        assert L.layout.startswith(want) and U.layout.startswith(want), \
            (L.layout, U.layout)
        r = torch.from_numpy(np.random.default_rng(4).standard_normal(
            L.row_pad))
        keep = r.clone()
        z = ilu_apply(L, U, dinv, r, *iters)
        assert torch.equal(z, _eager_apply(L, U, dinv, r, *iters))
        assert torch.equal(r, keep)          # r is read, never written

    def test_xl_apply_equals_tpusolve(self, monkeypatch):
        """tpusolve's factors in tpusolve's BDIA layout, run here by K5's
        plain version: the apply equals tpusolve's to 1e-12."""
        pytest.importorskip("jax")
        from tpusolve.ilu import ilu as tp_ilu
        from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
        from tpusolve.matrix.vectors import to_device_vector as tp_vec
        from tpusolve.mesh import make_mesh
        from test_torch_sharded import tpusolve_fields
        mesh = make_mesh(1)
        S = _momentum()
        n = S.shape[0]
        Lh, d, Uh = tp_ilu.chow_patel_ilu(S.copy(), sweeps=5)
        ro = np.array([0, n])
        tri = []
        for M in (Lh.tocoo(), Uh.tocoo()):
            Mt = TpMatrix.from_coo(mesh, S.shape, M.row, M.col, M.data,
                                   dtype=np.float64, allow_dia=False,
                                   allow_bell=False)
            A = ShardedMatrix.from_arrays(*tpusolve_fields(Mt), device=CPU)
            _, B, D, R = A.bdia_vals.shape
            xl = sharded.plan_xl(A.bdia_starts.numpy(), R, A.bdia_xpad, 8,
                                 A.bdia_nbytes, A.bdia_live, A.xl_work())
            tri.append((Mt, A._with_xl(xl[:5])))
        (Lt, L), (Ut, U) = tri
        assert L.uses_bdia_xl and U.uses_bdia_xl
        dinv_t = tp_vec(mesh, 1.0 / d, ro, n)
        r = np.random.default_rng(4).standard_normal(n)
        z_t = np.asarray(tp_ilu.ilu_apply(Lt, Ut, dinv_t,
                                          tp_vec(mesh, r, ro, n), 5, 5))
        z = ilu_apply(L, U, torch.from_numpy(1.0 / d), torch.from_numpy(r),
                      5, 5).numpy()
        np.testing.assert_allclose(z, z_t, rtol=0,
                                   atol=1e-12 * np.abs(z_t).max())


def test_spmv_update_writes_out_without_a_copy(rng, monkeypatch):
    """On K4's BDIA the update's last step writes into ``out``; on every
    layout the result is the eager expression's."""
    L, _, dinv = _port_factors("bdia", monkeypatch)
    x, b = (torch.from_numpy(rng.standard_normal(L.row_pad))
            for _ in range(2))
    out = torch.empty_like(x)
    got = spmv_update(L, x, b=b, s=dinv, out=out)
    assert got is out and torch.equal(out, dinv * (b - spmv(L, x)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
class TestCudaKernel:
    """Needs only the card: no JAX and no conftest fixture."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("R,gb", [(128, 1), (128, 6), (128, 32),
                                      (512, 3)])
    def test_kernel_equals_k4_with_and_without_mask(self, cuda, dtype, R,
                                                    gb):
        rng = np.random.default_rng(17)
        n = 40_000
        vals, starts, xpad, xlen, ovf, _ = operator(rng, dtype, n, R, 24)
        plan, kw = forced_plan(starts, R, xpad, np.dtype(dtype).itemsize, gb,
                               cuda)
        vt, st = (torch.from_numpy(a).to(cuda) for a in (vals, starts))
        ovf = tuple(t.to(cuda) for t in ovf)
        mask = bdia.segment_mask(vt)
        x = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(cuda)
        buf = torch.empty(n + 1, dtype=x.dtype, device=cuda)
        buf[1:] = x
        y4 = bdia.bdia_spmv(vt, st, x, xpad, xlen, n, ovf)
        for m in (bdia.full_mask(*vt.shape, cuda), mask):
            for xx in (x, buf[1:]):
                y = bdia.bdia_spmv_xl(vt, st, xx, xpad, n, *plan, ovf, mask=m,
                                      **kw)
                assert torch.equal(y, y4)
        ref = bdia.bdia_spmv_xl_plain(vt, st, x, xpad, n, *plan, ovf,
                                      mask=mask, **kw)
        assert float((y4 - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("form", ["b", "b,s", "c,w", "b,s,c,w"])
    def test_update_form_equals_plain(self, cuda, dtype, form):
        rng = np.random.default_rng(18)
        n = 40_000
        vals, starts, xpad, xlen, ovf, _ = operator(rng, dtype, n, 128, 24)
        plan, kw = forced_plan(starts, 128, xpad, np.dtype(dtype).itemsize, 8,
                               cuda)
        vt, st = (torch.from_numpy(a).to(cuda) for a in (vals, starts))
        ovf = tuple(t.to(cuda) for t in ovf)
        kw["mask"] = bdia.segment_mask(vt)
        x, b, s, c = (torch.from_numpy(rng.standard_normal(n).astype(dtype))
                      .to(cuda) for _ in range(4))
        upd = dict(b=b if "b" in form else None, s=s if "s" in form else None,
                   c=c if "c" in form else None,
                   w=0.7 if "w" in form else 1.0)
        y4 = bdia.bdia_spmv(vt, st, x, xpad, xlen, n, ovf)
        got = bdia.bdia_spmv_xl(vt, st, x, xpad, n, *plan, ovf, **kw, **upd)
        assert torch.equal(got, epilogue_plain(y4, **upd))
        if upd["c"] is not None:          # in place into c
            cc = c.clone()
            bdia.bdia_spmv_xl(vt, st, x, xpad, n, *plan, ovf, **kw, out=cc,
                              **dict(upd, c=cc))
            assert torch.equal(cc, got)
        with pytest.raises(ValueError, match="overlap"):
            bdia.bdia_spmv_xl(vt, st, x, xpad, n, *plan, ovf, **kw, out=x,
                              **upd)

    def test_ilu_apply_on_xl_factors(self, cuda, monkeypatch):
        """The sweeps fused into K5: one launch a sweep, the eager bits."""
        L, U, dinv = _port_factors("xl", monkeypatch, np.float32, cuda)
        assert L.uses_bdia_xl and U.uses_bdia_xl
        r = torch.randn(L.row_pad, device=cuda)
        before = bdia.bdia_spmv_xl.launches
        z = ilu_apply(L, U, dinv, r, 5, 5)
        assert bdia.bdia_spmv_xl.launches == before + 10
        assert torch.equal(z, _eager_apply(L, U, dinv, r, 5, 5))
