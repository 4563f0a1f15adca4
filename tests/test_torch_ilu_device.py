"""tpusolve_torch's device ILU(0) (``ilu/device_setup.py``) against
tpusolve's (``tpusolve/ilu/device_setup.py``), as
``tests/test_ilu_device.py`` holds tpusolve's against its host path.

The same numpy inputs go through both packages on the CPU: the DIA factors
(the band pattern) and the ELL factors (the stored pattern) and ``udiag_inv``
equal tpusolve's device factors, and the host Chow-Patel factors on the
same pattern, to 1e-12 relative in f64; a nonsymmetric solve converges in
tpusolve's count; ILUT stays on the host; on more than one part each
part's diag block is factored alone (block-Jacobi).  The
record of tpusolve's layout (``ShardedMatrix.tpusolve_layout``) equals the
layout class tpusolve's ``from_coo`` picks, and the device-or-host choice
equals tpusolve's ``_device_path``, on the gate-4 fixture scrambled, after
RCM and in natural order.  The CUDA cases run the factorizations on the
card against the same code on the CPU; they skip without one.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.config import ILUConfig
from tpusolve_torch.fixtures import make_system
from tpusolve_torch.ilu import device_setup
from tpusolve_torch.ilu.ilu import chow_patel_ilu, ilu_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import to_device_vector
from tpusolve_torch.stencil import laplace27

CPU = torch.device("cpu")


@pytest.fixture
def tp(monkeypatch):
    """tpusolve's ILU, with its device row floor at 1 row (the port's
    ``device_min_n=1``)."""
    pytest.importorskip("jax")
    monkeypatch.setenv("TPUSOLVE_ILU_DEVICE_MIN_N", "1")
    from tpusolve.config import ILUConfig as TpILUConfig
    from tpusolve.ilu import device_setup as tp_dev
    from tpusolve.ilu import ilu as tp_ilu
    from tpusolve.matrix.sharded import ShardedMatrix as TpMatrix
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27 as tp_laplace27
    return dict(ilu=tp_ilu, dev=tp_dev, cfg=TpILUConfig, Matrix=TpMatrix,
                mesh=make_mesh(1), laplace27=tp_laplace27)


def rel(M, M_ref) -> float:
    d = abs(M - M_ref)
    return (d.max() if d.nnz else 0.0) / abs(M_ref).max()


def check_factors(pre, L_ref, d_ref, U_ref, n, tol=1e-12):
    assert rel(pre.L.to_scipy(), L_ref) <= tol
    assert rel(pre.U.to_scipy(), U_ref) <= tol
    np.testing.assert_allclose(pre.udiag_inv.cpu().numpy()[:n], d_ref,
                               rtol=tol, atol=0)


def test_dia_factors_equal_tpusolve_and_host(tp):
    At, _, _ = tp["laplace27"](tp["mesh"], 6, 5, 4, dtype=np.float64)
    A, _, _ = laplace27(6, 5, 4, device=CPU, dtype=np.float64)
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    pre_t = tp["ilu"].ilu_setup(At, tp["cfg"]())
    assert pre.notes == pre_t.notes and "on device (DIA" in pre.notes[0]
    assert pre.L.uses_dia and pre.U.uses_dia
    n = A.shape[0]
    check_factors(pre, pre_t.L.to_scipy(), np.asarray(pre_t.udiag_inv)[:n],
                  pre_t.U.to_scipy(), n)
    # the host Chow-Patel factors on the band pattern
    H = device_setup.band_csr(A)
    Lh, ujj, Uh = chow_patel_ilu(H, sweeps=5)
    check_factors(pre, Lh, 1.0 / ujj, Uh, n)


def test_nonsymmetric_dia_solve_in_tpusolves_count(tp):
    """Momentum-like planes (the upper side scaled 1.25, the lower 0.8):
    BiCGSTAB with the device ILU converges in tpusolve's count and beats
    no preconditioner."""
    from tpusolve.krylov.bicgstab import bicgstab_setup as tp_bicgstab
    from tpusolve.matrix.vectors import to_device_vector as tp_vec
    from tpusolve_torch.krylov.bicgstab import bicgstab_setup
    A0, b, _ = laplace27(8, 8, 8, device=CPU, dtype=np.float64)
    planes = A0.dia_vals.clone()
    for k, t in enumerate(A0.dia_offsets):
        if t != (0, 0, 0):
            planes[:, k] *= 1.25 if t > (0, 0, 0) else 0.8
    empty = np.zeros(0, np.int64)
    A = ShardedMatrix.from_dia_parts(A0.shape, A0.dia_offsets, planes,
                                     [(empty, empty, empty)], device=CPU,
                                     dia_shape=(8, 8, 8))
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    res = bicgstab_setup(A, pre.apply, tol=1e-10, maxiter=60)(b)
    plain = bicgstab_setup(A, None, tol=1e-10, maxiter=200)(b)
    assert bool(res.converged) and res.iters < plain.iters
    flat = [(t[0] * 8 + t[1]) * 8 + t[2] for t in A.dia_offsets]
    At = tp["Matrix"].from_dia_parts(
        tp["mesh"], A.shape, flat, planes.numpy().reshape(1, len(flat), -1),
        [(empty, empty, np.zeros(0))], dtype=np.float64,
        dia_shape=(8, 8, 8))
    pre_t = tp["ilu"].ilu_setup(At, tp["cfg"]())
    bt = tp_vec(tp["mesh"], b.numpy(), At.row_offsets, At.row_pad)
    res_t = tp_bicgstab(At, pre_t.apply, tol=1e-10, maxiter=60)(bt)
    assert int(res_t.iters) == res.iters


def test_host_path_for_ilut_and_one_sided_band(tp):
    A, _, _ = laplace27(5, 4, 4, device=CPU, dtype=np.float64)
    pre = ilu_setup(A, ILUConfig(ilu_type=1), device_min_n=1)
    assert not any("on device" in s for s in pre.notes)
    assert device_setup.device_path(A, ILUConfig(ilu_fill_level=1), 1) \
        is None
    assert device_setup.device_path(
        A, ILUConfig(ilu_local_reordering=1), 1) is None
    assert device_setup.device_path(A, ILUConfig(), None) is None
    # a band with planes on one side of the diagonal only
    H = sp.tril(A.to_scipy()).tocsr()
    Lw = ShardedMatrix.from_csr_host(H, device=CPU)
    assert Lw.uses_dia and device_setup.device_path(Lw, ILUConfig(), 1) \
        is None


def scrambled_poisson(n_side: int, seed: int = 0) -> sp.csr_matrix:
    """The 2-D 5-point Laplacian under a random symmetric permutation
    (``tests/test_ilu_device.py``'s operator)."""
    L1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n_side, n_side))
    A2 = sp.kronsum(L1, L1, format="csr")
    n = A2.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    Pm = sp.csr_matrix((np.ones(n), (np.arange(n), perm)), shape=(n, n))
    M = (Pm @ A2 @ Pm.T).tocsr()
    M.sort_indices()
    return M


def momentum(side: int) -> sp.csr_matrix:
    r, c, v, _, n = make_system(side, side, side, seed=11, nonsym=0.35)
    return sp.csr_matrix((v, (r, c)), shape=(n, n))


@pytest.mark.parametrize("which", ["poisson", "momentum"])
def test_ell_factors_equal_tpusolve_and_host(tp, which):
    H = scrambled_poisson(20) if which == "poisson" else momentum(10)
    kw = dict(allow_dia=False, allow_bell=False, allow_bdia=False)
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64, **kw)
    At = tp["Matrix"].from_csr_host(tp["mesh"], H, dtype=np.float64, **kw)
    assert A.uses_ell and A.tpusolve_layout == "ell"
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    pre_t = tp["ilu"].ilu_setup(At, tp["cfg"]())
    assert pre.notes == pre_t.notes and "generic-ELL" in pre.notes[0]
    assert pre.L.uses_ell and pre.U.uses_ell
    n = A.shape[0]
    check_factors(pre, pre_t.L.to_scipy(), np.asarray(pre_t.udiag_inv)[:n],
                  pre_t.U.to_scipy(), n)
    Lh, ujj, Uh = chow_patel_ilu(H, sweeps=5)
    check_factors(pre, Lh, 1.0 / ujj, Uh, n)
    # the application through K2's plain version equals tpusolve's
    from tpusolve.matrix.vectors import to_device_vector as tp_vec
    r = np.random.default_rng(3).standard_normal(n)
    z_t = np.asarray(pre_t.apply(tp_vec(tp["mesh"], r, At.row_offsets,
                                        At.row_pad)))
    z = pre.apply(to_device_vector(r, A.row_offsets, A.row_pad, CPU)).numpy()
    np.testing.assert_allclose(z, z_t, rtol=0, atol=1e-12 * np.abs(z_t).max())


def test_ell_budget_chunks_equal_one_chunk():
    """The table built and applied in many small chunks gives the one-chunk
    factors bit for bit."""
    H = momentum(6)
    A = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                    allow_bell=False, allow_bdia=False)
    vals, cols = device_setup._ell_padded(A)
    KL, KU = device_setup.ilu_widths(vals, cols)
    R, K = vals.shape
    one = device_setup.make_ell_factorizer(R, K, 5, KL, KU)(vals, cols)
    many = device_setup.make_ell_factorizer(R, K, 5, KL, KU,
                                            budget=4096)(vals, cols)
    for a, b in zip(one, many):
        assert torch.equal(a, b)


def test_multi_part_raises():
    """More than one part no longer raises: each part's diag block is
    factored alone (block-Jacobi, the offd block left out), so the 2-part
    factors equal the one-part factors of each part's block."""
    A, _, _ = laplace27(5, 4, 4, device=CPU, dtype=np.float64, nparts=2)
    H = momentum(5)
    E = ShardedMatrix.from_csr_host(H, device=CPU, dtype=np.float64,
                                    nparts=2, allow_bell=False,
                                    allow_bdia=False)
    for M, setup in ((A, device_setup.ilu_setup_device),
                     (E, device_setup.ilu_setup_device_ell)):
        assert M.nparts == 2 and M.has_offd
        pre = setup(M, ILUConfig())
        assert pre.L.nparts == 2 and not pre.L.has_offd
        ro = M.row_offsets
        S = M.to_scipy().tocsr()
        for p in range(2):
            lo, hi = ro[p], ro[p + 1]
            B = ShardedMatrix.from_csr_host(
                S[lo:hi, lo:hi], device=CPU, dtype=np.float64,
                allow_dia=False, allow_bell=False, allow_bdia=False)
            one = device_setup.ilu_setup_device_ell(B, ILUConfig())
            for F, F1 in ((pre.L, one.L), (pre.U, one.U)):
                blk = F.to_scipy().tocsr()[lo:hi, lo:hi]
                assert rel(blk, F1.to_scipy()) <= 1e-12
            np.testing.assert_allclose(
                pre.udiag_inv[p * M.row_pad:p * M.row_pad + hi - lo]
                .numpy(), one.udiag_inv[:hi - lo].numpy(), rtol=1e-12)


def _fixture(kind: str, side: int):
    """The gate-4 fixture's entries: scrambled as written, after RCM, or in
    the generator's natural order."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    r, c, v, _, n = make_system(side, side, side, seed=11, nonsym=0.35,
                                permute=kind != "natural")
    if kind == "rcm":
        pat = sp.csr_matrix((np.ones(r.size, np.int8), (r, c)), shape=(n, n))
        perm = reverse_cuthill_mckee(pat + pat.T, symmetric_mode=True)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        r, c = inv[r], inv[c]
    return n, r, c, v


@pytest.mark.parametrize("kind, side, allow_ell", [
    ("scrambled", 16, True), ("scrambled", 24, True), ("scrambled", 48, True),
    ("rcm", 24, True), ("natural", 24, True), ("scrambled", 24, False),
    ("rcm", 16, False)])
def test_record_and_choice_follow_tpusolves_layout(tp, kind, side,
                                                   allow_ell):
    """The layout class tpusolve's ``from_coo`` picks (on the CPU, f64) is
    the one the port records, and ILU's device-or-host choice is
    tpusolve's, on the port's own layout: K2's ELL often, and BDIA or BELL
    where the port is kept off ELL (at 24^3 scrambled the port then stores
    BDIA-XL where tpusolve stores ELL)."""
    n, r, c, v = _fixture(kind, side)
    At = tp["Matrix"].from_coo(tp["mesh"], (n, n), r, c, v,
                               dtype=np.float64)
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU, dtype=np.float64,
                               allow_ell=allow_ell)
    assert A.uses_ell == (allow_ell and kind != "natural")
    cls = ("dia" if At.uses_dia else "bdia" if At.uses_bdia
           else "bell" if At.uses_bell else "ell")
    assert A.tpusolve_layout == cls
    assert A.priced_over == (cls if A.uses_ell and cls != "ell" else None)
    assert device_setup.device_path(A, ILUConfig(), 1) == \
        tp["dev"]._device_path(At, tp["cfg"]())


def test_ell_path_on_an_operator_the_port_stores_bdia(tp):
    """The scrambled fixture at 24^3, kept off ELL in the port (BDIA-XL):
    tpusolve stores it ELL and factors it on the device, and so does the
    port, from ELL arrays built from its entries, with tpusolve's factors
    and count."""
    n, r, c, v = _fixture("scrambled", 24)
    At = tp["Matrix"].from_coo(tp["mesh"], (n, n), r, c, v,
                               dtype=np.float64)
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU, dtype=np.float64,
                               allow_ell=False)
    assert A.uses_bdia and A.tpusolve_layout == "ell"
    assert not (At.uses_dia or At.uses_bdia or At.uses_bell)
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    pre_t = tp["ilu"].ilu_setup(At, tp["cfg"]())
    assert pre.notes == pre_t.notes and "generic-ELL" in pre.notes[0]
    check_factors(pre, pre_t.L.to_scipy(), np.asarray(pre_t.udiag_inv)[:n],
                  pre_t.U.to_scipy(), n)


def test_gate4_rcm_stays_on_the_host(tp):
    """Gate 4's RCM'd operator past the device row floor: tpusolve lays it
    out BDIA and factors it on the host; so does the port, whose own
    layout is K2's ELL."""
    n, r, c, v = _fixture("rcm", 41)
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU, dtype=np.float64)
    assert n >= device_setup.MIN_DEVICE_N and A.uses_ell
    assert A.tpusolve_layout == "bdia"
    assert device_setup.device_path(A, ILUConfig()) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the factorizations run on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dia", "ell"])
def test_factorization_on_cuda_equals_cpu(cuda, which):
    if which == "dia":
        A, _, _ = laplace27(12, 10, 9, device=CPU, dtype=np.float64)
    else:
        A = ShardedMatrix.from_csr_host(momentum(12), device=CPU,
                                        dtype=np.float64, allow_bell=False,
                                        allow_bdia=False)
    Ad = dataclasses.replace(A, **{
        f.name: getattr(A, f.name).to(cuda)
        for f in dataclasses.fields(A)
        if isinstance(getattr(A, f.name), torch.Tensor)})
    pre = ilu_setup(A, ILUConfig(), device_min_n=1)
    pre_d = ilu_setup(Ad, ILUConfig(), device_min_n=1)
    assert pre_d.L.device.type == "cuda" and pre_d.notes == pre.notes
    n = A.shape[0]
    check_factors(pre_d, pre.L.to_scipy(), pre.udiag_inv.numpy()[:n],
                  pre.U.to_scipy(), n)


@pytest.mark.cuda
def test_ell_factors_on_cuda_have_the_cpus_bits(cuda):
    """The ELL sweeps scatter one lower slot at a time onto distinct
    destinations, so the card sums in the CPU's order: the factors are the
    same bits, on every run."""
    A = ShardedMatrix.from_csr_host(momentum(12), device=CPU,
                                    dtype=np.float64, allow_bell=False,
                                    allow_bdia=False)
    vals, cols = device_setup._ell_padded(A)
    KL, KU = device_setup.ilu_widths(vals, cols)
    factor = device_setup.make_ell_factorizer(vals.shape[0], vals.shape[1],
                                              5, KL, KU)
    ref = factor(vals, cols)
    for _ in range(2):
        got = factor(vals.to(cuda), cols.to(cuda))
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
