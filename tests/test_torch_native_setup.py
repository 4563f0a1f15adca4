"""The AMG setup's native kernels (``csrc/spkernels.cpp`` through
``amg/spk.py``) against tpusolve's (``tpusolve/native/spk.py``) and against
the port's numpy versions, on the same inputs.

Inputs: the gate-3 pressure matrix at 16^3 (4,096 rows, so the kernels'
row loops run threaded) and its strength graph, PMIS split and P; a random
nonsymmetric matrix with negative diagonals for the strength test; the
27-point stencil's DIA table.  Integer outputs (strength patterns, masks,
splittings, sparsity patterns) must be equal; values agree to 1e-13
relative (tpusolve builds its copy with ``-march=native``, so FMA
contraction can differ in the last bits).  Serial RS has no numpy version:
its split equals tpusolve's and keeps RS's second-pass rule (every strong
F-F pair shares a strong C point).  A failed g++ build raises.  Gate 3 at
32^3 with ``coarsen_type: 6`` (Falgout, run as serial RS) through both CLIs
gives the same hierarchy and iteration count, relres within 1e-6 relative.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from tpusolve_torch import fixtures, stencil
from tpusolve_torch.amg import coarsen, galerkin, interp, spk, strength
from tpusolve_torch.kernels import build
from test_torch_amg import gate3_csr
from test_torch_slice import _iters, _run_port, _run_tpusolve

VTOL = 1e-13


@pytest.fixture(scope="module")
def tspk():
    pytest.importorskip("jax")
    from tpusolve.native import spk as tspk_mod
    if not tspk_mod.available():
        pytest.skip("tpusolve's native library did not build")
    return tspk_mod


@pytest.fixture(scope="module")
def setup16():
    """(A, S, split, P) of the gate-3 matrix at 16^3: strength 0.25, PMIS,
    extended+i."""
    A = gate3_csr(16)
    S = strength.classical_strength(A, 0.25)
    split = coarsen.pmis(S, seed=3)
    P = interp.extended_i_interpolation(A, S, split)
    return A, S, split, P


def nonsymmetric(n=5000, seed=2):
    """A random nonsymmetric CSR with sorted columns, some rows with a
    negative diagonal and positive off-diagonals."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=6 / n, random_state=rng, format="csr")
    M.data = -np.abs(M.data) + 0.1 * rng.standard_normal(M.nnz)
    M = (M + sp.diags(2.0 + rng.random(n))).tocsr()
    flip = sp.diags(np.where(rng.random(n) < 0.2, -1.0, 1.0))
    M = (flip @ M).tocsr()
    M.sort_indices()
    return M


def same_pattern(X, Y):
    np.testing.assert_array_equal(X.indptr, Y.indptr)
    np.testing.assert_array_equal(X.indices, Y.indices)


def close(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape == y.shape
    assert np.abs(x - y).max(initial=0) <= VTOL * max(np.abs(y).max(
        initial=0), 1e-300)


def cmap_of(split):
    return np.where(split == 1, np.cumsum(split == 1) - 1, -1)


# ---------------------------------------------------------------------------
# the bindings against tpusolve's, on the same inputs

@pytest.mark.parametrize("theta", [0.25, 0.57])
def test_strength_equals_tpusolve(tspk, setup16, theta):
    for A in (setup16[0], nonsymmetric()):
        S, S_t = spk.strength(A, theta), tspk.strength(A, theta)
        same_pattern(S, S_t)
        assert S.has_sorted_indices and S.nnz > 0


def test_pattern_mask_and_splits_equal_tpusolve(tspk, setup16):
    A, S, _, _ = setup16
    np.testing.assert_array_equal(spk.pattern_mask(A, S),
                                  tspk.pattern_mask(A, S))
    w = np.bincount(S.indices, minlength=A.shape[0]) + \
        np.random.default_rng(4).random(A.shape[0])
    np.testing.assert_array_equal(spk.pmis(S, w), tspk.pmis(S, w))
    np.testing.assert_array_equal(spk.rs_coarsen(S), tspk.rs_coarsen(S))


@pytest.mark.parametrize("kind", ["classical_interp", "exti_interp"])
def test_interpolation_equals_tpusolve(tspk, setup16, kind):
    A, S, split, _ = setup16
    is_C = split == 1
    P = getattr(spk, kind)(A, S, is_C, cmap_of(split))
    P_t = getattr(tspk, kind)(A, S, is_C, cmap_of(split))
    same_pattern(P, P_t)
    close(P.data, P_t.data)


def test_sampled_products_and_spgemm_equal_tpusolve(tspk, setup16):
    A, S, _, P = setup16
    Pat = (S + sp.eye(A.shape[0], format="csr")).tocsr()
    Pat.sort_indices()
    for name, args in (("masked_abt", (A, A, Pat)),
                       ("masked_ab", (A, A, Pat)),
                       ("sampled_transpose", (A, Pat))):
        close(getattr(spk, name)(*args), getattr(tspk, name)(*args))
    for X, Y in ((A, P), (P.T.tocsr(), (A @ P).tocsr())):
        C, C_t = spk.spgemm(X, Y), tspk.spgemm(X, Y)
        same_pattern(C, C_t)
        close(C.data, C_t.data)


def test_dia_to_csr_equals_tpusolve(tspk):
    offs, dia_one = stencil._dia_box(9, 7, 5, np.float64)
    dia_t = np.ascontiguousarray(dia_one.T)
    M, M_t = spk.dia_to_csr(dia_t, offs), tspk.dia_to_csr(dia_t, offs)
    same_pattern(M, M_t)
    np.testing.assert_array_equal(M.data, M_t.data)


# ---------------------------------------------------------------------------
# the bindings against the port's numpy versions

def test_strength_and_mask_equal_numpy(setup16):
    for A in (setup16[0], nonsymmetric()):
        for theta in (0.25, 0.57):
            S = strength.classical_strength(A, theta)
            S_np = strength.classical_strength_plain(A, theta).tocsr()
            S_np.sort_indices()
            same_pattern(S, S_np)
            np.testing.assert_array_equal(
                spk.pattern_mask(A, S), interp._pattern_mask_plain(A, S))


def test_pmis_equals_numpy_rounds(setup16):
    _, S, _, _ = setup16
    w = np.bincount(S.indices, minlength=S.shape[0]) + \
        np.random.default_rng(6).random(S.shape[0])
    np.testing.assert_array_equal(spk.pmis(S, w), coarsen.pmis_rounds(S, w))


def test_rs_split_keeps_the_second_pass_rule(setup16):
    """RS has no numpy version: its split is a proper C/F split, and every
    strong F-F pair shares a strong C point."""
    _, S, _, _ = setup16
    split = spk.rs_coarsen(S)
    assert set(np.unique(split)) == {0, 1}
    isC = split == 1
    rows = [set(S.indices[S.indptr[i]:S.indptr[i + 1]])
            for i in range(S.shape[0])]
    for i in np.flatnonzero(~isC):
        Ci = {k for k in rows[i] if isC[k]}
        for j in rows[i]:
            if not isC[j] and j != i:
                assert Ci & rows[j], (i, j)


@pytest.mark.parametrize("kind", ["classical", "extended_i"])
def test_interpolation_equals_numpy(setup16, kind):
    A, S, split, _ = setup16
    P = getattr(interp, f"{kind}_interpolation")(A, S, split)
    P_np = getattr(interp, f"{kind}_interpolation_plain")(A, S, split)
    P_np = P_np.tocsr()
    P_np.sort_indices()
    same_pattern(P, P_np)
    close(P.data, P_np.data)


def test_sampled_products_and_spgemm_equal_numpy(setup16):
    A, S, _, P = setup16
    Pat = (S + sp.eye(A.shape[0], format="csr")).tocsr()
    Pat.sort_indices()
    rp = interp._restrict_to_pattern
    close(spk.masked_abt(A, A, Pat), rp((A @ A.T).tocsr(), Pat).data)
    close(spk.masked_ab(A, P @ P.T, Pat),
          rp((A @ (P @ P.T)).tocsr(), Pat).data)
    close(spk.sampled_transpose(A, Pat), rp(A.T.tocsr(), Pat).data)
    C, C_np = galerkin.spgemm(A, P), (A @ P).tocsr()
    C_np.sort_indices()
    same_pattern(C, C_np)
    close(C.data, C_np.data)


def test_dia_to_csr_equals_numpy():
    offs, dia_one = stencil._dia_box(9, 7, 5, np.float32)
    dia_t = np.ascontiguousarray(dia_one.T)
    M, M_np = spk.dia_to_csr(dia_t, offs), stencil.dia_to_csr_plain(dia_t,
                                                                     offs)
    same_pattern(M, M_np)
    np.testing.assert_array_equal(M.data, M_np.data)
    assert (M != stencil.laplace27_scipy(9, 7, 5)[0]).nnz == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's message: there is no
    numpy path behind a failed build."""
    (tmp_path / "spkernels.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_loaded", {})
    spk._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            strength.classical_strength(sp.eye(3, format="csr"), 0.25)
    finally:
        spk._lib.cache_clear()


# ---------------------------------------------------------------------------
# gate 3 with Falgout coarsening through both CLIs

def test_gate3_rs_equals_tpusolve_cli(tmp_path, monkeypatch, capsys):
    path = fixtures.write_gate3(str(tmp_path), 32)
    text = open(path).read()
    assert "coarsen_type: 8" in text
    with open(path, "w") as fh:
        fh.write(text.replace("coarsen_type: 8", "coarsen_type: 6"))
    from tpusolve.harness.system import LinearSystem
    relres_t = []
    destroy = LinearSystem.destroy_system

    def keep_relres(self):
        relres_t.append(float(self.solve_results[0].relres))
        destroy(self)

    monkeypatch.setattr(LinearSystem, "destroy_system", keep_relres)
    rc_t, out_t, _, _ = _run_tpusolve(path, monkeypatch, capsys)
    rc, out, _, _, res = _run_port(path, capsys)
    assert rc == 0 and rc_t == 0, out[-800:]
    assert "Check solution: PASSED" in out and "Check solution: PASSED" in \
        out_t
    assert "run as serial RS" in out
    table = lambda o: o.split("AMG hierarchy:")[1].split("  AMG level 0")[0]
    assert table(out).strip() == table(out_t).split("Solve 0:")[0].strip()
    assert _iters(out) == _iters(out_t) == res.iters
    assert abs(float(res.relres) - relres_t[0]) <= 1e-6 * relres_t[0]
