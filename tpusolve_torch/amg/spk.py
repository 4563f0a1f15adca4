"""Python bindings of the AMG setup's native sparse kernels
(``csrc/spkernels.cpp``, a verbatim copy of ``tpusolve``'s
``native/spkernels.cpp``; this module is the port's copy of
``tpusolve/native/spk.py``).

The host setup (strength, coarsening, interpolation, Galerkin RAP) calls
these where ``tpusolve`` calls its own, at the same sites, so both packages
compute the same numbers.  The library is compiled by g++ at first use
(``kernels/build.py``) and a failed build raises: there is no silent numpy
path.  A binding returns None only where ``tpusolve``'s declines the input
(indices past int32, or unsorted column indices where it needs them
sorted); the caller then takes its numpy version, as ``tpusolve``'s does.
The numpy versions (``classical_strength_plain``, ``pmis_rounds``, the
``*_plain`` helpers of ``amg/interp.py``, ...) stay as the plain versions
the tests hold these against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.kernels import build

_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


@functools.cache
def _lib():
    """The loaded ``spkernels`` library with its signatures declared."""
    lib = build.load("spkernels")
    lib.sk_masked_abt.restype = None
    lib.sk_masked_abt.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p]
    lib.sk_spgemm_count.restype = ctypes.c_int64
    lib.sk_spgemm_count.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _i32p, _i32p, _i32p]
    lib.sk_spgemm.restype = None
    lib.sk_spgemm.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p]
    lib.sk_masked_ab.restype = None
    lib.sk_masked_ab.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p]
    lib.sk_sampled_at.restype = None
    lib.sk_sampled_at.argtypes = [
        ctypes.c_int32, _i32p, _i32p, _f64p, _i32p, _i32p, _f64p]
    lib.sk_rs_coarsen.restype = None
    lib.sk_rs_coarsen.argtypes = [
        ctypes.c_int32, _i32p, _i32p, _i32p, _i32p, _i32p]
    _i64p = ctypes.POINTER(ctypes.c_int64)
    _f32p = ctypes.POINTER(ctypes.c_float)
    lib.sk_dia_to_csr.restype = ctypes.c_int64
    lib.sk_dia_to_csr.argtypes = [
        ctypes.c_int64, ctypes.c_int32, _f32p, _i64p, _i64p, _i64p, _f64p]
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sk_strength.restype = ctypes.c_int64
    lib.sk_strength.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _f64p, ctypes.c_double, _i32p, _i32p]
    lib.sk_pattern_mask.restype = None
    lib.sk_pattern_mask.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _i32p, _i32p, _u8p]
    lib.sk_classical_interp_count.restype = ctypes.c_int64
    lib.sk_classical_interp_count.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _u8p, _i32p]
    lib.sk_classical_interp_fill.restype = None
    lib.sk_classical_interp_fill.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _f64p, _i32p, _i32p, _u8p, _i32p,
        _i32p, _i32p, _f64p]
    lib.sk_exti_interp_count.restype = ctypes.c_int64
    lib.sk_exti_interp_count.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _i32p, _i32p, _u8p, _i32p]
    lib.sk_exti_interp_fill.restype = None
    lib.sk_exti_interp_fill.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _f64p, _i32p, _i32p, _u8p, _i32p,
        _i32p, _i32p, _f64p]
    lib.sk_pmis.restype = None
    lib.sk_pmis.argtypes = [ctypes.c_int64, _i32p, _i32p, _f64p, _i32p]
    return lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def _csr_args(M: sp.csr_matrix):
    return (_as_i32(M.indptr), _as_i32(M.indices), _as_f64(M.data))


_I32_MAX = 2**31 - 1


def _fits(*mats) -> bool:
    return all(m.nnz <= _I32_MAX and max(m.shape) <= _I32_MAX for m in mats)


def masked_abt(A: sp.csr_matrix, B: sp.csr_matrix,
               Pat: sp.csr_matrix) -> np.ndarray | None:
    """out[e] = sum_m A[i, m] * B[k, m] for each stored entry e = (i, k) of
    ``Pat`` (rows of A dotted with rows of B, sampled at Pat's pattern).
    Returns values aligned 1:1 with Pat.data, or None where an
    operand exceeds int32 indexing."""
    lib = _lib()
    if not _fits(A, B, Pat):
        return None
    A = A.tocsr()
    B = B.tocsr()
    Pat = Pat.tocsr()
    n, m = A.shape
    assert B.shape[1] == m and Pat.shape[0] == n
    Ap, Aj, Ax = _csr_args(A)
    Bp, Bj, Bx = _csr_args(B)
    Pp, Pj, _ = _csr_args(Pat)
    out = np.zeros(Pat.nnz, np.float64)
    lib.sk_masked_abt(
        np.int32(n), np.int32(m),
        _ptr(Ap, _i32p), _ptr(Aj, _i32p), _ptr(Ax, _f64p),
        _ptr(Bp, _i32p), _ptr(Bj, _i32p), _ptr(Bx, _f64p),
        _ptr(Pp, _i32p), _ptr(Pj, _i32p), _ptr(out, _f64p))
    return out


def masked_ab(X: sp.csr_matrix, B: sp.csr_matrix,
              Pat: sp.csr_matrix) -> np.ndarray | None:
    """out[e] = (X @ B)[i, j] for each stored entry e = (i, j) of ``Pat``
    — the no-transpose form of the sampled product.  Returns values aligned
    1:1 with Pat.data, or None where an operand exceeds int32 indexing."""
    lib = _lib()
    if not _fits(X, B, Pat):
        return None
    X = X.tocsr()
    B = B.tocsr()
    Pat = Pat.tocsr()
    n, k = X.shape
    assert B.shape[0] == k and Pat.shape[0] == n
    m = max(B.shape[1], Pat.shape[1])
    Xp, Xj, Xx = _csr_args(X)
    Bp, Bj, Bx = _csr_args(B)
    Pp, Pj, _ = _csr_args(Pat)
    out = np.zeros(Pat.nnz, np.float64)
    lib.sk_masked_ab(
        np.int32(n), np.int32(m),
        _ptr(Xp, _i32p), _ptr(Xj, _i32p), _ptr(Xx, _f64p),
        _ptr(Bp, _i32p), _ptr(Bj, _i32p), _ptr(Bx, _f64p),
        _ptr(Pp, _i32p), _ptr(Pj, _i32p), _ptr(out, _f64p))
    return out


def sampled_transpose(B: sp.csr_matrix,
                      Pat: sp.csr_matrix) -> np.ndarray | None:
    """out[e] = B[j, i] for each stored entry e = (i, j) of ``Pat`` (the
    values of B^T sampled at Pat's pattern).  B's rows must have sorted
    column indices.  Returns values aligned 1:1 with Pat.data, or None where
    an operand exceeds int32 indexing or B's indices are unsorted."""
    lib = _lib()
    if not _fits(B, Pat):
        return None
    B = B.tocsr()
    # never sort in place: B may share indices/indptr with a caller matrix
    # whose data would silently desynchronize — decline and let the numpy
    # fallback handle unsorted input (mirrors pattern_mask)
    if not B.has_sorted_indices:
        return None
    Pat = Pat.tocsr()
    n = Pat.shape[0]
    Bp, Bj, Bx = _csr_args(B)
    Pp, Pj, _ = _csr_args(Pat)
    out = np.zeros(Pat.nnz, np.float64)
    lib.sk_sampled_at(
        np.int32(n),
        _ptr(Bp, _i32p), _ptr(Bj, _i32p), _ptr(Bx, _f64p),
        _ptr(Pp, _i32p), _ptr(Pj, _i32p), _ptr(out, _f64p))
    return out


def dia_to_csr(dia_t: np.ndarray, offs: np.ndarray) -> sp.csr_matrix | None:
    """CSR of a dense (rows, ndiag) float32 DIA-value table with diagonal
    offsets ``offs`` (single pass, no index temporaries)."""
    lib = _lib()
    dia_t = np.ascontiguousarray(dia_t, np.float32)
    rows, ndiag = dia_t.shape
    offs = np.ascontiguousarray(offs, np.int64)
    nnz_max = int(np.count_nonzero(dia_t))
    indptr = np.empty(rows + 1, np.int64)
    cols = np.empty(nnz_max, np.int64)
    vals = np.empty(nnz_max, np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    nnz = lib.sk_dia_to_csr(
        np.int64(rows), np.int32(ndiag),
        _ptr(dia_t, f32p), _ptr(offs, i64p),
        _ptr(indptr, i64p), _ptr(cols, i64p), _ptr(vals, _f64p))
    assert nnz == nnz_max
    out = sp.csr_matrix((vals, cols, indptr), shape=(rows, rows))
    out.has_sorted_indices = True
    return out


def strength(A: sp.csr_matrix, theta: float) -> sp.csr_matrix | None:
    """Classical strength-of-connection pattern CSR (ones data, sorted
    columns, no diagonal).  None where A exceeds int32 indexing."""
    lib = _lib()
    if not _fits(A):
        return None
    A = A.tocsr()
    n = A.shape[0]
    Ap, Aj, Ax = _csr_args(A)
    Sp = np.empty(n + 1, np.int32)
    Sj = np.empty(A.nnz, np.int32)
    nnz = lib.sk_strength(np.int64(n), _ptr(Ap, _i32p), _ptr(Aj, _i32p),
                          _ptr(Ax, _f64p), float(theta),
                          _ptr(Sp, _i32p), _ptr(Sj, _i32p))
    S = sp.csr_matrix((np.ones(nnz), Sj[:nnz], Sp), shape=A.shape)
    S.has_sorted_indices = True
    return S


def pattern_mask(A: sp.csr_matrix, S: sp.csr_matrix) -> np.ndarray | None:
    """Boolean mask over A.data marking entries present in S's pattern
    (both must have sorted column indices).  None where an operand exceeds
    int32 indexing or its indices are unsorted."""
    lib = _lib()
    if not _fits(A, S):
        return None
    A = A.tocsr()
    S = S.tocsr()
    # the mask must align with the CALLER's view of A.data — never sort in
    # place here; decline instead (the numpy fallback handles any order)
    if not A.has_sorted_indices or not S.has_sorted_indices:
        return None
    n = A.shape[0]
    Ap, Aj, _ = _csr_args(A)
    Sp, Sj, _ = _csr_args(S)
    mask = np.empty(A.nnz, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sk_pattern_mask(np.int64(n), _ptr(Ap, _i32p), _ptr(Aj, _i32p),
                        _ptr(Sp, _i32p), _ptr(Sj, _i32p), _ptr(mask, u8p))
    return mask.view(np.bool_)


def rs_coarsen(S: sp.csr_matrix) -> np.ndarray | None:
    """Classical Ruge-Stueben C/F splitting (first + second pass) on the
    strength pattern S (S[i,j]=1 iff j strongly influences i).  Returns an
    int array (1 = C, 0 = F), or None where S exceeds int32 indexing."""
    lib = _lib()
    if not _fits(S):
        return None
    S = S.tocsr()
    St = S.T.tocsr()
    n = S.shape[0]
    Sp, Sj, _ = _csr_args(S)
    Stp, Stj, _ = _csr_args(St)
    state = np.zeros(n, np.int32)
    lib.sk_rs_coarsen(np.int32(n),
                      _ptr(Sp, _i32p), _ptr(Sj, _i32p),
                      _ptr(Stp, _i32p), _ptr(Stj, _i32p),
                      _ptr(state, _i32p))
    return state.astype(np.int64)


def spgemm(A: sp.csr_matrix, B: sp.csr_matrix) -> sp.csr_matrix | None:
    """C = A @ B via two-pass Gustavson; row columns sorted.  None where an
    operand or the product exceeds int32 indexing."""
    lib = _lib()
    if not _fits(A, B):
        return None
    A = A.tocsr()
    B = B.tocsr()
    n, k = A.shape
    k2, m = B.shape
    assert k == k2
    Ap, Aj, Ax = _csr_args(A)
    Bp, Bj, Bx = _csr_args(B)
    Cp = np.zeros(n + 1, np.int32)
    nnz = lib.sk_spgemm_count(
        np.int32(n), np.int32(m),
        _ptr(Ap, _i32p), _ptr(Aj, _i32p),
        _ptr(Bp, _i32p), _ptr(Bj, _i32p), _ptr(Cp, _i32p))
    if nnz > _I32_MAX:
        return None
    Cj = np.zeros(nnz, np.int32)
    Cx = np.zeros(nnz, np.float64)
    lib.sk_spgemm(
        np.int32(n), np.int32(m),
        _ptr(Ap, _i32p), _ptr(Aj, _i32p), _ptr(Ax, _f64p),
        _ptr(Bp, _i32p), _ptr(Bj, _i32p), _ptr(Bx, _f64p),
        _ptr(Cp, _i32p), _ptr(Cj, _i32p), _ptr(Cx, _f64p))
    out = sp.csr_matrix((Cx, Cj, Cp), shape=(n, m))
    out.has_sorted_indices = True
    return out


def classical_interp(A: sp.csr_matrix, S: sp.csr_matrix,
                     is_C: np.ndarray, cmap: np.ndarray
                     ) -> sp.csr_matrix | None:
    """Classical modified interpolation (interp_type 0) in one native pass —
    P over the strong-C pattern, C rows identity.  Requires sorted column
    indices on A and S (S must exclude the diagonal).  None where A's or S's
    indices are unsorted or the operands exceed int32 indexing."""
    lib = _lib()
    if not _fits(A, S):
        return None
    if not A.has_sorted_indices or not S.has_sorted_indices:
        return None
    n = A.shape[0]
    Ap, Aj, Ax = _csr_args(A)
    Sp, Sj, _ = (_as_i32(S.indptr), _as_i32(S.indices), None)
    isC = np.ascontiguousarray(is_C, np.uint8)
    cm = _as_i32(cmap)
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    Pp = np.zeros(n + 1, np.int32)
    nnz = lib.sk_classical_interp_count(
        np.int64(n), _ptr(Sp, _i32p), _ptr(Sj, _i32p),
        _ptr(isC, _u8p), _ptr(Pp, _i32p))
    if nnz > _I32_MAX:
        return None
    Pj = np.zeros(nnz, np.int32)
    Px = np.zeros(nnz, np.float64)
    lib.sk_classical_interp_fill(
        np.int64(n),
        _ptr(Ap, _i32p), _ptr(Aj, _i32p), _ptr(Ax, _f64p),
        _ptr(Sp, _i32p), _ptr(Sj, _i32p),
        _ptr(isC, _u8p), _ptr(cm, _i32p),
        _ptr(Pp, _i32p), _ptr(Pj, _i32p), _ptr(Px, _f64p))
    nc = int(is_C.sum())
    P = sp.csr_matrix((Px, Pj, Pp), shape=(n, nc))
    P.eliminate_zeros()
    return P


def exti_interp(A: sp.csr_matrix, S: sp.csr_matrix,
                is_C: np.ndarray, cmap: np.ndarray
                ) -> sp.csr_matrix | None:
    """Extended+i interpolation (interp_type 6/7) in one native pass (P over
    the extended C pattern, C rows identity).  Same operand contract as
    :func:`classical_interp`."""
    lib = _lib()
    if not _fits(A, S):
        return None
    if not A.has_sorted_indices or not S.has_sorted_indices:
        return None
    n = A.shape[0]
    Ap, Aj, Ax = _csr_args(A)
    Sp, Sj = _as_i32(S.indptr), _as_i32(S.indices)
    isC = np.ascontiguousarray(is_C, np.uint8)
    cm = _as_i32(cmap)
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    Pp = np.zeros(n + 1, np.int32)
    nnz = lib.sk_exti_interp_count(
        np.int64(n), _ptr(Ap, _i32p), _ptr(Aj, _i32p),
        _ptr(Sp, _i32p), _ptr(Sj, _i32p), _ptr(isC, _u8p), _ptr(Pp, _i32p))
    if nnz > _I32_MAX:
        return None
    Pj = np.zeros(nnz, np.int32)
    Px = np.zeros(nnz, np.float64)
    lib.sk_exti_interp_fill(
        np.int64(n),
        _ptr(Ap, _i32p), _ptr(Aj, _i32p), _ptr(Ax, _f64p),
        _ptr(Sp, _i32p), _ptr(Sj, _i32p),
        _ptr(isC, _u8p), _ptr(cm, _i32p),
        _ptr(Pp, _i32p), _ptr(Pj, _i32p), _ptr(Px, _f64p))
    nc = int(is_C.sum())
    P = sp.csr_matrix((Px, Pj, Pp), shape=(n, nc))
    P.eliminate_zeros()
    return P


def pmis(S: sp.csr_matrix, w: np.ndarray) -> np.ndarray | None:
    """PMIS C/F split with caller-supplied tie-break measures ``w`` (exact
    synchronous-round semantics of coarsen.pmis; active-set shrinking).
    Returns int64 state (1=C, 0=F), or None where S exceeds int32
    indexing."""
    lib = _lib()
    if not _fits(S):
        return None
    S = S.tocsr()
    n = S.shape[0]
    Sp, Sj = _as_i32(S.indptr), _as_i32(S.indices)
    wv = _as_f64(w)
    state = np.empty(n, np.int32)
    lib.sk_pmis(np.int64(n), _ptr(Sp, _i32p), _ptr(Sj, _i32p),
                _ptr(wv, _f64p), _ptr(state, _i32p))
    return state.astype(np.int64)
