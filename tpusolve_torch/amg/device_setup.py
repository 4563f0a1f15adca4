"""Level-0 BoomerAMG setup on the operator's device, for box-DIA operators
(the port of ``tpusolve/amg/device_setup.py``, single part).

On the DIA offset lattice every stage of the fine-level setup is shifted
streaming arithmetic on the (D, nz, ny, nx) plane stack, with no gather
until the compaction at the end:

* strength of connection: elementwise on the planes;
* PMIS: an independent set whose neighbour maximum is D shifted maxima,
  compared as exact integer keys (:func:`pmis_rank`);
* direct (``interp_type`` 3) and classical-modified (0) interpolation:
  row-local sums plus distance-2 terms that are D^2 shifted products;
* Galerkin RAP in offset algebra::

      Ac[dc][j] = sum over (dp1, da, dp2) with dc = da + dp2 - dp1 of
                  P[dp1][j - dp1] * A[da][j - dp1] * P[dp2][j - dp1 + da]

  (D^3 terms; ``tpusolve`` runs them as one ``lax.scan`` over a term
  table, the port as one ``addcmul_`` a term into the coarse planes).

P, R and the coarse operator are then packed into ELL ``ShardedMatrix``
operators on the device (``tpusolve``'s layout for them, ELL, recorded),
and a host CSR of the coarse operator is fetched on demand, when a level
below goes through the host pipeline (``amg/builder.py``); one that is
large enough is set up on the device by the generic-ELL setup
(``amg/device_setup_ell.py``).

The stages mirror ``amg/{strength,coarsen,interp,galerkin}.py`` (the same
formulas, and the PMIS tie-break ranks drawn from the same seeded host
generator), so the device and host paths give the same C/F split and the
same P, R and coarse operator up to summation order.

Differences from ``tpusolve``, each on purpose:

* the offsets are the operator's stored (dz, dy, dx) triples, never flat
  offsets turned back into components (``_decompose_offset``, wrong on a
  4-wide box);
* the PMIS ranks always come from the host generator (:func:`pmis_rank`),
  as ``tpusolve`` does under ``TPUSOLVE_PMIS_HOST_RANK=1``; no
  environment variable is read: :func:`eligible` takes ``min_n``;
* one interpolation form, the fused one: ``tpusolve``'s staged form bounds
  TPU memory, and the Galerkin symmetry halving is off, as it is there in
  host-rank mode;
* the stages are eager PyTorch, not jitted XLA programs.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from tpusolve_torch.kernels.ell import pack_rowptr
from tpusolve_torch.matrix.sharded import ShardedMatrix, ell_form
from tpusolve_torch.matrix.spmv import spmv

# the device path is used when the fine level has at least this many rows
# (``tpusolve``'s crossover, measured on its TPU; the H100's is not
# measured yet)
MIN_DEVICE_N = 1 << 16
# offset-count guard: the RAP term count grows as D^3
MAX_DEVICE_OFFSETS = 40
# rows a pack step handles at once (bounds the (D, rows) temporaries)
PACK_ROWS = 1 << 16

UNDECIDED, C_PT, F_PT = 0, 1, 2


# ----------------------------------------------------------------------
# eligibility

def config_eligible(cfg, interp_types=(0, 3)) -> bool:
    """The config half of the device-setup gate (also the harness's
    host-CSR decision): PMIS-family coarsening, interpolation among
    ``interp_types``, no aggressive levels, truncation, non-Galerkin
    sparsification or complex smoothers."""
    if cfg.interp_type not in interp_types:
        return False
    if cfg.coarsen_type not in (0, 8, 10):
        return False
    if cfg.agg_num_levels > 0:
        return False
    if cfg.trunc_factor != 0.0 or cfg.p_max_elmts != 0:
        return False
    if cfg.non_galerkin_tol > 0 or cfg.nongalerk_tol:
        return False
    if cfg.smooth_type is not None and cfg.smooth_num_levels > 0:
        return False
    return True


def eligible(A: ShardedMatrix, cfg, min_n: int = MIN_DEVICE_N) -> bool:
    """Whether level 0 of ``A`` can be set up here: a square one-part box-DIA
    operator of at least ``min_n`` rows, at most ``MAX_DEVICE_OFFSETS``
    planes with a (0, 0, 0) plane, and a config of
    :func:`config_eligible`."""
    if not A.uses_dia or A.nparts != 1 or A.shape[0] != A.shape[1]:
        return False
    if A.shape[0] < min_n:
        return False
    if len(A.dia_offsets) > MAX_DEVICE_OFFSETS \
            or (0, 0, 0) not in A.dia_offsets:
        return False
    return config_eligible(cfg)


# ----------------------------------------------------------------------
# shifted views of the plane stacks

def _margins(comps, scale: int = 1) -> tuple:
    """Per-axis pad that covers ``scale`` times the largest component (a 1-D
    operator pads its x axis only)."""
    return tuple(scale * max(abs(c[k]) for c in comps) for k in range(3))


def _pad(S: torch.Tensor, m: tuple) -> torch.Tensor:
    """Zero-pad the last three (box) axes of ``S`` by ``m`` on each side."""
    return F.pad(S, (m[2], m[2], m[1], m[1], m[0], m[0]))


def _at(Sp: torch.Tensor, comps, m: tuple, dims) -> torch.Tensor:
    """View of the padded ``Sp`` shifted by ``comps``: ``out[idx] =
    S[idx + comps]``, zero where ``idx + comps`` leaves the box
    (``|comps[k]| <= m[k]`` on every axis)."""
    return Sp[..., m[0] + comps[0]:m[0] + comps[0] + dims[0],
              m[1] + comps[1]:m[1] + comps[1] + dims[1],
              m[2] + comps[2]:m[2] + comps[2] + dims[2]]


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _neg(a):
    return tuple(-x for x in a)


def _flat(comps, dims) -> int:
    f = 0
    for c, d in zip(comps, dims):
        f = f * d + c
    return f


def _round_up(x, m) -> int:
    return (int(x) + m - 1) // m * m


# ----------------------------------------------------------------------
# stages

def _strength_planes(Av, diag_slot: int, theta: float) -> torch.Tensor:
    """Strength masks per plane (0/1 in A's dtype), mirroring
    ``strength.classical_strength``."""
    diag = Av[diag_slot]
    sflip = torch.where(diag < 0, -1.0, 1.0).to(Av.dtype)
    cand = -Av * sflip
    others = [d for d in range(Av.shape[0]) if d != diag_slot]
    rowmax = cand[others].amax(dim=0)
    thresh = theta * torch.clamp(rowmax, min=0.0)
    S = ((cand >= thresh) & (cand > 0)).to(Av.dtype)
    S[diag_slot] = 0
    return S


def pmis_rank(seed: int, n: int, n_pad: int) -> np.ndarray:
    """int32 rank of the host PMIS tie-break randoms (``coarsen.pmis`` draws
    ``default_rng(seed).random(n)`` as its first sample), padding rows
    rank 0.  The device PMIS compares ``influence * 2^ceil(log2 n) + rank +
    1`` as an exact integer: the host's (integer influence, random) order,
    where a float ``influence + random`` would collide at millions of
    rows."""
    rng = np.random.default_rng(seed)
    r = rng.random(n)
    order = np.argsort(r, kind="stable")
    rank = np.zeros(n_pad, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return rank


def _pmis_keys(infl: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """PMIS priority keys (int64 holding ``tpusolve``'s uint32 values) from
    the integer-valued influence and the ranks; 0 is the inactive
    sentinel, live keys are at least 1."""
    n2 = 1 << max(int(rank.numel() - 1).bit_length(), 1)
    cap = (2 ** 32 - 1) // n2 - 2
    infl_i = torch.clamp(infl.to(torch.int64), max=cap)
    return infl_i * n2 + rank.to(torch.int64) + 1


def _pmis_split(Sm, comps, rank, max_rounds: int):
    """PMIS C/F split, mirroring ``coarsen.pmis``: ``rank`` holds the host
    tie-break ranks, so both paths select the same sets.  Returns (state,
    rounds); rows still undecided after ``max_rounds`` become C."""
    D = len(comps)
    dims = tuple(Sm.shape[1:])
    m = _margins(comps)
    Smp = _pad(Sm, m)
    infl = torch.zeros(dims, dtype=Sm.dtype, device=Sm.device)
    for d in range(D):
        infl = infl + _at(Smp[d], _neg(comps[d]), m, dims)
    state = torch.where(infl == 0, F_PT, UNDECIDED).to(torch.int32)
    w = _pmis_keys(infl, rank)

    # symmetric adjacency: G[d] = S[d] or S^T at the same offset
    rev = {c: i for i, c in enumerate(comps)}
    G = []
    for d in range(D):
        g = Sm[d]
        dneg = rev.get(_neg(comps[d]))
        if dneg is not None:
            g = torch.maximum(g, _at(Smp[dneg], comps[d], m, dims))
        G.append(g > 0)

    rounds = 0
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    while rounds < max_rounds and bool((state == UNDECIDED).any()):
        active = state == UNDECIDED
        wa = torch.where(active, w, zero)
        wap = _pad(wa, m)
        nbrmax = torch.zeros_like(w)
        for d in range(D):
            nbrmax = torch.maximum(nbrmax, torch.where(
                G[d], _at(wap, comps[d], m, dims), zero))
        newC = active & (wa > nbrmax)
        newCp = _pad(newC.to(Sm.dtype), m)
        hitC = torch.zeros_like(infl)
        for d in range(D):
            hitC = hitC + Sm[d] * _at(newCp, comps[d], m, dims)
        state = torch.where(newC, C_PT, state)
        state = torch.where(active & ~newC & (hitC > 0), F_PT, state)
        rounds += 1
    state = torch.where(state == UNDECIDED, C_PT, state)
    return state, rounds


def _interp_planes(Av, Sm, comps, diag_slot: int, Cmask,
                   interp_type: int) -> torch.Tensor:
    """P planes on A's offset lattice (the diagonal slot holds the C-point
    identity), mirroring ``interp.direct_interpolation`` (3) and
    ``interp.classical_interpolation`` (0)."""
    D = len(comps)
    dims = tuple(Av.shape[1:])
    dt = Av.dtype
    m = _margins(comps)
    diag = Av[diag_slot]
    Fmask = 1.0 - Cmask
    Cp = _pad(Cmask, m)
    strongC = Sm * torch.stack([_at(Cp, comps[d], m, dims)
                                for d in range(D)])
    off = torch.ones((D, 1, 1, 1), dtype=dt, device=Av.device)
    off[diag_slot] = 0.0

    if interp_type == 3:
        neg = (Av < 0).to(dt)
        pos = (Av > 0).to(dt)
        sum_neg = (Av * neg * off).sum(0)
        sum_pos = (Av * pos * off).sum(0)
        sC_neg = (Av * neg * strongC).sum(0)
        sC_pos = (Av * pos * strongC).sum(0)
        alpha = torch.where(sC_neg != 0, sum_neg / torch.where(
            sC_neg != 0, sC_neg, 1.0), 0.0)
        beta = torch.where(sC_pos != 0, sum_pos / torch.where(
            sC_pos != 0, sC_pos, 1.0), 0.0)
        dlump = torch.where(sC_pos == 0, sum_pos, 0.0)
        dii = diag + dlump
        dii = torch.where(dii != 0, dii, 1.0)
        scale = torch.where(Av < 0, alpha, beta)
        P = Fmask * strongC * (-scale * Av / dii)
        P[diag_slot] = Cmask
        return P

    # classical modified (interp_type 0)
    Fp = _pad(Fmask, m)
    strongF = Sm * torch.stack([_at(Fp, comps[d], m, dims)
                                for d in range(D)])
    weak = (Av != 0).to(dt) * (1.0 - Sm)
    # hat A: entries of sign opposite to the row diagonal
    Ahatp = _pad(torch.where(Av * diag < 0, Av, 0.0), m)
    for_d = {c: i for i, c in enumerate(comps)}

    def distance2(weights, dc_major: bool):
        """sum over df of weights * shift(Ahat[e], df), e = dc - df: the
        d_ik denominators (indexed by df, summed over dc) or the strong-F
        redistribution (indexed by dc, summed over df)."""
        out = torch.zeros_like(Av)
        for i in range(D):
            for j in range(D):
                dc, df = (i, j) if dc_major else (j, i)
                e = for_d.get(_add(comps[dc], _neg(comps[df])))
                if e is None:
                    continue
                out[i].addcmul_(weights[j], _at(Ahatp[e], comps[df], m,
                                                dims))
        return out

    # d_ik = sum_{m in C_i} hat_a_km  (k = i + df, m = i + dc)
    Dden = distance2(strongC, dc_major=False)
    dead = strongF * (Dden == 0).to(dt)
    dlump = (Av * dead).sum(0)
    W = torch.where(dead > 0, 0.0, strongF * Av / torch.where(
        Dden != 0, Dden, 1.0))
    sum_weak = (Av * weak * off).sum(0)
    dii = diag + sum_weak + dlump
    dii = torch.where(dii != 0, dii, 1.0)
    # T[dc] = sum_df W[df] * hat_a_{i+df, i+dc}, masked to strong C
    T = distance2(W, dc_major=True)
    P = Fmask * (-(Av * strongC + strongC * T) / dii)
    P[diag_slot] = Cmask
    return P


def _rap_planes(Av, Pv, comps):
    """``(dcs, planes)``: the coarse plane offsets dc = da + dp2 - dp1 in
    order of first appearance over (dp1, da, dp2) (``tpusolve``'s order),
    and the (len(dcs), *dims) planes at fine positions, every term's
    product of three shifted planes added into its dc plane in that
    order."""
    dims = tuple(Av.shape[1:])
    m = _margins(comps, 2)
    Avp, Pvp = _pad(Av, m), _pad(Pv, m)
    index = {}
    for c1 in comps:
        for ca in comps:
            for c2 in comps:
                index.setdefault(_add(_add(ca, c2), _neg(c1)), len(index))
    out = torch.zeros((len(index),) + dims, dtype=Av.dtype, device=Av.device)
    for dp1, c1 in enumerate(comps):
        back = _neg(c1)
        P1 = _at(Pvp[dp1], back, m, dims)
        for ca, A_plane in zip(comps, Avp):
            PA = P1 * _at(A_plane, back, m, dims)
            s2 = _add(ca, back)
            for c2, P_plane in zip(comps, Pvp):
                out[index[_add(s2, c2)]].addcmul_(PA, _at(P_plane, s2, m,
                                                         dims))
    return list(index), out


def _pack_ell(planes, cols_of, K: int):
    """Pack (D, nrows) value planes into padded ELL (nrows, K): each row's
    nonzeros first, in plane order; the column of plane d at rows [s, e)
    is ``cols_of(s, e)[d]`` (read only where the value is nonzero)."""
    D, nrows = planes.shape
    out_v = torch.zeros((nrows, K), dtype=planes.dtype, device=planes.device)
    out_c = torch.zeros((nrows, K), dtype=torch.int32, device=planes.device)
    for s in range(0, nrows, PACK_ROWS):
        e = min(nrows, s + PACK_ROWS)
        v = planes[:, s:e]
        live = v != 0
        # slot of each live entry among its row's; dead ones go to slot K,
        # a column that is dropped
        slot = torch.where(live, live.cumsum(0) - 1, K)
        rows = torch.arange(e - s, device=v.device).expand(D, e - s)
        buf_v = torch.zeros((e - s, K + 1), dtype=v.dtype, device=v.device)
        buf_c = torch.zeros((e - s, K + 1), dtype=torch.int32,
                            device=v.device)
        buf_v.index_put_((rows, slot), v)
        buf_c.index_put_((rows, slot), torch.where(
            live, cols_of(s, e), 0).to(torch.int32))
        out_v[s:e] = buf_v[:, :K]
        out_c[s:e] = buf_c[:, :K]
    return out_v, out_c


def _pack_rowptr(planes, cols_of):
    """Pack (D, nrows) value planes into the row-pointer ELL form
    ``(rowptr, vals, cols)`` by ``kernels/ell.py:pack_rowptr``: each row's
    nonzeros in plane order (the slot order of :func:`_pack_ell`), columns
    from ``cols_of`` as there."""
    D, nrows = planes.shape
    dev = planes.device
    counts = torch.zeros(nrows, dtype=torch.int64, device=dev)
    for s in range(0, nrows, PACK_ROWS):
        e = min(nrows, s + PACK_ROWS)
        counts[s:e] = (planes[:, s:e] != 0).sum(0)

    def chunks():
        for s in range(0, nrows, PACK_ROWS):
            e = min(nrows, s + PACK_ROWS)
            v = planes[:, s:e]
            live = v != 0
            rows = torch.arange(s, e, device=dev).expand(D, e - s)
            yield (rows[live], (live.cumsum(0) - 1)[live], v[live],
                   cols_of(s, e)[live])

    return pack_rowptr(counts, chunks(), planes.dtype)


def _width(planes) -> int:
    """The largest count of nonzeros a row has across the planes."""
    return int((planes != 0).sum(0).max()) if planes.numel() else 0


def _ell_matrix(shape, planes, cols_of, K: int, width: int, diag,
                nnz: int) -> ShardedMatrix:
    """A one-part ELL ``ShardedMatrix`` of the (D, rows) value ``planes``
    (columns by ``cols_of``, as :func:`_pack_ell` takes them) with ``nnz``
    nonzeros, at most ``width`` a row, in the form K2's model prices
    cheaper (``matrix/sharded.py:ell_form``): padded to ``K`` slots
    (:func:`_pack_ell`) or row-pointer (:func:`_pack_rowptr`).  It records
    ``tpusolve``'s layout, ELL (``_ell_sharded`` there), in either form."""
    nr, nc = int(shape[0]), int(shape[1])
    fields = dict(bdia_vals=None, bdia_starts=None, bell_vals=None,
                  bell_ids=None, diag=diag[None], shape=(nr, nc),
                  row_offsets=(0, nr), col_offsets=(0, nc), row_pad=nr,
                  col_pad=nc, nnz=int(nnz), row_width=int(width),
                  tpusolve_layout="ell")
    if ell_form(nr, nc, K, int(nnz), planes.element_size(),
                width)[0] == "padded":
        vals, cols = _pack_ell(planes, cols_of, K)
        return ShardedMatrix(diag_vals=vals[None], diag_cols=cols[None],
                             **fields)
    rowptr, vals, cols = _pack_rowptr(planes, cols_of)
    return ShardedMatrix(
        diag_vals=torch.zeros((1, nr, 1), dtype=planes.dtype,
                              device=planes.device),
        diag_cols=torch.zeros((1, nr, 1), dtype=torch.int32,
                              device=planes.device),
        ell_rowptr=rowptr[None], ell_vals=vals[None], ell_cols=cols[None],
        **fields)


# ----------------------------------------------------------------------
# orchestrator

def device_level0(A: ShardedMatrix, cfg, seed: int = 1234, log=None):
    """Set up level 0 of ``A`` on its device.

    Returns None when coarsening stalls (no C point, or all C), else a dict:
    ``Cmask`` (1.0 at C points), ``nc``, ``P`` (n, nc), ``R`` (nc, n) and
    ``Ac`` (nc, nc) as ELL operators on the device (each in the form K2's
    model prices cheaper), ``Ah_c_fn``
    (fetches the coarse operator as a sorted host CSR), ``dinv`` and
    ``dinv_l1`` (level 0's smoother vectors) and ``seconds`` (wall seconds
    of each stage, the device synchronised at each stage's end).  ``log``
    (a print-like callable) receives a line per stage."""
    dev = A.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    seconds = {}
    t = [time.perf_counter()]

    def stage(label):
        sync()
        now = time.perf_counter()
        seconds[label] = now - t[0]
        t[0] = now
        if log is not None:
            log(f"    setup[dev]: {label:24s} {seconds[label]:8.3f}s")

    comps = tuple(tuple(int(c) for c in off) for off in A.dia_offsets)
    dims = tuple(int(d) for d in A.dia_vals.shape[2:])
    diag_slot = comps.index((0, 0, 0))
    n = A.shape[0]
    D = len(comps)
    Av = A.dia_vals[0]

    # --- strength + PMIS (exact integer tie-break keys) ---
    Sm = _strength_planes(Av, diag_slot, float(cfg.strong_threshold))
    rank = torch.tensor(pmis_rank(seed, n, n), device=dev).reshape(dims)
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    state, rounds = _pmis_split(Sm, comps, rank, max_rounds)
    Cmask = (state == C_PT).to(Av.dtype)
    nc = int(Cmask.sum())
    if log is not None:
        log(f"      pmis rounds: {rounds}")
    stage("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation on the same offset lattice ---
    Pv = _interp_planes(Av, Sm, comps, diag_slot, Cmask, cfg.interp_type)
    del Sm
    diagp = Av[diag_slot].reshape(-1)
    dinv = 1.0 / torch.where(diagp != 0, diagp, 1.0)
    l1 = Av.abs().sum(0).reshape(-1)
    dinv_l1 = 1.0 / torch.where(l1 != 0, l1, 1.0)
    stage("interpolation")

    cflat = Cmask.reshape(-1)
    cnum = torch.cumsum(cflat, 0).to(torch.int64) - 1
    cidx = torch.nonzero(cflat).reshape(-1)

    # --- P and R = P^T as device ELL ---
    flats = torch.tensor([_flat(c, dims) for c in comps], device=dev)
    Ps = Pv.reshape(D, -1)
    wp = _width(Ps)
    Kp = min(D, max(8, _round_up(wp, 8)))
    nnz_p = int((Ps != 0).sum())
    zeros = lambda k: torch.zeros(k, dtype=Av.dtype, device=dev)
    P_sh = _ell_matrix((n, nc), Ps, lambda s, e: cnum[torch.clamp(
        torch.arange(s, e, device=dev)[None] + flats[:, None], 0, n - 1)],
        Kp, wp, zeros(n), nnz_p)
    m = _margins(comps)
    Pvp = _pad(Pv, m)
    # R[I, j] = P[j, I]: plane d at coarse row I reads fine row
    # j = cidx[I] - flat(d)
    Rs = torch.stack([_at(Pvp[d], _neg(comps[d]), m, dims).reshape(-1)[cidx]
                      for d in range(D)])
    del Pvp
    wr = _width(Rs)
    Kr = min(D, max(8, _round_up(wr, 8)))
    R_sh = _ell_matrix((nc, n), Rs, lambda s, e: torch.clamp(
        cidx[s:e][None] - flats[:, None], 0, n - 1), Kr, wr, zeros(nc),
        nnz_p)
    del Rs
    stage("P/R compaction")

    # --- Galerkin RAP in offset algebra, gathered to the C rows ---
    dcs, planes = _rap_planes(Av, Pv, comps)
    Dv = planes.reshape(len(dcs), -1)[:, cidx]
    del planes
    del Pv
    counts = (Dv != 0).sum(0)
    nnz_c = int(counts.sum())
    wc = int(counts.max())
    Kc = min(len(dcs), max(8, _round_up(wc, 8)))
    stage("galerkin RAP")

    zero_dc = next((i for i, dc in enumerate(dcs) if dc == (0, 0, 0)), None)
    dmain = (torch.ones(nc, dtype=Av.dtype, device=dev) if zero_dc is None
             else Dv[zero_dc])
    dmain = torch.where(dmain == 0, 1.0, dmain)
    shifts = torch.tensor([_flat(dc, dims) for dc in dcs], device=dev)
    Ac_sh = _ell_matrix((nc, nc), Dv, lambda s, e: cnum[torch.clamp(
        cidx[s:e][None] + shifts[:, None], 0, n - 1)], Kc, wc, dmain, nnz_c)
    del Dv
    stage("coarse A compaction")

    return dict(Cmask=cflat, nc=nc, P=P_sh, R=R_sh, Ac=Ac_sh,
                Ah_c_fn=lambda: host_csr(Ac_sh), dinv=dinv, dinv_l1=dinv_l1,
                seconds=seconds)


def host_csr(M: ShardedMatrix) -> sp.csr_matrix:
    """A one-part ELL operator (either form) as a host CSR in f64, its
    nonzeros only, indices sorted (``tpusolve``'s ``_fetch_coarse_csr``:
    compacted on the device, then fetched)."""
    nr, ncols = M.shape
    if M.uses_ell_rowptr:
        ptr = M.ell_rowptr[0]
        v, c = M.ell_vals[0, :int(ptr[-1])], M.ell_cols[0, :int(ptr[-1])]
        row = torch.repeat_interleave(torch.arange(nr, device=v.device),
                                      (ptr[1:nr + 1] - ptr[:nr]).long())
    else:
        v = M.diag_vals[0, :nr].reshape(-1)
        c = M.diag_cols[0, :nr].reshape(-1)
        row = torch.arange(nr, device=v.device).repeat_interleave(
            M.diag_vals.shape[-1])
    live = v != 0
    counts = torch.bincount(row[live], minlength=nr).cpu().numpy()
    v, c = v[live].cpu().numpy(), c[live].cpu().numpy()
    indptr = np.zeros(nr + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    Ah = sp.csr_matrix((v.astype(np.float64), c.astype(np.int64), indptr),
                       shape=(nr, ncols))
    Ah.sort_indices()
    return Ah


def power_lambda(A: ShardedMatrix, dinv: torch.Tensor, iters: int = 20,
                 seed: int = 0) -> float:
    """lambda_max(D^-1 A) by power iteration on A's device (the analog of
    ``smoothers.chebyshev_bounds`` without the host CSR)."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(A.row_pad).astype(np.float32)
    v0 /= np.linalg.norm(v0)
    v = torch.tensor(v0, dtype=A.dtype, device=A.device)
    lam = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        w = dinv * spmv(A, v)
        nw = torch.linalg.vector_norm(w)
        lam = torch.dot(v, w)
        v = torch.where(nw == 0, v, w / torch.where(nw == 0, 1.0, nw))
    return max(abs(float(lam)), 1e-12)
