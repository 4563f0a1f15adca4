"""Level-0 BoomerAMG setup on the device for a stencil operator of N parts
(the port of ``tpusolve/amg/device_setup_sharded.py``).

``amg/device_setup.py`` sets up one part's box-DIA operator in offset
algebra.  On N parts the same algebra runs on every part at once, the parts
stacked on one device as a leading axis of each plane stack, (D, P, nz, ny,
nx).  Its input is the generator's full-lattice stack
(``stencil.laplace27(..., with_lattice=True)``): each part's planes masked
by the GLOBAL domain, so a coupling across a seam is in the planes and its
neighbour's operand arrives through a halo.

Where ``tpusolve`` pads a part's box with its neighbours' planes by
``lax.ppermute`` under ``shard_map`` (``_halo3_block``), the port runs one
index gather over the part axis a direction (:func:`halo`): a source-part
table per axis and direction in which -1 reads zeros (the global boundary),
x first, then y, then z, so edges and corners fill from slabs already padded
without diagonal exchanges.  Every stage's neighbour reads stay within the
halo, so the one-part stages of ``amg/device_setup.py`` (plane strength,
PMIS, interpolation, the RAP terms of ``_rap_planes``) run unchanged on the
stacks with :func:`halo` as their pad.  Coarse and fine global ids are
planes too, and travel through the same halo, so every column is exact for
any process grid.

P, R and the coarse operator are packed as per-part ELL with global
columns and split into diag and offd blocks on the device
(``ilu/device_setup.py:from_device_ell_parts``); the coarse operator's
host CSR is fetched only when a level below needs it.

Differences from ``tpusolve``, each on purpose:

* the offsets are the operator's (dz, dy, dx) triples, never flat offsets
  turned back into components (``_decompose_offset``, wrong on a 4-wide
  box);
* the PMIS ranks come from the host generator (``pmis_rank(seed, n, n)``,
  split by part), as ``tpusolve`` does under ``TPUSOLVE_PMIS_HOST_RANK=1``;
* the interpolation is the one-part module's fused form, and the Galerkin
  terms are summed into the coarse planes in one pass (``tpusolve`` scans
  chunks of its term table to bound TPU memory); the sums agree to
  roundoff;
* the stages are eager PyTorch, not jitted XLA programs.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from tpusolve_torch.amg.device_setup import (
    C_PT, MAX_DEVICE_OFFSETS, MIN_DEVICE_N, _at, _interp_planes, _margins,
    _neg, _pack_ell, _plane_sum, _pmis_split, _rap_planes, _round_up,
    _strength_planes, _width, config_eligible, host_csr_parts, pmis_rank)
from tpusolve_torch.ilu.device_setup import from_device_ell_parts
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.stencil import part_to_grid


# ----------------------------------------------------------------------
# the halo: one gather over the part axis a direction

def neighbours(pgrid) -> dict:
    """Source-part tables of the halo: ``(axis, -1)`` names, for each part,
    the part whose high slab fills its low pad along ``axis`` (0: z, 1: y,
    2: x), ``(axis, +1)`` the part whose low slab fills its high pad; -1
    where the part lies on the global boundary (``tpusolve``'s ``_perms``,
    as gathers instead of sends)."""
    px, py, pz = pgrid
    nparts = px * py * pz
    out = {}
    for axis in range(3):
        for step in (-1, 1):
            src = np.full(nparts, -1, np.int64)
            for p in range(nparts):
                g = list(part_to_grid(p, pgrid)[::-1])      # (iz, iy, ix)
                g[axis] += step
                if 0 <= g[axis] < (pz, py, px)[axis]:
                    src[p] = (g[0] * py + g[1]) * px + g[2]
            out[axis, step] = src
    return out


def halo(S: torch.Tensor, m: tuple, pgrid) -> torch.Tensor:
    """``S`` (..., P, nz, ny, nx) padded by ``m[k]`` on each side of box
    axis k with the neighbours' planes (zeros at the global boundary): the
    x pass, then y on the x-padded stack, then z, so that edges and
    corners arrive through a face neighbour (``tpusolve``'s
    ``_halo3_block``).  Each pad is one ``index_select`` over the part
    axis."""
    tables = neighbours(pgrid)
    for axis in (2, 1, 0):
        h = int(m[axis])
        if h == 0:
            continue
        dim = S.dim() - 3 + axis
        size = S.shape[dim]
        if h > size:
            raise ValueError(f"halo of {h} planes on a box axis of {size}")
        pads = []
        for step, slab in ((-1, S.narrow(dim, size - h, h)),
                           (1, S.narrow(dim, 0, h))):
            src = torch.from_numpy(tables[axis, step]).to(S.device)
            got = slab.index_select(S.dim() - 4, src.clamp(min=0))
            live = (src >= 0).reshape((-1, 1, 1, 1))
            pads.append(torch.where(live, got, torch.zeros((), dtype=S.dtype,
                                                           device=S.device)))
        S = torch.cat([pads[0], S, pads[1]], dim=dim)
    return S


def _flat_halo_index(flat: torch.Tensor, dims, m) -> torch.Tensor:
    """The index, in a stack of P boxes padded by ``m`` (flattened), of
    each part-major flat position ``flat`` of the unpadded boxes."""
    nz, ny, nx = dims
    hz, hy, hx = (d + 2 * k for d, k in zip(dims, m))
    box = nz * ny * nx
    p, loc = flat // box, flat % box
    z, y, x = loc // (ny * nx), (loc // nx) % ny, loc % nx
    return ((p * hz + z + m[0]) * hy + y + m[1]) * hx + x + m[2]


def _halo_shift(c, dims, m) -> int:
    """The flat step of a (dz, dy, dx) shift in boxes padded by ``m``."""
    hy, hx = dims[1] + 2 * m[1], dims[2] + 2 * m[2]
    return (c[0] * hy + c[1]) * hx + c[2]


# ----------------------------------------------------------------------
# eligibility

def eligible(A: ShardedMatrix, cfg, lattice,
             min_n: int | None = MIN_DEVICE_N) -> bool:
    """``tpusolve``'s rule: a lattice dict for a square box-DIA operator of
    more than one part, its process grid of ``A.nparts`` parts, at most
    ``MAX_DEVICE_OFFSETS`` planes with a (0, 0, 0) plane, halo slabs (3
    times the largest component, the coarse numbering's reach) inside a
    part's box, at least ``min_n`` rows (None: never) and a config of
    ``config_eligible``."""
    if min_n is None or lattice is None or A.all_nparts <= 1 \
            or not A.uses_dia:
        return False
    if A.shape[0] != A.shape[1] or A.shape[0] < min_n:
        return False
    if int(np.prod(lattice["pgrid"])) != A.all_nparts:
        return False
    comps = A.dia_offsets
    if len(comps) > MAX_DEVICE_OFFSETS or (0, 0, 0) not in comps:
        return False
    maxc = max((abs(c) for comp in comps for c in comp), default=0)
    if min(int(d) for d in lattice["dims"]) < 3 * max(1, maxc):
        return False
    return config_eligible(cfg)


# ----------------------------------------------------------------------
# orchestrator

def device_level0_sharded(A: ShardedMatrix, cfg, lattice, seed: int = 1234,
                          log=None):
    """Set up level 0 of the N-part stencil operator ``A`` on its device
    from ``lattice`` (``tpusolve``'s ``device_level0_sharded``).

    Returns None when coarsening stalls, else the dict of
    ``device_setup.device_level0``: ``Cmask``, ``nc``, ``P``, ``R`` and
    ``Ac`` (N-part ELL operators with offd blocks; the coarse rows of part
    p are its C points, ``coarse_row_offsets`` their offsets), ``Ah_c_fn``,
    ``dinv``, ``dinv_l1`` and ``seconds``."""
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
            log(f"    setup[dev-sharded]: {label:24s} {seconds[label]:8.3f}s")

    comps = tuple(tuple(int(c) for c in off) for off in A.dia_offsets)
    dims = tuple(int(d) for d in lattice["dims"])
    pgrid = tuple(int(x) for x in lattice["pgrid"])
    diag_slot = comps.index((0, 0, 0))
    P_, D, n = A.nparts, len(comps), A.shape[0]
    box = int(np.prod(dims))
    pad = partial(halo, pgrid=pgrid)
    # (D, P, nz, ny, nx): the one-part stages' plane axis first; the
    # precision follows the solve's dtype
    Av = lattice["stack"].to(device=dev, dtype=A.dtype).transpose(0, 1)

    # --- strength + PMIS, the halo refreshed each round ---
    Sm = _strength_planes(Av, diag_slot, float(cfg.strong_threshold))
    rank = torch.from_numpy(pmis_rank(seed, n, n)).to(dev).reshape(
        (P_,) + dims)
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    state, rounds = _pmis_split(Sm, comps, rank, max_rounds, pad=pad)
    Cmask = (state == C_PT).to(Av.dtype)
    counts = Cmask.reshape(P_, -1).sum(dim=1).to(torch.int64).cpu().numpy()
    nc = int(counts.sum())
    if log is not None:
        log(f"      pmis rounds: {rounds}")
    stage("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation on the offset lattice, halos in the pads ---
    Pv = _interp_planes(Av, Sm, comps, diag_slot, Cmask, cfg.interp_type,
                        pad=pad)
    del Sm
    diagp = Av[diag_slot].reshape(-1)
    dinv = 1.0 / torch.where(diagp != 0, diagp, 1.0)
    l1 = _plane_sum(Av.abs()).reshape(-1)
    dinv_l1 = 1.0 / torch.where(l1 != 0, l1, 1.0)
    stage("interpolation")

    # --- global numbering planes: coarse ids (each part's C points after
    # the parts before it) and fine ids, exact across seams by halo ---
    row_off_f = np.asarray(A.row_offsets, np.int64)
    coff = np.zeros(P_ + 1, np.int64)
    np.cumsum(counts, out=coff[1:])
    cflat = Cmask.reshape(P_, -1)
    base = torch.from_numpy(coff[:-1]).to(dev)[:, None]
    cnum = (torch.cumsum(cflat.to(torch.int64), 1) - 1 + base).reshape(
        (P_,) + dims)
    cidx = torch.nonzero(cflat.reshape(-1)).reshape(-1)
    fid = (torch.from_numpy(row_off_f[:-1]).to(dev)[:, None]
           + torch.arange(box, device=dev)).reshape((P_,) + dims)
    m1 = _margins(comps)
    cnum_h = pad(cnum, m1).reshape(-1)
    fid_h = pad(fid, m1).reshape(-1)
    shift1 = torch.tensor([_halo_shift(c, dims, m1) for c in comps],
                          device=dev)
    ncap = max(1, int(counts.max()))
    crow = torch.arange(nc, device=dev)
    owner = torch.from_numpy(np.repeat(np.arange(P_), counts)).to(dev)
    cdest = owner * ncap + crow - torch.from_numpy(coff[:-1]).to(dev)[owner]

    def by_part(v, c):
        """(nc, K) coarse rows -> (P, ncap, K), part p's rows at their
        local index."""
        K = v.shape[1]
        ov = torch.zeros((P_ * ncap, K), dtype=v.dtype, device=dev)
        oc = torch.zeros((P_ * ncap, K), dtype=c.dtype, device=dev)
        ov[cdest], oc[cdest] = v, c
        return ov.reshape(P_, ncap, K), oc.reshape(P_, ncap, K)

    # --- P and R = P^T as N-part ELL with global columns ---
    Ps = Pv.reshape(D, -1)
    wp = _width(Ps)
    nnz_p = int((Ps != 0).sum())
    Pev, Pec = _pack_ell(Ps, lambda s, e: cnum_h[
        _flat_halo_index(torch.arange(s, e, device=dev), dims, m1)[None]
        + shift1[:, None]], max(1, wp))
    P_sh = from_device_ell_parts(
        (n, nc), Pev.reshape(P_, box, -1), Pec.reshape(P_, box, -1),
        nnz=nnz_p, row_offsets=row_off_f, col_offsets=coff,
        global_cols=True)
    del Pev, Pec
    Pvp = pad(Pv, m1)
    # R[I, j] = P[j, I]: plane d at coarse row I reads fine position
    # cidx[I] - comps[d], across a seam from the halo
    Rs = torch.stack([_at(Pvp[d], _neg(comps[d]), m1, dims).reshape(-1)[cidx]
                      for d in range(D)])
    del Pvp
    Rev, Rec = _pack_ell(Rs, lambda s, e: fid_h[
        _flat_halo_index(cidx[s:e], dims, m1)[None] - shift1[:, None]],
        max(1, _width(Rs)))
    del Rs
    Rev, Rec = by_part(Rev, Rec)
    R_sh = from_device_ell_parts((nc, n), Rev, Rec, nnz=nnz_p,
                                 row_offsets=coff, col_offsets=row_off_f,
                                 global_cols=True)
    del Rev, Rec
    stage("P/R compaction")

    # --- Galerkin RAP in offset algebra, gathered to the C rows ---
    dcs, planes = _rap_planes(Av, Pv, comps, pad=pad)
    Dv = planes.reshape(len(dcs), -1)[:, cidx]
    del planes, Pv
    ccount = (Dv != 0).sum(0)
    nnz_c = int(ccount.sum())
    Kc = min(len(dcs), max(8, _round_up(int(ccount.max()), 8)))
    stage("galerkin RAP")

    zero_dc = next((i for i, dc in enumerate(dcs) if dc == (0, 0, 0)), None)
    dmain = (torch.ones(nc, dtype=Av.dtype, device=dev) if zero_dc is None
             else Dv[zero_dc])
    dmain = torch.where(dmain == 0, 1.0, dmain)
    # the coarse columns reach 3 times the largest component: the coarse
    # numbering's halo covers them
    m3 = _margins(comps, 3)
    cnum_h3 = pad(cnum, m3).reshape(-1)
    shift3 = torch.tensor([_halo_shift(dc, dims, m3) for dc in dcs],
                          device=dev)
    Acv, Acc = _pack_ell(Dv, lambda s, e: cnum_h3[
        _flat_halo_index(cidx[s:e], dims, m3)[None] + shift3[:, None]], Kc)
    del Dv
    Acv, Acc = by_part(Acv, Acc)
    diag_c = torch.ones(P_ * ncap, dtype=Av.dtype, device=dev)
    diag_c[cdest] = dmain
    Ac_sh = from_device_ell_parts((nc, nc), Acv, Acc,
                                  diag_c.reshape(P_, ncap), nnz_c,
                                  row_offsets=coff, col_offsets=coff,
                                  global_cols=True)
    del Acv, Acc
    stage("coarse A compaction")

    return dict(Cmask=Cmask.reshape(-1), nc=nc, P=P_sh, R=R_sh, Ac=Ac_sh,
                Ah_c_fn=lambda: host_csr_parts(Ac_sh), dinv=dinv,
                dinv_l1=dinv_l1, coarse_row_offsets=coff, seconds=seconds)
