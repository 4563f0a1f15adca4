"""Level setup on the device for generic ELL operators of N parts (the port
of ``tpusolve/amg/device_setup_ell_mp.py``).

``amg/device_setup_ell.py`` sets up a one-part ELL operator; this module
runs the same pipeline (strength, PMIS, direct, classical-modified or
extended+i interpolation, Galerkin RAP) on an operator of N parts, the parts
stacked on one device.  Each part works in ``tpusolve``'s extended local
index space: its ``R`` rows, then one slot for each of its ``G`` ghost
columns (the operator's halo plan), then one inert slot, ``E = R + G + 1``
in all.  The port lays the parts' spaces end to end, part p's slot e at
``p * E + e``, so that the row-local formulas of the one-part module run on
all parts' rows at once, and cross-part coupling reduces to ``tpusolve``'s
two halo primitives, each one index operation over the stacked parts where
``tpusolve`` runs an ``all_to_all`` under ``shard_map``:

* the forward halo (:meth:`_Space.ext`, ``tpusolve``'s ``_gather_ghost``):
  the owners' rows copied into the ghost slots, one gather for 1-D and 2-D
  row payloads alike;
* the reverse halo (:meth:`_Space.reverse`, ``_scatter_ghost``): each ghost
  slot's contribution combined into its owner's row, by max, or by add on
  integers (PMIS influence).

P's ghost rows travel by the forward halo, so W = A P is local.  Ac = P^T W
is a partial product over each part's own fine rows: a contribution to a
coarse row another part owns lands in a ghost-slot row and travels to that
part, where a sorted merge adds it in (``_seam_shard``, ``_merge_shard``,
``_final``).  Every floating-point sum runs in an order fixed by positions
(a row's slots one after another, sorted runs by Hillis-Steele steps); the
only scatter-add over floats adds the distinct-slot partial rows the merge
then sums, so the card gives the CPU's bits.

Semantics follow ``tpusolve``'s module (the same formulas; the PMIS ranks of
the global host generator, placed by row offsets, as there under
``TPUSOLVE_PMIS_HOST_RANK=1``), so the N-part hierarchy is the host
pipeline's to roundoff.  Differences, each on purpose: the sums and packs
of the one-part port (fixed-order sums, sorted searches, per-chunk widths)
in place of ``tpusolve``'s one-hot contractions and static pack widths;
``_interp_exti_mp``'s worst-case width ``(KF + 1) * Kc`` is never
allocated (P keeps the trimmed width ``_fit_width_jit`` gives there).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpusolve_torch.amg.device_setup import (host_csr_parts, pmis_rank,
                                             _pmis_keys, _round_up)
from tpusolve_torch.amg.device_setup_ell import (
    BUDGET, MAX_ELL_K, C_PT, F_PT, UND, _I32_MAX, _chunks, _classical_chunk,
    _exti_chunk, _left_pack, _product, _rowsum, _run_pack, _run_scan,
    _transpose)
from tpusolve_torch.ilu.device_setup import (ell_padded_parts,
                                             from_device_ell_parts)
from tpusolve_torch.matrix.sharded import ShardedMatrix, halo_sources
from tpusolve_torch.matrix.vectors import numpy_dtype


# ----------------------------------------------------------------------
# the stacked extended spaces and their halo primitives

class _Space:
    """The parts' extended index spaces laid end to end, with one halo
    plan: ``src`` (P * G,), for each ghost slot the flat row (owner *
    ``R`` + local) it copies (``matrix/sharded.py:halo_sources`` of the
    plan's ``send_idx`` and ``ghost_slot``)."""

    def __init__(self, P: int, R: int, src: torch.Tensor):
        self.P, self.R = P, R
        self.G = src.numel() // P
        self.E = R + self.G + 1
        self.src = src
        dev = src.device
        part = torch.arange(P, device=dev)
        # the slot of each local row and ghost in the flat spaces
        self.own = (part[:, None] * self.E
                    + torch.arange(R, device=dev)).reshape(-1)
        self.owner = src // R
        self.dead = part * self.E + self.E - 1

    def ext(self, v: torch.Tensor, fill) -> torch.Tensor:
        """Forward halo: rows ``v`` (P * R, ...) -> (P * E, ...), each
        part's rows, its ghosts' copies of their owners' rows (one gather),
        ``fill`` in the inert slot."""
        P, R, G = self.P, self.R, self.G
        tail = tuple(v.shape[1:])
        out = torch.full((P, self.E) + tail, fill, dtype=v.dtype,
                         device=v.device)
        out[:, :R] = v.reshape((P, R) + tail)
        out[:, R:R + G] = v[self.src].reshape((P, G) + tail)
        return out.reshape((P * self.E,) + tail)

    def reverse(self, x: torch.Tensor, combine: str) -> torch.Tensor:
        """Reverse halo: a (P * E,) vector over the extended spaces ->
        (P * R,), each row its own entry combined with its ghost copies'
        (``"max"``, or ``"add"`` on integers)."""
        P, R, G = self.P, self.R, self.G
        x = x.reshape(P, self.E)
        out = x[:, :R].reshape(-1).clone()
        ghost = x[:, R:R + G].reshape(-1)
        if combine == "max":
            return out.scatter_reduce_(0, self.src, ghost, "amax")
        if ghost.is_floating_point():
            raise TypeError("the reverse halo adds integers only")
        return out.index_add_(0, self.src, ghost)

    def flat(self, ecols: torch.Tensor) -> torch.Tensor:
        """(P, R, K) extended columns -> their flat slots (P * R, K)."""
        base = torch.arange(self.P, device=ecols.device) * self.E
        return (ecols + base[:, None, None]).reshape(-1, ecols.shape[-1])


def _plan(send_idx, ghost_slot, R: int, dev) -> torch.Tensor:
    return torch.from_numpy(halo_sources(send_idx, ghost_slot, R)).to(dev)


# ----------------------------------------------------------------------
# input staging

def _stage_ell_mp(A: ShardedMatrix, A_host):
    """(vals, ecols, space, ghost_globals, rowcnt): each part's diag and
    offd blocks side by side as padded ELL (P, R, Kd + Ko) over its
    extended space (a ghost slot g at column ``R + g``), the space of its
    halo plan, the global column of each ghost slot (P, G) and the parts'
    row counts (``tpusolve``'s ``_stage_ell_mp``).  Where ``tpusolve``
    stores ``A`` other than ELL, both blocks come from the host CSR, as
    there."""
    if A.tpusolve_layout != "ell":
        A = ShardedMatrix.from_csr_host(
            A_host, device=A.device, dtype=numpy_dtype(A.dtype),
            row_offsets=A.row_offsets, col_offsets=A.col_offsets,
            allow_dia=False, allow_bdia=False, allow_bell=False)
    P, R = A.nparts, A.row_pad
    dv, dc = ell_padded_parts(A)
    vals = torch.cat([dv, A.offd_vals], dim=2)
    ecols = torch.cat([dc.long(), A.offd_cols.long() + R], dim=2)
    ecols = torch.where(vals != 0, ecols, R + A.ghost_slot.shape[1])
    send = A.send_idx.cpu().numpy()
    gslot = A.ghost_slot.cpu().numpy()
    space = _Space(P, R, _plan(send, gslot, R, A.device))
    co = np.asarray(A.col_offsets, np.int64)
    S = send.shape[-1]
    owners, pos = gslot // S, gslot % S
    q = np.repeat(np.arange(P), gslot.shape[1]).reshape(gslot.shape)
    ghost_globals = co[owners] + send[owners, q, pos]
    return vals, ecols, space, ghost_globals, np.diff(A.row_offsets)


# ----------------------------------------------------------------------
# strength + PMIS

def _strength_mp(vals, xcols, own, valid, theta: float):
    """Strength on the extended slots (``tpusolve``'s ``_strength_mp``; a
    ghost slot never equals a row's own): ``(S, diag, offd)``."""
    offd = xcols != own[:, None]
    diag = _rowsum(torch.where(offd, 0.0, vals))
    sflip = torch.where(diag < 0, -1.0, 1.0).to(vals.dtype)
    cand = torch.where(offd, -vals * sflip[:, None], -torch.inf)
    rowmax = cand.amax(dim=1)
    S = (cand >= theta * rowmax[:, None]) & (cand > 0) & valid[:, None]
    return S, diag, offd


def _pmis_mp(S, xcols, space: _Space, rank, valid, max_rounds: int):
    """PMIS C/F split over all parts (``tpusolve``'s ``_pmis_mp``): the
    influence counts S's columns in the extended spaces and adds each
    ghost's count into its owner (reverse halo); each round sends the
    undecided keys to the ghosts, takes each row's neighbour maximum over
    its strong columns and, by a scatter-max and the reverse halo, over
    the rows that hold it strong, and sends the new C flags to the ghosts.
    Keys are exact integers in the global rank space.  Returns (state,
    rounds)."""
    Ks = max(1, int(S.sum(dim=1).max()))
    scols, = _left_pack(S, Ks, [(xcols, -1)])
    Smk = torch.arange(Ks, device=S.device)[None] < S.sum(dim=1)[:, None]
    row_dead = space.dead.repeat_interleave(space.R)
    scols = torch.where(Smk, scols, row_dead[:, None])
    N = space.P * space.E
    infl = space.reverse(torch.bincount(scols[Smk], minlength=N), "add")
    w = _pmis_keys(infl, rank)
    state = torch.where((infl == 0) | ~valid, F_PT, UND)
    it = 0
    while it < max_rounds and bool((state == UND).any()):
        active = state == UND
        wa = torch.where(active, w, 0)
        m_row = torch.where(Smk, space.ext(wa, 0)[scols], 0).amax(dim=1)
        mbuf = torch.zeros(N, dtype=w.dtype, device=w.device).scatter_reduce_(
            0, scols.reshape(-1), torch.where(Smk, wa[:, None], 0).reshape(-1),
            "amax")
        newC = active & (wa > torch.maximum(m_row,
                                            space.reverse(mbuf, "max")))
        state = torch.where(newC, C_PT, state)
        hit = (Smk & space.ext(newC, False)[scols]).any(dim=1)
        state = torch.where(active & ~newC & hit, F_PT, state)
        it += 1
    state = torch.where(state == UND, C_PT, state)
    return torch.where(valid, state, F_PT), it


# ----------------------------------------------------------------------
# interpolation

def _interp_direct_mp(vals, xcols, S, offd, isC, isC_x, cmapg_x, diag):
    """Direct interpolation (``tpusolve``'s ``_interp_direct_mp``): (w,
    pcol, keep) on the extended slots, ``pcol`` global coarse ids."""
    strongC = S & isC_x[xcols]
    neg, pos = vals < 0, vals > 0
    sum_neg = _rowsum(torch.where(offd & neg, vals, 0.0))
    sum_pos = _rowsum(torch.where(offd & pos, vals, 0.0))
    sC_neg = _rowsum(torch.where(strongC & neg, vals, 0.0))
    sC_pos = _rowsum(torch.where(strongC & pos, vals, 0.0))
    alpha = torch.where(sC_neg != 0, sum_neg / torch.where(
        sC_neg != 0, sC_neg, 1.0), 0.0)
    beta = torch.where(sC_pos != 0, sum_pos / torch.where(
        sC_pos != 0, sC_pos, 1.0), 0.0)
    dlump = torch.where(sC_pos == 0, sum_pos, 0.0)
    dii = diag + dlump
    dii = torch.where(dii != 0, dii, 1.0)
    keep = strongC & ~isC[:, None]
    scale = torch.where(vals < 0, alpha[:, None], beta[:, None])
    w = torch.where(keep, -scale * vals / dii[:, None], 0.0)
    pcol = torch.where(keep, cmapg_x[xcols], 0)
    return w, pcol, keep


def _strong_sets_mp(vals, xcols, S, offd, isC_x, gext, dead):
    """The distance-2 interpolations' packs (``tpusolve``'s ``_cwidths_mp``
    and ``_pack_sel_jit``): strong-C slots (vals, extended slots, global
    fine ids, counts) and strong-F ones (vals, extended slots, counts),
    left-packed, dead slots at the inert slot, and the weak sums."""
    isCcol = isC_x[xcols]
    strongC, strongF = S & isCcol, S & ~isCcol
    ccnt, fcnt = strongC.sum(dim=1), strongF.sum(dim=1)
    Kc, KF = max(1, int(ccnt.max())), max(1, int(fcnt.max()))
    scv, sec = _left_pack(strongC, Kc, [(vals, 0.0), (xcols, -1)])
    fv, fe = _left_pack(strongF, KF, [(vals, 0.0), (xcols, -1)])
    sec = torch.where(sec < 0, dead[:, None], sec)
    fe = torch.where(fe < 0, dead[:, None], fe)
    scm = torch.arange(Kc, device=vals.device)[None] < ccnt[:, None]
    scg = torch.where(scm, gext[sec], _I32_MAX)
    weaksum = _rowsum(torch.where(offd & ~S, vals, 0.0))
    return (scv, sec, scg, ccnt), (fv, fe, fcnt), strongC, weaksum


def _interp_classical_mp(vals, xcols, S, offd, isC_x, cmapg_x, diag,
                         space: _Space, gext, budget, log):
    """Classical-modified interpolation (``tpusolve``'s
    ``_interp_classical_mp``): each ghost neighbour's whole row travels by
    the forward halo (values, global fine columns, diagonal), then the
    one-part chunks (``device_setup_ell._classical_chunk``) run on all
    parts' rows, strong-C sets keyed by global fine id.  Returns (w, pcol,
    route) over each row's strong-C slots sorted by global fine id: the
    global coarse id, and the ghost slot of a remote one (-1 local)."""
    n_rows, K = vals.shape
    dead = space.dead.repeat_interleave(space.R)
    (scv, sec, scg, ccnt), (fv, fe, fcnt), _, weaksum = _strong_sets_mp(
        vals, xcols, S, offd, isC_x, gext, dead)
    vals_x = space.ext(vals, 0.0)
    gcols_x = space.ext(gext[xcols], -1)
    diag_x = space.ext(diag, 1.0)
    order = torch.argsort(-fcnt, stable=True)
    fcnt_s = fcnt[order].cpu()
    parts = _chunks(n_rows, K * 8 * 8, budget)
    if log is not None:
        log(f"      classical interp [{space.P} parts]: KF={fv.shape[1]} "
            f"Kc={scv.shape[1]} chunks={len(parts)}")
    ws = []
    for sl in parts:
        o = order[sl]
        KF_c = min(fv.shape[1], max(1, _round_up(int(fcnt_s[sl.start]), 4)))
        w, _ = _classical_chunk(fv[o, :KF_c], fe[o, :KF_c], scv[o], scg[o],
                                ccnt[o], diag[o], weaksum[o], vals_x,
                                gcols_x, diag_x, KF_c)
        ws.append(w)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_rows, device=order.device)
    w = torch.cat(ws)[inv]
    # the slots in the order the chunks sorted them: by global fine id
    _, idx = torch.sort(scg, dim=1, stable=True)
    sec_s = torch.gather(sec, 1, idx)
    live = torch.gather(scg, 1, idx) < _I32_MAX
    pcol = torch.where(live, cmapg_x[sec_s], 0)
    route = _route(sec_s, live, space)
    return w, pcol, route


def _route(slots, live, space: _Space):
    """The ghost slot of each live extended slot in another part's rows,
    else -1 (``tpusolve``'s P routes)."""
    e = slots % space.E
    return torch.where(live & (e >= space.R), e - space.R, -1)


def _exti_set_mp(own_c, own_v, sgf, sgc, fv_c, fe_c, sc_gf_x, sc_gc_x,
                 ccnt_x):
    """A chunk's extended column sets (``tpusolve``'s ``_interp_exti_mp``
    candidate runs): the row's own entries (values, out of the pattern),
    its strong-C columns and each strong-F neighbour's (in the pattern,
    with their global coarse ids, value 0), sorted by global fine id, each
    column's run summed, its pattern and coarse id combined by max; the
    pattern's columns left-packed.  Returns (keys INF-padded, a_ij on
    them, coarse ids)."""
    C_, KF = fe_c.shape
    Kc = sgf.shape[1]
    dev = own_v.device
    nb_live = ((torch.arange(Kc, device=dev)[None, None]
                < ccnt_x[fe_c][:, :, None])
               & (fv_c != 0)[:, :, None]).reshape(C_, KF * Kc)
    nb_gf = torch.where(nb_live, sc_gf_x[fe_c].reshape(C_, -1), _I32_MAX)
    nb_gc = torch.where(nb_live, sc_gc_x[fe_c].reshape(C_, -1), -1)
    cat_c = torch.cat([own_c, sgf, nb_gf], dim=1)
    zeros = torch.zeros((C_, Kc + KF * Kc), dtype=own_v.dtype, device=dev)
    cat_v = torch.cat([own_v, zeros], dim=1)
    cat_p = torch.cat([torch.zeros_like(own_c), (sgf < _I32_MAX).long(),
                       nb_live.long()], dim=1)
    cat_g = torch.cat([torch.full_like(own_c, -1), sgc, nb_gc], dim=1)
    c_s, idx = torch.sort(cat_c, dim=1, stable=True)
    val_run = _run_scan(torch.gather(cat_v, 1, idx), c_s, torch.add)
    pat_run = _run_scan(torch.gather(cat_p, 1, idx), c_s, torch.maximum)
    gc_run = _run_scan(torch.gather(cat_g, 1, idx), c_s, torch.maximum)
    end = torch.ones_like(c_s, dtype=torch.bool)
    end[:, :-1] = c_s[:, :-1] != c_s[:, 1:]
    end &= (c_s < _I32_MAX) & (pat_run > 0)
    width = max(1, int(end.sum(dim=1).max()))
    key_s, idx = torch.sort(torch.where(end, c_s, _I32_MAX), dim=1,
                            stable=True)
    keys = key_s[:, :width].contiguous()
    on = keys < _I32_MAX
    aon = torch.where(on, torch.gather(val_run, 1, idx[:, :width]), 0.0)
    gck = torch.where(on, torch.gather(gc_run, 1, idx[:, :width]), 0)
    return keys, aon, gck


def _interp_exti_mp(vals, xcols, S, offd, isC_x, cmapg_x, diag,
                    space: _Space, gext, rows_gid, budget, log):
    """Extended+i interpolation (``tpusolve``'s ``_interp_exti_mp``): the
    ghosts' rows and their strong-C packs (global fine and coarse ids)
    travel by the forward halo, a distance-2 C point being perhaps owned
    by a part that is no neighbour; then the one-part chunk
    (``device_setup_ell._exti_chunk``) on all parts' rows.  Returns (w,
    gf, gc): weights over each row's extended columns sorted, their global
    fine ids (INF on dead slots) and global coarse ids."""
    n_rows, K = vals.shape
    dead = space.dead.repeat_interleave(space.R)
    (scv, sec, scg, ccnt), (fv, fe, _), strongC, weaksum = _strong_sets_mp(
        vals, xcols, S, offd, isC_x, gext, dead)
    KF, Kc = fe.shape[1], sec.shape[1]
    scm = torch.arange(Kc, device=vals.device)[None] < ccnt[:, None]
    sgc = torch.where(scm, cmapg_x[sec], -1)
    gcols = gext[xcols]
    vals_x = space.ext(vals, 0.0)
    gcols_x = space.ext(gcols, -1)
    diag_x = space.ext(diag, 1.0)
    sc_gf_x = space.ext(scg, _I32_MAX)
    sc_gc_x = space.ext(sgc, -1)
    ccnt_x = space.ext(ccnt, 0)
    own_c = torch.where(offd & (vals != 0), gcols, _I32_MAX)
    own_v = torch.where(own_c < _I32_MAX, vals, 0.0)
    parts = _chunks(n_rows, (K + KF * Kc + Kc) * 8 * 4, budget)
    ws, gfs, gcs = [], [], []
    for sl in parts:
        keys, aon, gck = _exti_set_mp(own_c[sl], own_v[sl], scg[sl], sgc[sl],
                                      fv[sl], fe[sl], sc_gf_x, sc_gc_x,
                                      ccnt_x)
        w, k = _exti_chunk(keys, aon, fv[sl], fe[sl], diag[sl],
                           weaksum[sl], vals_x, gcols_x, diag_x,
                           rows_gid[sl])
        ws.append(w)
        gfs.append(k)
        gcs.append(gck)
    Kce = _round_up(max(k.shape[1] for k in gfs), 4)
    if log is not None:
        log(f"      ext+i interp [{space.P} parts]: KF={KF} Kc={Kc} "
            f"Kce={Kce} chunks={len(parts)}")
    pad = lambda a, fill: torch.nn.functional.pad(
        a, (0, Kce - a.shape[1]), value=fill)
    return (torch.cat([pad(a, 0.0) for a in ws]),
            torch.cat([pad(a, _I32_MAX) for a in gfs]),
            torch.cat([pad(a, 0) for a in gcs]))


def _pack_p_mp(w, pairs, keep, isC, identity):
    """P's ELL (rows, Kp), ``Kp = max(8, round_up(widest row, 8))``: each
    F row's ``keep`` slots left-packed in slot order, each C row the
    identity in slot 0 (``tpusolve``'s packs and ``_fit_width_jit``).
    ``pairs``: (array, fill) of the slots' other fields; ``identity``:
    their C-row values.  Returns (Pv, [fields], nnz)."""
    keep = keep & ~isC[:, None]
    pw = int(keep.sum(dim=1).max()) if keep.numel() else 0
    Kp = max(8, _round_up(max(pw, 1), 8))
    out = _left_pack(keep, Kp, [(w, 0.0)] + list(pairs))
    out[0][:, 0] = torch.where(isC, 1.0, out[0][:, 0])
    for arr, ident in zip(out[1:], identity):
        arr[:, 0] = torch.where(isC, ident, arr[:, 0])
    return out[0], out[1:], int(keep.sum()) + int(isC.sum())


def _ring2_plan(Pgf_h, Pv_h, rowcnt, ro):
    """The second-ring transpose plan from P's remote fine columns
    (``tpusolve``'s ``_ring2_plan``, host, O(seam) data): each part's
    sorted unique remote fine ids become its ghost slots.  Returns
    (send_idx (P, P, S2), ghost_slot (P, G2), ghosts (P, G2), -1 padded)."""
    Pn = Pgf_h.shape[0]
    ghost_lists = []
    for p in range(Pn):
        g = Pgf_h[p][Pv_h[p] != 0].astype(np.int64)
        ghost_lists.append(np.unique(g[(g < ro[p]) | (g >= ro[p + 1])]))
    G2 = max(1, max(g.size for g in ghost_lists))
    send_counts = np.zeros((Pn, Pn), np.int64)
    for q in range(Pn):
        send_counts[:, q] = np.diff(np.searchsorted(ghost_lists[q], ro))
    S2 = max(1, int(send_counts.max()))
    sidx2 = np.zeros((Pn, Pn, S2), np.int32)
    gslot2 = np.zeros((Pn, G2), np.int32)
    ghosts = np.full((Pn, G2), -1, np.int64)
    for q in range(Pn):
        gl = ghost_lists[q]
        st = np.searchsorted(gl, ro)
        owners = np.searchsorted(ro, gl, side="right") - 1
        gslot2[q, :gl.size] = owners * S2 + np.arange(gl.size) - st[owners]
        ghosts[q, :gl.size] = gl
        for p in range(Pn):
            seg = gl[st[p]:st[p + 1]] - ro[p]
            sidx2[p, q, :seg.size] = seg
    return sidx2, gslot2, ghosts


# ----------------------------------------------------------------------
# the seams of R and Ac

def _ship(Mv, Mc, ncl: int, space: _Space, tgt: torch.Tensor):
    """``tpusolve``'s ``_seam_shard``: the ghost-slot rows (P * G, K) of
    each part's extended coarse rows ``Mv``, ``Mc`` (P * (ncl + G), K)
    travel to the ghosts' owners, where they land on the owners' local
    coarse rows ``tgt`` (P * G,).  Returns COO (row, col, val), row in the
    owners' flat (P * ncl) rows, in ghost-slot order."""
    P, G = space.P, space.G
    K = Mv.shape[1]
    sv = Mv.reshape(P, ncl + G, K)[:, ncl:].reshape(P * G, K)
    sc = Mc.reshape(P, ncl + G, K)[:, ncl:].reshape(P * G, K)
    row = (space.owner * ncl + tgt)[:, None].expand(P * G, K)
    live = sv != 0
    return row[live], sc[live], sv[live]


def _merge(Mv, Mc, extra, nrows: int, sentinel: int):
    """``tpusolve``'s ``_merge_shard`` and ``_final``: each row's own
    entries (nrows, K), then the shipped entries ``extra`` (row, col, val)
    in their order, sorted by column and each column's run summed
    (:func:`device_setup_ell._run_pack`).  Returns (vals, cols, counts)."""
    row, col, val = extra
    dev = Mv.device
    key_s, idx = torch.sort(row, stable=True)
    pos = torch.arange(key_s.numel(), device=dev)
    start = torch.ones_like(key_s, dtype=torch.bool)
    start[1:] = key_s[1:] != key_s[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, -1), dim=0).values
    Kx = int(rank.max()) + 1 if rank.numel() else 0
    xv = torch.zeros((nrows, Kx), dtype=Mv.dtype, device=dev)
    xc = torch.full((nrows, Kx), sentinel, dtype=torch.int64, device=dev)
    xv[key_s, rank] = val[idx]
    xc[key_s, rank] = col[idx].long()
    v = torch.cat([Mv, xv], dim=1)
    c = torch.cat([torch.where(Mv != 0, Mc.long(), sentinel), xc], dim=1)
    c = torch.where(v != 0, c, sentinel)
    return _run_pack(v, c, sentinel)


# ----------------------------------------------------------------------
# orchestrator

def device_level0_ell_mp(A: ShardedMatrix, cfg, *, A_host=None,
                         seed: int = 1234, log=None, budget: int = BUDGET):
    """Set up one level of the N-part ELL operator ``A`` on its device
    (``tpusolve``'s ``device_level0_ell_mp``).  Returns None when coarsening
    stalls, else the dict of ``device_setup_ell.device_level0_ell``: P
    (n, nc), R and Ac as N-part ELL operators with offd blocks, the coarse
    rows of part p its C points (``coarse_row_offsets``)."""
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
            log(f"    setup[dev-ell-mp]: {label:22s} {seconds[label]:8.3f}s")

    n, dt = A.shape[0], A.dtype
    P_, R = A.nparts, A.row_pad
    ro = np.asarray(A.row_offsets, np.int64)
    vals3, ecols, space, ghost_globals, rowcnt = _stage_ell_mp(A, A_host)
    if vals3.shape[-1] > MAX_ELL_K:
        return None
    vals = vals3.reshape(P_ * R, -1)
    xcols = space.flat(ecols)
    lrow = torch.arange(R, device=dev).repeat(P_)
    part = torch.arange(P_, device=dev).repeat_interleave(R)
    valid = lrow < torch.from_numpy(rowcnt).to(dev)[part]
    stage("ELL staging")

    # --- strength + PMIS, ranks of the global generator by row offsets ---
    S, diag, offd = _strength_mp(vals, xcols, space.own, valid,
                                 float(cfg.strong_threshold))
    rg = pmis_rank(seed, n, n)
    rank = np.zeros((P_, R), np.int32)
    for p in range(P_):
        rank[p, :rowcnt[p]] = rg[ro[p]:ro[p + 1]]
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    state, rounds = _pmis_mp(S, xcols, space,
                             torch.from_numpy(rank.reshape(-1)).to(dev),
                             valid, max_rounds)
    isC = state == C_PT
    nc_p = isC.reshape(P_, R).sum(dim=1).cpu().numpy().astype(np.int64)
    nc = int(nc_p.sum())
    if log is not None:
        log(f"      pmis rounds: {rounds}")
    stage("strength+PMIS")
    if nc == 0 or nc >= n:
        return None
    coff = np.zeros(P_ + 1, np.int64)
    np.cumsum(nc_p, out=coff[1:])
    ncl = max(1, int(nc_p.max()))
    cmap = (torch.cumsum(isC.reshape(P_, R), dim=1) - 1).reshape(-1)
    cmapg = cmap + torch.from_numpy(coff[:-1]).to(dev)[part]

    # --- interpolation: C flags and coarse ids to the ghosts ---
    isC_x = space.ext(isC, False)
    cmapg_x = space.ext(cmapg, 0)
    space_T = space
    if cfg.interp_type in (0, 6):
        co = np.asarray(A.col_offsets, np.int64)
        gext = np.zeros((P_, space.E), np.int64)
        gext[:, :R] = co[:-1, None] + np.arange(R)
        gext[:, R:R + space.G] = ghost_globals
        gext = torch.from_numpy(gext.reshape(-1)).to(dev)
    if cfg.interp_type == 0:
        w, pcol, route = _interp_classical_mp(
            vals, xcols, S, offd, isC_x, cmapg_x, diag, space, gext, budget,
            log)
        Pv, (Pcg, Prt), nnz_p = _pack_p_mp(
            w, [(pcol, 0), (route, -1)], w != 0, isC, [cmapg, -1])
    elif cfg.interp_type == 6:
        rows_gid = torch.from_numpy(ro[:-1]).to(dev)[part] + lrow
        w, gf, gc = _interp_exti_mp(vals, xcols, S, offd, isC_x, cmapg_x,
                                    diag, space, gext, rows_gid, budget, log)
        Pv, (Pcg, Pgf), nnz_p = _pack_p_mp(
            w, [(gc, 0), (gf, 0)], w != 0, isC, [cmapg, rows_gid])
        # the second-ring plan, from P's remote fine columns
        Pv_h = Pv.reshape(P_, R, -1).cpu().numpy()
        Pgf_h = Pgf.reshape(P_, R, -1).cpu().numpy()
        send2, gslot2, ghosts2 = _ring2_plan(Pgf_h, Pv_h, rowcnt, ro)
        prt = np.full(Pgf_h.shape, -1, np.int64)
        for p in range(P_):
            g = Pgf_h[p].astype(np.int64)
            remote = (Pv_h[p] != 0) & ((g < ro[p]) | (g >= ro[p + 1]))
            gl = ghosts2[p][ghosts2[p] >= 0]
            prt[p][remote] = np.searchsorted(gl, g[remote])
        Prt = torch.from_numpy(prt.reshape(P_ * R, -1)).to(dev)
        space_T = _Space(P_, R, _plan(send2, gslot2, R, dev))
    else:
        w, pcol, keep = _interp_direct_mp(vals, xcols, S, offd, isC, isC_x,
                                          cmapg_x, diag)
        Pv, (Pcg, Prt), nnz_p = _pack_p_mp(
            w, [(pcol, 0), (_route(xcols, keep, space), -1)], keep, isC,
            [cmapg, -1])
    del S, w
    dinv = 1.0 / torch.where(diag != 0, diag, 1.0)
    l1 = _rowsum(vals.abs())
    dinv_l1 = 1.0 / torch.where(l1 != 0, l1, 1.0)
    stage("interpolation")

    # --- W = A P: P's ghost rows by the forward halo, then local ---
    Wv, Wc, Kw, nnz_w = _product(vals, xcols, space.ext(Pv, 0.0),
                                 space.ext(Pcg, 0), nc, budget)
    if log is not None:
        log(f"      spgemm[A@P]: K={Kw} nnz={nnz_w}")
    stage("A@P")

    # --- R = P^T over each part's extended coarse rows: its own coarse
    # rows, then one a ghost slot of the transpose plan ---
    TR = ncl + space_T.G
    lc = Pcg - torch.from_numpy(coff[:-1]).to(dev)[part][:, None]
    key = torch.where(Prt >= 0, ncl + Prt, lc) + (part * TR)[:, None]
    Rv, Rc = _transpose(Pv, torch.where(Pv != 0, key, 0), P_ * TR)
    stage("R = P^T")

    # --- partial Ac = (extended-row R) W, global coarse columns ---
    Acv, Acc, _, _ = _product(Rv, Rc, Wv, Wc, nc, budget)
    del Wv, Wc
    stage("R@(AP)")

    # --- the seams: ghost-slot rows to their owners, merged ---
    gsrc = space_T.src
    tgt = cmap[gsrc]
    # R's columns: fine rows of the stacked parts -> global fine ids
    Rc_g = Rc - (Rc // R) * R + torch.from_numpy(ro[:-1]).to(dev)[Rc // R]
    own_rows = (torch.arange(P_, device=dev)[:, None] * TR
                + torch.arange(ncl, device=dev)).reshape(-1)
    Acv2, Acc2, cnt = _merge(Acv[own_rows], Acc[own_rows],
                             _ship(Acv, Acc, ncl, space_T, tgt), P_ * ncl, nc)
    Rv2, Rc2, _ = _merge(Rv[own_rows], Rc_g[own_rows],
                         _ship(Rv, Rc_g, ncl, space_T, tgt), P_ * ncl, n)
    del Acv, Acc, Rv, Rc
    nnz_c = int(cnt.sum())
    Kc = max(8, _round_up(Acv2.shape[1], 8))
    Kr = max(8, _round_up(Rv2.shape[1], 8))
    pad = lambda a, K: torch.nn.functional.pad(a, (0, K - a.shape[1]))
    Acv2, Acc2 = pad(Acv2, Kc), pad(Acc2, Kc)
    Rv2, Rc2 = pad(Rv2, Kr), pad(Rc2, Kr)
    crow = torch.arange(ncl, device=dev).repeat(P_)
    cpart = torch.arange(P_, device=dev).repeat_interleave(ncl)
    grow = crow + torch.from_numpy(coff[:-1]).to(dev)[cpart]
    dmain = _rowsum(torch.where((Acc2 == grow[:, None]) & (Acv2 != 0), Acv2,
                                0.0))
    pad_row = crow >= torch.from_numpy(nc_p).to(dev)[cpart]
    dmain = torch.where((dmain == 0) | pad_row, 1.0, dmain)
    if log is not None:
        log(f"      spgemm[R@(AP)]: K={Kc} nnz={nnz_c}")
    stage("seam merge")

    Ac_sh = from_device_ell_parts(
        (nc, nc), Acv2.reshape(P_, ncl, Kc), Acc2.reshape(P_, ncl, Kc),
        dmain.reshape(P_, ncl), nnz_c, row_offsets=coff, col_offsets=coff,
        global_cols=True)
    P_sh = from_device_ell_parts(
        (n, nc), Pv.reshape(P_, R, -1), Pcg.reshape(P_, R, -1), nnz=nnz_p,
        row_offsets=ro, col_offsets=coff, global_cols=True)
    R_sh = from_device_ell_parts(
        (nc, n), Rv2.reshape(P_, ncl, Kr), Rc2.reshape(P_, ncl, Kr),
        nnz=nnz_p, row_offsets=coff, col_offsets=ro, global_cols=True)
    stage("P/R/Ac wrap")
    return dict(Cmask=isC.to(dt), nc=nc, P=P_sh, R=R_sh, Ac=Ac_sh,
                Ah_c_fn=lambda: host_csr_parts(Ac_sh), dinv=dinv,
                dinv_l1=dinv_l1, coarse_row_offsets=coff, seconds=seconds)
