"""PFMG-style structured multigrid for box-generated operators (the port of
``tpusolve/amg/structured.py``).

HYPRE answers structured problems with its Struct/PFMG solvers rather than
BoomerAMG; this module is the analog for operators produced by the stencil
generator (a rank-3 ``A.dia_shape``):

* **geometric coarsening**: each part's box halves per dim (coarsening is
  local to the part, so the transfer operators are block-diagonal);
* **transfers** (K3): cell-centered linear interpolation over each part's
  box and its exact adjoint, one hand-written kernel launch each on the
  card (``kernels/transfer.py``, ``csrc/box_transfer.cu``); the
  prolongation adds its correction to the fine vector as it goes;
* **Galerkin coarse operators**: DIA-algebra RAP on the host
  (``amg/dia_rap.py``), assembled as box-DIA matrices whose planes keep
  their (dz, dy, dx) triples, so every level's SpMV runs K1;
* smoothers and the coarse solve shared with the algebraic builder.

Only the matrix-free setup (``structured_mg_setup_fast``, from the
stencil's ``with_parts`` payload) is ported; the scipy-RAP setup
``structured_mg_setup`` raises.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import scipy.sparse as sp

from tpusolve_torch.amg import smoothers
from tpusolve_torch.amg.builder import (
    AMGPreconditioner, Level, _build_cycle, _guard_coarse, _padded_pinv,
    _NOT_PORTED, _resolve_kinds)
from tpusolve_torch.amg.dia_rap import dia_rap
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.kernels.transfer import box_prolong, box_restrict
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import (
    numpy_dtype, to_device_vector, to_tensor)


# ----------------------------------------------------------------------
# host-side transfer operator (for Galerkin RAP only)
def _p1d(m: int) -> sp.csr_matrix:
    """1-D cell-centered interpolation (m fine cells <- m//2 coarse cells):
    fine 2c   <- .75 c + .25 (c-1, clamped)
    fine 2c+1 <- .75 c + .25 (c+1, clamped)"""
    mc = m // 2
    rows, cols, vals = [], [], []
    c = np.arange(mc)
    rows.append(2 * c); cols.append(c); vals.append(np.full(mc, 0.75))
    rows.append(2 * c); cols.append(np.maximum(c - 1, 0)); vals.append(np.full(mc, 0.25))
    rows.append(2 * c + 1); cols.append(c); vals.append(np.full(mc, 0.75))
    rows.append(2 * c + 1); cols.append(np.minimum(c + 1, mc - 1)); vals.append(np.full(mc, 0.25))
    Pm = sp.csr_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(m, mc))
    Pm.sum_duplicates()
    return Pm


def _p_box(box: tuple) -> sp.csr_matrix:
    """Per-part interpolation for an (nz, ny, nx) box, x-fastest order."""
    nz, ny, nx = box
    return sp.kron(sp.kron(_p1d(nz), _p1d(ny)), _p1d(nx)).tocsr()


def _dia_nongalerkin(dia_c: dict, tol: float) -> dict:
    """Non-Galerkin sparsification on a DIA dict: drop whole offset planes
    whose max coupling is below ``tol`` x the max of the main diagonal
    plane.  Plain truncation: the dropped values are NOT lumped onto the
    diagonal (``tpusolve``'s docstring says they are; its code, ported here,
    truncates; ROADMAP Queue 3).  Mirror planes drop together on a
    symmetric operator, so symmetry is preserved."""
    zero = next(k for k in dia_c if all(c == 0 for c in k))
    ref = float(np.abs(dia_c[zero]).max())
    return {off: plane for off, plane in dia_c.items()
            if off == zero or float(np.abs(plane).max()) >= tol * ref}


def _make_transfers(fine_box, coarse_box):
    """(prolong, restrict) of each part's box: ``prolong(ec, x, out=x)``
    is ``x + P ec`` and ``restrict(r)`` is ``P^T r``, each one launch of K3
    on the card (``kernels/transfer.py``)."""
    return (partial(box_prolong, fine_box, coarse_box),
            partial(box_restrict, fine_box, coarse_box))


# ----------------------------------------------------------------------
def structured_possible(A: ShardedMatrix) -> bool:
    return (A.uses_dia and A.dia_shape is not None
            and len(A.dia_shape) == 3
            and all(d % 2 == 0 and d >= 4 for d in A.dia_shape))


def structured_mg_setup(A: ShardedMatrix, config=None, *, A_host=None):
    """``tpusolve``'s scipy-RAP structured setup, for operators without the
    generator's payload: not ported (the port's stencil always supplies
    ``with_parts``)."""
    raise NotImplementedError(
        "structured_mg_setup (scipy RAP without the stencil's host_parts): "
        "not ported yet; use structured_mg_setup_fast; see ROADMAP.md "
        "Queue 1")


# ----------------------------------------------------------------------
# Matrix-free setup path: the whole hierarchy in DIA algebra
# (host_parts from tpusolve_torch.stencil.laplace27_host_parts)

def _dia_dict_to_arrays(dia: dict, box: tuple, nparts: int, dtype):
    """{offset_tuple: box array} -> (flat offsets sorted, (Pn, D, R) values
    broadcast across parts, the (dz, dy, dx) triples in the same order).
    On a box whose y or x extent is 4, distinct triples share flat offsets:
    the triples, not the flat offsets, name the planes."""
    strides = [int(np.prod(box[i + 1:])) for i in range(len(box))]
    items = sorted(dia.items(),
                   key=lambda kv: int(np.dot(kv[0], strides)))
    offs = np.array([int(np.dot(off, strides)) for off, _ in items],
                    np.int64)
    vals = np.stack([v.reshape(-1).astype(dtype) for _, v in items])  # (D,R)
    triples = tuple(tuple(int(c) for c in off) for off, _ in items)
    return offs, np.broadcast_to(vals[None], (nparts,) + vals.shape), triples


def _structured_to_csr(dia: dict, box: tuple, offd_parts, nparts: int):
    """Assemble the small global CSR (coarsest-level direct solve)."""
    R = int(np.prod(box))
    n = R * nparts
    idx = np.indices(box).reshape(len(box), -1)
    flat = np.arange(R)
    strides = np.array([int(np.prod(box[i + 1:])) for i in range(len(box))])
    rows_l, cols_l, vals_l = [], [], []
    for off, v in dia.items():
        tgt = idx + np.asarray(off)[:, None]
        ok = np.all((tgt >= 0) & (tgt < np.asarray(box)[:, None]), axis=0)
        fo = int(np.dot(off, strides))
        for p in range(nparts):
            rows_l.append(p * R + flat[ok])
            cols_l.append(p * R + flat[ok] + fo)
            vals_l.append(v.reshape(-1)[ok])
    for p in range(nparts):
        olr, ogc, ov = offd_parts[p]
        rows_l.append(p * R + np.asarray(olr))
        cols_l.append(np.asarray(ogc))
        vals_l.append(np.asarray(ov, np.float64))
    return sp.csr_matrix((np.concatenate(vals_l),
                          (np.concatenate(rows_l), np.concatenate(cols_l))),
                         shape=(n, n))


def _coarse_offd(offd_parts, box_f, nparts):
    """Coarse boundary-shell couplings: P^T A_offd P with block-diagonal P.
    A_offd holds only surface entries, so this scipy product is tiny."""
    Rf = int(np.prod(box_f))
    nf = Rf * nparts
    rows = np.concatenate([p * Rf + np.asarray(olr)
                           for p, (olr, _, _) in enumerate(offd_parts)])
    cols = np.concatenate([np.asarray(ogc) for _, ogc, _ in offd_parts])
    vals = np.concatenate([np.asarray(ov, np.float64)
                           for _, _, ov in offd_parts])
    if rows.size == 0:
        return [(np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.float64))] * nparts
    Ao = sp.csr_matrix((vals, (rows, cols)), shape=(nf, nf))
    Pg = sp.block_diag([_p_box(box_f)] * nparts, format="csr")
    Ac = (Pg.T @ (Ao @ Pg)).tocoo()
    Ac.eliminate_zeros()
    Rc = Rf // 8
    out = []
    owners = Ac.row // Rc
    for p in range(nparts):
        sel = owners == p
        out.append((Ac.row[sel] - p * Rc, Ac.col[sel],
                    Ac.data[sel]))
    return out


def _make_level_structured(A_sh, dia, offd_parts, box, dtype,
                           kind_down, kind_up, cfg, kind_coarse=None) -> Level:
    """Smoother data straight from the DIA/offd payload (no CSR).  The
    Chebyshev bounds are the Gershgorin bound of the DIA dict, max over rows
    of l1 / |diag|, not a power iteration."""
    nparts = A_sh.nparts
    R = int(np.prod(box))
    center = tuple(0 for _ in box)
    d0 = dia[center].reshape(-1).astype(np.float64)
    d0 = np.where(d0 != 0, d0, 1.0)
    l1_box = sum(np.abs(v) for v in dia.values()).reshape(-1)

    kinds = (kind_down, kind_up, kind_coarse)
    need_l1 = smoothers.RELAX_L1_JACOBI in kinds
    need_cheby = smoothers.RELAX_CHEBYSHEV in kinds

    ro = np.asarray(A_sh.row_offsets)
    dinv_g = np.tile(1.0 / d0, nparts)
    l1_g = np.empty(R * nparts)
    lam = 1.0
    for p in range(nparts):
        olr, _, ov = offd_parts[p]
        extra = np.bincount(np.asarray(olr, np.int64),
                            weights=np.abs(np.asarray(ov, np.float64)),
                            minlength=R)
        l1_p = l1_box + extra
        l1_g[p * R:(p + 1) * R] = np.where(l1_p != 0, l1_p, 1.0)
        lam = max(lam, float(np.max(l1_p / np.abs(d0))))

    dev = A_sh.device
    dinv = to_device_vector(dinv_g, ro, A_sh.row_pad, dev, dtype=dtype)
    dinv_l1 = (to_device_vector(1.0 / l1_g, ro, A_sh.row_pad, dev,
                                dtype=dtype) if need_l1 else None)
    # Gershgorin upper bound on lambda_max(D^-1 A) for Chebyshev
    cheby_bounds = ((cfg.cheby_fraction * lam, 1.1 * lam)
                    if need_cheby else None)
    nnz = (sum(int(np.count_nonzero(v)) for v in dia.values()) * nparts
           + sum(len(o[0]) for o in offd_parts))
    return Level(A=A_sh, P=None, R=None, dinv_l1=dinv_l1, dinv=dinv,
                 cheby_bounds=cheby_bounds, n=R * nparts, nnz=nnz)


def _dia_matrix(dia: dict, offd_parts, box, nparts, device, dtype):
    """The box-DIA operator of a level's DIA dict, its planes named by their
    triples."""
    _, arr, triples = _dia_dict_to_arrays(dia, box, nparts, dtype)
    n = int(np.prod(box)) * nparts
    return ShardedMatrix.from_dia_parts((n, n), triples, arr, offd_parts,
                                        device=device, dtype=dtype,
                                        dia_shape=box)


def structured_mg_setup_fast(A: ShardedMatrix, config=None, *,
                             host_parts) -> AMGPreconditioner:
    """Matrix-free structured setup: Galerkin RAP in DIA algebra per level
    (``amg/dia_rap.py``), boundary-shell couplings via a tiny sparse
    product."""
    cfg = config or BoomerAMGConfig()
    if getattr(cfg, "smoother_dtype", "match") == "bfloat16":
        raise NotImplementedError(f"smoother_dtype: bfloat16 {_NOT_PORTED}")
    if not structured_possible(A):
        raise ValueError("structured multigrid requires a rank-3 dia_shape "
                         "with even dims >= 4")
    dtype = numpy_dtype(A.dtype)
    nparts = A.nparts
    notes = ["structured (PFMG-style) geometric hierarchy",
             "setup: DIA-algebra Galerkin RAP"]
    kind_down, kind_up, kind_coarse, knotes = _resolve_kinds(cfg)
    notes += knotes

    dia, offd_parts = host_parts
    box = tuple(A.dia_shape)
    A_sh = A
    levels: list[Level] = []
    max_coarse = max(cfg.max_coarse_size, 1)

    for lvl in range(cfg.max_levels):
        n = int(np.prod(box)) * nparts
        can_coarsen = all(d % 2 == 0 and d >= 4 for d in box)
        if n <= max_coarse or lvl == cfg.max_levels - 1 or not can_coarsen:
            break
        coarse_box = tuple(d // 2 for d in box)

        lev = _make_level_structured(A_sh, dia, offd_parts, box, dtype,
                                     kind_down, kind_up, cfg)
        lev.prolong, lev.restrict = _make_transfers(box, coarse_box)
        levels.append(lev)

        dia_c, _ = dia_rap(dia, box)
        if cfg.non_galerkin_tol > 0:
            dia_c = _dia_nongalerkin(dia_c, cfg.non_galerkin_tol)
        offd_c = _coarse_offd(offd_parts, box, nparts)
        A_sh = _dia_matrix(dia_c, offd_c, coarse_box, nparts, A.device,
                           dtype)
        dia, offd_parts, box = dia_c, offd_c, coarse_box

    n_c = int(np.prod(box)) * nparts
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, n_c, cfg, notes)
    lev = _make_level_structured(A_sh, dia, offd_parts, box, dtype,
                                 kind_down, kind_up, cfg,
                                 kind_coarse=kind_coarse)
    levels.append(lev)
    if kind_coarse == smoothers.RELAX_DIRECT:
        Ah_c = _structured_to_csr(dia, box, offd_parts, nparts)
        coarse_inv = _padded_pinv(Ah_c, A_sh, dtype)
    else:
        coarse_inv = to_tensor(np.zeros((1, 1), dtype), A.device)

    pre = AMGPreconditioner(levels=levels, coarse_inv=coarse_inv, config=cfg,
                            notes=notes, num_levels=len(levels))
    pre.cycle = _build_cycle(pre, kind_down, kind_up, cfg,
                             kind_coarse=kind_coarse,
                             coarse_sweeps=coarse_sweeps)
    return pre


def hierarchy_from_dia_dicts(levels: list[dict], coarse_inv: np.ndarray,
                             config: BoomerAMGConfig | None, device, dtype
                             ) -> AMGPreconditioner:
    """The port's structured preconditioner on per-level DIA dicts built
    elsewhere (``tpusolve``'s ``dia_rap`` hierarchy), so that one V-cycle of
    both packages can run on identical operators: the structured
    counterpart of ``builder.hierarchy_from_arrays``.

    ``levels[i]`` holds ``dia`` ({(dz, dy, dx): box array}), ``box``, and
    ``dinv``, ``dinv_l1`` (padded numpy vectors or None) and
    ``cheby_bounds``; every level but the last gets the box transfers to
    the next.  ``coarse_inv`` is the padded coarsest pseudo-inverse."""
    cfg = config or BoomerAMGConfig()
    kind_down, kind_up, kind_coarse, notes = _resolve_kinds(cfg)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    vec = lambda a: None if a is None else to_tensor(np.asarray(a), device,
                                                     dtype)
    levs = []
    for i, d in enumerate(levels):
        box = tuple(d["box"])
        A = _dia_matrix(d["dia"], [empty], box, 1, device, dtype)
        lev = Level(A=A, P=None, R=None, dinv_l1=vec(d.get("dinv_l1")),
                    dinv=vec(d.get("dinv")),
                    cheby_bounds=d.get("cheby_bounds"), n=A.shape[0],
                    nnz=A.nnz)
        if i + 1 < len(levels):
            lev.prolong, lev.restrict = _make_transfers(
                box, tuple(levels[i + 1]["box"]))
        levs.append(lev)
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, levs[-1].n, cfg,
                                               notes)
    pre = AMGPreconditioner(levels=levs, coarse_inv=vec(coarse_inv),
                            config=cfg, notes=notes, num_levels=len(levs))
    pre.cycle = _build_cycle(pre, kind_down, kind_up, cfg,
                             kind_coarse=kind_coarse,
                             coarse_sweeps=coarse_sweeps)
    return pre
