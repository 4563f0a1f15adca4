"""Device ILU(0) setup: Chow-Patel sweeps on the operator's device (the port
of ``tpusolve/ilu/device_setup.py``).

The reference's iterative (rocSPARSE-style) ILU0 setup, configured by the
``ilu_iterative_setup_*`` keys (src/HypreSystem.cpp:352-361): fixed-point
sweeps, each a masked sparse product and an elementwise update.  Two
factorizers, as in ``tpusolve``, written in eager PyTorch:

* **DIA** (:func:`make_factorizer`): on a box-DIA operator the masked
  product ``(L U)|pattern`` is a static set of shifted plane multiply-adds
  in box space: a term ``l[d1](c) * u[d2](c + d1)`` lands on plane
  ``d1 + d2`` where that plane is in the band.  The pattern is the whole
  band masked to the box (each stored plane is dense over the box), a
  superset of the host path's stored nonzeros.  The factors are DIA, and
  K1 runs their Jacobi sweeps.
* **ELL** (:func:`make_ell_factorizer`): on a padded-ELL operator (the
  file-loaded class) the product is precomputed once as a static table of
  (lower entry, upper entry, destination) positions, found by a sorted
  search over the rows' sorted columns, one table a lower slot; each sweep
  is then, a slot at a time, a gather, a multiply and an ``index_add_``
  whose destinations are distinct, so the sums come in the same order, and
  give the same bits, on the CPU and on a GPU (whose ``index_add_`` is
  atomic).  (``tpusolve``'s compare-count and one-hot contraction is a
  scatter-free device for the TPU; its sums agree to roundoff.)  The
  factors are ELL, and K2 runs them in the form
  ``matrix/sharded.py:ell_form`` prices.

Which path applies (:func:`device_path`) is read against the layout
``tpusolve`` gives the operator (``ShardedMatrix.tpusolve_layout``), so the
port factors on the device exactly where ``tpusolve`` does.  An eligible
operator is factored on its device or the setup raises; it never takes the
host path instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusolve_torch import dist
from tpusolve_torch.matrix.sharded import ShardedMatrix, _offd_fields
from tpusolve_torch.matrix.vectors import numpy_dtype

# tpusolve factors ILU(0) on the device from this many rows
# (tpusolve/ilu/device_setup.py:38), ELL operators up to this row width (:41)
MIN_DEVICE_N = 1 << 16
MAX_ELL_K = 128
# the largest temporary, in bytes, of the ELL factorizer's table build and
# of each sweep's product (one chunk of rows, one chunk of the table)
ELL_BUDGET = 2 << 30


def device_path(A: ShardedMatrix, cfg, device_min_n: int = MIN_DEVICE_N):
    """``"dia"``, ``"ell"`` or None: ``tpusolve``'s ``_device_path``.
    ILU(0) without local reordering, from ``device_min_n`` rows (None:
    never), on the layout ``tpusolve`` gives ``A``: DIA with the main
    diagonal and planes on both sides of it (the (dz, dy, dx) triples'
    lexicographic sign, which is the flat offset's wherever the flat offset
    names one triple), or ELL of at most ``MAX_ELL_K`` entries a row.
    ``tpusolve``'s BDIA and BELL layouts stay on the host.  Where
    ``tpusolve`` stores ELL and the port BDIA or BELL, the path is ELL all
    the same (:func:`_ell_padded` builds the ELL arrays)."""
    if cfg.ilu_type != 0 or cfg.ilu_fill_level != 0:
        return None
    if cfg.ilu_local_reordering:
        return None
    if device_min_n is None or A.shape[0] < device_min_n:
        return None
    if A.tpusolve_layout == "dia" and A.uses_dia:
        origin = (0, 0, 0)
        offs = A.dia_offsets
        if origin in offs and any(t < origin for t in offs) \
                and any(t > origin for t in offs):
            return "dia"
        return None
    if A.tpusolve_layout == "ell":
        return "ell" if A.row_width <= MAX_ELL_K else None
    return None


# ----------------------------------------------------------------------
# DIA Chow-Patel sweeps

def _valid_mask(t, dims, device) -> torch.Tensor:
    """Boolean (*dims) mask: cell + t stays inside the box (where plane
    ``t`` has a matrix entry)."""
    m = torch.ones(dims, dtype=torch.bool, device=device)
    for ax, (c, d) in enumerate(zip(t, dims)):
        ar = torch.arange(d, device=device).reshape(
            [-1 if i == ax else 1 for i in range(len(dims))])
        m = m & (ar >= max(0, -c)) & (ar < d - max(0, c))
    return m


def _pad3(a: torch.Tensor, pads, fill: float = 0.0) -> torch.Tensor:
    """``a`` (..., nz, ny, nx) padded by ``pads`` = (pz, py, px) on both
    sides of each box axis with ``fill``."""
    pz, py, px = pads
    return F.pad(a, (px, px, py, py, pz, pz), value=fill)


def _at(padded: torch.Tensor, pads, t, dims) -> torch.Tensor:
    """The view of a :func:`_pad3`-padded (nz, ny, nx) array at cell + t."""
    return padded[tuple(slice(p + c, p + c + d)
                        for p, c, d in zip(pads, t, dims))]


def make_factorizer(offsets, dims, sweeps: int):
    """``(factor, l_offsets, u_offsets)`` for the static (triples, box)
    plan: ``factor(dia)`` takes the (D, nz, ny, nx) planes and returns
    ``(l_planes, u_strict_planes, udiag_inv)`` after ``sweeps`` Chow-Patel
    sweeps, the updates ``tpusolve``'s (``make_factorizer``, :163-171)."""
    triples = tuple(tuple(int(c) for c in t) for t in offsets)
    dims = tuple(int(d) for d in dims)
    origin = (0, 0, 0)
    low = [k for k, t in enumerate(triples) if t < origin]
    upp = [k for k, t in enumerate(triples) if t >= origin]   # with diag
    k0 = triples.index(origin)
    li = {k: i for i, k in enumerate(low)}
    ui = {k: i for i, k in enumerate(upp)}
    index = {t: k for k, t in enumerate(triples)}
    # product terms l_{t1}(c) * u_{t2}(c + t1) land on plane t1 + t2;
    # terms outside the band are dropped (the restriction to the pattern)
    pairs: dict[int, list] = {}
    for k1 in low:
        for k2 in upp:
            s = tuple(a + b for a, b in zip(triples[k1], triples[k2]))
            if s in index:
                pairs.setdefault(index[s], []).append(
                    (li[k1], ui[k2], triples[k1]))
    # one pad width per axis: the u stack is padded once a sweep and every
    # product term reads a view of it
    pads = tuple(max([1] + [abs(t[ax]) for t in triples]) for ax in range(3))

    def factor(dia: torch.Tensor):
        a = dia.reshape((len(triples),) + dims)
        one = torch.ones((), dtype=a.dtype, device=a.device)
        vmask = [_valid_mask(t, dims, a.device) for t in triples]
        d0 = a[k0]
        d0s = _pad3(torch.where(d0 != 0, d0, one), pads, 1.0)
        # init: l_ij = a_ij / a_jj ; u_ij = a_ij
        l = torch.stack([torch.where(vmask[k], a[k] / _at(d0s, pads,
                                                          triples[k], dims),
                                     0) for k in low])
        u = torch.stack([torch.where(vmask[k], a[k], 0) for k in upp])
        for _ in range(sweeps):
            ujj = u[ui[k0]]
            ujj = torch.where(ujj != 0, ujj, one)
            up = _pad3(u, pads)
            ujp = _pad3(ujj, pads, 1.0)
            newl, newu = [], []
            for k in range(len(triples)):
                p = torch.zeros(dims, dtype=a.dtype, device=a.device)
                for lpi, upi, t1 in pairs.get(k, ()):
                    p = p + l[lpi] * _at(up[upi], pads, t1, dims)
                if k in li:
                    # l_ij = (a_ij - (p_ij - l_ij u_jj)) / u_jj
                    ujs = _at(ujp, pads, triples[k], dims)
                    newl.append(torch.where(
                        vmask[k], (a[k] - p + l[li[k]] * ujs) / ujs, 0))
                else:
                    # u_ij = a_ij - p_ij  (p excludes k = i: L is strict)
                    newu.append(torch.where(vmask[k], a[k] - p, 0))
            l, u = torch.stack(newl), torch.stack(newu)
        ujj = u[ui[k0]]
        dinv = one / torch.where(ujj != 0, ujj, one)
        u_strict = torch.stack([u[ui[k]] for k in upp if k != k0])
        return l, u_strict, dinv.reshape(-1)

    l_offs = tuple(triples[k] for k in low)
    u_offs = tuple(triples[k] for k in upp if k != k0)
    return factor, l_offs, u_offs


def band_csr(A: ShardedMatrix):
    """The band pattern of DIA operator ``A`` as host CSR: every in-box
    position of every plane is an entry, explicit zeros kept (the pattern
    :func:`make_factorizer` factors on, for the host path to be held
    against it)."""
    import scipy.sparse as sp
    dims = tuple(A.dia_vals.shape[2:])
    planes = A.dia_vals[0].cpu().numpy()
    idx = np.arange(int(np.prod(dims))).reshape(dims)
    rows, cols, vals = [], [], []
    for k, t in enumerate(A.dia_offsets):
        sl = tuple(slice(max(0, -c), d - max(0, c)) for c, d in zip(t, dims))
        src = idx[sl].ravel()
        rows.append(src)
        cols.append(src + (t[0] * dims[1] + t[1]) * dims[2] + t[2])
        vals.append(planes[k][sl].ravel())
    n = idx.size
    M = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    M.sort_indices()
    return M


# ----------------------------------------------------------------------
# ELL Chow-Patel sweeps

def _sort_rows(vals: torch.Tensor, cols: torch.Tensor):
    """Each row's live slots (value not 0) sorted by column, dead slots
    last: ``(key, vals)`` with ``key`` the column, ``n`` (the row count)
    on a dead slot."""
    n = vals.shape[0]
    key = torch.where(vals != 0, cols.long(), n)
    key, order = torch.sort(key, dim=1, stable=True)
    return key, torch.gather(vals, 1, order)


def _product_table(key: torch.Tensor, nlow: torch.Tensor,
                   nup: torch.Tensor, KL: int, KU: int, budget: int):
    """One ``(src_l, src_u, dest)`` a lower slot t, flat int64 positions
    into the (R, K) sorted arrays, of every product term ``l[i, t] *
    u[k, j]`` of the masked product: t a lower slot of row i (column k), j
    an upper slot of row k whose column m is in row i's pattern at
    ``dest``.  Within one t no two terms share a destination (row k's
    columns are distinct), so a scatter of one t's terms has no collision,
    and the t's taken in turn sum each destination's terms in t's order on
    any device.  Rows in chunks whose candidates' arrays stay within
    ``budget`` bytes."""
    R, K = key.shape
    dev = key.device
    stride = R + 1
    gkey = (torch.arange(R, device=dev)[:, None] * stride + key).reshape(-1)
    chunk = max(1, budget // max(1, KL * KU * 64))
    t_ar = torch.arange(KL, device=dev)
    j_ar = torch.arange(KU, device=dev)
    out = []
    for r0 in range(0, R, chunk):
        rows = torch.arange(r0, min(R, r0 + chunk), device=dev)
        kcol = key[rows, :KL]                                # (c, KL)
        tlive = t_ar[None] < nlow[rows, None]
        k = torch.where(tlive, kcol, 0)
        jslot = nlow[k][..., None] + j_ar                    # (c, KL, KU)
        live = tlive[..., None] & (j_ar < nup[k][..., None])
        jslot = torch.where(live, jslot, 0)
        m = key[k[..., None], jslot]
        q = rows[:, None, None] * stride + m
        pos = torch.searchsorted(gkey, q.reshape(-1)).reshape(q.shape)
        pos = pos.clamp_max(R * K - 1)
        hit = live & (gkey[pos] == q)
        # the hits in (t, i, j) order, each lower slot's terms together
        t_i, i_i, j_i = hit.transpose(0, 1).nonzero(as_tuple=True)
        counts = torch.bincount(t_i, minlength=KL).tolist()
        out.append([torch.split(a, counts) for a in (
            rows[i_i] * K + t_i, k[i_i, t_i] * K + jslot[i_i, t_i, j_i],
            pos[i_i, t_i, j_i])])
    return [tuple(torch.cat([ch[a][t] for ch in out]) for a in range(3))
            for t in range(KL)]


def _left_pack(vals: torch.Tensor, key: torch.Tensor, mask: torch.Tensor,
               width: int):
    """The masked slots of each row moved left, in slot order, into
    (R, width) values and int32 columns; the rest value 0, column 0."""
    R = vals.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    row, slot = mask.nonzero(as_tuple=True)
    pv = torch.zeros((R, width), dtype=vals.dtype, device=vals.device)
    pc = torch.zeros((R, width), dtype=torch.int32, device=vals.device)
    pv[row, rank[row, slot]] = vals[row, slot]
    pc[row, rank[row, slot]] = key[row, slot].to(torch.int32)
    return pv, pc


def make_ell_factorizer(R: int, K: int, sweeps: int, KL: int, KU: int,
                        budget: int = ELL_BUDGET):
    """``factor(vals, cols) -> (Lv, Lc, Uv, Uc, dinv)`` for a padded-ELL
    (R, K) operator: strict-lower and strict-upper ELL factors (left-packed
    in column order, local columns, widths KL and KU) and 1 / u_ii after
    ``sweeps`` Chow-Patel sweeps, ``tpusolve``'s ``make_ell_factorizer``.
    No temporary exceeds about ``budget`` bytes."""
    KL = max(1, int(KL))
    KU = max(1, int(KU))

    def factor(vals: torch.Tensor, cols: torch.Tensor):
        key, v = _sort_rows(vals, cols)
        rows = torch.arange(R, device=vals.device)[:, None]
        live = key < R
        colsafe = torch.where(live, key, 0)
        lower = live & (key < rows)
        diagm = live & (key == rows)
        upper = live & (key >= rows)
        nlow = lower.sum(dim=1)
        nup = upper.sum(dim=1)
        table = _product_table(key, nlow, nup, KL, KU, budget)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        one = torch.ones((), dtype=v.dtype, device=v.device)
        d0 = torch.where(diagm, v, zero).sum(dim=1)
        d0s = torch.where(d0 != 0, d0, one)
        lv = torch.where(lower, v / d0s[colsafe], zero)
        uv = torch.where(upper, v, zero)
        step = max(1, budget // 24)
        for _ in range(sweeps):
            ujj = torch.where(diagm, uv, zero).sum(dim=1)
            ujjs = torch.where(ujj != 0, ujj, one)[colsafe]
            p = torch.zeros(R * K, dtype=v.dtype, device=v.device)
            lf, uf = lv.reshape(-1), uv.reshape(-1)
            for src_l, src_u, dest in table:
                for s0 in range(0, dest.numel(), step):
                    sl = slice(s0, s0 + step)
                    p.index_add_(0, dest[sl], lf[src_l[sl]] * uf[src_u[sl]])
            p = p.reshape(R, K)
            # i > j:  l_ij = (a_ij - (p_ij - l_ij u_jj)) / u_jj
            new_l = torch.where(lower, (v - p + lv * ujjs) / ujjs, zero)
            # i <= j: u_ij = a_ij - p_ij   (p excludes k = i: L is strict)
            uv = torch.where(upper, v - p, zero)
            lv = new_l
        ujj = torch.where(diagm, uv, zero).sum(dim=1)
        dinv = one / torch.where(ujj != 0, ujj, one)
        Lv, Lc = _left_pack(lv, colsafe, lower & (lv != 0), KL)
        Uv, Uc = _left_pack(uv, colsafe, upper & ~diagm & (uv != 0), KU)
        return Lv, Lc, Uv, Uc, dinv

    return factor


def ell_padded_parts(A: ShardedMatrix) -> tuple:
    """(vals, cols) (P, row_pad, K) of each part's diag block in the padded
    ELL form ``tpusolve`` stores (width: the largest count of entries a
    row; local columns).  An operator the port stores BDIA or BELL is first
    laid out ELL over the same parts, each row's entries in column order,
    as ``tpusolve``'s ``from_coo`` orders them."""
    if not A.uses_ell:
        # on a rank's slice: laid out over every part, its parts kept
        M = dist.gather_scipy(A.to_scipy())
        M.sort_indices()
        A = dist.place(ShardedMatrix.from_csr_host(
            M, device=dist.staging(A.device), dtype=numpy_dtype(A.dtype),
            row_offsets=A.all_row_offsets, col_offsets=A.all_col_offsets,
            allow_dia=False, allow_bdia=False, allow_bell=False))
    if not A.uses_ell_rowptr:
        return A.diag_vals, A.diag_cols
    from tpusolve_torch.kernels.ell import rowptr_to_padded
    parts = [rowptr_to_padded(A.ell_rowptr[p], A.ell_vals[p], A.ell_cols[p],
                              A.row_width) for p in range(A.nparts)]
    return (torch.stack([v for v, _ in parts]),
            torch.stack([c for _, c in parts]))


def _ell_padded(A: ShardedMatrix) -> tuple:
    """(vals, cols) (rows, K) of a one-part ``A``: :func:`ell_padded_parts`
    of its part."""
    vals, cols = ell_padded_parts(A)
    return vals[0], cols[0]


def ilu_widths(vals: torch.Tensor, cols: torch.Tensor) -> tuple:
    """(KL, KU): the largest counts of strict-lower and of upper (with the
    diagonal) entries a row of a padded ELL part has (``tpusolve``'s
    ``_ilu_widths``)."""
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
    live = vals != 0
    kl = int((live & (cols < rows)).sum(dim=1).max())
    ku = int((live & (cols >= rows)).sum(dim=1).max())
    return kl, ku


def from_device_ell_parts(shape, vals: torch.Tensor, cols: torch.Tensor,
                          diag: torch.Tensor | None = None,
                          nnz: int | None = None, row_offsets=None,
                          col_offsets=None,
                          global_cols: bool = False) -> ShardedMatrix:
    """An ELL ShardedMatrix of ``shape`` from padded values and columns on
    the device, (rows, K) for one part or (P, row_pad, K) for the parts of
    ``row_offsets`` and ``col_offsets`` (``tpusolve``'s
    ``ShardedMatrix.from_device_ell_parts`` and ``_ell_sharded``;
    zero-valued slots are padding), in the form K2's model prices cheaper
    (``with_ell_form``), recording ``tpusolve``'s layout, ELL.  Its main
    diagonal ``diag`` (1, as there, by default) and ``nnz`` (the count of
    nonzero values by default).

    ``cols`` are each part's local columns, and the operator has no offd
    block; or, with ``global_cols``, global columns (the multi-part device
    setups' P, R and coarse operators, whose ``col_offsets`` may differ
    from ``row_offsets``): the split runs on the device, each part's
    entries in the columns it owns staying in their slots as its diag
    block (the others' slots zeroed), and only the entries in other parts'
    columns, the seams, reach the host, where they make the offd block and
    halo plan (``matrix/sharded.py:_offd_fields``, ``tpusolve``'s
    ``_build_offd_and_halo``)."""
    nr, ncols = int(shape[0]), int(shape[1])
    if vals.dim() == 2:
        vals, cols = vals[None], cols[None]
        diag = None if diag is None else diag[None]
    P, R, K = vals.shape
    row_offsets = (0, nr) if row_offsets is None else row_offsets
    col_offsets = (0, ncols) if col_offsets is None else col_offsets
    if len(row_offsets) != P + 1:
        raise ValueError(f"{P} parts of values for {len(row_offsets) - 1} "
                         "row parts")
    offd = {}
    if nnz is None:
        nnz = int(torch.count_nonzero(vals))
    if global_cols:
        co = torch.tensor(np.asarray(col_offsets, np.int64),
                          device=vals.device)
        cols = cols.long()
        lo, hi = co[:-1].reshape(P, 1, 1), co[1:].reshape(P, 1, 1)
        own = (cols >= lo) & (cols < hi)
        seam = (vals != 0) & ~own
        cols = cols - lo
        part, row, slot = torch.nonzero(seam, as_tuple=True)
        sv = vals[part, row, slot].cpu().numpy()
        sg = (cols[part, row, slot] + lo.reshape(-1)[part]).cpu().numpy()
        part, row = part.cpu().numpy(), row.cpu().numpy()
        offd_parts = [(row[part == p], sg[part == p], sv[part == p])
                      for p in range(P)]
        if P > 1:
            offd = _offd_fields(offd_parts, R, col_offsets,
                                numpy_dtype(vals.dtype), vals.device)
            offd.pop("nnz")
        elif len(row):
            raise ValueError("one part owns every column")
        vals = torch.where(seam, 0, vals)
    vals = torch.where(vals != 0, vals, 0)
    cols = torch.where(vals != 0, cols, 0).to(torch.int32)
    if diag is None:
        diag = torch.ones((P, R), dtype=vals.dtype, device=vals.device)
    col_pad = max(1, int(np.diff(np.asarray(col_offsets)).max()))
    A = ShardedMatrix(
        diag_vals=vals.contiguous(), diag_cols=cols.contiguous(),
        bdia_vals=None, bdia_starts=None, bell_vals=None, bell_ids=None,
        diag=diag, shape=(nr, ncols),
        row_offsets=tuple(int(o) for o in row_offsets),
        col_offsets=tuple(int(o) for o in col_offsets), row_pad=R,
        col_pad=col_pad, nnz=int(nnz), tpusolve_layout="ell", **offd)
    return A.with_ell_form()


def _notes(kind: str, sweeps: int, A: ShardedMatrix) -> list:
    notes = [f"ILU(0) setup on device ({kind} Chow-Patel, {sweeps} sweeps; "
             "ref src/HypreSystem.cpp:352-361)"]
    if A.all_nparts > 1:
        notes.append("multi-part: block-Jacobi ILU (per-part diagonal "
                     "blocks, hypre parallel-ILU semantics)")
    if A.has_offd:
        notes.append("off-part couplings excluded from the factors "
                     "(block-Jacobi)")
    return notes


def ilu_setup_device(A: ShardedMatrix, cfg):
    """Factor each part's box-DIA diag block on its device (block-Jacobi
    across the parts, the offd blocks left out, as ``tpusolve``'s vmap over
    its parts); the factors are DIA operators (``from_dia_parts``), whose
    Jacobi sweeps run K1."""
    from tpusolve_torch.ilu.ilu import ILUPreconditioner
    sweeps = max(cfg.ilu_iterative_setup_max_iter, 1) * 5
    dims = tuple(A.dia_vals.shape[2:])
    factor, l_offs, u_offs = make_factorizer(A.dia_offsets, dims, sweeps)
    l_planes, u_planes, dinv = zip(*(factor(A.dia_vals[p])
                                     for p in range(A.nparts)))
    empty = np.zeros(0, np.int64)
    mk = lambda offs, planes: ShardedMatrix.from_dia_parts(
        A.shape, offs, torch.stack(planes),
        [(empty, empty, empty)] * A.nparts, device=A.device,
        dia_shape=A.dia_shape, row_offsets=A.row_offsets,
        col_offsets=A.col_offsets)
    return ILUPreconditioner(
        L=mk(l_offs, l_planes), U=mk(u_offs, u_planes),
        udiag_inv=torch.cat(dinv),
        lower_iters=max(cfg.ilu_lower_jacobi_iters, 1),
        upper_iters=max(cfg.ilu_upper_jacobi_iters, 1),
        notes=_notes("DIA", sweeps, A))


def ilu_setup_device_ell(A: ShardedMatrix, cfg, budget: int = ELL_BUDGET):
    """Factor each part's padded-ELL diag block on its device (block-Jacobi
    across the parts, the offd blocks left out, as ``tpusolve``'s vmap over
    its parts); the factors are ELL operators (:func:`from_device_ell_parts`),
    whose Jacobi sweeps run K2.  The parts are factored in one pass, as one
    block-diagonal operator: part p's rows follow part p - 1's and its
    columns are rebased by p * row_pad, so no row reaches another part and
    each row's sums are those of its part alone."""
    from tpusolve_torch.ilu.ilu import ILUPreconditioner
    sweeps = max(cfg.ilu_iterative_setup_max_iter, 1) * 5
    vals, cols = ell_padded_parts(A)
    P, R, K = vals.shape
    base = (torch.arange(P, device=vals.device, dtype=torch.int64)
            * R).reshape(P, 1, 1)
    vals = vals.reshape(P * R, K)
    cols = torch.where(vals != 0, (cols.long() + base).reshape(P * R, K), 0)
    KL, KU = ilu_widths(vals, cols)
    Lv, Lc, Uv, Uc, dinv = make_ell_factorizer(P * R, K, sweeps, KL, KU,
                                               budget)(vals, cols)

    def mk(v, c):
        v = v.reshape(P, R, -1)
        c = torch.where(v != 0, c.reshape(P, R, -1).long() - base, 0)
        return from_device_ell_parts(A.shape, v, c,
                                     row_offsets=A.row_offsets,
                                     col_offsets=A.col_offsets)

    return ILUPreconditioner(
        L=mk(Lv, Lc), U=mk(Uv, Uc), udiag_inv=dinv,
        lower_iters=max(cfg.ilu_lower_jacobi_iters, 1),
        upper_iters=max(cfg.ilu_upper_jacobi_iters, 1),
        notes=_notes("generic-ELL", sweeps, A))
