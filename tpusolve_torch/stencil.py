"""27-point 3-D Laplacian weak-scaling generator (the port of
``tpusolve/stencil.py``, its host branches).

Rebuild of the reference's HIP-only generator (``build_27pt_stencil``, ref:
src/HypreSystem.cpp:1323-1608, device kernels in
src/laplace_3d_weak_scaling.hpp:171-602): each part owns an
``nx x ny x nz`` box of the global ``(px*nx) x (py*ny) x (pz*nz)`` grid, the
process grid comes from prime factorization (ref: hpp:98-169), the matrix is
the 27-point Laplacian with diagonal 26 and off-diagonal -1, and the RHS is
``26 - (row_nnz - 1)`` (ref: hpp:321) so the exact solution is x = 1
everywhere.

Global row ordering is block-by-part with x-fastest lexicographic order
inside each box.  The port carries one part (``parts.require_single_part``),
so the process grid is (1, 1, 1) and the diag block is the whole operator.
Generation is vectorized NumPy on the host; the box DIA planes go to the
device once.  The DIA fast path hands ``ShardedMatrix.from_dia_parts`` the
(dz, dy, dx) triples of its planes, so nothing turns a flat offset back into
a triple.  On-device generation (``tpusolve``'s ``_dia_box_device*`` and
``with_lattice``) is not ported and raises.
"""

from __future__ import annotations

import numpy as np

from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import to_device_vector
from tpusolve_torch.parts import compute_3d_process_distribution

_DEVICE_ITEM = ("on-device stencil generation: not ported yet; see "
                "ROADMAP.md Queue 1 item 15")

_OFFSETS = np.array([(dx, dy, dz)
                     for dz in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)], dtype=np.int64)  # (27, 3)


def part_to_grid(part: int, pgrid: tuple[int, int, int]) -> tuple[int, int, int]:
    px, py, pz = pgrid
    return part % px, (part // px) % py, part // (px * py)


def _local_part(part, nx, ny, nz, pgrid, dtype):
    """Entries + rhs for one part: (local_rows, global_cols, vals), rhs."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    box = nx * ny * nz
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz

    i = np.arange(nx, dtype=np.int64)
    j = np.arange(ny, dtype=np.int64)
    k = np.arange(nz, dtype=np.int64)
    # x fastest: lrow = k*(nx*ny) + j*nx + i
    gx = (ipx * nx + i)[None, None, :]
    gy = (ipy * ny + j)[None, :, None]
    gz = (ipz * nz + k)[:, None, None]
    lrow = (k[:, None, None] * (ny * nx) + j[None, :, None] * nx
            + i[None, None, :]).reshape(-1)                    # (box,)

    ngx = gx + _OFFSETS[:, 0][:, None, None, None]             # (27,nz,ny,nx)
    ngy = gy + _OFFSETS[:, 1][:, None, None, None]
    ngz = gz + _OFFSETS[:, 2][:, None, None, None]
    valid = ((ngx >= 0) & (ngx < gx_max) & (ngy >= 0) & (ngy < gy_max)
             & (ngz >= 0) & (ngz < gz_max))
    full = (27, nz, ny, nx)
    ngx = np.broadcast_to(ngx, full).reshape(27, -1)
    ngy = np.broadcast_to(ngy, full).reshape(27, -1)
    ngz = np.broadcast_to(ngz, full).reshape(27, -1)
    valid = valid.reshape(27, -1)                              # (27, box)

    # owner part + local index of each neighbor -> global column
    opx, olx = np.divmod(ngx, nx)
    opy, oly = np.divmod(ngy, ny)
    opz, olz = np.divmod(ngz, nz)
    opart = opz * (px * py) + opy * px + opx
    ocol = opart * box + olz * (ny * nx) + oly * nx + olx

    is_center = (_OFFSETS == 0).all(axis=1)[:, None]           # (27, 1)
    vals = np.where(is_center, 26.0, -1.0)
    vals = np.broadcast_to(vals, (27, box))

    rows27 = np.broadcast_to(lrow[None, :], (27, box))
    sel = valid
    lr = rows27[sel]
    gc = ocol[sel]
    v = vals[sel].astype(dtype)

    n_neighbors = valid.sum(axis=0) - 1                        # exclude center
    rhs = (26.0 - n_neighbors).astype(dtype)
    # rhs is indexed by lrow order; reorder to local-row order
    rhs_ordered = np.empty(box, dtype)
    rhs_ordered[lrow] = rhs
    return (lr, gc, v), rhs_ordered


def _dia_box(nx, ny, nz, dtype):
    """DIA values of the *diag block* for one local box.

    A neighbor inside the local box is automatically inside the global
    domain, so the diag block is pure local-box geometry — identical for
    every part.  Returns (offsets (27,), dia_vals (box, 27))."""
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    dia = np.zeros((27, nz, ny, nx), dtype)
    offs = np.empty(27, np.int64)
    for k, (dx, dy, dz) in enumerate(_OFFSETS):
        offs[k] = dz * ny * nx + dy * nx + dx
        if dx == dy == dz == 0:
            dia[k] = 26.0
            continue
        mx = (ix + dx >= 0) & (ix + dx < nx)
        my = (iy + dy >= 0) & (iy + dy < ny)
        mz = (iz + dz >= 0) & (iz + dz < nz)
        dia[k] = np.where(
            mz[:, None, None] & my[None, :, None] & mx[None, None, :],
            dtype(-1.0), dtype(0.0))
    order = np.argsort(offs)
    return offs[order], dia[order].reshape(27, nx * ny * nz)


def _dia_box_triples(nx, ny, nz) -> tuple:
    """The (dz, dy, dx) triple of each plane :func:`_dia_box` returns, in its
    order (ascending flat offset, unique for nx, ny >= 3)."""
    offs = np.array([dz * ny * nx + dy * nx + dx for dx, dy, dz in _OFFSETS],
                    np.int64)
    return tuple((int(dz), int(dy), int(dx))
                 for dx, dy, dz in _OFFSETS[np.argsort(offs)])


def _local_offd_and_rhs(part, nx, ny, nz, pgrid, dtype):
    """Off-owner (ghost shell) entries + RHS for one part."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz
    box = nx * ny * nz
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    gx0, gy0, gz0 = ipx * nx, ipy * ny, ipz * nz

    count = np.zeros((nz, ny, nx), np.int8)
    olr, ogc = [], []
    for dx, dy, dz in _OFFSETS:
        if dx == dy == dz == 0:
            continue
        dom_x = (gx0 + ix + dx >= 0) & (gx0 + ix + dx < gx_max)
        dom_y = (gy0 + iy + dy >= 0) & (gy0 + iy + dy < gy_max)
        dom_z = (gz0 + iz + dz >= 0) & (gz0 + iz + dz < gz_max)
        in_dom = (dom_z[:, None, None] & dom_y[None, :, None]
                  & dom_x[None, None, :])
        count += in_dom
        box_x = (ix + dx >= 0) & (ix + dx < nx)
        box_y = (iy + dy >= 0) & (iy + dy < ny)
        box_z = (iz + dz >= 0) & (iz + dz < nz)
        in_box = (box_z[:, None, None] & box_y[None, :, None]
                  & box_x[None, None, :])
        crossing = in_dom & ~in_box
        kz, ky, kx = np.nonzero(crossing)
        if kx.size == 0:
            continue
        ngx = gx0 + kx + dx
        ngy = gy0 + ky + dy
        ngz = gz0 + kz + dz
        opx, olx = np.divmod(ngx, nx)
        opy, oly = np.divmod(ngy, ny)
        opz, olz = np.divmod(ngz, nz)
        opart = opz * (px * py) + opy * px + opx
        olr.append(kz * ny * nx + ky * nx + kx)
        ogc.append(opart * box + olz * (ny * nx) + oly * nx + olx)
    if olr:
        olr = np.concatenate(olr)
        ogc = np.concatenate(ogc)
    else:
        olr = np.zeros(0, np.int64)
        ogc = np.zeros(0, np.int64)
    ov = np.full(olr.shape, -1.0, dtype)
    rhs = (26.0 - count.reshape(-1)).astype(dtype)
    return (olr, ogc, ov), rhs


def laplace27(nx: int = 128, ny: int = 128, nz: int = 128, *, device,
              dtype=np.float64, pgrid: tuple[int, int, int] | None = None,
              with_host: bool = False, with_parts: bool = False,
              with_lattice: bool = False):
    """Build the 27-pt system of one part on ``device``.

    Returns ``(A, b, x_ref)``: the matrix, the padded RHS and the padded
    reference solution (all ones), as tensors on ``device``.
    ``with_host=True`` appends the host CSR (for a host preconditioner
    setup); ``with_parts=True`` appends the structured (dia dict, offd
    parts) payload instead, for ``structured_mg_setup_fast``.  The DIA fast
    path needs nx, ny >= 3; smaller boxes take the COO path (``tpusolve``:
    tiny boxes can alias DIA offsets).  ``with_lattice`` (the device setup's
    plane stacks) is not ported."""
    if with_lattice:
        raise NotImplementedError(_DEVICE_ITEM)
    nparts = 1
    if pgrid is None:
        pgrid = compute_3d_process_distribution(nparts)
    px, py, pz = pgrid
    if px * py * pz != nparts:
        raise ValueError(f"process grid {pgrid} != part count {nparts}")
    box = nx * ny * nz
    n = box * nparts

    parts = None
    if nx >= 3 and ny >= 3:
        # fast path: diag block = shared DIA geometry, offd = boundary shell
        offs, dia_one = _dia_box(nx, ny, nz, dtype)
        dia_vals = np.broadcast_to(dia_one[None], (nparts, 27, box))
        offd_parts, rhs_parts = [], []
        for part in range(nparts):
            offd, rhs = _local_offd_and_rhs(part, nx, ny, nz, pgrid, dtype)
            offd_parts.append(offd)
            rhs_parts.append(rhs)
        A = ShardedMatrix.from_dia_parts(
            (n, n), _dia_box_triples(nx, ny, nz), dia_vals, offd_parts,
            device=device, dtype=dtype, dia_shape=(nz, ny, nx))
        if with_parts:
            host_parts = (_dia_arrays_to_dict(offs, dia_one, (nz, ny, nx)),
                          offd_parts)
    else:
        # tiny boxes can alias DIA offsets; use the generic COO path
        parts, rhs_parts = [], []
        for part in range(nparts):
            p, rhs = _local_part(part, nx, ny, nz, pgrid, dtype)
            parts.append(p)
            rhs_parts.append(rhs)
        A = ShardedMatrix.from_local_parts((n, n), parts, device=device,
                                           dtype=dtype)
    rhs_global = np.concatenate(rhs_parts)
    b = to_device_vector(rhs_global, A.row_offsets, A.row_pad, device,
                         dtype=dtype)
    x_ref = to_device_vector(np.ones(n, dtype), A.row_offsets, A.row_pad,
                             device, dtype=dtype)
    if with_parts:
        if parts is not None:
            raise ValueError("with_parts requires the DIA fast path "
                             "(nx, ny >= 3)")
        return A, b, x_ref, host_parts
    if with_host:
        import scipy.sparse as sp
        if parts is None:
            # the DIA fast path's CSR in row-major order (tpusolve's numpy
            # fallback of its native dia_to_csr)
            dia_t = np.ascontiguousarray(dia_one.T)       # (box, 27)
            r_k, k_idx = np.nonzero(dia_t)                # row-major
            cols_one = (r_k + offs[k_idx]).astype(np.int32)
            vals_one = dia_t[r_k, k_idx].astype(np.float64)
            counts_one = np.count_nonzero(dia_t, axis=1)
            indptr = np.empty(n + 1, np.int64)
            indptr[0] = 0
            np.cumsum(counts_one, out=indptr[1:])
            A_host = sp.csr_matrix((vals_one, cols_one.astype(np.int64),
                                    indptr), shape=(n, n))
            A_host.has_sorted_indices = True   # offsets ascend per row
        else:
            rows_l, cols_l, vals_l = [], [], []
            for q, p in enumerate(parts):
                rows_l.append(p[0] + q * box)
                cols_l.append(p[1])
                # setup math (strength/interp/RAP) runs in f64 on the host
                # even when the device operators are f32
                vals_l.append(p[2].astype(np.float64))
            A_host = sp.csr_matrix(
                (np.concatenate(vals_l),
                 (np.concatenate(rows_l), np.concatenate(cols_l))),
                shape=(n, n))
        return A, b, x_ref, A_host
    return A, b, x_ref


def laplace27_scipy(nx, ny, nz, pgrid=(1, 1, 1)):
    """Host oracle: the same system as a scipy CSR + rhs (for tests)."""
    import scipy.sparse as sp
    nparts = int(np.prod(pgrid))
    rows, cols, vals, rhs_all = [], [], [], []
    box = nx * ny * nz
    for part in range(nparts):
        (lr, gc, v), rhs = _local_part(part, nx, ny, nz, pgrid, np.float64)
        rows.append(lr + part * box)
        cols.append(gc)
        vals.append(v)
        rhs_all.append(rhs)
    n = box * nparts
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return A, np.concatenate(rhs_all)


def _dia_arrays_to_dict(offs, dia_one, box):
    """(flat offsets, (27, R) values) -> {(dz,dy,dx): box array} views."""
    nz, ny, nx = box
    dia = {}
    for k, off in enumerate(offs):
        dz, r = divmod(int(off), ny * nx)
        if r > (ny * nx) // 2:
            dz, r = dz + 1, r - ny * nx
        dy, dx = divmod(r, nx)
        if dx > nx // 2:
            dy, dx = dy + 1, dx - nx
        # setup math (Galerkin RAP, smoother norms) runs in f64 regardless
        # of the device dtype
        dia[(dz, dy, dx)] = dia_one[k].reshape(box).astype(np.float64)
    return dia


def laplace27_host_parts(nparts: int, nx: int, ny: int, nz: int, *,
                         pgrid: tuple[int, int, int] | None = None,
                         dtype=np.float64):
    """Host-side structured payload for preconditioner setup.

    Returns ``(dia, offd)`` where ``dia`` maps offset tuples (dz, dy, dx) to
    box-shaped value arrays (identical for every part — the diag block is
    pure box geometry), and ``offd`` is the per-part list of
    (local_rows, global_cols, vals) boundary-shell entries.  Feed to
    ``structured_mg_setup_fast(..., host_parts=...)`` to run the whole setup
    in DIA algebra (no sparse matrices)."""
    if pgrid is None:
        pgrid = compute_3d_process_distribution(nparts)
    offs, dia_one = _dia_box(nx, ny, nz, dtype)
    dia = _dia_arrays_to_dict(offs, dia_one, (nz, ny, nx))
    offd = []
    for part in range(nparts):
        (olr, ogc, ov), _ = _local_offd_and_rhs(part, nx, ny, nz, pgrid,
                                                dtype)
        offd.append((olr, ogc, ov))
    return dia, offd
