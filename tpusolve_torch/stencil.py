"""27-point 3-D Laplacian weak-scaling generator (the port of
``tpusolve/stencil.py``).

Rebuild of the reference's HIP-only generator (``build_27pt_stencil``, ref:
src/HypreSystem.cpp:1323-1608, device kernels in
src/laplace_3d_weak_scaling.hpp:171-602): each part owns an
``nx x ny x nz`` box of the global ``(px*nx) x (py*ny) x (pz*nz)`` grid, the
process grid comes from prime factorization (ref: hpp:98-169), the matrix is
the 27-point Laplacian with diagonal 26 and off-diagonal -1, and the RHS is
``26 - (row_nnz - 1)`` (ref: hpp:321) so the exact solution is x = 1
everywhere.

Global row ordering is block-by-part with x-fastest lexicographic order
inside each box.  With ``nparts`` parts (stacked on one device) each part's
diag block is the box's planes and its offd block the couplings across its
boundary shell (:func:`_local_offd_and_rhs`), as ``tpusolve`` builds them
on its mesh (``tpusolve/stencil.py:385-420``).
The box DIA planes are generated either on the host (vectorized NumPy, then
copied to the device once) or on the device itself, by ``tpusolve``'s rule
(:func:`laplace27`'s ``on_device``): on one part :func:`_dia_box_device`,
on N parts :func:`_dia_box_device_parts` (masks from ``arange``
comparisons, no host table of a box's size; the host builds only the
boundary shells); both branches give the same bits.  The DIA fast path
hands ``ShardedMatrix.from_dia_parts`` the (dz, dy, dx) triples of its
planes, so nothing turns a flat offset back into a triple.  With
``with_lattice`` the generator also returns each part's full-lattice planes
(masked by the global domain, seam couplings included), the operand of the
multi-part lattice AMG setup (``amg/device_setup_sharded.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import (
    numpy_dtype, to_device_vector, torch_dtype)
from tpusolve_torch.parts import compute_3d_process_distribution

# tpusolve generates the planes on the device from a plane stack of this
# many bytes (tpusolve/stencil.py:333-338)
DEVICE_MIN_BYTES = 128 << 20

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


def _dia_box_device(nx, ny, nz, dtype, device):
    """On-device twin of :func:`_dia_box` and the one-part RHS
    (``tpusolve``'s ``_dia_box_device``): ``(offsets, gen)``, where
    ``gen()`` returns the (27, box) planes and the (box,) RHS as tensors on
    ``device``.  Each plane's mask comes from ``arange`` comparisons, in the
    planes' sorted order, with the values -1, 26 and 0 (exact in any float),
    so the planes are :func:`_dia_box`'s bit for bit; the RHS is ``26 -
    count`` (one part: a neighbour in the box is one in the domain).  No
    host table of the box's size is built."""
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)
    tdt = torch_dtype(numpy_dtype(dtype))

    def gen():
        ix = torch.arange(nx, device=device)
        iy = torch.arange(ny, device=device)
        iz = torch.arange(nz, device=device)
        dia = torch.empty((27, nz, ny, nx), dtype=tdt, device=device)
        count = torch.zeros((nz, ny, nx), dtype=tdt, device=device)
        for k, kk in enumerate(order):
            dx, dy, dz = (int(c) for c in _OFFSETS[kk])
            if dx == dy == dz == 0:
                dia[k] = 26.0
                continue
            m = (((iz + dz >= 0) & (iz + dz < nz))[:, None, None]
                 & ((iy + dy >= 0) & (iy + dy < ny))[None, :, None]
                 & ((ix + dx >= 0) & (ix + dx < nx))[None, None, :])
            dia[k].zero_()
            dia[k].masked_fill_(m, -1.0)
            count += m
        rhs = (26.0 - count).reshape(-1)
        return dia.reshape(27, nx * ny * nz), rhs

    return offs[order], gen


def _dia_box_lattice(part, nx, ny, nz, pgrid, dtype):
    """Full-lattice DIA planes for one part: like ``_dia_box`` but masked by
    the GLOBAL domain, so couplings crossing part seams are included (the
    entries the box-consistent diag block zeroes and stores as offd).  This
    is the operator view the sharded device setup consumes
    (amg/device_setup_sharded.py): every part sees its true lattice rows
    and neighbor data arrives via halo exchange."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    gx0, gy0, gz0 = ipx * nx, ipy * ny, ipz * nz
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)
    planes = np.zeros((27, nz, ny, nx), dtype)
    for k, kk in enumerate(order):
        dx, dy, dz = _OFFSETS[kk]
        if dx == dy == dz == 0:
            planes[k] = 26.0
            continue
        m = (((gz0 + iz + dz >= 0) & (gz0 + iz + dz < gz_max))[:, None, None]
             & ((gy0 + iy + dy >= 0)
                & (gy0 + iy + dy < gy_max))[None, :, None]
             & ((gx0 + ix + dx >= 0)
                & (gx0 + ix + dx < gx_max))[None, None, :])
        planes[k][m] = -1.0
    return offs[order], planes


def _dia_box_device_parts(nx, ny, nz, pgrid, dtype, device, parts=None):
    """On-device generation for N parts (``tpusolve``'s
    ``_dia_box_device_sharded``): ``(offsets, lat, dia, rhs)``, the flat
    offsets in the planes' order and three tensors on ``device``: the
    full-lattice stack (P, 27, nz, ny, nx) (global-domain masks, as
    :func:`_dia_box_lattice`), the box DIA stack of the same shape (box
    masks, as :func:`_dia_box`) and the RHS (P, box), b = A 1 as the row
    sums of the lattice stack.  The host does O(P) work: each part's grid
    origin.  Values -1, 26 and 0 and integer row sums are exact in any
    float, so the stacks are the host's bit for bit.  ``parts`` = (lo, hi)
    generates parts ``[lo, hi)`` of the grid alone (a rank's), each as the
    whole grid's run gives it."""
    px, py, pz = pgrid
    lo, hi = (0, px * py * pz) if parts is None else parts
    nparts = hi - lo
    gmax = (pz * nz, py * ny, px * nx)
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)
    tdt = torch_dtype(numpy_dtype(dtype))
    origin = torch.tensor([[g * d for g, d in zip(part_to_grid(p, pgrid)[::-1],
                                                  (nz, ny, nx))]
                           for p in range(lo, hi)], device=device)
    ar = [torch.arange(d, device=device) for d in (nz, ny, nx)]
    shapes = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    lat = torch.empty((nparts, 27, nz, ny, nx), dtype=tdt, device=device)
    dia = torch.empty_like(lat)
    for k, kk in enumerate(order):
        dx, dy, dz = (int(c) for c in _OFFSETS[kk])
        if dx == dy == dz == 0:
            lat[:, k] = 26.0
            dia[:, k] = 26.0
            continue
        gm = torch.ones((nparts, 1, 1, 1), dtype=torch.bool, device=device)
        bm = torch.ones((1, 1, 1), dtype=torch.bool, device=device)
        for a, (c, d) in enumerate(zip((dz, dy, dx), (nz, ny, nx))):
            loc = ar[a] + c
            g = origin[:, a].reshape(-1, 1, 1, 1) + loc.reshape(shapes[a])
            gm = gm & (g >= 0) & (g < gmax[a])
            bm = bm & ((loc >= 0) & (loc < d)).reshape(shapes[a])
        lat[:, k] = torch.where(gm, -1.0, 0.0).to(tdt)
        dia[:, k] = torch.where(bm, -1.0, 0.0).to(tdt)
    rhs = lat.sum(dim=1).reshape(nparts, -1)
    return offs[order], lat, dia, rhs


def generates_on_device(nx, ny, nz, dtype, device, with_host=False,
                        with_parts=False) -> bool:
    """``tpusolve``'s auto rule for on-device generation
    (``tpusolve/stencil.py:333-338``): nx, ny >= 3, no host payload, a
    27-plane stack of at least ``DEVICE_MIN_BYTES`` and a device that is not
    the CPU."""
    box = nx * ny * nz
    return (nx >= 3 and ny >= 3 and not with_host and not with_parts
            and box * 27 * np.dtype(dtype).itemsize >= DEVICE_MIN_BYTES
            and torch.device(device).type != "cpu")


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
              on_device: bool | None = None, with_lattice: bool = False,
              nparts: int = 1, rank_parts: tuple | None = None):
    """Build the 27-pt system of ``nparts`` parts (``tpusolve``'s mesh
    size), each an nx x ny x nz box, on ``device``.

    Returns ``(A, b, x_ref)``: the matrix, the padded RHS and the padded
    reference solution (all ones), as tensors on ``device``.
    ``with_host=True`` appends the host CSR (for a host preconditioner
    setup); ``with_parts=True`` appends the structured (dia dict, offd
    parts) payload instead, for ``structured_mg_setup_fast``.  The DIA fast
    path needs nx, ny >= 3; smaller boxes take the COO path (``tpusolve``:
    tiny boxes can alias DIA offsets).

    ``on_device`` (``tpusolve``'s ``device``) generates the planes and the
    RHS on ``device`` (:func:`_dia_box_device`); None decides by
    :func:`generates_on_device`, and True with a host payload or a box under
    3 x 3 raises ``ValueError``.  ``with_lattice=True`` appends
    ``tpusolve``'s lattice dict (``stack`` (P, 27, nz, ny, nx) on
    ``device``, each part's full-lattice planes; ``offsets``, the flat
    offsets of the planes; ``pgrid``; ``dims``) on either branch; the
    planes are in the order of ``A.dia_offsets``, whose triples the setup
    reads.

    ``rank_parts`` = (lo, hi, world) generates a rank's share (``dist.py``:
    parts ``[lo, hi)`` of ``nparts`` over ``world`` ranks), as ``tpusolve``
    puts only its devices' parts on them (``tpusolve/stencil.py:395-420``,
    ``put_sharded``): ``A`` is the rank's slice
    (``ShardedMatrix.from_dia_parts``'s ``parts``, the whole operator's
    ``rank_slice`` field for field), ``b`` and ``x_ref`` its parts' padded
    rows, the lattice stack its parts' planes and the host CSR its rows (the
    global shape); the boundary shells of every part are built on the host
    (O(surface)), as there, so each rank derives the whole halo plan, and
    the structured payload holds them all.  It needs the DIA fast path."""
    if pgrid is None:
        pgrid = compute_3d_process_distribution(nparts)
    px, py, pz = pgrid
    if px * py * pz != nparts:
        raise ValueError(f"process grid {pgrid} != part count {nparts}")
    box = nx * ny * nz
    n = box * nparts
    lo, hi = (0, nparts) if rank_parts is None else rank_parts[:2]
    own = range(lo, hi)
    if rank_parts is not None and (nx < 3 or ny < 3):
        raise ValueError("a rank's parts need the DIA fast path (nx, ny "
                         ">= 3)")
    # the analytic diag-block nnz: each axis shift c in {-1, 0, 1} keeps
    # n_d - |c| planes, so prod_d (3 n_d - 2)
    dia_nnz = nparts * (3 * nz - 2) * (3 * ny - 2) * (3 * nx - 2)

    if on_device is None:
        on_device = generates_on_device(nx, ny, nz, dtype, device,
                                        with_host, with_parts)
    if on_device:
        if nx < 3 or ny < 3 or with_host or with_parts:
            raise ValueError("device stencil generation requires nx/ny >= 3 "
                             "and no host payloads")
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, dtype))
        if nparts == 1:
            offs, gen = _dia_box_device(nx, ny, nz, dtype, device)
            dia_dev, rhs = gen()
            dia_dev = dia_dev[None]
            lat = dia_dev      # no seams on one part: the lattice is the box
            offd_parts = [empty]
        else:
            offs, lat, dia_dev, rhs = _dia_box_device_parts(
                nx, ny, nz, pgrid, dtype, device, parts=(lo, hi))
            rhs = rhs.reshape(-1)
            # the boundary shells stay a host build: O(surface) data
            offd_parts = [_local_offd_and_rhs(p, nx, ny, nz, pgrid, dtype)[0]
                          for p in range(nparts)]
        # the planes go in as a view, with no second copy of the stack
        A = ShardedMatrix.from_dia_parts(
            (n, n), _dia_box_triples(nx, ny, nz), dia_dev, offd_parts,
            device=device, dtype=dtype, dia_shape=(nz, ny, nx),
            dia_nnz=dia_nnz, parts=rank_parts)
        x_ref = torch.ones(rhs.numel(), dtype=rhs.dtype, device=rhs.device)
        if with_lattice:
            return A, rhs, x_ref, dict(
                stack=A.dia_vals if nparts == 1 else lat, offsets=offs,
                pgrid=pgrid, dims=(nz, ny, nx))
        return A, rhs, x_ref

    parts = None
    if nx >= 3 and ny >= 3:
        # fast path: diag block = shared DIA geometry, offd = boundary shell
        offs, dia_one = _dia_box(nx, ny, nz, dtype)
        dia_vals = np.broadcast_to(dia_one[None], (len(own), 27, box))
        offd_parts, rhs_parts = [], []
        for part in range(nparts):
            offd, rhs = _local_offd_and_rhs(part, nx, ny, nz, pgrid, dtype)
            offd_parts.append(offd)
            if part in own:
                rhs_parts.append(rhs)
        A = ShardedMatrix.from_dia_parts(
            (n, n), _dia_box_triples(nx, ny, nz), dia_vals, offd_parts,
            device=device, dtype=dtype, dia_shape=(nz, ny, nx),
            dia_nnz=dia_nnz, parts=rank_parts)
        if with_parts:
            host_parts = (_dia_arrays_to_dict(offs, dia_one, (nz, ny, nx)),
                          offd_parts)
        if with_lattice:
            # full-lattice plane stacks (seam couplings included), one a part
            stacks = np.stack([
                _dia_box_lattice(p, nx, ny, nz, pgrid, dtype)[1]
                for p in own])
            lattice = dict(
                stack=torch.from_numpy(stacks).to(device), offsets=offs,
                pgrid=pgrid, dims=(nz, ny, nx))
    else:
        # tiny boxes can alias DIA offsets; use the generic COO path
        parts, rhs_parts = [], []
        for part in range(nparts):
            p, rhs = _local_part(part, nx, ny, nz, pgrid, dtype)
            parts.append(p)
            rhs_parts.append(rhs)
        A = ShardedMatrix.from_local_parts((n, n), parts, device=device,
                                           dtype=dtype)
    # a rank's vectors are its parts' rows, global indices (lo * box ...)
    rhs_global = np.zeros(hi * box, dtype)
    rhs_global[lo * box:] = np.concatenate(rhs_parts)
    b = to_device_vector(rhs_global, A.row_offsets, A.row_pad, device,
                         dtype=dtype)
    x_ref = to_device_vector(np.ones(hi * box, dtype), A.row_offsets,
                             A.row_pad, device, dtype=dtype)
    if with_lattice:
        if parts is not None:
            raise ValueError("with_lattice requires the DIA fast path "
                             "(nx, ny >= 3)")
        return A, b, x_ref, lattice
    if with_parts:
        if parts is not None:
            raise ValueError("with_parts requires the DIA fast path "
                             "(nx, ny >= 3)")
        return A, b, x_ref, host_parts
    if with_host:
        import scipy.sparse as sp
        if parts is None:
            # the DIA fast path's CSR in row-major order, in one native
            # pass (no 2x-nnz index temporaries), as tpusolve builds it:
            # one box's, tiled over the parts (a rank's: its own, at their
            # global rows), plus the boundary shells
            from tpusolve_torch.amg import spk
            A_host = spk.dia_to_csr(np.ascontiguousarray(dia_one.T), offs)
            if nparts > 1 and rank_parts is None:
                A_host = sp.block_diag([A_host] * nparts, format="csr")
                rows_l = [p * box + np.asarray(o[0])
                          for p, o in enumerate(offd_parts)]
                A_host = (A_host + sp.csr_matrix(
                    (np.concatenate([np.asarray(o[2], np.float64)
                                     for o in offd_parts]),
                     (np.concatenate(rows_l),
                      np.concatenate([o[1] for o in offd_parts]))),
                    shape=(n, n))).tocsr()
                A_host.sort_indices()
            elif nparts > 1:
                # a rank's rows: its boxes at their global rows, and its
                # parts' shells
                blk = sp.block_diag([A_host] * len(own), format="coo")
                A_host = sp.csr_matrix((
                    np.concatenate([blk.data] + [
                        np.asarray(offd_parts[p][2], np.float64)
                        for p in own]),
                    (np.concatenate([blk.row + lo * box] + [
                        p * box + np.asarray(offd_parts[p][0])
                        for p in own]),
                     np.concatenate([blk.col + lo * box] + [
                         np.asarray(offd_parts[p][1]) for p in own]))),
                    shape=(n, n))
                A_host.sort_indices()
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


def dia_to_csr_plain(dia_t: np.ndarray, offs) -> "sp.csr_matrix":
    """The CSR of a (rows, ndiag) DIA-value table with diagonal offsets
    ``offs`` in numpy (``tpusolve``'s fallback of its native
    ``dia_to_csr``): the plain version of ``amg.spk.dia_to_csr``."""
    import scipy.sparse as sp
    dia_t = np.ascontiguousarray(dia_t, np.float32)
    n = dia_t.shape[0]
    r_k, k_idx = np.nonzero(dia_t)                # row-major
    cols = r_k + np.asarray(offs, np.int64)[k_idx]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.count_nonzero(dia_t, axis=1), out=indptr[1:])
    out = sp.csr_matrix((dia_t[r_k, k_idx].astype(np.float64), cols, indptr),
                        shape=(n, n))
    out.has_sorted_indices = True   # offsets ascend per row
    return out
