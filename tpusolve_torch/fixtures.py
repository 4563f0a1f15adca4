"""Nalu-wind-shaped fixtures for gates 3 and 4 (the port of
``tools/gatefix.py``: ``make_system``, ``write_pressure_mm``,
``write_momentum_ij``, ``GATE3_YAML``, ``GATE4_YAML`` and
``GATE4_YAML_3COMP``), so a machine without JAX can write them.

The reference loads its pressure and momentum systems from MatrixMarket and
HYPRE-IJ dumps of nalu-wind runs (readers: src/HypreSystem.cpp:1613-1969,
1021-1318): 27-pt finite-volume operators on unstructured node numberings,
banded after reordering and scattered as stored.

* pressure (gate 3): an SPD jittered-coefficient 27-pt Laplacian under a
  random node permutation, as MatrixMarket files; GMRES + BoomerAMG;
* momentum (gate 4): the same graph with a first-order upwind convection
  term (non-symmetric, diagonally dominant), as HYPRE-IJ files; BiCGSTAB +
  ILU, precision mixed.

Both carry ``b = A @ 1`` so the golden check (``x_ref = 1``) applies.  The
writers write the same files as ``tools/gatefix.py`` for the same arguments.

    python -m tpusolve_torch.fixtures OUTDIR [SIDE] [GATE]

writes the fixture of gate GATE (3 or 4, default 4; 4c for gate 4's three
components) at SIDE^3 (default 48) and its YAML, and prints the YAML's
path.  ``STENCIL_ILU_YAML`` and
``ILU_OPTIONS`` are the templates of the ILU paths beside them,
``WEAKSCALE_YAML`` the weak-scaling example's text at any box and
``WEAKSCALE_BF16_YAML`` the same with the bfloat16 smoother twin
(``smoother_dtype: bfloat16``).  :func:`write_gate4_3comp` writes gate 4's
three momentum components (x, y and z) against one matrix, for the
segregated or the coupled (``segregated_solve: false``) solve.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from tpusolve_torch.formats import ij, mmio
from tpusolve_torch.parts import row_decomposition


def _box_27pt_graph(nx: int, ny: int, nz: int):
    """COO pattern of the 27-pt stencil on an nx*ny*nz box (int64)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, kinds = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                      & (jz >= 0) & (jz < nz))
                rows.append(idx[ok])
                cols.append((jx + nx * (jy + ny * jz))[ok])
                kinds.append(np.full(int(ok.sum()), dx, np.int8))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(kinds), n)


def make_system(nx: int = 64, ny: int = 64, nz: int = 64, *,
                seed: int = 7, nonsym: float = 0.0, permute: bool = True):
    """(rows, cols, vals, b, n) with b = A @ 1 and x_ref = 1.

    ``nonsym > 0`` adds an upwind convection skew of that relative
    magnitude on the +/-x couplings (momentum-equation shape)."""
    rows, cols, dxk, n = _box_27pt_graph(nx, ny, nz)
    rng = np.random.default_rng(seed)
    off = rows != cols
    # jittered FV coefficients in [-1.2, -0.8], keyed on the undirected
    # edge so the base operator is symmetric
    ekey = (np.minimum(rows, cols) * np.int64(n)
            + np.maximum(rows, cols)).astype(np.uint64)
    ekey = (ekey ^ np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    ekey ^= ekey >> np.uint64(31)
    ekey *= np.uint64(0xBF58476D1CE4E5B9)
    u = (ekey >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    vals = np.where(off, -(1.0 + 0.4 * (u - 0.5)), 0.0)
    if nonsym:
        # upwind convection along +x: strengthens the -x coupling,
        # weakens +x (row-sum dominance kept by the diagonal below)
        vals = vals * (1.0 + nonsym * dxk)
    # diagonal = |row sum of off-diag| * (1 + eps): strictly dominant
    dsum = np.zeros(n)
    np.add.at(dsum, rows, -vals)
    dom = 1.0 + 0.02 * rng.random(n)
    diag_rows = rows[~off]
    vals[~off] = (dsum * dom)[diag_rows]
    if permute:
        p = rng.permutation(n).astype(np.int64)
        rows, cols = p[rows], p[cols]
    b = np.zeros(n)
    np.add.at(b, rows, vals)     # b = A @ ones
    return rows, cols, vals, b, n


def write_pressure_mm(dirpath: str, nx: int = 64, ny: int = 64,
                      nz: int = 64, seed: int = 7):
    """Gate-3 pressure fixture as MatrixMarket files; returns (matrix path,
    rhs path, solution path, n)."""
    os.makedirs(dirpath, exist_ok=True)
    rows, cols, vals, b, n = make_system(nx, ny, nz, seed=seed)
    mpath = os.path.join(dirpath, "pressure.mm")
    rpath = os.path.join(dirpath, "pressure_rhs.mm")
    spath = os.path.join(dirpath, "pressure_sln.mm")
    mmio.write_matrix(mpath, rows, cols, vals, (n, n),
                      comment="gate-3 pressure fixture (tools/gatefix.py)")
    mmio.write_vector(rpath, b)
    mmio.write_vector(spath, np.ones(n))
    return mpath, rpath, spath, n


def write_momentum_ij(dirpath: str, nx: int = 48, ny: int = 48,
                      nz: int = 48, seed: int = 11, nfiles: int = 2,
                      ncomp: int = 1):
    """Gate-4 momentum fixture as HYPRE-IJ multi-file dumps; returns
    (matrix prefix, rhs prefix, solution prefix, n).

    ``ncomp=3`` writes per-component rhs/sln files (x/y/z momentum — the
    reference's segregated multi-RHS path, src/HypreSystem.cpp:1636-1645):
    component k solves against a distinct smooth reference field; the rhs
    and solution prefixes are then lists, one a component."""
    import scipy.sparse as sp
    os.makedirs(dirpath, exist_ok=True)
    rows, cols, vals, b, n = make_system(nx, ny, nz, seed=seed,
                                         nonsym=0.35)
    offsets = row_decomposition(n, nfiles)
    mprefix = os.path.join(dirpath, "momentum.IJ.mat")
    order = np.argsort(rows, kind="stable")
    ij.write_matrix(mprefix, rows[order], cols[order], vals[order],
                    offsets, ncols=n)
    if ncomp == 1:
        rprefix = os.path.join(dirpath, "momentum_rhs.IJ.vec")
        sprefix = os.path.join(dirpath, "momentum_sln.IJ.vec")
        ij.write_vector(rprefix, b, offsets)
        ij.write_vector(sprefix, np.ones(n), offsets)
        return mprefix, rprefix, sprefix, n
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    rpres, spres = [], []
    idx = np.arange(n)
    for k in range(ncomp):
        # distinct smooth reference per component (constant + low-freq)
        xk = 1.0 + 0.25 * np.sin(2 * np.pi * (k + 1) * idx / n)
        rp = os.path.join(dirpath, f"momentum_rhs{k}.IJ.vec")
        sps = os.path.join(dirpath, f"momentum_sln{k}.IJ.vec")
        ij.write_vector(rp, A @ xk, offsets)
        ij.write_vector(sps, xk, offsets)
        rpres.append(rp)
        spres.append(sps)
    return mprefix, rpres, spres, n


GATE3_YAML = """\
# gate 3: file-loaded pressure system, GMRES + BoomerAMG (BASELINE.json
# config 3; reference readers src/HypreSystem.cpp:1613-1969)
linear_system:
  type: matrix_market
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
solver_settings:
  method: gmres
  preconditioner: boomeramg
  tolerance: 1.0e-8
  max_iterations: 200
  kspace: 20
  matrix_ordering: rcm
boomeramg_settings:
  coarsen_type: 8
  interp_type: 6
  strong_threshold: 0.25
  relax_type: 18
  max_levels: 20
"""

GATE4_YAML = """\
# gate 4: file-loaded momentum system, BiCGSTAB + ILU, mixed precision
# (BASELINE.json config 4; reference readers src/HypreSystem.cpp:1021-1318)
linear_system:
  type: hypre_ij
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
  num_partitions: {nfiles}
solver_settings:
  method: bicg
  preconditioner: ilu
  tolerance: 1.0e-8
  max_iterations: 500
  precision: mixed
  matrix_ordering: rcm
ilu_preconditioner_settings:
  ilu_type: 0
  ilu_fill_level: 0
  ilu_lower_jacobi_iters: 5
  ilu_upper_jacobi_iters: 5
"""


STENCIL_ILU_YAML = """\
# the generated 27-point stencil (hypre-mini-app's weak-scaling generator,
# examples/stencil_pcg_amg.yaml) under BiCGSTAB + ILU(0) in double: from
# 65,536 rows ILU(0) is factored on the device over the whole DIA band
# (tpusolve/ilu/device_setup.py:402)
linear_system:
  type: build_27pt_stencil
  nx: {side}
  ny: {side}
  nz: {side}
  rtol: 1.0e-5
  atol: 1.0e-6
solver_settings:
  method: bicgstab
  preconditioner: ilu
  tolerance: 1.0e-8
  max_iterations: 500
  precision: double
ilu_preconditioner_settings:
  ilu_type: 0
  ilu_fill_level: 0
  ilu_lower_jacobi_iters: 5
  ilu_upper_jacobi_iters: 5
"""

GATE4_YAML_3COMP = """\
# gate 4 (3-component): momentum x/y/z as segregated multi-RHS solves
# against one IJ matrix (ref: src/HypreSystem.cpp:1636-1645)
linear_system:
  type: hypre_ij
  matrix_file: {mat}
  num_components: 3
  segregated_solve: yes
  rhs_file0: {rhs0}
  rhs_file1: {rhs1}
  rhs_file2: {rhs2}
  sln_file0: {sln0}
  sln_file1: {sln1}
  sln_file2: {sln2}
  num_partitions: {nfiles}
solver_settings:
  method: bicg
  preconditioner: ilu
  tolerance: 1.0e-8
  max_iterations: 500
  precision: mixed
ilu_preconditioner_settings:
  ilu_type: 0
  ilu_fill_level: 0
  ilu_lower_jacobi_iters: 5
  ilu_upper_jacobi_iters: 5
"""

WEAKSCALE_YAML = """\
# Weak scaling with the SHARDED DEVICE AMG SETUP
# (amg/device_setup_sharded.py): one 27-pt box per chip, PCG + BoomerAMG;
# the fine level's strength/PMIS/interp/RAP run on the device mesh itself
# with ppermute halo exchanges (the analog of the reference's on-device
# distributed BoomerAMGSetup, src/HypreSystem.cpp:692).
linear_system:
  type: build_27pt_stencil
  nx: {side}
  ny: {side}
  nz: {side}
  rtol: 1.0e-4
  atol: 1.0e-5
solver_settings:
  method: cg
  preconditioner: boomeramg
  tolerance: 1.0e-6
  max_iterations: 200
  precision: single
boomeramg_settings:
  coarsen_type: 8           # PMIS
  interp_type: 0            # classical-modified
  strong_threshold: 0.57
  relax_type: 18            # l1-Jacobi
  max_coarse_size: 512
  max_levels: 8
"""

# the weak-scaling example with the bfloat16 smoother twin, its one key
# added
WEAKSCALE_BF16_YAML = WEAKSCALE_YAML + "  smoother_dtype: bfloat16\n"

# the host ILU options, each on its own (ilu_preconditioner_settings keys):
# ILU(1), ILUT (ILU(0) with a drop and a row cap that both bite) and RCM
# local reordering
ILU_OPTIONS = {
    "fill1": {"ilu_fill_level": 1},
    "ilut": {"ilu_type": 1, "ilu_drop_threshold": 0.02,
             "ilu_max_nnz_per_row": 10},
    "rcm": {"ilu_local_reordering": 1},
}


def with_settings(text: str, **sections) -> str:
    """A YAML text with keys set: ``sections`` maps a top-level section
    (``linear_system``, ``solver_settings``, ``boomeramg_settings``,
    ``ilu_preconditioner_settings``) to the keys and values to set in it.
    Without any, the text unchanged."""
    if not sections:
        return text
    import yaml
    doc = yaml.safe_load(text)
    for name, keys in sections.items():
        doc.setdefault(name, {}).update(keys)
    return yaml.safe_dump(doc, sort_keys=False)


def _write_yaml(dirpath: str, name: str, text: str) -> str:
    path = os.path.join(dirpath, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def write_gate4(dirpath: str, side: int, nfiles: int = 2,
                precision: str = "mixed", **sections) -> str:
    """Write the gate-4 fixture at side^3 and its YAML (its settings changed
    as :func:`with_settings` takes them); returns the YAML path."""
    m, r, s, _ = write_momentum_ij(dirpath, side, side, side, nfiles=nfiles)
    text = GATE4_YAML.format(mat=m, rhs=r, sln=s, nfiles=nfiles)
    if precision != "mixed":
        text = text.replace("precision: mixed", f"precision: {precision}")
    return _write_yaml(dirpath, "gate4.yaml", with_settings(text, **sections))


def write_gate4_3comp(dirpath: str, side: int, nfiles: int = 2,
                      **sections) -> str:
    """Write gate 4's three-component fixture at side^3 (one matrix, a
    right-hand side and a solution a component) and its YAML,
    ``GATE4_YAML_3COMP`` with its settings changed as
    :func:`with_settings` takes them (``linear_system:
    {"segregated_solve": False}`` for the coupled solve); returns the YAML
    path."""
    m, r, s, _ = write_momentum_ij(dirpath, side, side, side, nfiles=nfiles,
                                   ncomp=3)
    text = GATE4_YAML_3COMP.format(mat=m, rhs0=r[0], rhs1=r[1], rhs2=r[2],
                                   sln0=s[0], sln1=s[1], sln2=s[2],
                                   nfiles=nfiles)
    return _write_yaml(dirpath, "gate4_3comp.yaml",
                       with_settings(text, **sections))


def write_gate3(dirpath: str, side: int, **sections) -> str:
    """Write the gate-3 fixture at side^3 and its YAML (its settings changed
    as :func:`with_settings` takes them); returns the YAML path."""
    m, r, s, _ = write_pressure_mm(dirpath, side, side, side)
    return _write_yaml(dirpath, "gate3.yaml", with_settings(
        GATE3_YAML.format(mat=m, rhs=r, sln=s), **sections))


def write_weakscale(dirpath: str, side: int, bf16: bool = False) -> str:
    """Write ``examples/weakscale_pcg_boomeramg_devsetup.yaml`` with its box
    at side^3 (no data files: the YAML generates the system), with the
    bfloat16 smoother twin when ``bf16`` (``WEAKSCALE_BF16_YAML``); returns
    its path."""
    os.makedirs(dirpath, exist_ok=True)
    text = WEAKSCALE_BF16_YAML if bf16 else WEAKSCALE_YAML
    return _write_yaml(dirpath, "weakscale_bf16.yaml" if bf16
                       else "weakscale.yaml", text.format(side=side))


def write_stencil_ilu(dirpath: str, side: int, **sections) -> str:
    """Write the stencil-ILU YAML at side^3 (no data files: the YAML
    generates the system); returns its path."""
    os.makedirs(dirpath, exist_ok=True)
    return _write_yaml(dirpath, "stencil_ilu.yaml", with_settings(
        STENCIL_ILU_YAML.format(side=side), **sections))


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) not in (1, 2, 3, 4) or args[2:3] not in ([], ["3"], ["4"],
                                                         ["4c"]) \
            or not all(a.isdigit() for a in args[1:2] + args[3:]):
        print("usage: python -m tpusolve_torch.fixtures OUTDIR [SIDE] "
              "[GATE [NFILES]]  (GATE 3, 4, or 4c: gate 4's three "
              "components; NFILES: gate 4's HYPRE-IJ files, 2 by default)",
              file=sys.stderr)
        sys.exit(1)
    side = int(args[1]) if len(args) > 1 else 48
    write = {"3": write_gate3, "4c": write_gate4_3comp}.get(
        (args[2:] or ["4"])[0], write_gate4)
    kw = {"nfiles": int(args[3])} if len(args) > 3 else {}
    print(write(args[0], side, **kw))
