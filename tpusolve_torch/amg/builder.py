"""BoomerAMG-equivalent multilevel hierarchy: setup and the V-cycle (the
port of ``tpusolve/amg/builder.py``).

Replacement for ``HYPRE_BoomerAMG{Create,Setup,Solve}`` and the setter
surface the reference drives (src/HypreSystem.cpp:91-326):

* **Setup** (strength -> PMIS coarsening -> interpolation -> Galerkin RAP).
  Level 0 is set up on its device where ``tpusolve`` sets it up on the TPU
  (``builder.py:236-281``), in its order: a stencil of N parts with its
  lattice planes by the sharded lattice setup
  (``amg/device_setup_sharded.py``), else a one-part box-DIA operator of at
  least ``device_setup.MIN_DEVICE_N`` rows in offset algebra
  (``amg/device_setup.py``), else a generic-ELL one of at least
  ``device_setup_ell.MIN_DEVICE_N`` on one part or many
  (``amg/device_setup_ell.py``, ``amg/device_setup_ell_mp.py``); every
  level below that is eligible for the generic-ELL setup is set up on the
  device too (``tpusolve``'s device recursion, ``builder.py:289-320``).
  The other levels run vectorized on the host, as ``tpusolve``'s host
  pipeline (``builder.py:283-405``) does, on the native setup kernels
  (``amg/spk.py``).  Square level operators take the layout the assembly
  chooses (DIA, BDIA, BELL or ELL); P and R are ELL (K2), and so are the
  device setups' coarse operators.
* **Cycling** (smooth -> restrict -> recurse -> prolong -> smooth) is a
  Python recursion over the levels; every SpMV runs its layout's kernel and
  the coarsest level applies a dense pseudo-inverse with ``torch.matmul``.
  Every level but the coarsest carries ``prolong``/``restrict`` callables:
  the sparse ``P``/``R`` products of the algebraic hierarchy, or the box
  transfers of the structured one (``amg/structured.py``).
* **Solve**: AMG as the solver is the harness's stationary iteration
  (``krylov/stationary.py``) with ``apply`` (one V-cycle) as M.

ILU smoothers on the finest ``smooth_num_levels`` levels (``smooth_type``
5, 6, 7, 9; ``_attach_ilu_smoother``): host Chow-Patel ILU(0) factors whose
``smooth_num_sweeps`` corrections take the relaxation's place there.

The bfloat16 smoother twin (``smoother_dtype: bfloat16``,
``_relax_twin``): a bf16 copy of a level's values, where ``tpusolve`` makes
one, which the relaxation sweeps read (K1 or K2 on bf16 values, x and the
sums in the solve's dtype); the residual before restriction, the coarse
solve, the ILU smoother and the Chebyshev bounds read A.

A batch of k vectors (k, n) (the coupled solve) runs the algebraic cycle on
the whole batch, each SpMV one k-column launch where the layout's kernel
has one (``matrix/spmv.py``); the structured cycle, whose transfers are
fused into K1's single-vector launches, runs each column in turn.

Across ranks (``dist.py``) ``A`` is a rank's slice: the host hierarchy is
built on every rank from the gathered host CSR (the same bits on each),
and each level's A, P and R (offd blocks and halo plans with them) are
assembled over every part on the host and placed as the rank's parts
(``dist.place``); the coarsest solve gathers the coarse residual over the
ranks and keeps the rank's rows of the pseudo-inverse's product.  The
device setups raise there (ROADMAP.md Queue 1 item 19).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch import dist
from tpusolve_torch.amg import coarsen as coarsen_mod
from tpusolve_torch.amg import device_setup
from tpusolve_torch.amg import device_setup_ell
from tpusolve_torch.amg import device_setup_sharded
from tpusolve_torch.amg import galerkin
from tpusolve_torch.amg import interp as interp_mod
from tpusolve_torch.amg import smoothers
from tpusolve_torch.amg import strength as strength_mod
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.ilu.ilu import chow_patel_ilu, ilu_apply
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update
from tpusolve_torch.matrix.vectors import (
    numpy_dtype, pad_vector, to_device_vector, to_tensor)
from tpusolve_torch.parts import row_decomposition

# the row floors of the DIA and the generic-ELL device setups
# (``boomeramg_setup``'s ``device_min_n``)
DEVICE_MIN_N = (device_setup.MIN_DEVICE_N, device_setup_ell.MIN_DEVICE_N)
DIA_NOTE = ("level 0 setup on device (DIA offset algebra: "
            "strength/PMIS/interp/RAP as shifted streaming ops)")
ELL_NOTE = ("level 0 setup on device (generic ELL: PMIS via "
            "gather/scatter rounds, RAP as sort-based SpGEMM)")
RECURSION_NOTE = "coarse levels recursed on device (generic ELL setup)"


@dataclass
class Level:
    """One level of the hierarchy: its operator, the transfers to the next
    level (None at the coarsest) and the smoother's vectors.  Every level
    but the coarsest has the ``prolong``/``restrict`` callables the cycle
    runs; an algebraic level also keeps the sparse ``P``/``R`` they apply,
    a structured level has box transfers and no ``P``/``R``, and also
    their forms fused with K1 on its A (``restrict_residual``,
    ``prolong_update``; ``amg/structured.py:_make_transfers``), which stay
    None on an algebraic level."""
    A: ShardedMatrix
    P: ShardedMatrix | None          # (n_fine, n_coarse); None at coarsest
    R: ShardedMatrix | None          # P^T
    dinv_l1: torch.Tensor | None     # 1 / l1 row norms (padded)
    dinv: torch.Tensor | None        # 1 / diag        (padded)
    cmask: torch.Tensor | None = None   # 1.0 at C-points (CF relax order)
    cheby_bounds: tuple | None = None
    n: int = 0
    nnz: int = 0
    prolong: Callable | None = None  # (ec, x, out=) -> x + P ec
    restrict: Callable | None = None  # fine -> coarse vector, P^T r
    # (x, b) -> P^T (b - A x), one launch
    restrict_residual: Callable | None = None
    # (ec, x, b, s, w, c_is_xnew, xnew_out) -> [x'] + w s (b - A x'),
    # x' = x + P ec, one launch
    prolong_update: Callable | None = None
    # ILU smoother factors (smooth_type), which replace the relaxation on
    # this level: strict L and U and 1 / u_ii
    ilu_L: ShardedMatrix | None = None
    ilu_U: ShardedMatrix | None = None
    ilu_dinv: torch.Tensor | None = None
    # the bfloat16 smoother twin of A (smoother_dtype: bfloat16,
    # _relax_twin), which the relaxation sweeps read; None: they read A
    A_relax: ShardedMatrix | None = None


@dataclass
class AMGPreconditioner:
    levels: list[Level]
    coarse_inv: torch.Tensor         # (row_pad_c, row_pad_c) pinv
    config: BoomerAMGConfig
    notes: list[str]
    cycle: Callable | None = None    # z = cycle(r), one V- or W-cycle
    num_levels: int = 0
    # wall seconds of the setup's stages (level 0's device stages, each
    # later device level's as "level i <stage>", then the host levels');
    # empty when the host pipeline built every level
    setup_seconds: dict = field(default_factory=dict)
    # (level, rows) of each coarse operator a device setup built that was
    # fetched to the host, for a host level or the coarsest solve
    host_fetches: list = field(default_factory=list)
    # (level, setup, parts) of each level set up on the device: setup
    # "lattice" (amg/device_setup_sharded.py), "dia" (amg/device_setup.py)
    # or "ell" (amg/device_setup_ell.py, its N-part pipeline on N parts)
    device_setups: list = field(default_factory=list)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = (one AMG cycle)(r) from zero initial guess — the
        preconditioner contract."""
        return self.cycle(r)

    def describe(self) -> str:
        """Grid/operator complexity table (hypre print_level>=1 analog)."""
        lines = ["AMG hierarchy:",
                 f"  {'lvl':>3s} {'rows':>12s} {'nnz':>14s} {'avg nnz/row':>12s}"]
        n0 = self.levels[0].n
        nnz0 = self.levels[0].nnz
        for i, lev in enumerate(self.levels):
            avg = lev.nnz / max(lev.n, 1)
            lines.append(f"  {i:3d} {lev.n:12d} {lev.nnz:14d} {avg:12.2f}")
        grid_c = sum(l.n for l in self.levels) / max(n0, 1)
        op_c = sum(l.nnz for l in self.levels) / max(nnz0, 1)
        lines.append(f"  grid complexity {grid_c:.3f}   "
                     f"operator complexity {op_c:.3f}")
        for note in self.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)

    def layouts(self) -> list[str]:
        """One line per level naming the layout of each operator, and which
        box transfers the cycle carries inside K1's launches."""
        fused = getattr(self.cycle, "fused", None) or []
        out = []
        for i, lev in enumerate(self.levels):
            line = f"AMG level {i}: A {lev.A.layout}"
            if lev.A_relax is not None:
                line += f" (bf16 twin {lev.A_relax.layout})"
            if lev.P is not None:
                line += f"; P {lev.P.layout}; R {lev.R.layout}"
            elif lev.prolong is not None:
                line += "; P, R box transfers"
                down, up = fused[i] if i < len(fused) else (False, False)
                kinds = (["restriction with the residual"] if down else []) \
                    + (["prolongation with the first post-sweep"] if up
                       else [])
                if kinds:
                    line += " inside K1 (" + ", ".join(kinds) + ")"
            out.append(line)
        return out


def _sharded_from_scipy(M: sp.spmatrix, device, dtype, row_offsets=None,
                        col_offsets=None, allow_tiles: bool = True,
                        nparts: int = 1) -> ShardedMatrix:
    """``allow_tiles=False`` forces ELL, padded or row-pointer as K2's
    model prices them (``matrix/sharded.py:ell_form``).  Used for P/R:
    transfer operators average ~2-4 entries/row, so the dense-tile layouts
    (BELL/BDIA) would expand them 40-60x.  Square coarse operators are
    denser per row and keep the full layout selection, ELL among it.
    Across ranks the operator over every part is assembled on the host and
    the rank keeps its parts (``dist.place``)."""
    return dist.place(ShardedMatrix.from_csr_host(
        M.tocsr(), device=dist.staging(device), dtype=dtype,
        row_offsets=row_offsets, col_offsets=col_offsets,
        allow_bell=allow_tiles, allow_bdia=allow_tiles, nparts=nparts))


# dense coarse solve guard: above this size the (Npad_c^2) pinv is
# substituted by coarse relaxation sweeps
DENSE_COARSE_MAX = 8192
_COARSE_FALLBACK_SWEEPS = 10


def _resolve_kinds(cfg: BoomerAMGConfig):
    notes = []
    kind_down, note = smoothers.resolve_relax(
        cfg.relax_down if cfg.relax_down is not None else cfg.relax_type)
    if note:
        notes.append(note)
    kind_up, note = smoothers.resolve_relax(
        cfg.relax_up if cfg.relax_up is not None else cfg.relax_type)
    if note and note not in notes:
        notes.append(note)
    kind_coarse, note = smoothers.resolve_coarse_relax(cfg.relax_coarse)
    if note and note not in notes:
        notes.append(note)
    return kind_down, kind_up, kind_coarse, notes


def _relax_twin(A: ShardedMatrix, cfg) -> ShardedMatrix | None:
    """The bfloat16 smoother twin of level operator ``A``
    (``smoother_dtype: bfloat16``, ``tpusolve``'s ``_relax_twin``): None
    unless the config asks for it, or where ``tpusolve`` stores the
    operator BDIA or BELL (``ShardedMatrix.tpusolve_layout``; its Pallas
    kernels take f32 only); else A's values rounded to bf16 in A's own
    layout where that is DIA (K1) or ELL (K2), and laid out ELL (each
    row's entries in column order, as ``ilu/device_setup.py:_ell_padded``
    lays a factor out) where the port stores BDIA, BDIA-XL or BELL: K4, K5
    and K6 take no bf16 values."""
    if getattr(cfg, "smoother_dtype", "match") != "bfloat16":
        return None
    if A.tpusolve_layout in ("bdia", "bell"):
        return None
    if not (A.uses_dia or A.uses_ell):
        M = dist.gather_scipy(A.to_scipy())
        M.sort_indices()
        A = dist.place(ShardedMatrix.from_csr_host(
            M, device=dist.staging(A.device), dtype=numpy_dtype(A.dtype),
            row_offsets=np.asarray(A.all_row_offsets),
            col_offsets=np.asarray(A.all_col_offsets), allow_dia=False,
            allow_bdia=False, allow_bell=False))
    return A.astype(torch.bfloat16)


def boomeramg_setup(A: ShardedMatrix, config: BoomerAMGConfig | None = None,
                    *, A_host: sp.csr_matrix | None = None,
                    seed: int = 1234, lattice_parts=None,
                    device_min_n: int | tuple | None = DEVICE_MIN_N
                    ) -> AMGPreconditioner:
    """Build the AMG hierarchy for ``A``.

    Level 0 is set up on A's device when ``device_setup_sharded.eligible``
    holds for ``A`` and ``lattice_parts`` (the N-part stencil's lattice
    dict, ``stencil.laplace27(..., with_lattice=True)``), or else
    ``device_setup.eligible`` (the one-part DIA setup), or else
    ``device_setup_ell.eligible`` (the generic-ELL setup, on one part or
    many), and each later level while ``device_setup_ell.eligible`` holds
    for it; every other level on the host.  ``device_min_n``: the row
    floors of the device setups, a (DIA, ELL) pair (by default each
    setup's own; the lattice setup takes the DIA floor), one int for both,
    or None (never on the device).  ``A_host`` may supply the host CSR
    (straight after file load).  Set ``TPUSOLVE_SETUP_LOG=1`` for
    per-level phase timings (the analog of BoomerAMG's setup print_level
    output)."""
    log_on = os.environ.get("TPUSOLVE_SETUP_LOG", "0") == "1"
    log = (lambda s: print(s, flush=True)) if log_on else None
    _t = [time.perf_counter()]

    def _phase(label):
        if log_on:
            t = time.perf_counter()
            print(f"    setup: {label:28s} {t - _t[0]:8.2f}s", flush=True)
            _t[0] = t

    if device_min_n is None or isinstance(device_min_n, int):
        dia_min = ell_min = device_min_n
    else:
        dia_min, ell_min = device_min_n
    cfg = config or BoomerAMGConfig()
    device = A.device
    dtype = numpy_dtype(A.dtype)
    kind_down, kind_up, kind_coarse, notes = _resolve_kinds(cfg)
    # remaining reference keys (src/HypreSystem.cpp:180-190) with no
    # behavioral freedom here — record how each is honored/mapped so no
    # accepted key is a silent no-op:
    if cfg.rap2:
        notes.append("rap2=1 honored by construction: RAP is always "
                     "computed as two products, (A@P) then P^T@(AP)")
    if cfg.keep_transpose:
        notes.append("keep_transpose=1 honored by construction: R = P^T "
                     "is materialized and stored per level")
    if cfg.variant is not None:
        notes.append(f"variant {cfg.variant} (Schwarz smoother variant) "
                     "not applicable: Schwarz smoothing maps to ILU(0)")

    min_coarse = cfg.min_coarse_size or 1
    max_coarse = max(cfg.max_coarse_size, min_coarse)

    levels: list[Level] = []
    A_sh = A
    Ah = None
    Ah_fn = None       # a device setup's deferred coarse-CSR fetch
    lvl_start = 0
    seconds = {}
    fetches = []
    setups = []
    t_device = 0.0     # wall seconds of the device levels below level 0

    def host_csr(lvl):
        """The level's host CSR, fetched from the device only when the host
        pipeline needs it."""
        nonlocal Ah
        if Ah is None:
            Ah = Ah_fn().tocsr()
            fetches.append((lvl, Ah.shape[0]))
        return Ah

    # --- level 0 on the device: an N-part stencil by its lattice
    # (amg/device_setup_sharded.py), a box-DIA operator in offset algebra
    # (amg/device_setup.py), else a generic-ELL one (amg/device_setup_ell.py)
    if A.shape[0] > max_coarse and cfg.max_levels > 1:
        res = None
        if A.is_slice and (
                device_setup_sharded.eligible(A, cfg, lattice_parts,
                                              min_n=dia_min)
                or (dia_min is not None
                    and device_setup.eligible(A, cfg, min_n=dia_min))
                or device_setup_ell.eligible(A, cfg, A_host, min_n=ell_min)):
            dist.refuse("the device AMG setup of level 0")
        if device_setup_sharded.eligible(A, cfg, lattice_parts,
                                         min_n=dia_min):
            if log_on:
                print(f"  setup level 0 [device, {A.nparts} parts]: "
                      f"n={A.shape[0]} nnz={A.nnz}", flush=True)
            res = device_setup_sharded.device_level0_sharded(
                A, cfg, lattice_parts, seed=seed, log=log)
            dev_note, kind = DIA_NOTE, "lattice"
        elif dia_min is not None and device_setup.eligible(A, cfg,
                                                           min_n=dia_min):
            if log_on:
                print(f"  setup level 0 [device]: n={A.shape[0]} "
                      f"nnz={A.nnz}", flush=True)
            res = device_setup.device_level0(A, cfg, seed=seed, log=log)
            dev_note, kind = DIA_NOTE, "dia"
        elif device_setup_ell.eligible(A, cfg, A_host, min_n=ell_min):
            if log_on:
                print(f"  setup level 0 [device, generic ELL]: "
                      f"n={A.shape[0]} nnz={A.nnz}", flush=True)
            res = device_setup_ell.device_level0_ell(
                A, cfg, A_host=A_host, seed=seed, log=log)
            dev_note, kind = ELL_NOTE, "ell"
        if res is not None and res["nc"] >= min_coarse:
            levels.append(_make_level_device(A, res, kind_down, kind_up,
                                             cfg))
            Ah_fn = res["Ah_c_fn"]
            A_sh = res["Ac"]
            lvl_start = 1
            seconds.update(res["seconds"])
            setups.append((0, kind, A.nparts))
            notes.append(dev_note)
            if cfg.coarsen_type != 8:
                notes.append(f"device setup: coarsen_type "
                             f"{cfg.coarsen_type} runs PMIS (as in hypre's "
                             "device setup)")
    t_host = time.perf_counter()
    if lvl_start == 0:
        Ah = (A_host if A_host is not None
              else dist.gather_scipy(A.to_scipy())).tocsr()
        Ah.sum_duplicates()

    for lvl in range(lvl_start, cfg.max_levels):
        n = A_sh.shape[0]
        if n <= max_coarse or lvl == cfg.max_levels - 1:
            break
        # device recursion: a level the generic-ELL setup takes runs on the
        # device, its host CSR (if any) dropped for the deferred fetch
        if device_setup_ell.eligible(A_sh, cfg, Ah, min_n=ell_min):
            dist.refuse(f"the device AMG setup of level {lvl}")
            if log_on:
                print(f"  setup level {lvl} [device, generic ELL]: n={n} "
                      f"nnz={A_sh.nnz}", flush=True)
            t_lvl = time.perf_counter()
            res = device_setup_ell.device_level0_ell(
                A_sh, cfg, A_host=Ah, seed=seed + lvl, log=log)
            if res is not None:
                if res["nc"] < min_coarse:
                    break     # next grid would be below min_coarse_size
                levels.append(_make_level_device(A_sh, res, kind_down,
                                                 kind_up, cfg))
                seconds.update({f"level {lvl} {k}": v
                                for k, v in res["seconds"].items()})
                setups.append((lvl, "ell", A_sh.nparts))
                Ah = None
                Ah_fn = res["Ah_c_fn"]
                A_sh = res["Ac"]
                if RECURSION_NOTE not in notes:
                    notes.append(RECURSION_NOTE)
                t_device += time.perf_counter() - t_lvl
                continue
            # res None: coarsening stalled on the device; the host stages
            # below reach the same conclusion and stop
            t_device += time.perf_counter() - t_lvl
        Ah = host_csr(lvl)
        if log_on:
            print(f"  setup level {lvl}: n={n} nnz={Ah.nnz}", flush=True)
        _t[0] = time.perf_counter()
        S = strength_mod.classical_strength(Ah, cfg.strong_threshold)
        _phase("strength")
        aggressive = lvl < cfg.agg_num_levels
        if aggressive:
            # agg_num_levels finest levels coarsen aggressively
            # (ref: src/HypreSystem.cpp:207-213)
            split = coarsen_mod.aggressive_pmis(S, seed=seed + lvl)
            note = "aggressive (two-pass PMIS) coarsening"
            if note not in notes:
                notes.append(note)
        else:
            split, note = coarsen_mod.coarsen(S, cfg.coarsen_type,
                                              seed=seed + lvl)
            if note and note not in notes:
                notes.append(note)
        _phase("coarsen")
        nc = int((split == coarsen_mod.C_PT).sum())
        if nc == 0 or nc >= n:
            break  # coarsening stalled: stop here, direct-solve this level
        if nc < min_coarse:
            # BoomerAMG stops when the next grid would drop below
            # min_coarse_size (ref: src/HypreSystem.cpp:216-219)
            break
        P_host, note = interp_mod.build_interpolation(
            Ah, S, split,
            cfg.agg_interp_type if aggressive else cfg.interp_type,
            cfg.trunc_factor, cfg.p_max_elmts,
            require_distance2=aggressive)
        if note and note not in notes:
            notes.append(note)
        _phase("interpolation")
        Ac = galerkin.rap(Ah, P_host)
        _phase("galerkin RAP")
        ng_tol = cfg.non_galerkin_tol
        if cfg.nongalerk_tol:
            idx = min(lvl, len(cfg.nongalerk_tol) - 1)
            ng_tol = float(cfg.nongalerk_tol[idx])
        if ng_tol > 0:
            Ac = galerkin.nongalerkin_sparsify(Ac, ng_tol)

        lev = _make_level(A_sh, Ah, dtype, kind_down, kind_up, cfg)
        _phase("level vectors")
        if lvl < cfg.smooth_num_levels and cfg.smooth_type is not None:
            _attach_ilu_smoother(lev, A_sh, Ah, dtype, cfg, notes)
        if cfg.relax_order == 1:
            lev.cmask = to_device_vector(
                (split == coarsen_mod.C_PT).astype(np.float64),
                A_sh.row_offsets, A_sh.row_pad, device, dtype=dtype)
        row_off = np.asarray(A_sh.all_row_offsets)
        col_off = row_decomposition(nc, A_sh.all_nparts)
        lev.P = _sharded_from_scipy(P_host, device, dtype,
                                    row_offsets=row_off, col_offsets=col_off,
                                    allow_tiles=False)
        lev.R = _sharded_from_scipy(P_host.T.tocsr(), device, dtype,
                                    row_offsets=col_off, col_offsets=row_off,
                                    allow_tiles=False)
        _phase("P/R device assembly")
        levels.append(lev)

        Ah = Ac
        A_sh = _sharded_from_scipy(Ah, device, dtype, nparts=A.all_nparts)
        _phase("coarse A device assembly")

    # coarsest level: dense (pseudo)inverse or relaxation sweeps
    Ah = host_csr(len(levels))
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, Ah.shape[0],
                                               cfg, notes)
    lev = _make_level(A_sh, Ah, dtype, kind_down, kind_up, cfg,
                      kind_coarse=kind_coarse)
    levels.append(lev)
    coarse_inv = _coarse_solver_data(Ah, A_sh, dtype, kind_coarse)
    if seconds:
        seconds["host levels"] = time.perf_counter() - t_host - t_device

    pre = AMGPreconditioner(levels=levels, coarse_inv=coarse_inv, config=cfg,
                            notes=notes, num_levels=len(levels),
                            setup_seconds=seconds, host_fetches=fetches,
                            device_setups=setups)
    pre.cycle = _build_cycle(pre, kind_down, kind_up, cfg,
                             kind_coarse=kind_coarse,
                             coarse_sweeps=coarse_sweeps)
    return pre


def _attach_ilu_smoother(lev: Level, A_sh, Ah, dtype, cfg, notes) -> None:
    """ILU(0) factors on a fine level (``smooth_type``,
    ``smooth_num_levels``, ``smooth_num_sweeps``, ref:
    src/HypreSystem.cpp:237-321): HYPRE's codes 5 (ParILUK), 7 (Pilut) and
    9 (Euclid) are ILU-family, 6 (Schwarz) is substituted; the factors come
    from the host Chow-Patel ILU(0) with 5 sweeps (``tpusolve``'s
    ``_attach_ilu_smoother``).  Other codes leave the level's relaxation
    and say so."""
    st = cfg.smooth_type
    if st not in (5, 6, 7, 9):
        note = f"smooth_type {st} unsupported: levels use relax_type instead"
        if note not in notes:
            notes.append(note)
        return
    note = {5: "smooth_type 5 (ParILUK) as Chow-Patel ILU(0) + Jacobi "
               "trisolve",
            7: "smooth_type 7 (Pilut) as Chow-Patel ILU(0) + Jacobi trisolve",
            9: "smooth_type 9 (Euclid) as Chow-Patel ILU(0) + Jacobi "
               "trisolve",
            6: "smooth_type 6 (Schwarz) mapped to ILU(0) smoothing"}[st]
    if note not in notes:
        notes.append(note)
    L_host, ujj, U_host = chow_patel_ilu(Ah.tocsr(), sweeps=5, fill_level=0)
    ro = np.asarray(A_sh.all_row_offsets)
    lev.ilu_L, lev.ilu_U = (dist.place(ShardedMatrix.from_csr_host(
        M, device=dist.staging(A_sh.device), dtype=dtype, row_offsets=ro,
        col_offsets=ro)) for M in (L_host, U_host))
    lev.ilu_dinv = to_device_vector(1.0 / ujj, A_sh.row_offsets,
                                    A_sh.row_pad, A_sh.device, dtype=dtype)


def hierarchy_from_arrays(levels: list[dict], coarse_inv: np.ndarray,
                          config: BoomerAMGConfig | None, device
                          ) -> AMGPreconditioner:
    """The port's preconditioner on operators built elsewhere, so that one
    V-cycle of both packages can run on identical operators.

    ``levels[i]`` holds ``A``, ``P`` and ``R`` (None, a scipy matrix, or
    ``(arrays, meta)`` as :meth:`ShardedMatrix.from_arrays` takes them:
    ``tpusolve``'s fields fetched as numpy; a DIA operator comes across
    through its scipy form) and ``dinv``, ``dinv_l1``, ``cmask`` (padded
    numpy vectors or None) and ``cheby_bounds``; ``coarse_inv`` is the
    padded coarsest pseudo-inverse."""
    cfg = config or BoomerAMGConfig()
    kind_down, kind_up, kind_coarse, notes = _resolve_kinds(cfg)

    def op(m):
        if m is None:
            return None
        if sp.issparse(m):
            return ShardedMatrix.from_csr_host(m, device=device,
                                               allow_bdia=False,
                                               allow_bell=False)
        return ShardedMatrix.from_arrays(*m, device=device)

    vec = lambda a: None if a is None else to_tensor(np.asarray(a), device)
    levs = []
    for d in levels:
        A = op(d["A"])
        levs.append(Level(A=A, P=op(d.get("P")), R=op(d.get("R")),
                          dinv_l1=vec(d.get("dinv_l1")),
                          dinv=vec(d.get("dinv")), cmask=vec(d.get("cmask")),
                          cheby_bounds=d.get("cheby_bounds"), n=A.shape[0],
                          nnz=A.nnz, A_relax=_relax_twin(A, cfg)))
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, levs[-1].n, cfg,
                                               notes)
    pre = AMGPreconditioner(levels=levs, coarse_inv=vec(coarse_inv),
                            config=cfg, notes=notes, num_levels=len(levs))
    pre.cycle = _build_cycle(pre, kind_down, kind_up, cfg,
                             kind_coarse=kind_coarse,
                             coarse_sweeps=coarse_sweeps)
    return pre


def _guard_coarse(kind_coarse, n_c: int, cfg, notes: list):
    """Dense-solve guard + coarse sweep count resolution."""
    ncs = (cfg.num_coarse_sweeps if cfg.num_coarse_sweeps is not None
           else cfg.num_sweeps)
    if kind_coarse == smoothers.RELAX_DIRECT and n_c > DENSE_COARSE_MAX:
        notes.append(
            f"coarse level has {n_c} rows > {DENSE_COARSE_MAX}: dense "
            "inverse replaced by l1-Jacobi sweeps (raise max_coarse_size "
            "guardedly or set relax_coarse)")
        return smoothers.RELAX_L1_JACOBI, max(ncs, _COARSE_FALLBACK_SWEEPS)
    return kind_coarse, ncs


def _coarse_solver_data(Ah, A_sh, dtype, kind_coarse) -> torch.Tensor:
    if kind_coarse == smoothers.RELAX_DIRECT:
        return _padded_pinv(Ah, A_sh, dtype)
    # relaxation-based coarse solve: a (1,1) placeholder
    return to_tensor(np.zeros((1, 1), dtype), A_sh.device)


def _make_level_device(A_sh, res, kind_down, kind_up, cfg) -> Level:
    """A level from a device setup's results, without a host CSR: the
    Chebyshev bounds by power iteration on the device."""
    kinds = (kind_down, kind_up)
    dinv_l1 = (res["dinv_l1"] if smoothers.RELAX_L1_JACOBI in kinds
               else None)
    cheby_bounds = None
    if smoothers.RELAX_CHEBYSHEV in kinds:
        lam = device_setup.power_lambda(A_sh, res["dinv"])
        cheby_bounds = (cfg.cheby_fraction * lam, 1.1 * lam)
    cmask = res["Cmask"].to(A_sh.dtype) if cfg.relax_order == 1 else None
    return Level(A=A_sh, P=res["P"], R=res["R"], dinv_l1=dinv_l1,
                 dinv=res["dinv"], cmask=cmask, cheby_bounds=cheby_bounds,
                 n=A_sh.shape[0], nnz=A_sh.nnz,
                 A_relax=_relax_twin(A_sh, cfg))


def _make_level(A_sh, Ah, dtype, kind_down, kind_up, cfg,
                kind_coarse=None) -> Level:
    ro = np.asarray(A_sh.row_offsets)
    kinds = (kind_down, kind_up, kind_coarse)
    dinv_l1 = None
    cheby_bounds = None
    d = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv_host = 1.0 / d
    dinv = to_device_vector(dinv_host, ro, A_sh.row_pad, A_sh.device,
                            dtype=dtype)
    if smoothers.RELAX_L1_JACOBI in kinds:
        l1 = smoothers.l1_row_norms(Ah)
        dinv_l1 = to_device_vector(1.0 / l1, ro, A_sh.row_pad, A_sh.device,
                                   dtype=dtype)
    if smoothers.RELAX_CHEBYSHEV in kinds:
        lam = smoothers.chebyshev_bounds(Ah, dinv_host)
        cheby_bounds = (cfg.cheby_fraction * lam, 1.1 * lam)
    return Level(A=A_sh, P=None, R=None, dinv_l1=dinv_l1, dinv=dinv,
                 cheby_bounds=cheby_bounds, n=Ah.shape[0], nnz=Ah.nnz,
                 A_relax=_relax_twin(A_sh, cfg))


def _padded_pinv(Ah, A_sh, dtype) -> torch.Tensor:
    """Dense pseudo-inverse of the coarsest operator, laid out in the padded
    vector space on both axes; on a rank's slice its parts' rows, against
    the padded columns of every part."""
    ro = np.asarray(A_sh.all_row_offsets)
    pad = A_sh.row_pad
    inv = np.linalg.pinv(Ah.toarray(), rcond=1e-12)
    tmp = pad_vector(inv, ro, pad)                           # (Npad, n)
    full = pad_vector(np.ascontiguousarray(tmp.T), ro, pad)  # (Npad, Npad)
    lo = A_sh.part_lo * pad
    return to_tensor(full.T[lo:lo + A_sh.nparts * pad], A_sh.device, dtype)


def _build_cycle(pre: AMGPreconditioner, kind_down, kind_up,
                 cfg: BoomerAMGConfig,
                 kind_coarse=smoothers.RELAX_DIRECT, coarse_sweeps=None,
                 fused: bool = True):
    """Build cycle(r) -> z over ``pre.levels`` and ``pre.coarse_inv``.

    On a box level the restriction rides inside the residual's K1 launch,
    and the prolongation inside the first post-smoothing update's, when the
    level has the fused callables and (for the prolongation) the
    post-smoother is l1-Jacobi, Jacobi or Chebyshev with at least one sweep
    and no CF order; any other level runs the pair of launches.
    ``fused=False`` runs the pairs everywhere (the yardstick the fused cycle
    equals bit for bit).  The choice is made here, once, and kept as the
    cycle's ``fused`` attribute, one (restriction, prolongation) pair of
    flags per level, which ``layouts()`` shows."""
    levels = pre.levels
    L = len(levels)
    if coarse_sweeps is None:
        coarse_sweeps = (cfg.num_coarse_sweeps
                         if cfg.num_coarse_sweeps is not None
                         else cfg.num_sweeps)
    nu_down = (cfg.num_down_sweeps if cfg.num_down_sweeps is not None
               else cfg.num_sweeps)
    nu_up = (cfg.num_up_sweeps if cfg.num_up_sweeps is not None
             else cfg.num_sweeps)
    gamma = 2 if cfg.cycle_type == 2 else 1
    weight = 1.0
    cf_order = cfg.relax_order == 1

    def relax_op(lev: Level):
        """The operator the relaxation sweeps read: the bf16 twin where the
        level has one (``tpusolve``'s ``A_s``), else A."""
        return lev.A_relax if lev.A_relax is not None else lev.A

    def cheby(lev: Level, b, x, r=None):
        if cfg.cheby_variant == 4:
            return smoothers.chebyshev4_sweeps(relax_op(lev), lev.dinv, b, x,
                                               lev.cheby_bounds[1],
                                               cfg.cheby_order, r=r)
        return smoothers.chebyshev_sweeps(relax_op(lev), lev.dinv, b, x,
                                          lev.cheby_bounds, cfg.cheby_order,
                                          r=r)

    def smooth(lev: Level, b, x, kind, ns):
        if ns <= 0:
            return x
        if lev.ilu_L is not None:
            # the ILU smoother replaces the relaxation on this level
            for _ in range(cfg.smooth_num_sweeps):
                x = x + ilu_apply(lev.ilu_L, lev.ilu_U, lev.ilu_dinv,
                                  spmv_update(lev.A, x, b=b), 5, 5)
            return x
        use_cf = cf_order and lev.cmask is not None
        A_s = relax_op(lev)
        if kind == smoothers.RELAX_L1_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(A_s, lev.dinv_l1,
                                                  lev.cmask, b, x, ns, 1.0)
            return smoothers.jacobi_sweeps(A_s, lev.dinv_l1, b, x, ns, 1.0)
        if kind == smoothers.RELAX_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(A_s, lev.dinv, lev.cmask,
                                                  b, x, ns, weight)
            return smoothers.jacobi_sweeps(A_s, lev.dinv, b, x, ns, weight)
        if kind == smoothers.RELAX_CHEBYSHEV:
            for _ in range(ns):
                x = cheby(lev, b, x)
            return x
        raise ValueError(kind)

    for lev in levels[:-1]:
        if lev.P is not None:
            lev.prolong, lev.restrict = _sparse_transfers(lev.P, lev.R)
    fuse_up_kinds = (smoothers.RELAX_L1_JACOBI, smoothers.RELAX_JACOBI,
                     smoothers.RELAX_CHEBYSHEV)
    plan = [(fused and lev.restrict_residual is not None,
             fused and lev.prolong_update is not None and nu_up > 0
             and kind_up in fuse_up_kinds
             and not (cf_order and lev.cmask is not None))
            for lev in levels[:-1]]

    def post_smooth(l: int, lev: Level, b, x, ec):
        """x + P ec, then the post-smoother: the first update in the
        prolongation's launch where the level fuses them."""
        if not plan[l][1]:
            x = lev.prolong(ec, x, out=x)
            return smooth(lev, b, x, kind_up, nu_up)
        if kind_up == smoothers.RELAX_CHEBYSHEV:
            xn = torch.empty_like(x)
            r = lev.prolong_update(ec, x, b, lev.dinv, 1.0, False, xn)
            x = cheby(lev, b, xn, r)
        elif kind_up == smoothers.RELAX_L1_JACOBI:
            x = lev.prolong_update(ec, x, b, lev.dinv_l1, 1.0, True)
        else:
            x = lev.prolong_update(ec, x, b, lev.dinv, weight, True)
        return smooth(lev, b, x, kind_up, nu_up - 1)

    def cycle(l: int, b, x):
        lev = levels[l]
        if l == L - 1:
            if kind_coarse != smoothers.RELAX_DIRECT:
                # coarse-level relaxation (relax_coarse / num_coarse_sweeps,
                # ref: src/HypreSystem.cpp:129-151)
                return smooth(lev, b, x, kind_coarse, coarse_sweeps)
            # across ranks the residual of every part (dist.all_gather_cat)
            rr = dist.all_gather_cat(spmv_update(lev.A, x, b=b))
            if rr.dim() == 2:       # a batch (k, n): each row's solve
                return x + torch.matmul(rr, pre.coarse_inv.T)
            return x + torch.matmul(pre.coarse_inv, rr)
        x = smooth(lev, b, x, kind_down, nu_down)
        if plan[l][0]:
            rc = lev.restrict_residual(x, b)
        else:
            rc = lev.restrict(spmv_update(lev.A, x, b=b))
        Ac = levels[l + 1].A
        ec = torch.zeros(b.shape[:-1] + (Ac.nparts * Ac.row_pad,),
                         dtype=b.dtype, device=b.device)
        for _ in range(gamma):
            ec = cycle(l + 1, rc, ec)
        # the correction is added into x, which the cycle owns
        return post_smooth(l, lev, b, x, ec)

    boxed = any(lev.P is None and lev.prolong is not None
                for lev in levels[:-1])

    def run(r):
        if r.dim() == 2 and boxed:
            # the structured cycle's transfers are single-vector launches
            # fused into K1's: a batch runs column by column
            return torch.stack([cycle(0, rj, torch.zeros_like(rj))
                                for rj in r])
        return cycle(0, r, torch.zeros_like(r))

    run.fused = plan
    return run


def _sparse_transfers(P: ShardedMatrix, R: ShardedMatrix):
    """(prolong, restrict) of an algebraic level, in the box transfers'
    form: ``prolong(ec, x, out=None)`` is ``x + P ec`` (into ``out`` when
    given) and ``restrict(r)`` is ``R r``.  On ELL, padded or row-pointer
    (as the builders lay P and R out), each is one K2 launch, the
    prolongation's add its epilogue ``c - w * (P ec)`` with ``c = x`` and
    ``w = -1``."""
    def prolong(ec, x, out=None):
        if P.uses_ell:
            return spmv_update(P, ec, c=x, w=-1.0, out=out)
        return torch.add(x, spmv(P, ec), out=out)

    def restrict(r):
        return spmv(R, r)

    return prolong, restrict
