"""BoomerAMG-equivalent multilevel hierarchy: host setup and the V-cycle (the
port of ``tpusolve/amg/builder.py``, its host branch).

Replacement for ``HYPRE_BoomerAMG{Create,Setup,Solve}`` and the setter
surface the reference drives (src/HypreSystem.cpp:91-326):

* **Setup** (strength -> PMIS coarsening -> interpolation -> Galerkin RAP)
  runs vectorized on the host, as ``tpusolve``'s host pipeline
  (``builder.py:283-405``) does, and produces a static hierarchy of
  ShardedMatrix operators.  Square level operators take the layout the
  assembly chooses (BDIA, BELL or ELL); P and R stay padded ELL.
* **Cycling** (smooth -> restrict -> recurse -> prolong -> smooth) is a
  Python recursion over the levels; every SpMV runs its layout's kernel and
  the coarsest level applies a dense pseudo-inverse with ``torch.matmul``.
  A level carries sparse transfers (``P``/``R``) or, in the structured
  hierarchy of ``amg/structured.py``, box transfers (``prolong``/
  ``restrict``).

Not ported, and raising ``NotImplementedError``: ``tpusolve``'s device
setup paths (``lattice_parts``; its generic-ELL device setup reproduces the
host hierarchy to roundoff, so the port always runs the host pipeline),
ILU smoothers on AMG levels (``smooth_type`` 5/6/7/9) and the bfloat16
smoother twin (``smoother_dtype: bfloat16``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import coarsen as coarsen_mod
from tpusolve_torch.amg import galerkin
from tpusolve_torch.amg import interp as interp_mod
from tpusolve_torch.amg import smoothers
from tpusolve_torch.amg import strength as strength_mod
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.spmv import spmv, spmv_update
from tpusolve_torch.matrix.vectors import (
    numpy_dtype, pad_vector, to_device_vector, to_tensor)
from tpusolve_torch.parts import row_decomposition

_NOT_PORTED = "not ported yet; see ROADMAP.md Queue 1"


@dataclass
class Level:
    """One level of the hierarchy: its operator, the transfers to the next
    level (None at the coarsest) and the smoother's vectors.  Transfers are
    either sparse operators (``P``/``R``: the algebraic hierarchy) or
    callables (``prolong``/``restrict``: the structured hierarchy's box
    transfers); one pair is set on every level but the coarsest."""
    A: ShardedMatrix
    P: ShardedMatrix | None          # (n_fine, n_coarse); None at coarsest
    R: ShardedMatrix | None          # P^T
    dinv_l1: torch.Tensor | None     # 1 / l1 row norms (padded)
    dinv: torch.Tensor | None        # 1 / diag        (padded)
    cmask: torch.Tensor | None = None   # 1.0 at C-points (CF relax order)
    cheby_bounds: tuple | None = None
    n: int = 0
    nnz: int = 0
    prolong: Callable | None = None  # (ec, x, out=) -> x + P ec (structured)
    restrict: Callable | None = None  # fine -> coarse vector (structured)


@dataclass
class AMGPreconditioner:
    levels: list[Level]
    coarse_inv: torch.Tensor         # (row_pad_c, row_pad_c) pinv
    config: BoomerAMGConfig
    notes: list[str]
    cycle: Callable | None = None    # z = cycle(r), one V- or W-cycle
    num_levels: int = 0

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
        """One line per level naming the layout of each operator."""
        out = []
        for i, lev in enumerate(self.levels):
            line = f"AMG level {i}: A {lev.A.layout}"
            if lev.P is not None:
                line += f"; P {lev.P.layout}; R {lev.R.layout}"
            elif lev.prolong is not None:
                line += "; P, R box transfers"
            out.append(line)
        return out


def _sharded_from_scipy(M: sp.spmatrix, device, dtype, row_offsets=None,
                        col_offsets=None,
                        allow_tiles: bool = True) -> ShardedMatrix:
    """``allow_tiles=False`` forces the plain padded-ELL layout.  Used for
    P/R: transfer operators average ~2-4 entries/row, so the dense-tile
    layouts (BELL/BDIA) would expand them 40-60x.  Square coarse operators
    are denser per row and keep the full layout selection."""
    return ShardedMatrix.from_csr_host(
        M.tocsr(), device=device, dtype=dtype, row_offsets=row_offsets,
        col_offsets=col_offsets, allow_bell=allow_tiles,
        allow_bdia=allow_tiles)


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


def _check_ported(cfg: BoomerAMGConfig, lattice_parts) -> None:
    if lattice_parts is not None:
        raise NotImplementedError(f"AMG device setup (lattice_parts) "
                                  f"{_NOT_PORTED}, item 16")
    if getattr(cfg, "smoother_dtype", "match") == "bfloat16":
        raise NotImplementedError(f"smoother_dtype: bfloat16 {_NOT_PORTED}")
    if cfg.smooth_num_levels > 0 and cfg.smooth_type in (5, 6, 7, 9):
        raise NotImplementedError(f"ILU smoothers on AMG levels (smooth_type "
                                  f"{cfg.smooth_type}) {_NOT_PORTED}, "
                                  "item 12")


def boomeramg_setup(A: ShardedMatrix, config: BoomerAMGConfig | None = None,
                    *, A_host: sp.csr_matrix | None = None,
                    seed: int = 1234, lattice_parts=None) -> AMGPreconditioner:
    """Build the AMG hierarchy for ``A`` on the host.

    ``A_host`` may supply the host CSR (straight after file load).  Set
    ``TPUSOLVE_SETUP_LOG=1`` for per-level phase timings (the analog of
    BoomerAMG's setup print_level output)."""
    log_on = os.environ.get("TPUSOLVE_SETUP_LOG", "0") == "1"
    _t = [time.perf_counter()]

    def _phase(label):
        if log_on:
            t = time.perf_counter()
            print(f"    setup: {label:28s} {t - _t[0]:8.2f}s", flush=True)
            _t[0] = t

    cfg = config or BoomerAMGConfig()
    _check_ported(cfg, lattice_parts)
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
    Ah = (A_host if A_host is not None else A.to_scipy()).tocsr()
    Ah.sum_duplicates()

    for lvl in range(cfg.max_levels):
        n = A_sh.shape[0]
        if n <= max_coarse or lvl == cfg.max_levels - 1:
            break
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
            note = (f"smooth_type {cfg.smooth_type} unsupported: levels use "
                    "relax_type instead")
            if note not in notes:
                notes.append(note)
        if cfg.relax_order == 1:
            lev.cmask = to_device_vector(
                (split == coarsen_mod.C_PT).astype(np.float64),
                A_sh.row_offsets, A_sh.row_pad, device, dtype=dtype)
        row_off = np.asarray(A_sh.row_offsets)
        col_off = row_decomposition(nc, A_sh.nparts)
        lev.P = _sharded_from_scipy(P_host, device, dtype,
                                    row_offsets=row_off, col_offsets=col_off,
                                    allow_tiles=False)
        lev.R = _sharded_from_scipy(P_host.T.tocsr(), device, dtype,
                                    row_offsets=col_off, col_offsets=row_off,
                                    allow_tiles=False)
        _phase("P/R device assembly")
        levels.append(lev)

        Ah = Ac
        A_sh = _sharded_from_scipy(Ah, device, dtype)
        _phase("coarse A device assembly")

    # coarsest level: dense (pseudo)inverse or relaxation sweeps
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, Ah.shape[0],
                                               cfg, notes)
    lev = _make_level(A_sh, Ah, dtype, kind_down, kind_up, cfg,
                      kind_coarse=kind_coarse)
    levels.append(lev)
    coarse_inv = _coarse_solver_data(Ah, A_sh, dtype, kind_coarse)

    pre = AMGPreconditioner(levels=levels, coarse_inv=coarse_inv, config=cfg,
                            notes=notes, num_levels=len(levels))
    pre.cycle = _build_cycle(pre, kind_down, kind_up, cfg,
                             kind_coarse=kind_coarse,
                             coarse_sweeps=coarse_sweeps)
    return pre


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
                          nnz=A.nnz))
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
                 cheby_bounds=cheby_bounds, n=Ah.shape[0], nnz=Ah.nnz)


def _padded_pinv(Ah, A_sh, dtype) -> torch.Tensor:
    """Dense pseudo-inverse of the coarsest operator, laid out in the padded
    vector space on both axes."""
    ro = np.asarray(A_sh.row_offsets)
    pad = A_sh.row_pad
    inv = np.linalg.pinv(Ah.toarray(), rcond=1e-12)
    tmp = pad_vector(inv, ro, pad)                           # (Npad, n)
    full = pad_vector(np.ascontiguousarray(tmp.T), ro, pad)  # (Npad, Npad)
    return to_tensor(full.T, A_sh.device, dtype)


def _build_cycle(pre: AMGPreconditioner, kind_down, kind_up,
                 cfg: BoomerAMGConfig,
                 kind_coarse=smoothers.RELAX_DIRECT, coarse_sweeps=None):
    """Build cycle(r) -> z over ``pre.levels`` and ``pre.coarse_inv``."""
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

    def smooth(lev: Level, b, x, kind, ns):
        if ns <= 0:
            return x
        use_cf = cf_order and lev.cmask is not None
        if kind == smoothers.RELAX_L1_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(lev.A, lev.dinv_l1,
                                                  lev.cmask, b, x, ns, 1.0)
            return smoothers.jacobi_sweeps(lev.A, lev.dinv_l1, b, x, ns, 1.0)
        if kind == smoothers.RELAX_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(lev.A, lev.dinv, lev.cmask,
                                                  b, x, ns, weight)
            return smoothers.jacobi_sweeps(lev.A, lev.dinv, b, x, ns, weight)
        if kind == smoothers.RELAX_CHEBYSHEV:
            for _ in range(ns):
                if cfg.cheby_variant == 4:
                    x = smoothers.chebyshev4_sweeps(lev.A, lev.dinv, b, x,
                                                    lev.cheby_bounds[1],
                                                    cfg.cheby_order)
                else:
                    x = smoothers.chebyshev_sweeps(lev.A, lev.dinv, b, x,
                                                   lev.cheby_bounds,
                                                   cfg.cheby_order)
            return x
        raise ValueError(kind)

    def cycle(l: int, b, x):
        lev = levels[l]
        if l == L - 1:
            if kind_coarse != smoothers.RELAX_DIRECT:
                # coarse-level relaxation (relax_coarse / num_coarse_sweeps,
                # ref: src/HypreSystem.cpp:129-151)
                return smooth(lev, b, x, kind_coarse, coarse_sweeps)
            rr = spmv_update(lev.A, x, b=b)
            return x + torch.matmul(pre.coarse_inv, rr)
        x = smooth(lev, b, x, kind_down, nu_down)
        rr = spmv_update(lev.A, x, b=b)
        rc = lev.restrict(rr) if lev.R is None else spmv(lev.R, rr)
        ec = torch.zeros(levels[l + 1].A.row_pad, dtype=b.dtype,
                         device=b.device)
        for _ in range(gamma):
            ec = cycle(l + 1, rc, ec)
        # the box transfer adds its correction into x, which the cycle owns
        x = (lev.prolong(ec, x, out=x) if lev.P is None
             else x + spmv(lev.P, ec))
        return smooth(lev, b, x, kind_up, nu_up)

    return lambda r: cycle(0, r, torch.zeros_like(r))
