"""LinearSystem — the run-orchestration layer (the port of
``tpusolve/harness/system.py``).

Analog of ``nalu::HypreSystem`` (ref: src/HypreSystem.h:66-298) with the same
8-method lifecycle, called in the reference's order (src/main.cpp:172-192)::

    sys = LinearSystem(config, device)
    sys.setup_precon_and_solver()
    sys.load()
    sys.solve()
    sys.check_solution()
    sys.output_linear_system()
    sys.summarize_timers()
    sys.destroy_system()

Timer names match the reference's.  The port carries MatrixMarket and
HYPRE-IJ loading and the generated 27-point stencil (``build_27pt_stencil``,
one part), ``matrix_ordering: rcm``, precision double/single/mixed, the
methods PCG, BiCGSTAB, GMRES, COGMRES and FlexGMRES, and the
preconditioners PFMG-style structured multigrid (on the stencil), BoomerAMG
(host setup, on loaded systems), ILU(0) (on loaded systems) and none;
anything else raises ``NotImplementedError`` naming where it stands in
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch.amg.builder import boomeramg_setup
from tpusolve_torch.amg.structured import (
    structured_mg_setup_fast, structured_possible)
from tpusolve_torch.config import AppConfig
from tpusolve_torch.formats import ij, mmio
from tpusolve_torch.harness.check import check_solution
from tpusolve_torch.ilu.ilu import ilu_setup
from tpusolve_torch.kernels import build
from tpusolve_torch.krylov.bicgstab import bicgstab_setup
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.krylov.gmres import (
    cogmres_setup, fgmres_setup, gmres_setup)
from tpusolve_torch.krylov.refine import refined_solve_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import (
    from_device_vector, to_device_vector)
from tpusolve_torch.parts import local_range, row_decomposition
from tpusolve_torch.stencil import laplace27
from tpusolve_torch.timers import Timers

_NOT_PORTED = "not ported yet; see ROADMAP.md Queue 1"


class LinearSystem:
    def __init__(self, config: AppConfig, device, verbose: bool = True):
        self.config = config
        self.device = torch.device(device)
        self.verbose = verbose
        self.timers = Timers(self.device)

        ls = config.linear_system
        self.rtol = ls.rtol
        self.atol = ls.atol
        self.check_enabled = False
        if ls.num_components > 1 and not ls.segregated_solve:
            raise NotImplementedError(f"coupled multi-component solve "
                                      f"{_NOT_PORTED}")
        for key in ("write_outputs", "write_solution", "write_amg_matrices"):
            if getattr(ls, key):
                raise NotImplementedError(f"{key}: {_NOT_PORTED}")
        if config.solver.reuse_preconditioner:
            raise NotImplementedError(f"reuse_preconditioner: {_NOT_PORTED}")

        prec = config.solver.precision
        if prec not in ("double", "single", "mixed"):
            raise ValueError(f"unknown precision: {prec}")
        self.precision = prec
        # "mixed": f32 operators for Krylov/preconditioner + an f64 copy for
        # iterative-refinement residuals
        self.dtype = np.float32 if prec == "single" else np.float64

        self.A: ShardedMatrix | None = None
        self.A_lo: ShardedMatrix | None = None   # f32 twin (mixed precision)
        self.A_host: sp.csr_matrix | None = None
        self.rhs: list[torch.Tensor] = []
        self.sln: list[torch.Tensor] = []
        self.sln_ref: list[np.ndarray] = []
        self.solve_results = []
        self._precond = None
        self._solver = None        # solve(b, x0=None) of the last solve()
        self._host_parts = None    # stencil's structured payload (pfmg)
        self._method = None
        self._precond_name = None
        self._perm = None          # matrix_ordering: new index -> old

    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    def setup_precon_and_solver(self):
        """Resolve method/preconditioner names (ref:
        src/HypreSystem.cpp:49-89); on a CUDA device, build the kernels the
        solve launches (the measured "Kernel build" row)."""
        s = self.config.solver
        method = s.method.lower()
        precond = (s.preconditioner or "none").lower()
        valid_methods = {"gmres", "cogmres", "fgmres", "bicg", "bicgstab",
                         "cg", "pcg", "boomeramg", "ilu"}
        if method not in valid_methods:
            raise ValueError(f"Invalid method provided: {method}")
        if precond not in {"boomeramg", "ilu", "none", "pfmg"}:
            raise ValueError(f"Invalid preconditioner provided: {precond}")
        if method in ("boomeramg", "ilu"):
            raise NotImplementedError(f"method {method} (the preconditioner "
                                      f"as the solver): {_NOT_PORTED}, "
                                      "item 10")
        self._method = method
        self._precond_name = precond
        self._log(f"Setting up solver: {method}; preconditioner: {precond}")
        if self.device.type == "cuda":
            with self.timers.span("Kernel build"):
                build.build_all()

    # ------------------------------------------------------------------
    def load(self):
        """Dispatch on linear_system.type (ref: src/HypreSystem.cpp:16-47)."""
        kind = self.config.linear_system.type
        if kind == "matrix_market":
            self._load_matrix_market()
        elif kind == "hypre_ij":
            self._load_hypre_ij()
        elif kind == "build_27pt_stencil":
            self._build_27pt_stencil()
        else:
            raise RuntimeError(f"Invalid linear system type option: {kind}")

    # ------------------------------------------------------------------
    def _apply_ordering(self, rows, cols, vals, n):
        """Optional global reordering A -> P A P^T (``matrix_ordering:
        rcm``): bandwidth reduction makes file-loaded systems eligible for
        the BDIA layout.  ``self._perm`` maps new index -> old and is applied
        to every vector staged afterwards."""
        ordering = self.config.solver.matrix_ordering
        if ordering in (None, "none"):
            return rows, cols, vals
        if ordering != "rcm":
            raise ValueError(f"unknown matrix_ordering: {ordering}")
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        pat = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                            shape=(n, n))
        perm = np.asarray(reverse_cuthill_mckee(pat + pat.T,
                                                symmetric_mode=True))
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        self._perm = perm          # new -> old
        self._log("  note: matrix_ordering: rcm applied (bandwidth "
                  "reduction for the blocked-DIA fast path)")
        return inv[rows], inv[cols], vals

    def _assemble(self, rows, cols, vals, n):
        """COO -> device matrix (+ its f32 twin) + host CSR for the
        preconditioner's host setup (AMG or ILU)."""
        rows, cols, vals = self._apply_ordering(rows, cols, vals, n)
        with self.timers.span("Initialize system"):
            offsets = row_decomposition(n, 1)
            lo, hi = local_range(offsets, 0)
            self._log(f"  Shard {0:4d}:: iLower = {lo:9d}; "
                      f"iUpper = {hi:9d}; numRows = {hi - lo + 1}")
        with self.timers.span("Assemble system"):
            self.A = ShardedMatrix.from_coo(
                (n, n), rows, cols, vals, device=self.device,
                dtype=self.dtype, row_offsets=offsets,
                allow_bdia=self.config.solver.spmv_use_bdia,
                allow_bell=self.config.solver.spmv_use_bell)
            if self.precision == "mixed":
                # f32 twin by a device-side cast, not a second assembly
                self.A_lo = self.A.astype(np.float32)
            if self._precond_name in ("boomeramg", "ilu"):
                self.A_host = sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n, n))
                self.A_host.sum_duplicates()
        self._log(f"  A: {self.A.layout}")

    def _permute_in(self, vec_np):
        return vec_np[self._perm] if self._perm is not None else vec_np

    def _stage_vector(self, vec_np):
        return to_device_vector(self._permute_in(vec_np), self.A.row_offsets,
                                self.A.row_pad, self.device, dtype=self.dtype)

    def _load_matrix_market(self):
        ls = self.config.linear_system
        with self.timers.span("Matrix market : determine system size"):
            info = mmio.read_info(ls.matrix_file)
            n = info.nrows * (2 if ls.complex_numbers else 1)
        self._log(f"Loading matrix market file: {ls.matrix_file} "
                  f"({n} rows)")
        with self.timers.span("Matrix market : read and build matrix"):
            rows, cols, vals, shape = mmio.read_matrix(ls.matrix_file)
            if ls.complex_numbers:
                rows, cols, vals, shape = mmio.expand_complex_to_real(
                    rows, cols, vals, shape)
            elif np.iscomplexobj(vals):
                raise RuntimeError(
                    "complex matrix file requires complex_numbers: true")
        self._assemble(rows, cols, np.real(vals), n)
        with self.timers.span("Matrix market : read and build vector"):
            for rf in ls.rhs_files:
                v = mmio.read_vector(rf)
                if ls.complex_numbers:
                    v = mmio.expand_complex_vector(v)
                self.rhs.append(self._stage_vector(np.real(v)))
            for sf in ls.sln_files:
                v = mmio.read_vector(sf)
                if ls.complex_numbers:
                    v = mmio.expand_complex_vector(v)
                self.sln_ref.append(self._permute_in(np.real(v)))
        self.check_enabled = bool(self.sln_ref) and \
            len(self.sln_ref) == len(self.rhs)

    def _load_hypre_ij(self):
        ls = self.config.linear_system
        nfiles = ls.num_partitions or 1
        with self.timers.span("IJ : determine system size"):
            n = ij.num_global_rows(ls.matrix_file, nfiles)
        self._log(f"Loading HYPRE IJ files: {ls.matrix_file} x{nfiles} "
                  f"({n} rows)")
        with self.timers.span("IJ : read and build matrix"):
            rows, cols, vals = ij.read_matrix(ls.matrix_file, nfiles)
        self._assemble(rows, cols, vals, n)
        with self.timers.span("IJ : read and build vector"):
            for rf in ls.rhs_files:
                self.rhs.append(self._stage_vector(
                    ij.read_dense_vector(rf, nfiles, n)))
            for sf in ls.sln_files:
                self.sln_ref.append(self._permute_in(
                    ij.read_dense_vector(sf, nfiles, n)))
        self.check_enabled = bool(self.sln_ref) and \
            len(self.sln_ref) == len(self.rhs)

    def _build_27pt_stencil(self):
        """The generated 27-point system, one part of nx x ny x nz rows
        (``tpusolve``'s ``_build_27pt_stencil``, its host branches).  PFMG
        takes the generator's structured payload; BoomerAMG and ILU on the
        stencil need its host CSR and are not ported (ROADMAP Queue 1
        item 10), nor is the on-device generation (item 15)."""
        ls = self.config.linear_system
        if self._precond_name in ("boomeramg", "ilu"):
            raise NotImplementedError(
                f"preconditioner {self._precond_name} on build_27pt_stencil "
                f"(needs the stencil's host CSR): {_NOT_PORTED}, item 10")
        with self.timers.span("Build 27Pt Stencil HYPRE matrix"):
            if self._precond_name == "pfmg" and min(ls.nx, ls.ny) >= 3:
                # structured payload reuses the generator's arrays and the
                # matrix-free setup never needs a host CSR
                A, b, _, self._host_parts = laplace27(
                    ls.nx, ls.ny, ls.nz, device=self.device,
                    dtype=self.dtype, with_parts=True)
            else:
                A, b, _ = laplace27(ls.nx, ls.ny, ls.nz, device=self.device,
                                    dtype=self.dtype)
            self.A = A
            if self.precision == "mixed":
                self.A_lo = A.astype(np.float32)
            self.rhs = [b]
            self.sln_ref = [np.ones(A.shape[0])]
        self._log(f"Built 27-pt stencil system: {ls.nx}x{ls.ny}x{ls.nz} "
                  f"per device, {A.shape[0]} global rows")
        self._log(f"  A: {self.A.layout}")
        self.check_enabled = True

    # ------------------------------------------------------------------
    @property
    def _A_solve(self):
        """Operator the Krylov/preconditioner machinery runs on."""
        return self.A_lo if self.precision == "mixed" else self.A

    def _build_solver(self, M):
        s = self.config.solver
        mixed = self.precision == "mixed"
        # mixed precision: the inner f32 solve only needs to reach the f32
        # floor; the IR outer loop carries it to s.tolerance
        inner_tol = float(s.extra.get("inner_tolerance", 1e-5))
        kw = dict(tol=inner_tol if mixed else s.tolerance,
                  maxiter=s.max_iterations)
        A = self._A_solve
        if self._method in ("cg", "pcg"):
            inner = pcg_setup(A, M, **kw)
        elif self._method == "gmres":
            inner = gmres_setup(A, M, restart=s.kspace, **kw)
        elif self._method == "cogmres":
            inner = cogmres_setup(A, M, restart=s.kspace, cgs=s.cgs, **kw)
        elif self._method == "fgmres":
            inner = fgmres_setup(A, M, restart=s.kspace, **kw)
        else:
            inner = bicgstab_setup(A, M, **kw)
        if mixed:
            return refined_solve_setup(
                self.A, inner, tol=s.tolerance,
                max_refine=int(s.extra.get("max_refine", 6)))
        return inner

    def solve(self):
        """Preconditioner setup + solve per component
        (ref: src/HypreSystem.cpp:673-737)."""
        with self.timers.span("Preconditioner setup"):
            M = None
            if self._precond_name == "ilu":
                self._precond = ilu_setup(self._A_solve, self.config.ilu,
                                          A_host=self.A_host)
                M = self._precond.apply
                self._log(f"  ILU L: {self._precond.L.layout}; "
                          f"U: {self._precond.U.layout}")
            elif self._precond_name == "pfmg":
                if not structured_possible(self._A_solve):
                    raise ValueError("pfmg requires a structured "
                                     "(box-generated) operator")
                self._precond = structured_mg_setup_fast(
                    self._A_solve, self.config.boomeramg,
                    host_parts=self._host_parts)
                M = self._precond.apply
                if self.verbose:
                    self._log(self._precond.describe())
                    for line in self._precond.layouts():
                        self._log(f"  {line}")
            elif self._precond_name == "boomeramg":
                self._precond = boomeramg_setup(
                    self._A_solve, self.config.boomeramg, A_host=self.A_host)
                M = self._precond.apply
                if self.verbose:
                    self._log(self._precond.describe())
                    for line in self._precond.layouts():
                        self._log(f"  {line}")
            solver = self._solver = self._build_solver(M)

        with self.timers.span("Solve"):
            self.solve_results = [solver(b) for b in self.rhs]
            self.sln = [res.x for res in self.solve_results]

        for i, res in enumerate(self.solve_results):
            self._log(f"Solve {i}: iters={int(res.iters)} "
                      f"relres={float(res.relres):.3e} "
                      f"converged={bool(res.converged)}")
            if res.passes is not None:
                self._log(f"  refinement passes: {len(res.passes)} "
                          f"(inner iterations {res.passes})")
            if self.config.solver.print_level >= 4 and res.history is not None:
                h = res.history.cpu().numpy()
                h = h[h >= 0]
                for k, rn in enumerate(h):
                    self._log(f"    iter {k:4d}  ||r|| = {rn:.6e}")

    # ------------------------------------------------------------------
    def check_solution(self):
        """Golden check (ref: src/HypreSystem.cpp:771-845)."""
        if not self.check_enabled:
            self._log("Solution check skipped (no reference solution)")
            return True
        with self.timers.span("Check solution"):
            all_pass = True
            for i, x_dev in enumerate(self.sln):
                x = from_device_vector(x_dev, self.A.row_offsets,
                                       self.A.row_pad)
                passed, _ = check_solution(x, self.sln_ref[i], self.rtol,
                                           self.atol, verbose=self.verbose)
                all_pass &= passed
        return all_pass

    def output_linear_system(self):
        """File output (ref: src/HypreSystem.cpp:739-769): refused at
        construction in this slice, so nothing to write."""

    def summarize_timers(self):
        self._log(self.timers.summarize())

    def retrieve_timers(self, profile):
        profile.append(self.timers)

    def destroy_system(self):
        self.A = None
        self.A_lo = None
        self.A_host = None
        self.rhs = []
        self.sln = []
        self._precond = None
        self._solver = None
        self._host_parts = None
