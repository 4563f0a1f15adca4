"""LinearSystem — the run-orchestration layer (the port of
``tpusolve/harness/system.py``).

Analog of ``nalu::HypreSystem`` (ref: src/HypreSystem.h:66-298) with the same
8-method lifecycle, called in the reference's order (src/main.cpp:172-192)::

    sys = LinearSystem(config, device, nparts=1)
    sys.setup_precon_and_solver()
    sys.load()
    sys.solve()
    sys.check_solution()
    sys.output_linear_system()
    sys.summarize_timers()
    sys.destroy_system()

Timer names match the reference's.  ``nparts`` is ``tpusolve``'s mesh
size: the rows split over that many parts, stacked on the one device.  The
port carries MatrixMarket and HYPRE-IJ loading and the generated 27-point
stencil (``build_27pt_stencil``, an nx x ny x nz box a part),
``matrix_ordering: rcm``, precision double/single/mixed, the
methods PCG, BiCGSTAB, GMRES, COGMRES and FlexGMRES and the stationary
solvers BoomerAMG and ILU, the preconditioners PFMG-style structured
multigrid (on the stencil), BoomerAMG (level 0 set up on the device for a
large stencil, ``amg/device_setup.py``), ILU (ILU(0) of a large DIA or ELL
operator factored on the device, ``ilu/device_setup.py``) and none, file
output (``write_outputs``, ``write_solution``, ``write_amg_matrices``),
``reuse_preconditioner`` across the CLI's tests, and the multi-component
solve, segregated (one solve a component) or coupled
(``segregated_solve: false``: one solver call on the stacked right-hand
sides, ``tpusolve``'s ``vmap`` path, each column frozen once it stops;
``krylov/common.py``).

Across R processes (``dist.py``, ``python -m torch.distributed.run``) each
rank holds N / R of the ``nparts`` parts: it reads only its rows from the
files (``dist.host_row_range``; the IJ reader parses only the part files
that meet them), skips RCM with ``tpusolve``'s note (no rank holds the
global pattern), gathers the global COO (``dist.allgather_host_coo``) for
the assembly and the host setups, which every rank runs on the same bits
and keeps its parts of (``dist.place``), stages its parts of each vector,
and checks its own rows, the verdict reduced over the ranks (the
reference's per-rank check, src/HypreSystem.cpp:771-845).  The generated
stencil is generated by rank: each rank builds only its parts (the PFMG,
host-CSR and operator-only branches; the lattice branch raises, ROADMAP.md
Queue 1 item 19).
"""

from __future__ import annotations


import numpy as np
import scipy.sparse as sp
import torch

from tpusolve_torch import dist
from tpusolve_torch.amg import device_setup
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
from tpusolve_torch.krylov.stationary import stationary_solve_setup
from tpusolve_torch.matrix import coo as coo_mod
from tpusolve_torch.matrix.sharded import ShardedMatrix
from tpusolve_torch.matrix.vectors import (
    from_device_vector, to_device_vector)
from tpusolve_torch.parts import local_range, row_decomposition
from tpusolve_torch.stencil import laplace27
from tpusolve_torch.timers import Timers

class LinearSystem:
    def __init__(self, config: AppConfig, device, nparts: int = 1,
                 verbose: bool = True, reuse_cache: dict | None = None):
        self.config = config
        self.device = torch.device(device)
        if nparts < 1:
            raise ValueError(f"nparts must be positive, got {nparts}")
        self.nparts = int(nparts)
        if self.nparts % dist.world():
            raise ValueError(f"{nparts} parts do not split over "
                             f"{dist.world()} processes")
        self.verbose = verbose
        grp = dist.group()
        self.timers = Timers(self.device, label=None if grp is None
                             else f"rank {grp.rank}")
        # reuse_preconditioner: the CLI passes one dict across its tests;
        # the first test's solver and preconditioner are kept there and
        # later tests skip their setup (the same system each test)
        self._reuse_cache = reuse_cache

        ls = config.linear_system
        self.rtol = ls.rtol
        self.atol = ls.atol
        self.check_enabled = False
        self.segregated = ls.segregated_solve

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
        self._lattice = None       # its lattice planes (BoomerAMG, N parts)
        self._method = None
        self._precond_name = None
        self._perm = None          # matrix_ordering: new index -> old
        # what this rank read: its inclusive rows, the files it parsed and
        # the matrix entries it kept
        self.rows_read: tuple[int, int] | None = None
        self.files_read: list[str] = []
        self.entries_read = 0

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
        lo, hi = self._host_range(n)
        if lo != 0 or hi != n - 1:
            self._log("  note: matrix_ordering: rcm skipped (global "
                      "pattern not local to this host)")
            return rows, cols, vals
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
        preconditioner's host setup (:meth:`_needs_host_csr`).  Across
        ranks the rows each read are gathered first: every rank assembles
        the whole operator on the host and keeps its parts
        (``dist.place``)."""
        self.entries_read = int(np.size(rows))
        rows, cols, vals = self._apply_ordering(rows, cols, vals, n)
        if dist.world() > 1:
            # each rank sorts and combines its own rows first: the gathered
            # COO is then in order, which the assembly's sort keeps
            rows, cols, vals = coo_mod.dedup_coo(rows, cols, vals)
            rows, cols, vals = dist.allgather_host_coo(rows, cols, vals)
        with self.timers.span("Initialize system"):
            offsets = row_decomposition(n, self.nparts)
            for p in range(min(self.nparts, 8)):
                lo, hi = local_range(offsets, p)
                self._log(f"  Shard {p:4d}:: iLower = {lo:9d}; "
                          f"iUpper = {hi:9d}; numRows = {hi - lo + 1}")
        with self.timers.span("Assemble system"):
            A = ShardedMatrix.from_coo(
                (n, n), rows, cols, vals, device=dist.staging(self.device),
                dtype=self.dtype, row_offsets=offsets,
                allow_dia=self.config.solver.spmv_use_dia,
                allow_bdia=self.config.solver.spmv_use_bdia,
                allow_bell=self.config.solver.spmv_use_bell)
            if self.precision == "mixed":
                # f32 twin by a device-side cast, not a second assembly
                self.A_lo = dist.place(A.astype(np.float32))
            self.A = dist.place(A)
            if self._needs_host_csr():
                self.A_host = sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n, n))
                self.A_host.sum_duplicates()
        self._log(f"  A: {self.A.layout}")

    def _host_range(self, n: int) -> tuple[int, int]:
        """The inclusive rows this rank reads and stages: every row in one
        process (``tpusolve``'s ``_host_range``)."""
        return dist.host_row_range(row_decomposition(n, self.nparts))

    def _needs_host_csr(self) -> bool:
        """Keep a host CSR only for consumers that set up on the host (AMG,
        ILU, PFMG on a loaded system); with preconditioner ``none`` it
        would be waste."""
        return (self._precond_name in ("boomeramg", "ilu", "pfmg")
                or self._method in ("boomeramg", "ilu")
                or self.config.linear_system.write_outputs)

    def _permute_in(self, vec_np):
        return vec_np[self._perm] if self._perm is not None else vec_np

    def _permute_out(self, vec_np):
        """A vector of the solve's (reordered) basis in the original one,
        for the file writers."""
        if self._perm is None:
            return vec_np
        out = np.empty_like(vec_np)
        out[self._perm] = vec_np
        return out

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
            # a rank keeps its rows (src/HypreSystem.cpp:1751-1835), of
            # the real form where the file is complex
            rr = self.rows_read = self._host_range(n)
            self.files_read = [ls.matrix_file] + ls.rhs_files + ls.sln_files
            rows, cols, vals, shape = mmio.read_matrix(
                ls.matrix_file,
                row_range=None if ls.complex_numbers else rr)
            if ls.complex_numbers:
                rows, cols, vals, shape = mmio.expand_complex_to_real(
                    rows, cols, vals, shape)
                keep = (rows >= rr[0]) & (rows <= rr[1])
                rows, cols, vals = rows[keep], cols[keep], vals[keep]
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
            # a rank parses only the part files that meet its rows
            # (src/HypreSystem.cpp:1147, 1203-1236)
            rr = self.rows_read = self._host_range(n)
            start = len(ij.PARSED)
            rows, cols, vals = ij.read_matrix(ls.matrix_file, nfiles,
                                              row_range=rr)
        self._assemble(rows, cols, vals, n)
        with self.timers.span("IJ : read and build vector"):
            for rf in ls.rhs_files:
                self.rhs.append(self._stage_vector(
                    ij.read_dense_vector(rf, nfiles, n, row_range=rr)))
            for sf in ls.sln_files:
                self.sln_ref.append(self._permute_in(
                    ij.read_dense_vector(sf, nfiles, n, row_range=rr)))
        self.files_read = ij.PARSED[start:]
        self.check_enabled = bool(self.sln_ref) and \
            len(self.sln_ref) == len(self.rhs)

    def _build_27pt_stencil(self):
        """The generated 27-point system, one part of nx x ny x nz rows
        (``tpusolve``'s ``_build_27pt_stencil``), in its order of branches:
        PFMG takes the generator's structured payload; BoomerAMG whose level
        0 is set up on the device (:meth:`_device_amg`) needs no host CSR;
        other host setups (BoomerAMG, ILU) take the host CSR; else the
        operator alone.  The device-setup and operator-only branches
        generate the planes on the device by ``tpusolve``'s rule
        (``stencil.generates_on_device``: a plane stack of 128 MB or more on
        a device that is not the CPU); the PFMG and host-CSR branches build
        them on the host, as there.
        On N parts the device-setup branch is ``tpusolve``'s lattice branch
        (``tpusolve/harness/system.py:295-322``): the generator also returns
        each part's full-lattice planes, which BoomerAMG's sharded lattice
        setup takes (``lattice_parts``).

        Across ranks each rank generates only its parts
        (``laplace27``'s ``rank_parts``): its slice of the operator, its
        rows of the right-hand side and, for a host setup, its rows of the
        host CSR, which the ranks gather (``dist.gather_scipy``).  The
        lattice branch raises in BoomerAMG's setup, and a box under 3 x 3
        (the COO path) here (ROADMAP.md Queue 1 item 19)."""
        ls = self.config.linear_system
        n = ls.nx * ls.ny * ls.nz * self.nparts
        rank_parts = None
        if dist.world() > 1:
            if min(ls.nx, ls.ny) < 3:
                dist.refuse("the generated stencil on a box under 3 x 3 "
                            "(its COO path)")
            rank_parts = dist.rank_parts(self.nparts) + (dist.world(),)
        self.rows_read = self._host_range(n)
        with self.timers.span("Build 27Pt Stencil HYPRE matrix"):
            kw = dict(device=self.device, dtype=self.dtype,
                      nparts=self.nparts, rank_parts=rank_parts)
            if self._precond_name == "pfmg" and min(ls.nx, ls.ny) >= 3:
                # structured payload reuses the generator's arrays and the
                # matrix-free setup never needs a host CSR
                A, b, _, self._host_parts = laplace27(
                    ls.nx, ls.ny, ls.nz, with_parts=True, **kw)
            elif self._device_amg() and self.nparts > 1:
                A, b, _, self._lattice = laplace27(
                    ls.nx, ls.ny, ls.nz, with_lattice=True, **kw)
            elif self._device_amg():
                A, b, _ = laplace27(ls.nx, ls.ny, ls.nz, **kw)
            elif self._needs_host_csr():
                A, b, _, A_host = laplace27(
                    ls.nx, ls.ny, ls.nz, with_host=True, **kw)
                # every rank's rows (the CSR itself in one process)
                self.A_host = dist.gather_scipy(A_host)
            else:
                A, b, _ = laplace27(ls.nx, ls.ny, ls.nz, **kw)
            self.A = A
            if self.precision == "mixed":
                self.A_lo = A.astype(np.float32)
            self.rhs = [b]
            self.sln_ref = [np.ones(A.shape[0])]
        self._log(f"Built 27-pt stencil system: {ls.nx}x{ls.ny}x{ls.nz} "
                  f"per device, {A.shape[0]} global rows"
                  + ("" if rank_parts is None else
                     f", rows {self.rows_read[0]}..{self.rows_read[1]} "
                     f"(parts {rank_parts[0]}..{rank_parts[1] - 1}) on "
                     f"this rank"))
        self._log(f"  A: {self.A.layout}")
        self.check_enabled = True

    @property
    def planes_bytes(self) -> int:
        """The bytes of the box-DIA planes this process holds for A (and
        its f32 twin): every part's in one process, a rank's own parts'
        across ranks."""
        return sum(M.dia_vals.numel() * M.dia_vals.element_size()
                   for M in (self.A, self.A_lo)
                   if M is not None and M.dia_vals is not None)

    def _device_amg(self) -> bool:
        """Whether BoomerAMG will set level 0 of the stencil up on the
        device (``tpusolve``'s ``dev_amg``): a box-DIA operator (nx, ny >=
        3) of at least ``device_setup.MIN_DEVICE_N`` rows, no file output,
        no reordering and an eligible config."""
        ls = self.config.linear_system
        return ((self._precond_name == "boomeramg"
                 or self._method == "boomeramg")
                and min(ls.nx, ls.ny) >= 3
                and ls.nx * ls.ny * ls.nz * self.nparts
                >= device_setup.MIN_DEVICE_N
                and not ls.write_outputs
                and self.config.solver.matrix_ordering == "none"
                and device_setup.config_eligible(self.config.boomeramg))

    # ------------------------------------------------------------------
    @property
    def _A_solve(self):
        """Operator the Krylov/preconditioner machinery runs on."""
        return self.A_lo if self.precision == "mixed" else self.A

    def _setup_preconditioner(self, name: str):
        """Build preconditioner ``name`` (``ilu``, ``pfmg`` or
        ``boomeramg``) on the solve operator and log what it is."""
        A = self._A_solve
        if name == "ilu":
            pre = ilu_setup(A, self.config.ilu, A_host=self.A_host)
            self._log(f"  ILU L: {pre.L.layout}; U: {pre.U.layout}")
            for note in pre.notes:
                self._log(f"  note: {note}")
            return pre
        if name == "pfmg":
            if not structured_possible(A):
                raise ValueError("pfmg requires a structured "
                                 "(box-generated) operator")
            pre = structured_mg_setup_fast(A, self.config.boomeramg,
                                           host_parts=self._host_parts)
        else:
            pre = boomeramg_setup(A, self.config.boomeramg,
                                  A_host=self.A_host,
                                  lattice_parts=self._lattice)
        if self.verbose:
            self._log(pre.describe())
            for line in pre.layouts():
                self._log(f"  {line}")
        return pre

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
        elif self._method in ("bicg", "bicgstab"):
            inner = bicgstab_setup(A, M, **kw)
        else:
            # AMG or ILU as the solver (ref: setup_boomeramg_solver,
            # src/HypreSystem.cpp:91-117; setup_ilu, :457-497): stationary
            # iterations x <- x + M(b - A x) on _A_solve
            inner = stationary_solve_setup(A, self._precond.apply, **kw)
        if mixed:
            return refined_solve_setup(
                self.A, inner, tol=s.tolerance,
                max_refine=int(s.extra.get("max_refine", 6)))
        return inner

    def solve(self):
        """Preconditioner setup + solve per component
        (ref: src/HypreSystem.cpp:673-737).  For ``method: boomeramg |
        ilu`` the method's own setup takes the preconditioner's place."""
        with self.timers.span("Preconditioner setup"):
            cache = self._reuse_cache
            if cache is not None and "solver" in cache:
                self._log("Reusing preconditioner/solver from previous test")
                self._precond = cache["precond"]
                solver = self._solver = cache["solver"]
            else:
                M = None
                if self._method in ("boomeramg", "ilu"):
                    self._precond = self._setup_preconditioner(self._method)
                elif self._precond_name != "none":
                    self._precond = self._setup_preconditioner(
                        self._precond_name)
                    M = self._precond.apply
                solver = self._solver = self._build_solver(M)
                if cache is not None:
                    cache["solver"] = solver
                    cache["precond"] = self._precond

        if self.config.linear_system.write_amg_matrices and \
                hasattr(self._precond, "levels"):
            with self.timers.span("Write AMG Matrices"):
                self._write_amg_matrices()

        with self.timers.span("Solve"):
            if self.segregated or len(self.rhs) <= 1:
                self.solve_results = [solver(b) for b in self.rhs]
            else:
                # coupled multi-component solve: one call on the stacked
                # right-hand sides (the reference's multivector path,
                # src/HypreSystem.h:261-263)
                res = solver(torch.stack(self.rhs))
                self.solve_results = [res.column(i)
                                      for i in range(len(self.rhs))]
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
            lo, hi = self.A.row_offsets[0], self.A.row_offsets[-1]
            for i, x_dev in enumerate(self.sln):
                x = from_device_vector(x_dev, self.A.row_offsets,
                                       self.A.row_pad)
                if dist.world() == 1:
                    passed, _ = check_solution(x, self.sln_ref[i], self.rtol,
                                               self.atol,
                                               verbose=self.verbose)
                else:
                    # this rank's rows, the verdict reduced over the ranks
                    _, nbad = check_solution(
                        x[lo:hi], self.sln_ref[i][lo:hi], self.rtol,
                        self.atol, verbose=self.verbose, row0=lo,
                        verdict=False)
                    total = dist.sum_int(nbad)
                    passed = total == 0
                    self._log(f"Check solution (rank {dist.rank()}, rows "
                              f"{lo}..{hi - 1}): {nbad} rows bad")
                    self._log("Check solution: PASSED" if passed else
                              f"Check solution: FAILED ({total} rows)")
                all_pass &= passed
        return all_pass

    def output_linear_system(self):
        """Write the matrix, right-hand sides and solutions as HYPRE-IJ files
        (ref: src/HypreSystem.cpp:739-769): ``output_matrix_name``,
        ``IJV<i>.rhs`` and ``IJV<i>.sln``, in the original index space under
        ``matrix_ordering``, so that the files hold A x = b in the
        reference's numbering."""
        ls = self.config.linear_system
        if not (ls.write_outputs or ls.write_solution):
            return
        with self.timers.span("Output system"):
            offsets = np.asarray(self.A.all_row_offsets)
            host = lambda v: self._permute_out(dist.fetch_host(
                v, offsets))
            if dist.rank() != 0:
                # rank 0 writes; the others join its gathers
                for v in (self.rhs if ls.write_outputs else []) + self.sln:
                    host(v)
                return
            if ls.write_outputs:
                Ah = self.A_host if self.A_host is not None else \
                    self.A.to_scipy()
                Ac = Ah.tocoo()
                arow, acol = Ac.row, Ac.col
                if self._perm is not None:
                    arow, acol = self._perm[arow], self._perm[acol]
                ij.write_matrix(ls.output_matrix_name, arow, acol, Ac.data,
                                offsets, ncols=self.A.shape[1])
                for i, b in enumerate(self.rhs):
                    ij.write_vector(f"IJV{i}.rhs", host(b), offsets)
            for i, x in enumerate(self.sln):
                ij.write_vector(f"IJV{i}.sln", host(x), offsets)

    def _write_amg_matrices(self):
        """Each AMG level's operator as HYPRE-IJ files ``IJM.mat_level_<l>``
        (ref: src/HypreSystem.cpp:700-714), which the hypre_ij reader loads
        again."""
        for lvl, level in enumerate(self._precond.levels):
            Mh = dist.gather_scipy(level.A.to_scipy()).tocoo()
            if dist.rank() == 0:
                ij.write_matrix(f"IJM.mat_level_{lvl}", Mh.row, Mh.col,
                                Mh.data, np.asarray(level.A.all_row_offsets),
                                ncols=level.A.shape[1])

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
