"""YAML configuration schema (the port of ``tpusolve/config.py``).

Same file layout, key names and dataclasses as ``tpusolve`` (reference:
etc/hypre_app.yaml:1-42; ``get_optional`` at src/HypreSystem.h:57-64).  Four
sections: ``linear_system``, ``solver_settings``, ``boomeramg_settings`` and
``ilu_preconditioner_settings``.  Unknown keys are kept in ``extra``.
PyYAML parses the file, as in ``tpusolve``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import yaml


def get_optional(node: dict | None, key: str, default):
    """Reference semantics (src/HypreSystem.h:57-64): value if present,
    else default."""
    if node is None:
        return default
    val = node.get(key, default)
    if val is None:
        return default
    if default is not None and not isinstance(default, bool) and isinstance(val, bool):
        return val
    if isinstance(default, bool):
        return bool(val)
    if isinstance(default, int) and not isinstance(default, bool) and not isinstance(val, float):
        return int(val)
    if isinstance(default, float):
        return float(val)
    return val


@dataclass
class LinearSystemConfig:
    type: str = "matrix_market"   # matrix_market | hypre_ij | build_27pt_stencil
    matrix_file: str | None = None
    rhs_file: str | None = None
    sln_file: str | None = None
    rhs_files: list[str] = field(default_factory=list)   # rhs_file0..N
    sln_files: list[str] = field(default_factory=list)
    num_partitions: int | None = None    # IJ file count
    num_components: int = 1
    segregated_solve: bool = True
    complex_numbers: bool = False
    rtol: float = 1.0e-6                 # golden-check tolerances
    atol: float = 1.0e-8                 # (ref defaults src/HypreSystem.h:296-297)
    nx: int = 128
    ny: int = 128
    nz: int = 128
    write_outputs: bool = False
    write_solution: bool = False
    write_amg_matrices: bool = False
    output_matrix_name: str = "IJM.mat"
    extra: dict = field(default_factory=dict)


@dataclass
class SolverConfig:
    method: str = "gmres"        # gmres|cogmres|fgmres|bicg|cg|boomeramg|ilu
    preconditioner: str = "boomeramg"   # boomeramg|ilu|none
    tolerance: float = 1.0e-5
    max_iterations: int = 1000
    kspace: int = 10
    cgs: int = 1
    print_level: int = 1
    num_tests: int = 1
    csv_profile_file: str | None = None
    spmv_use_dia: bool = True
    spmv_use_bell: bool = True
    spmv_use_bdia: bool = True
    matrix_ordering: str = "none"        # none | rcm
    reuse_preconditioner: bool = False
    precision: str = "double"            # double | single | mixed
    extra: dict = field(default_factory=dict)


@dataclass
class BoomerAMGConfig:
    print_level: int = 1
    max_iterations: int = 1
    tolerance: float = 0.0
    coarsen_type: int = 8
    cycle_type: int = 1
    relax_type: int = 6
    relax_order: int = 0
    relax_down: int | None = None
    relax_up: int | None = None
    relax_coarse: int | None = None
    num_sweeps: int = 1
    num_down_sweeps: int | None = None
    num_up_sweeps: int | None = None
    num_coarse_sweeps: int | None = None
    strong_threshold: float = 0.57
    max_levels: int = 20
    min_coarse_size: int | None = None
    max_coarse_size: int = 64
    interp_type: int = 0
    trunc_factor: float = 0.0
    p_max_elmts: int = 0
    agg_num_levels: int = 0
    agg_interp_type: int = 4
    rap2: int = 0
    keep_transpose: int = 0
    non_galerkin_tol: float = 0.0
    nongalerk_tol: list[float] = field(default_factory=list)
    variant: int | None = None
    smooth_type: int | None = None
    smooth_num_sweeps: int = 1
    smooth_num_levels: int = 0
    smoother_dtype: str = "match"
    cheby_order: int = 2
    cheby_fraction: float = 0.3
    cheby_variant: int = 0
    extra: dict = field(default_factory=dict)


@dataclass
class ILUConfig:
    ilu_type: int = 0              # 0=ILU(k) local
    ilu_fill_level: int = 0
    ilu_drop_threshold: float = 1.0e-2
    ilu_max_nnz_per_row: int = 100
    ilu_max_iterations: int = 1
    ilu_tolerance: float = 0.0
    ilu_local_reordering: int = 0
    ilu_print_level: int = 0
    ilu_tri_solve: int = 0         # 0 = Jacobi-iteration trisolve
    ilu_lower_jacobi_iters: int = 5
    ilu_upper_jacobi_iters: int = 5
    ilu_iterative_setup_type: int = 0
    ilu_iterative_setup_option: int = 0
    ilu_iterative_setup_max_iter: int = 1
    ilu_iterative_setup_tolerance: float = 0.0
    extra: dict = field(default_factory=dict)


@dataclass
class AppConfig:
    linear_system: LinearSystemConfig
    solver: SolverConfig
    boomeramg: BoomerAMGConfig
    ilu: ILUConfig
    raw: dict = field(default_factory=dict)


def _fill(dc_cls, node: dict | None):
    node = dict(node or {})
    known = {f for f in dc_cls.__dataclass_fields__ if f != "extra"}
    obj = dc_cls(**{k: v for k, v in node.items() if k in known})
    obj.extra = {k: v for k, v in node.items() if k not in known}
    return obj


def parse_config(doc: dict) -> AppConfig:
    linsys_node = doc.get("linear_system", {}) or {}
    solver_node = doc.get("solver_settings", {}) or {}

    linsys = _fill(LinearSystemConfig, linsys_node)
    # multi-component rhs_file0..N / sln_file0..N (ref: src/HypreSystem.cpp:1636-1645)
    ncomp = linsys.num_components
    if ncomp > 1:
        missing = [f"rhs_file{i}" for i in range(ncomp)
                   if linsys_node.get(f"rhs_file{i}") is None]
        if missing:
            raise ValueError(
                f"num_components={ncomp} requires rhs_file0..rhs_file{ncomp-1}"
                f"; missing: {', '.join(missing)}")
        linsys.rhs_files = [linsys_node.get(f"rhs_file{i}") for i in range(ncomp)]
        slns = [linsys_node.get(f"sln_file{i}") for i in range(ncomp)]
        if all(s is not None for s in slns):
            linsys.sln_files = slns
    else:
        if linsys.rhs_file:
            linsys.rhs_files = [linsys.rhs_file]
        if linsys.sln_file:
            linsys.sln_files = [linsys.sln_file]

    solver = _fill(SolverConfig, solver_node)
    # ILU-as-solver keys live in solver_settings (ref: src/HypreSystem.cpp:459-486)
    ilu_node = dict(doc.get("ilu_preconditioner_settings", {}) or {})
    for k in list(solver.extra):
        if k.startswith("ilu_"):
            ilu_node.setdefault(k, solver.extra[k])
    ilu = _fill(ILUConfig, ilu_node)
    amg = _fill(BoomerAMGConfig, doc.get("boomeramg_settings", {}))
    return AppConfig(linear_system=linsys, solver=solver, boomeramg=amg,
                     ilu=ilu, raw=doc)


def load_config(path: str) -> AppConfig:
    with open(path) as fh:
        doc = yaml.safe_load(fh) or {}
    return parse_config(doc)
