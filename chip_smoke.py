#!/usr/bin/env python3
"""Smoke run of tpusolve_torch on one CUDA card.

    python3 chip_smoke.py [--side N] [--side3 N] [--side-ilu N]
    python3 chip_smoke.py --ranks-profile

From the root of a checkout, on a machine with one NVIDIA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

1. prints the card's name and power limit, and the PyYAML version;
2. builds every kernel of ``tpusolve_torch/csrc`` (one nvcc per source, all
   at once) and prints the seconds;
3. holds the BDIA SpMV kernels K4 and K5, overflow list included, and the
   BELL SpMV kernel K6 against their plain PyTorch versions, in float32 and
   float64, and K5 with and without its segment mask against K4 bit for
   bit, once on an x that is not 16-byte aligned, K5's update forms (the
   ILU sweeps') against the plain update of its product bit for bit, and
   K4's launch plans (a small launch of wide blocks run as
   chunks, an operator of 640 slots) against K5 bit for bit; the ELL SpMV
   kernel K2 against its plain version on ragged square and rectangular
   operators of K = 1, 8, 40, 131 and 638 slots, in f32 and f64, in both
   storage forms (padded, row-pointer), at every threads-a-row count and
   in every update form, in place too, the same bits in both forms;
4. gate 4: writes the momentum fixture at N^3 rows (``--side``, default
   96^3 = 884,736 rows, 23.4M nonzeros) and runs it through the port's CLI
   (``tpusolve_torch.harness.cli.main``): HYPRE-IJ files read by the native
   parser, RCM, BDIA assembly in f64 with an f32 twin, Chow-Patel ILU(0)
   whose operators run K2, K4 or K5 as the time model prices them (the
   factors K5, its Jacobi sweeps fused into its launches), BiCGSTAB in
   f32 inside f64 iterative refinement, golden check (at 96^3 exactly the
   port's 55 iterations); then at the four operator shapes of that run (A,
   A_lo, L, U) on their BDIA layouts times K4, K5 where a step plan fits
   (the bytes it reads against the bytes stored, the share of segments it
   skips), the plain version, the library's CSR SpMV (``torch.sparse``)
   and the bound, K2 at the operators that run it (plain, library, bound,
   both forms), each operator's kernel now against the one it ran before
   K2 was priced among the layouts and, for the factors, before K5 was
   priced on the bytes it reads (K4; the moved operators' table, which
   fails where a new kernel is slower but for K6's frozen prices), one
   warm solve's profile, and K2's and K5's k-column forms on the four
   operators (``columns_check``): for k in ``COLS`` each column of a
   launch the single kernel's bits (update forms too) and the plain
   version's to ``RTOL``, timed at k = 3 against three single launches,
   K2 on an x packed beforehand and cuSPARSE's SpMM, with the bound (K2's
   with its column indices too);
5. gate 3: writes the pressure fixture at N^3 rows (``--side3``, default
   48^3 = 110,592 rows, 2.86M nonzeros; 64^3 before phases (o) and (p))
   and runs it through the CLI:
   MatrixMarket files, RCM, BoomerAMG host setup (PMIS, extended+i,
   l1-Jacobi; the native setup kernels of ``csrc/spkernels.cpp``) with
   each level's A, P and R in the layout the model prices fastest (K2 in
   either storage form, K4, K6), GMRES(20) in f64, golden check; prints
   each level's layout and the timer rows, then K6 and K4/K5 (plain,
   library, bound) at the BELL and BDIA levels and at the old layouts of
   the levels that left them, at every ELL operator (A, P and R by level)
   K2, plain, library and bound with K2 in both forms and the library on
   it, every moved operator's old
   kernel against its new one, and the warm-solve profile; then the same
   pressure fixture at 32^3 (64^3 before the multi-part phases) with
   ``coarsen_type: 6`` (Falgout, run as serial RS): its hierarchy, timer
   rows, moved operators and tpusolve's 11 iterations;
6. gate 1: ``examples/gate1_64cube_pcg_amg.yaml`` as it is (64^3 =
   262,144 rows, ``mixed``) through the CLI: the 27-point stencil as box
   DIA, the PFMG-style structured hierarchy (DIA-algebra RAP, the box
   transfers carried inside K1's launches by the fused kernels of
   ``csrc/box_cycle.cu``, l1-Jacobi, dense coarse solve), PCG in f32 inside
   f64 refinement, golden check, the preconditioner's applications
   counted; then K1 against its plain version on every
   level in f32 and f64, in the plain form and each update form
   ``c + w * s * (b - A x)`` of the cycle, and the same bits in two runs;
   at each level (and on the f64 A) K1's time, the plain version's, the
   library's CSR SpMV and the bound; the 32^3 level cold (L2 flushed) and
   warm; K3 (prolongation with its add, restriction) against its plain
   versions on every transition in f32 and f64, the adjoint identity on
   the card, and each kernel's time, the plain version's, the library's
   (``interpolate``, trilinear, for the prolongation, and its backward,
   ``upsample_trilinear3d_backward``, for the restriction) and the bound;
   the fused kernels (the restriction with K1's residual, the
   prolongation with K1's first post-smoothing update, in its Jacobi and
   Chebyshev forms) against their plain versions and, bit for bit,
   against the pairs of launches they replace on every transition in f32
   and f64, each one's time in turns with the pair's, the plain version's,
   a library reference (no single PyTorch call computes either) and the
   bound; one whole V-cycle against the pair-form cycle bit for bit;
   then one warm solve under
   ``torch.profiler``: device operations and device time by kernel class
   (K1, K3, ...), K1's launches by form, and the device's idle share;
7. gate 2: ``examples/gate2_weakscale_gmres_cheby.yaml`` with its box at
   32^3 (32,768 rows; 64^3 from the coupled and bf16 phases to the
   multi-part ones, 128^3 before, so that the run keeps inside its time on
   a slow host; ``single``, GMRES(20) + Chebyshev-smoothed PFMG) through
   the CLI, ``tpusolve``'s 5 iterations, then the same K1, K3 and fused
   checks and timings at its three levels and two transitions, its
   warm-solve profile, and K1 on a 4-wide coarse box against the exact CSR
   product;
8. (run right after step 3's checks, before gate 4) the device AMG setup
   against the host pipeline: level 0 of the 32^3
   stencil in f64 set up on the card (``amg/device_setup.py``, its row
   floor forced) for classical-modified and direct interpolation, held
   against the port's host pipeline on the same operator (the C/F split
   equal, P, R and the coarse A to 1e-12 relative), with each stage's
   seconds;
9. the weak-scaling BoomerAMG path:
   ``examples/weakscale_pcg_boomeramg_devsetup.yaml`` as it is (128^3 =
   2,097,152 rows, ``single``, PCG + BoomerAMG: PMIS, classical-modified
   interpolation, theta 0.57, l1-Jacobi, ``max_coarse_size`` 512) through
   the CLI: level 0 set up on the card (it fails unless the hierarchy
   carries ``amg/builder.py``'s device note), the host pipeline below, golden check; the seconds of
   each setup stage and of the host levels, each level's layout, the
   timer rows, K1, K4 and K6 against their plain versions at the levels
   that run them (K4 and K6 also on the old layouts of the levels that
   left them) with their times, K2 at every ELL operator in both forms,
   the moved operators, the launch counts (it fails unless each
   operator's layout launched its kernel, K2 in each storage form it
   holds) and the warm-solve profile;
10. (right after step 8, early in the process, where the traces it times
   by are whole) measures the constants of the time model
   (``kernels/calibrate.py``) beside the ones in the code;

Step 4 also times the ELL device factorization of gate 4's RCM'd A
against the run's host ILU setup (not adopted).  After step 9:

11. the stencil
   (``fixtures.STENCIL_ILU_YAML``, ``--side-ilu``, default 64^3 = 262,144
   rows; 128^3 before phases (f) and (g)) under BiCGSTAB + ILU(0) in
   double through the CLI: ILU(0)
   factored on the card over the DIA band (``ilu/device_setup.py``; it
   fails if the host factors), K1 running A and the factors' sweeps, the
   count held to tpusolve's (within ``STENCIL_ILU_SPREAD`` at 128^3, and
   exactly in a second run at 64^3); K1 on L and U against its plain
   version; the factorization's profile (device operations, busy, idle
   share) and, at 64^3, the device factorization against the port's host
   ``chow_patel_ilu`` on the same band (time and the factors' largest
   difference), each beside the card's name and power limit;
12. the gate-4 fixture as written (``matrix_ordering: none``) at 48^3 (96^3
   before phases (f) and (g), 64^3 before phases (o) and (p))
   in double: ILU(0) factored on the card by the ELL path, K2 running A,
   L and U, the count held to tpusolve's; K2 on the three against its
   plain version, the factorization's profile and device against host;
13. the RCM'd gate-4 fixture at 32^3 in double with ILU(1), ILUT and RCM
   local reordering (``fixtures.ILU_OPTIONS``), each count held to
   tpusolve's;
14. gate 3 at 32^3 (64^3 before phases (f) and (g)) with ``smooth_type:
   5`` on its finest level (ILU(0) smoothing), the count held to
   tpusolve's;
15. gate 3 at 32^3 with ``write_outputs``,
   ``write_solution`` and ``write_amg_matrices``, the files read back by
   the port's IJ reader as the system; then two tests with
   ``reuse_preconditioner`` (the second's setup row under 1 % of the
   first's) and ``check_memory``, and the memory probe on the card.

Between steps 9 and 11, the generic-ELL device setup
(``amg/device_setup_ell.py``) and on-device generation:

(f) the weak-scaling YAML with its box at 256^3 (16,777,216 rows), the
   example's settings otherwise, through the CLI: the system generated on
   the card (the host generators fail if called), level 0 set up on the
   card by the DIA setup and every level of 2^19 rows or more below it by
   the generic-ELL setup (it fails otherwise, or if such a level's coarse
   operator went to the host), K1 and K2 launched, golden check, the count
   within one of tpusolve's;
   the hierarchy, each level's setup stages, the timer rows and the
   setup's peak of allocated device memory (step 9's 128^3 run also
   generates on the card, its build row printed beside the host's);
(g) gate 3 at 84^3 (592,704 rows; 96^3 before phases (o) and (p), which
   runs gate 3 at 96^3 on 8 parts) through the CLI: level 0 set up on the
   card by the generic-ELL setup (extended+i), K2 on every ELL level, the
   count tpusolve's; then on its operator, and on gate 3's 64^3 one, the
   ELL setup of level 0 against the port's host pipeline (the same C/F
   split, P to 1e-11, the coarse A to 1e-10 relative, R = P^T exactly),
   its runs the same bits, both setups timed, and the ELL setup's wall,
   device operations, busy time and idle share (on the 64^3 operator in
   step 5's run).

Right after step 4, early in the process, where the traces they time by
keep their device events, the coupled multi-component solve and the
bfloat16 smoother twin:

(h) gate 4's three momentum components (``fixtures.GATE4_YAML_3COMP`` at
   64^3 (96^3 before the multi-part phases) with ``segregated_solve: no``
   and RCM) through the CLI: one solver call on the stacked right-hand
   sides, the golden check on each component, A and A_lo on K2, L and U on
   the model's kernels, K5 for one of them at least (it fails otherwise),
   each
   application one k-column launch for all the batch's columns (the
   launches by columns equal to ``coupled_launches`` of the run's
   refinement passes); the same solver on each component alone, each
   coupled count within ``COUPLED_SPREAD`` of its segregated one, beside
   tpusolve's coupled counts; the warm coupled solve's profile against the
   three segregated ones' (K2's and K5's device time in each, K2's with
   its packs); then K2's and K5's k-column forms on its A, A_lo, L and U
   for k in ``COLS``, each column the single kernel's bits (update forms
   too) and the plain version's to ``RTOL``;
(i) the same in natural order in double at 64^3 (the ELL device ILU(0),
   K2's 3-column form on A, L and U): tpusolve's coupled counts exactly,
   and the segregated ones;
(j) the weak-scaling YAML at 128^3 with ``smoother_dtype: bfloat16``:
   each level's twin and kernel, K1 and K2 launched on bf16 values, the
   count within one of tpusolve's with the twin;
(k) gate 1 at 64^3 with the twin: K1 and the fused prolongation on bf16
   planes, the count within one a pass of tpusolve's; then K1 and K2 on
   (j)'s twins and the fused prolongation on (k)'s level 0, each equal to
   its f32 and f64 form on the rounded values bit for bit, timed against
   the f32 form.

Last, the multi-part operators, 8 parts stacked on the card (``--parts 8``,
``tpusolve``'s mesh of 8 devices), each path's count held to
``tpusolve``'s 8-part count (``TPUSOLVE_PARTS_ITERS``), its golden check,
its layouts (the offd block's K2 form beside each diag block's) and timer
rows printed, and K2's offd launches counted (it fails if there were none):

(m) gate 4 at 96^3 from 8 HYPRE-IJ files (``GATE4_YAML``, RCM, ``mixed``):
   K2 on A and A_lo and on their offd blocks, the ILU(0) factored where
   ``tpusolve`` factors it (its layout for A_lo's banded parts is BDIA,
   which it factors on the host: the whole operator, L and U with offd
   blocks; block-Jacobi on the card where it would factor on its devices)
   and its sweeps on the model's kernel; within one a refinement pass of
   ``tpusolve``'s count;
(l) gate 1 on 8 parts (``examples/gate1_64cube_pcg_amg.yaml`` as it is:
   64^3 a part, process grid (2, 2, 2), 2,097,152 rows): K1 on the 8 boxes,
   the fused transfers on b' = b - A_offd g, K2 on the boundary shells;
   within one a refinement pass;
(n) gate 3 at 64^3 on 8 parts (``double``, host BoomerAMG, K2 on every
   level and transfer): exactly ``tpusolve``'s count;
then BoomerAMG set up on the card over 8 parts, each count held to
``tpusolve``'s 8-part count, measured on the CPU:

(o) the weak-scaling YAML at 96^3 a part (``WEAKSCALE_PARTS_SIDE``; 128^3
   a part, as written, was not measurable in ``tpusolve`` on the CPU),
   7,077,888 rows, ``single``: level 0 by the sharded lattice setup, level
   1 by the N-part ELL setup (it fails otherwise), within one of 31; the
   generator run on the card at this size against the CLI's planes (which
   ``tpusolve``'s rule builds on the host below 128 MB a part) bit for
   bit; the hierarchy, setup stages, timer rows, the setup's peak of
   allocated memory, and a second setup's device operations, busy time and
   idle share;
(p) gate 3 at 96^3 on 8 parts (``double``, extended+i): level 0 by the
   N-part ELL setup, exactly 12, each level's layout and the launches;
then the bit check: the weak-scaling settings at 16^3 a part on 8 parts
set up on the CPU and twice on the card, P, R and the coarse operators of
the lattice level and an ELL level equal bit for bit; then
``multipart_check``: K2 on a stacked offd block in both storage forms
and for 1 and 3 columns against its plain version, one 8-part SpMV on each
layout (DIA, ELL padded and row-pointer, BDIA on K4 and K5, BELL) against
``to_scipy() @ x``, and K2 on (l)'s, (m)'s and (n)'s offd blocks timed
(device, per call, the plain version, cuSPARSE on the same block, the
bound) beside the halo's one index gather, each again in one fresh
process, cuSPARSE's device events by name.

Then the file-loaded gates as 2 processes joined by ``torch.distributed``
(``python -m torch.distributed.run --nproc-per-node 2 -m tpusolve_torch Y
--parts 8 --dist-backend gloo``), both ranks on the one card through gloo,
each holding 4 parts, reading only its rows and printing one
``tpusolve_torch rank r/2:`` line (device, backend, rows and files read,
layouts, launches, timer rows, count, check); each rank must exit 0, pass
its check, run K2 on an offd block, read only its own rows and part files
and take ``tpusolve``'s 8-device count with the same YAML
(``TPUSOLVE_RANKS_ITERS``):

(q) gate 3 at 64^3, ``double``, ``matrix_ordering: none``: exactly 12;
(r) gate 4 at 96^3 from 8 files, ``mixed``, ``matrix_ordering: none``
   (each rank parses only its 4 files; the ILU(0) block-Jacobi on the
   card, each rank its own parts): within one a refinement pass of 141;
then (q) over ``nccl``, one card a rank, where the machine has two cards,
else a line saying that NCCL was not run.

``python3 chip_smoke.py --ranks-profile`` runs (q) again on 2 ranks alone
(``--rank-profile``, each rank a process of this script under
``torch.distributed.run``): each rank's warm solve profiled (device
operations, busy time, idle share by class) and timed with every
collective (the halo's ``all_to_all_single``, the reductions'
``all_reduce``, the coarse solve's ``all_gather``) between two
synchronisations; the smoke's own run leaves it out for its time.

Every fixture is written once, in a process of its own (gate 4's before
the kernel build, the others after step 10), so that the writes overlap
the phases before their use.

Every kernel time is given twice: device time (the kernels' durations in a
``torch.profiler`` trace, ``calibrate.device_ms``) and time per call
between CUDA events (``calibrate.time_ms``), which on a small launch is
the host's.  Each path's kernel launches are counted from 0 just before its
CLI run and read just after; a path that launched none of its kernels
fails, and gate 4 fails unless each of its operators launched the kernel
the model prices fastest (K4 and K6, which no operator of the paths takes,
are held by the checks of step 3 and the timings alone).  The
second-to-last line is a JSON object with one entry per kernel (launches,
device and per-call times, plain, library and bound); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines, as does a machine without CUDA or a directory without
the ``tpusolve_torch`` package.  Gates 1 and 2 fail unless K1 and both
fused kernels ran during their run, each fused kernel exactly once a
transition and preconditioner application, the standalone K3 kernels not
at all (they stay as the yardstick of the fused ones) and no other SpMV
kernel (every operator of the structured path is box DIA).  ``profile_solves.py`` profiles the
warm solves of gates 1 and 2 alone, also of an earlier checkout.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# max |kernel - plain| / max |plain| allowed: summation order differs
# (slot order in the kernel, torch's reduction in the plain version)
RTOL = {"float32": 1e-5, "float64": 1e-12}
# tpusolve on CPU, gate-4 fixture 96^3, precision mixed: BiCGSTAB
# iterations summed over the refinement passes; the port's count on the
# card (31 + 24) with A and its f32 twin on K2 (padded, K = 27), as the
# layout model prices them: each f32 row summed in double and rounded once
# (56, 31 + 25, while K2 summed f32 rows in f32).  On K4's BDIA layout (the
# same whether K4 or K5 runs it, equal bit for bit) the port took 54
# (31 + 23)
TPUSOLVE_ITERS_96 = 56
PORT_ITERS_96 = 55
# tpusolve on CPU, gate-3 fixture 64^3, precision double: GMRES iterations;
# at 48^3 (the gate-3 phase's side since phases (o) and (p) came; relres
# 6.280e-09, four levels 110592, 9122, 664, 63 rows; 14.1 s, 1.92 GB) the
# same.  TPUSOLVE_GATE3_ITERS below holds every side
TPUSOLVE_GATE3_ITERS_64 = 12
# tpusolve on CPU, examples/gate1_64cube_pcg_amg.yaml as it is (64^3,
# mixed): PCG iterations summed over the refinement passes
TPUSOLVE_GATE1_ITERS = 14
# tpusolve on CPU, examples/gate2_weakscale_gmres_cheby.yaml at 64^3
# (single): GMRES iterations, printed for reference only (22 at 128^3).
# Its f32 projection h = V @ w under XLA on the CPU is 450x less accurate
# than torch's, and its GMRES stalls; with that projection in f64, or with
# cgs: 2, tpusolve takes 6 at 64^3 (tests/test_torch_gmres_projection.py,
# ROADMAP.md Queue 3).  The port took 6 on the card at 128^3 and at 64^3.
# Since the multi-part phases the smoke runs it at 32^3, where both
# packages take 5 on the CPU (`python -m tpusolve_torch Y --device cpu`
# and `JAX_PLATFORMS=cpu python -m tpusolve.harness.cli Y`, Y the example
# with its box at 32^3); the gate holds the port within one of 5
GATE2_SIDE = 32
TPUSOLVE_GATE2_ITERS = 5
PORT_GATE2_ITERS = 5
# tpusolve on CPU, examples/weakscale_pcg_boomeramg_devsetup.yaml as it is
# (128^3, single, its level 0 set up by its device setup on the CPU, host
# PMIS ranks: TPUSOLVE_PMIS_HOST_RANK=1): PCG iterations, relres 5.474e-07;
# the port is held within one of it
TPUSOLVE_WEAKSCALE_ITERS = 23
# tpusolve on CPU, gate-3 fixture 64^3 with coarsen_type 6 (Falgout, run as
# serial RS by its native kernel), precision double: GMRES iterations,
# relres 1.517e-09, five levels (32768, 4097, 532, 135, 51 rows), at 32^3,
# where the smoke runs it since the multi-part phases (the port's on the
# CPU the same; at 64^3 11 too, PERF.md section 4)
TPUSOLVE_GATE3_RS_ITERS = 11
GATE3_RS_SIDE = 32
# tpusolve on CPU (one device), fixtures.STENCIL_ILU_YAML (BiCGSTAB +
# ILU(0), double; its ILU(0) factored by its device DIA path) by side:
# BiCGSTAB iterations, relres 4.315e-09 at 128^3 and 7.808e-09 at 64^3.  The
# YAML is the one `python -c "from tpusolve_torch import fixtures;
# print(fixtures.write_stencil_ilu('/tmp/s', 128))"` writes, run by
# `JAX_PLATFORMS=cpu python -m tpusolve.harness.cli /tmp/s/stencil_ilu.yaml`
TPUSOLVE_STENCIL_ILU_ITERS = {128: 53, 64: 33}
# at 128^3 that count follows the summation order: the port's and tpusolve's
# residual histories on the CPU agree to 7 digits for 27 iterations, then
# part, roundoff growing about threefold an iteration, and the port takes
# 51 on the CPU and 54 on the card (ROADMAP.md Queue 3).  So 128^3 is held
# within this many of tpusolve's count, 64^3 exactly
STENCIL_ILU_SPREAD = 3
# the same for the gate-4 fixture as written, precision double and
# matrix_ordering none (fixtures.write_gate4(d, side, precision="double",
# solver_settings={"matrix_ordering": "none"})): tpusolve stores it ELL and
# factors ILU(0) by its device ELL path; relres 3.200e-09 at 96^3 (312 s
# and 9 GB on the CPU), 2.286e-09 at 64^3, 1.804e-09 at 48^3 (44.6 s and
# 1.51 GB)
TPUSOLVE_GATE4_ELL_ITERS = {48: 32, 64: 34, 96: 46}
# ... the RCM'd gate-4 fixture in double with each of fixtures.ILU_OPTIONS
# (fixtures.write_gate4(d, 32, precision="double",
# ilu_preconditioner_settings=fixtures.ILU_OPTIONS[name])): relres
# 1.662e-09, 2.172e-09, 7.472e-09
TPUSOLVE_ILU_OPTION_ITERS = {("fill1", 32): 16, ("ilut", 32): 30,
                             ("rcm", 32): 21}
# ... the gate-3 fixture with smooth_type 5 on one level (double,
# fixtures.write_gate3(d, side, boomeramg_settings={"smooth_type": 5,
# "smooth_num_levels": 1})): GMRES iterations, relres 4.580e-09 at 64^3
TPUSOLVE_GATE3_ST5_ITERS = {64: 7, 32: 7}
# tpusolve on CPU, the weak-scaling YAML at 256^3
# (fixtures.write_weakscale(d, 256): the example's settings, single; its
# planes generated on the host, level 0 set up by its DIA device setup and
# level 1 (1,360,076 rows) by its generic-ELL device setup on the CPU, host
# PMIS ranks): PCG iterations, relres 9.572e-07, eight levels (16777216,
# 1360076, 332795, 79060, 15974, 3348, 744, 186 rows); 1,474 s and 24.4 GB
# of host memory.  The command: `TPUSOLVE_PMIS_HOST_RANK=1
# JAX_PLATFORMS=cpu python -m tpusolve.harness.cli d/weakscale.yaml`.  The
# port is held within one of it, as at 128^3 (f32)
TPUSOLVE_WEAKSCALE_ITERS_256 = 38
# tpusolve on CPU, the gate-3 fixture at side^3 (fixtures.write_gate3(d,
# side)), double: its level 0 set up by its generic-ELL device setup on the
# CPU (host PMIS ranks, as above): GMRES iterations by side; at 96^3 relres
# 5.726e-09, five levels (884736, 72320, 4863, 362, 25 rows); at 84^3
# relres 5.382e-09, five levels (592704, 48652, 3290, 256, 38 rows), 432.7
# s and 12.60 GB on the CPU.  (g) runs at GATE3_ELL_SIDE^3 since the
# multi-part phases (o) and (p) came: the smallest side of 2^19 rows or
# more that tpusolve was measured at, (p) running gate 3 at 96^3 on 8
# parts
TPUSOLVE_GATE3_ITERS = {96: 12, 84: 12, 64: TPUSOLVE_GATE3_ITERS_64, 48: 12}
GATE3_ELL_SIDE = 84
# the start of the note the builder records for a device level 0
DEVICE_NOTE = "level 0 setup on device"
# tpusolve's counts on 8 parts: its CLI on its mesh of 8 virtual CPU
# devices, each measured once on the CPU by `XLA_FLAGS=
# --xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu python -m
# tpusolve.harness.cli Y.yaml`, Y: gate 1, examples/gate1_64cube_pcg_amg.yaml
# as it is (PCG iterations over its refinement passes, relres 7.070e-11);
# gate 4, the fixture `python -m tpusolve_torch.fixtures d 96 4 8` (96^3 in
# 8 files, mixed: BiCGSTAB iterations over the passes, relres 1.198e-10);
# gate 3, `python -m tpusolve_torch.fixtures d 64 3` (double: GMRES, relres
# 5.830e-09).  32, 104 and 36 s on the CPU
TPUSOLVE_PARTS_ITERS = {"gate1": 21, "gate4": 54, "gate3": 12}
# ... and with its multi-part device setups, host PMIS ranks
# (TPUSOLVE_PMIS_HOST_RANK=1 added to the command above): the weak-scaling
# YAML at 96^3 a part (fixtures.write_weakscale(d, 96), single: level 0
# by its sharded lattice setup, level 1 by its N-part ELL setup; PCG
# iterations, relres 7.541e-07, seven levels 7077888, 574674, 140597,
# 33397, 6767, 1345, 314 rows; 242.9 s, a peak resident size of 63.36 GB
# as getrusage reports it); at 128^3 a part it was killed at 65 GB after
# 209 s, so the phase runs at 96^3.  Gate 3 at 96^3 (fixtures.write_gate3(d,
# 96), double, level 0 by its N-part ELL setup: GMRES iterations, relres
# 5.726e-09, five levels 884736, 72320, 4863, 362, 25 rows; 356.4 s,
# 57.18 GB)
TPUSOLVE_PARTS_ITERS.update(weakscale_96=31, gate3_96=12)
WEAKSCALE_PARTS_SIDE = 96
PARTS = 8
# the weak-scaling YAML's "Build 27Pt Stencil HYPRE matrix" row at 128^3
# when the planes were generated on the host (chip_smoke.py, H100 80GB
# HBM3, 700.00 W, before on-device generation), printed beside the row
WEAKSCALE_HOST_BUILD_S = 0.526165


# (q), (r): the file-loaded gates as RANKS processes joined by
# torch.distributed (``python -m torch.distributed.run --nproc-per-node
# RANKS -m tpusolve_torch Y --parts PARTS --dist-backend gloo``), both
# ranks on the one card through gloo, each holding PARTS / RANKS parts.
# tpusolve's counts on its mesh of 8 virtual CPU devices with the same
# YAMLs (the fixture with matrix_ordering: none), measured once on the CPU
# by `XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
# python -m tpusolve.harness.cli Y.yaml`: gate 3 at 64^3 (fixtures.
# write_gate3(d, 64, solver_settings={"matrix_ordering": "none"}), double:
# GMRES iterations, relres 6.519e-09, 36 s); gate 4 at 96^3 from 8 files
# (fixtures.write_gate4(d, 96, nfiles=8, solver_settings=
# {"matrix_ordering": "none"}), mixed, its ILU(0) block-Jacobi on its
# devices: BiCGSTAB iterations over the refinement passes, relres
# 3.379e-10, 86 s)
RANKS = 2
TPUSOLVE_RANKS_ITERS = {"gate3": 12, "gate4": 141}
RANKS_SIDES = {"gate3": 64, "gate4": 96}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi listed no GPU")
    return out[0]


def rel_err(y, y_ref) -> float:
    scale = float(y_ref.abs().max())
    return float((y - y_ref).abs().max()) / (scale if scale > 0 else 1.0)


def banded_check(device) -> tuple:
    """K4 and K5 against their plain versions on a banded matrix whose
    clipped boundary blocks spill to the overflow list, K5 with and without
    its segment mask against K4 bit for bit (also on an x that is not
    16-byte aligned), K5's update forms against their plain versions bit
    for bit, and the whole SpMV against scipy.  Returns the largest
    relative error of K4 and of K5."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch.kernels.bdia import (
        bdia_spmv, bdia_spmv_plain, bdia_spmv_xl, bdia_spmv_xl_plain,
        full_mask)
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(5)
    n = 200_000
    rr = np.arange(n, dtype=np.int64)
    rows = np.concatenate([rr] * 10)
    cols = np.concatenate([np.clip(rr + base + dd, 0, n - 1)
                           for base in (-600, 0, 600) for dd in (-1, 0, 1)]
                          + [rr])
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    worst4 = worst5 = 0.0
    for dtype in (np.float32, np.float64):
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=device,
                                   dtype=dtype, allow_ell=False)
        if not A.uses_bdia or A.bdia_ovf_vals is None:
            fail(f"banded check: expected BDIA with overflow, got {A.layout}")
        x = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=device)
        args = (A.bdia_vals, A.bdia_starts, x, A.bdia_xpad, A.bdia_xlen,
                A.row_pad, A.bdia_ovf)
        y4 = bdia_spmv(*args)
        err = rel_err(y4, bdia_spmv_plain(*args))
        y = spmv(A, x).double().cpu().numpy()
        y_ref = S.astype(dtype) @ x.cpu().numpy()
        err_sp = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        name = str(A.dtype).replace("torch.", "")
        print(f"K4 banded n={n} {name} {A.layout}: kernel vs plain "
              f"rel err {err:.3e} (limit {RTOL[name]:.0e}); SpMV vs scipy "
              f"{err_sp:.3e}", flush=True)
        if not err <= RTOL[name] or not err_sp <= 10 * RTOL[name]:
            fail(f"banded check {name} out of tolerance")
        worst4 = max(worst4, err)
        # K5 on the same layout, on the step plan the model prices best
        # (whether or not it would beat K4 there)
        _, B, D, R = A.bdia_vals.shape
        Ax = xl_operator(A)
        if Ax is None:
            fail("banded check: no K5 step plan fits")
        xargs, kw = xl_args(Ax, x)
        y5 = bdia_spmv_xl(*xargs, **kw)
        err5 = rel_err(y5, bdia_spmv_xl_plain(*xargs, **kw))
        buf = torch.empty(n + 1, dtype=A.dtype, device=device)
        buf[1:] = x
        y5u = bdia_spmv_xl(*xl_args(Ax, buf[1:])[0], **kw)
        same = all(bool(torch.equal(y, y4)) for y in (
            y5, y5u, bdia_spmv_xl(*xargs, **dict(kw, mask=full_mask(
                1, B, D, R, device)))))
        upd_same = update_forms_equal(xargs, kw, rng)
        print(f"K5 banded n={n} {name} gb={Ax.bdia_gb} panel={Ax.bdia_panel}"
              f" steps={Ax.bdia_step_lo.shape[1]} stage={Ax.bdia_stage} "
              f"segments live {A.bdia_live}/"
              f"{B * D * R // 32}: kernel vs plain rel err {err5:.3e} "
              f"(limit {RTOL[name]:.0e}); equal to K4, with the mask and "
              f"with every segment set, and on an x at a 16-byte misalignment "
              f"({buf[1:].data_ptr() % 16} bytes off 16): {same}; update "
              f"forms equal to their plain versions: {upd_same}", flush=True)
        if not err5 <= RTOL[name] or not same or not all(upd_same.values()):
            fail(f"banded check: K5 {name} out of tolerance or not K4's")
        worst5 = max(worst5, err5)
    return worst4, worst5


def xl_operator(M):
    """BDIA operator ``M`` run by K5: itself where it is BDIA-XL, else on
    the step plan the model prices best (whether or not it beats K4), or
    None where no plan fits."""
    from tpusolve_torch.matrix import sharded
    if M.uses_bdia_xl:
        return M
    plan = sharded.plan_xl(M.bdia_starts.cpu().numpy(), M.bdia_block,
                           M.bdia_xpad, M.bdia_vals.element_size(),
                           M.bdia_nbytes, M.bdia_live, M.xl_work())
    return None if plan is None else M._with_xl(plan[:5])


def xl_args(M, x) -> tuple:
    """(positional, keyword) arguments of ``bdia_spmv_xl`` for BDIA-XL
    operator ``M`` on ``x``, as ``matrix/spmv.py`` passes them."""
    return ((M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.row_pad,
             M.bdia_gb, M.bdia_step_lo, M.bdia_panel, M.bdia_ovf),
            dict(mask=M.bdia_mask, step_b0=M.bdia_step_b0,
                 stage=M.bdia_stage))


def update_forms_equal(xargs, kw, rng) -> dict:
    """K5's update forms (the ILU's lower sweep ``b - A x`` and upper sweep
    ``s * (b - A x)``, and ``c + w * s * (b - A x)``) on arguments
    ``xargs`` and keywords ``kw`` of ``bdia_spmv_xl``, each against the
    plain update (``epilogue_plain``, the eager steps the path ran before)
    of K5's own ``A x``: {form: equal bit for bit}.  (The plain SpMV sums the slots
    in torch's order, so against it the update form agrees to RTOL.)
    Fails where an update form strays from the whole plain version by more
    than RTOL."""
    import torch
    from tpusolve_torch.kernels.bdia import bdia_spmv_xl, bdia_spmv_xl_plain
    from tpusolve_torch.kernels.dia import epilogue_plain
    x = xargs[2]
    n = xargs[4]
    dt = str(x.dtype).replace("torch.", "")
    b, s, c = (torch.tensor(rng.standard_normal(n), dtype=x.dtype,
                            device=x.device) for _ in range(3))
    y = bdia_spmv_xl(*xargs, **kw)
    out = {}
    for form, upd in (("b", dict(b=b)), ("b,s", dict(b=b, s=s)),
                      ("b,s,c,w", dict(b=b, s=s, c=c, w=0.7))):
        got = bdia_spmv_xl(*xargs, **kw, **upd)
        out[form] = bool(torch.equal(got, epilogue_plain(y, **upd)))
        err = rel_err(got, bdia_spmv_xl_plain(*xargs, **kw, **upd))
        if not err <= RTOL[dt]:
            fail(f"K5 update form {form} {dt} vs plain rel err {err:.3e}")
    return out


def k4_launch_check(device) -> float:
    """K4's launch plans against its plain version and K5 bit for bit, in
    both dtypes, overflow lists included: a small launch of wide blocks
    (5,000 rows in 10 blocks of R=512, run as chunks of 256 rows, deep
    register stages) and an operator of D=640 slots, like gate 3's level 1
    (688).  Returns the largest relative error against the plain
    version."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels import bdia
    from tpusolve_torch.matrix.sharded import _ovf_fields

    rng = np.random.default_rng(12)
    n = 5000
    rr = np.arange(n, dtype=np.int64)
    # a band of 9 random entries a row within 40 of the diagonal; and 12
    # entries a row drawn from 900 offsets per 128-row block within 2,000
    band = (np.repeat(rr, 9), np.clip(np.repeat(rr, 9) + rng.integers(
        -40, 41, size=9 * n), 0, n - 1))
    offs = rng.integers(-2000, 2001, size=(-(-n // 128), 900))
    wr = np.repeat(rr, 12)
    wide = (wr, np.clip(wr + offs[wr // 128, rng.integers(0, 900, wr.size)],
                        0, n - 1))
    worst = 0.0
    for what, (rows, cols), R, D in (("small launch", band, 512, 12),
                                     ("D=640", wide, 128, 640)):
        key = np.unique(np.concatenate([rows, rr]) * n
                        + np.concatenate([cols, rr]))
        r, c = key // n, key % n
        v = rng.standard_normal(key.size)
        for dtype in (np.float32, np.float64):
            st, fi, vo, o_r, o_c, o_v = bdia.compact(
                r, c, v, n, n, R, D, dtype=dtype, overflow=True)
            B = -(-n // R)
            vals = np.zeros(B * D * R, dtype)
            vals[fi] = vo
            starts, xpad, xlen = bdia.finalize_starts(st, n, R)
            f = _ovf_fields([(o_r, o_c, o_v)], n, n, dtype, device)
            ovf = (f["bdia_ovf_ptr"], f["bdia_ovf_cols"], f["bdia_ovf_vals"])
            vt = torch.tensor(vals.reshape(1, B, D, R), device=device)
            stt = torch.tensor(starts[None], device=device)
            x = torch.tensor(rng.standard_normal(n).astype(dtype),
                             device=device)
            args = (vt, stt, x, xpad, xlen, n, ovf)
            y4 = bdia.bdia_spmv(*args)
            err = rel_err(y4, bdia.bdia_spmv_plain(*args))
            gb, step_lo, panel, step_b0, stage = bdia.plan_steps(
                starts[None], R, xpad, vals.itemsize,
                lambda g, nsteps, panel, smem: abs(g - 4))
            y5 = bdia.bdia_spmv_xl(
                vt, stt, x, xpad, n, gb, torch.tensor(step_lo, device=device),
                panel, ovf, mask=bdia.segment_mask(vt),
                step_b0=torch.tensor(step_b0, device=device), stage=stage)
            rc, S, blocks, _ = bdia.k4_plan(1, B, D, R, vals.itemsize)
            name = np.dtype(dtype).name
            same = bool(torch.equal(y4, y5))
            print(f"K4 {what} n={n} {name} R={R} D={D} overflow="
                  f"{int(ovf[0][0, -1])}: {blocks} blocks of {rc} rows, "
                  f"S={S}; kernel vs plain rel err {err:.3e} (limit "
                  f"{RTOL[name]:.0e}); equal to K5 (gb={gb}): {same}",
                  flush=True)
            if not err <= RTOL[name] or not same:
                fail(f"K4 {what} {name} out of tolerance or not K5's")
            worst = max(worst, err)
    return worst


def bell_check(device) -> float:
    """K6 against its plain version on a blocked matrix with ragged groups
    and windows (1,501 rows: the last group and the last window are
    partial), in both dtypes; the whole SpMV against scipy.  Returns the
    largest relative error seen."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch.kernels.bell import bell_spmv, bell_spmv_plain
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(6)
    n, width = 1501, 40
    rows = np.repeat(np.arange(n, dtype=np.int64), 32)
    base = rng.integers(0, n - width, size=(n, 8)).repeat(4, axis=1)
    cols = base.reshape(-1) + rng.integers(0, width, size=rows.size)
    key = np.unique(np.concatenate([rows * n + cols, np.arange(n) * (n + 1)]))
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    worst = 0.0
    for dtype in (np.float32, np.float64):
        A = ShardedMatrix.from_coo((n, n), rows, cols, vals, device=device,
                                   dtype=dtype, allow_ell=False)
        if not A.uses_bell:
            fail(f"blocked check: expected BELL, got {A.layout}")
        x = torch.tensor(rng.standard_normal(n), dtype=A.dtype, device=device)
        args = (A.bell_vals, A.bell_ids, x, A.bell_nwin, A.row_pad)
        err = rel_err(bell_spmv(*args), bell_spmv_plain(*args))
        y = spmv(A, x).double().cpu().numpy()
        y_ref = S.astype(dtype) @ x.cpu().numpy()
        err_sp = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        name = str(A.dtype).replace("torch.", "")
        print(f"K6 blocked n={n} {name} {A.layout}: kernel vs plain rel err "
              f"{err:.3e} (limit {RTOL[name]:.0e}); SpMV vs scipy "
              f"{err_sp:.3e}", flush=True)
        if not err <= RTOL[name] or not err_sp <= 10 * RTOL[name]:
            fail(f"blocked check {name} out of tolerance")
        worst = max(worst, err)
    return worst


def library_csr(M):
    """Operator ``M`` as a CSR ``torch.sparse`` tensor (cuSPARSE's) in M's
    dtype on its device, unpadded; the port never calls it."""
    import torch
    H = M.to_scipy().tocsr()
    dev = M.device
    return torch.sparse_csr_tensor(
        torch.tensor(H.indptr, dtype=torch.int64, device=dev),
        torch.tensor(H.indices, dtype=torch.int64, device=dev),
        torch.tensor(H.data, dtype=M.dtype, device=dev), size=H.shape)


def library_spmv(M):
    """(call, x) of the PyTorch library's SpMV on operator ``M``: a CSR
    ``torch.sparse`` matvec (cuSPARSE) in M's dtype; the port never calls
    it.  ``x`` has M's unpadded width."""
    import torch
    csr = library_csr(M)
    x = torch.zeros(csr.shape[1], dtype=M.dtype, device=M.device)
    return (lambda: csr @ x), x


def bound_ms(nbytes: int, device_name: str) -> float:
    """The least time the card could take to move ``nbytes``: over its
    published HBM rate (``runtime.hbm_gbps``)."""
    from tpusolve_torch.runtime import hbm_gbps
    gbps = hbm_gbps(device_name)
    if gbps is None:
        fail(f"no published HBM rate for {device_name}")
    return nbytes / (gbps * 1e9) * 1e3


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# calls a trace of device_times holds: the mean of each kernel's durations
# over them is the device time.  Tracing the plain version of a 125-plane
# operator (hundreds of launches a call) took 10-13 s a trace at 50 calls,
# about 130 s of gates 1 and 2, so the smoke traces 20
TRACE_REPS = 20


def device_times(calls: dict, only: str | None = None) -> dict:
    """``calibrate.device_ms_each`` of each of ``calls`` (of the kernels
    named like ``only``, if given), each call in a trace of its own, or NaN
    for one whose traces held no device event (printed; the JSON line gives
    null): a time that was not measured fails no check.  One trace for
    several calls counts each device event for the call whose host span
    holds its start, and on the card's machine such a trace once counted
    a call's events for the span before it (a K2 call read the next call's
    time, and the call before it gained K2's).  Each trace holds
    ``TRACE_REPS`` calls."""
    from tpusolve_torch.kernels.calibrate import device_ms_each
    out = {}
    for key, call in calls.items():
        try:
            out.update(device_ms_each({key: call}, reps=TRACE_REPS,
                                      only=only))
        except RuntimeError as err:
            print(f"device time not measured: {err}", flush=True)
            out[key] = float("nan")
    return out


def fresh_device_ms(M, x, what: str) -> float:
    """The device time of ``spmv(M, x)`` taken in a fresh process
    (``python -m tpusolve_torch.kernels.calibrate --retrace FILE``), for a
    headline row whose trace lost the kernel's device events late in this
    one; NaN, printed, if that fails too."""
    import torch
    path = os.path.join(REPO, "build", "retrace.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(dict(M=M, x=x), path)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "tpusolve_torch.kernels.calibrate",
             "--retrace", path], cwd=REPO, capture_output=True, text=True,
            timeout=300)
    finally:
        os.remove(path)
    try:
        ms = float(json.loads(out.stdout.strip().splitlines()[-1])
                   ["device_ms"])
    except (ValueError, IndexError, KeyError):
        print(f"{what}: device time not measured in a fresh process either "
              f"(exit {out.returncode}): {out.stderr.strip()[-400:]}",
              flush=True)
        return float("nan")
    print(f"{what}: device {ms:.5f} ms, taken in a fresh process", flush=True)
    return ms


def no_nan(obj):
    """``obj`` with every NaN float replaced by None, for strict JSON."""
    if isinstance(obj, float) and obj != obj:
        return None
    if isinstance(obj, dict):
        return {k: no_nan(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [no_nan(v) for v in obj]
    return obj


def spmv_nbytes(M) -> int:
    """The bytes an SpMV of operator ``M`` must move, whatever its layout:
    each nonzero's value once, x once and y once.  A layout's padding and
    in-band zeros are not needed, and the DIA, BDIA and BELL layouts take a
    value's column from its diagonal or tile, so no index is counted; the
    layout's own bytes are reported beside the bound, not in it."""
    rows, cols = M.shape
    return (M.nnz + rows + cols) * M.diag.element_size()


def bdia_timings(ops, device_name: str, seed: int):
    """At each (name, BDIA operator) of ``ops``: the layout; K4, and K5
    with the operator's segment mask where a step plan fits (the
    operator's own, else the model's best), each against its plain version,
    K5 against K4 bit for bit and its update forms against the plain
    update of its product (:func:`update_forms_equal`); the library's SpMV;
    the bound; the bytes the layout stores, the bytes K5 reads (the
    segments its mask keeps, the overflow, the panels) and the share of
    segments it skips.  Returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.bdia import (
        bdia_spmv, bdia_spmv_plain, bdia_spmv_xl, bdia_spmv_xl_plain)
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.matrix import sharded
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(seed)
    rows = []
    for name, M in ops:
        if not M.uses_bdia:
            fail(f"operator {name} is not BDIA ({M.layout})")
        dt = str(M.dtype).replace("torch.", "")
        _, B, D, R = M.bdia_vals.shape
        itemsize = M.bdia_vals.element_size()
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        args = (M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.bdia_xlen,
                M.row_pad, M.bdia_ovf)
        y4 = bdia_spmv(*args)
        y4p = bdia_spmv_plain(*args)
        err4 = rel_err(y4, y4p)
        if not err4 <= RTOL[dt]:
            fail(f"{name}: K4 vs plain rel err {err4:.3e} > {RTOL[dt]}")
        k = int(M.bdia_ovf_ptr[0, -1]) if M.bdia_ovf_ptr is not None else 0
        nbytes = sharded.bdia_bytes(B, D, R, k, itemsize)
        live = M.bdia_live
        reads = nbytes - sharded.skipped_bytes(1, B, D, R, itemsize, live)
        model4 = 1e3 * sharded.k4_model_s(itemsize, nbytes, 1, B, D, R)
        plan = sharded.plan_xl(M.bdia_starts.cpu().numpy(), R, M.bdia_xpad,
                               itemsize, nbytes, live, M.xl_work())
        model5 = None if plan is None else 1e3 * plan[5]
        Mx = xl_operator(M)
        xargs, kw = (None, {}) if Mx is None else xl_args(Mx, x)
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        err_lib = rel_err(lib_call(), y4p[:xlib.numel()])
        row = dict(op=name, dtype=dt, layout=M.layout, B=B, D=D, R=R,
                   overflow=k, rel_err=err4, max_abs_err=float(
                       (y4 - y4p).abs().max()), lib_rel_err=err_lib,
                   model_k4_ms=model4, model_k5_ms=model5,
                   layout_mb=nbytes / 1e6, segments_live=live,
                   segments=B * D * R // 32,
                   skipped_share=1 - live * 32 / (B * D * R))
        if xargs is not None:
            y5 = bdia_spmv_xl(*xargs, **kw)
            y5p = bdia_spmv_xl_plain(*xargs, **kw)
            err5 = rel_err(y5, y5p)
            if not err5 <= RTOL[dt] or not torch.equal(y5, y4):
                fail(f"{name}: K5 vs plain rel err {err5:.3e} or not equal "
                     "to K4")
            upd = update_forms_equal(xargs, kw, rng)
            if not all(upd.values()):
                fail(f"{name}: K5's update forms {upd}")
            nsteps = Mx.bdia_step_lo.shape[1]
            row.update(gb=Mx.bdia_gb, panel=Mx.bdia_panel, steps=nsteps,
                       stage=Mx.bdia_stage,
                       xl_rel_err=err5, xl_max_abs_err=float(
                           (y5 - y5p).abs().max()), xl_equal_to_k4=True,
                       update_forms_equal=upd,
                       xl_read_mb=(reads + nsteps * Mx.bdia_panel
                                   * itemsize) / 1e6)
        # alternate plain, kernels, library, kernels, plain on the card;
        # "plain" is K4's plain version, "xl_plain" K5's
        calls = [("plain", lambda: bdia_spmv_plain(*args)),
                 ("k4", lambda: bdia_spmv(*args))]
        if xargs is not None:       # as the solve calls it
            calls += [("xl_plain", lambda: bdia_spmv_xl_plain(*xargs, **kw)),
                      ("k5", lambda: spmv(Mx, x))]
        calls.append(("lib", lib_call))
        runs = {key: [] for key, _ in calls}
        for key, call in calls + calls[::-1]:
            runs[key].append(time_ms(call))
        for key, ts in runs.items():
            row[key + "_ms"] = min(ts)
            row[key + "_runs"] = ts
        for key, ms in device_times(dict(calls)).items():
            row[key + "_dev_ms"] = ms
        row["bound_ms"] = bound_ms(spmv_nbytes(M), device_name)
        row["ms"] = row["k5_ms" if M.uses_bdia_xl else "k4_ms"]
        k5 = (f"K5 gb={row['gb']} panel={row['panel']} device "
              f"{row['k5_dev_ms']:.5f} ms, per call {row['k5_ms']:.5f} ms "
              f"(runs {row['k5_runs'][0]:.5f}, {row['k5_runs'][1]:.5f}; "
              f"model {model5:.5f}), rel err {row['xl_rel_err']:.3e}, equal "
              f"to K4, update forms equal to the plain update "
              f"{row['update_forms_equal']}; reads {row['xl_read_mb']:.3f} "
              f"MB with its panels, {row['skipped_share']:.3f} of the "
              f"segments skipped; K5's plain version device "
              f"{row['xl_plain_dev_ms']:.5f} ms, per call "
              f"{row['xl_plain_ms']:.5f} ms; " if xargs is not None
              else "K5: no step plan fits; ")
        print(f"{name} {dt} {M.layout}: K4 device {row['k4_dev_ms']:.5f} ms, "
              f"per call {row['k4_ms']:.5f} ms (runs "
              f"{row['k4_runs'][0]:.5f}, {row['k4_runs'][1]:.5f}; model "
              f"{model4:.5f}), rel err "
              f"{err4:.3e}; {k5}K4's plain version device "
              f"{row['plain_dev_ms']:.5f} ms, "
              f"per call {row['plain_ms']:.5f} ms; library (torch.sparse "
              f"CSR) device {row['lib_dev_ms']:.5f} ms, per call "
              f"{row['lib_ms']:.5f} ms (rel err {err_lib:.1e}); bound "
              f"{row['bound_ms']:.5f} ms ({M.nnz} nnz, x, y; the layout "
              f"stores {row['layout_mb']:.3f} MB)", flush=True)
        rows.append(row)
    return rows


def reset_counters(counters) -> None:
    """Every launch counter of ``counters`` set to 0: the launches, and the
    launches by form (K1, K2, K5), by storage form (K2), by columns (the
    k-column forms of K2 and K5) and on bf16 values (K1, K2 and the fused
    prolongation)."""
    for fn in counters:
        fn.launches = 0
        for key in ("launches_by_form", "launches_by_layout",
                    "launches_by_cols"):
            if hasattr(fn, key):
                setattr(fn, key, {})
        for key in ("launches_bf16", "launches_offd",
                    "launches_ghost_prolong"):
            if hasattr(fn, key):
                setattr(fn, key, 0)


def run_cli(yaml_path: str, counters, keep: list | None = None,
            parts: int = 1) -> tuple:
    """Run the port's CLI on ``yaml_path`` (on ``parts`` parts, its
    ``--parts``) with every launch counter set to 0 just before; returns
    (exit code, LinearSystem, wall seconds, {counter name: launches});
    ``keep``, where given, receives every test's LinearSystem, as
    ``cli.main``'s does; a counter's ``launches_by_form`` (K1's and K2's
    launches by update form), ``launches_by_layout`` (K2's by storage form)
    ``launches_offd`` (K2's on offd blocks, ``ell_spmv offd``) and
    ``launches_ghost_prolong`` (K2's on the box prolongation's rows at the
    ghosts' sources, ``ell_spmv ghost prolong``) are set to 0 with it
    (:func:`reset_counters`)."""
    from tpusolve_torch.harness import cli
    reset_counters(counters)
    systems = [] if keep is None else keep
    t0 = time.perf_counter()
    rc = cli.main([yaml_path, "--device", "cuda", "--parts", str(parts)],
                  keep=systems)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    k2 = next((fn for fn in counters if fn.__name__ == "ell_spmv"), None)
    if k2 is not None:
        for form in ("padded", "rowptr"):
            launches[f"ell_spmv {form}"] = k2.launches_by_layout.get(form, 0)
        launches["ell_spmv offd"] = k2.launches_offd
        launches["ell_spmv ghost prolong"] = k2.launches_ghost_prolong
    return rc, (systems[0] if systems else None), wall, launches


FIXTURES = os.path.join(REPO, "build", "fixtures")
# (gate, side) -> the process writing that fixture (start_fixture_writers)
WRITERS = {}


def start_fixture_writers(specs) -> None:
    """Write the fixtures of ``specs`` ((gate, side) pairs) under
    ``FIXTURES`` as :func:`fixture_yaml` would, one process each
    (``python -m tpusolve_torch.fixtures``), all started now, so that the
    writes overlap the checks and phases before each one's first use.
    The processes are stopped at exit (:func:`stop_fixture_writers`)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    if not WRITERS:
        atexit.register(stop_fixture_writers)
    for gate, side in specs:
        d = os.path.join(FIXTURES, f"gate{gate}_{side}")
        WRITERS[(gate, side)] = subprocess.Popen(
            [sys.executable, "-m", "tpusolve_torch.fixtures", d, str(side)]
            + str(gate).split("p"), cwd=REPO, env=env,
            stdout=subprocess.DEVNULL)


def stop_fixture_writers() -> None:
    for proc in WRITERS.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    WRITERS.clear()


def fixture_yaml(gate: int, side: int, name: str, edit=None,
                 **sections) -> str:
    """The path of a YAML ``name`` for the gate-``gate`` (3, 4, "4c":
    gate 4's three components, or "4p8": gate 4 in 8 files) fixture at
    side^3, its text passed through ``edit`` and its settings changed as
    ``fixtures.with_settings`` takes them.  The fixture's files are written
    once, under ``FIXTURES``, for every phase that runs them (the 96^3
    gate-4 fixture takes some 40 s to write)."""
    from tpusolve_torch import fixtures
    d = os.path.join(FIXTURES, f"gate{gate}_{side}")
    base = os.path.join(d, "gate4_3comp.yaml" if gate == "4c"
                        else f"gate{str(gate).split('p')[0]}.yaml")
    writer = WRITERS.pop((gate, side), None)
    if writer is not None:
        t0 = time.perf_counter()
        if writer.wait() != 0:
            fail(f"writing the gate-{gate} fixture at {side}^3 failed")
        print(f"gate-{gate} fixture {side}^3 written in the background, "
              f"waited {time.perf_counter() - t0:.1f} s", flush=True)
    if not os.path.exists(base):
        t0 = time.perf_counter()
        if gate == "4p8":
            fixtures.write_gate4(d, side, nfiles=8)
        else:
            {3: fixtures.write_gate3, "4c": fixtures.write_gate4_3comp}.get(
                gate, fixtures.write_gate4)(d, side)
        print(f"gate-{gate} fixture {side}^3 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(base) as fh:
        text = fh.read()
    if edit is not None:
        text = edit(text)
    path = os.path.join(d, name)
    with open(path, "w") as fh:
        fh.write(fixtures.with_settings(text, **sections))
    return path


def check_solve(system, rc: int, what: str, tol: float = 1e-8):
    """Fail unless the run passed its golden check with relres <= ``tol``
    (the run's tolerance) and a finite solution of the padded shape."""
    import torch
    if rc != 0:
        fail(f"the {what} run failed (cli exit {rc})")
    res = system.solve_results[0]
    relres = float(res.relres)
    if not (relres <= tol and bool(res.converged)):
        fail(f"{what}: relres {relres:.3e} above {tol:g} or not converged")
    x = system.sln[0]
    if not bool(torch.isfinite(x).all()) \
            or x.shape != (system.A.nparts * system.A.row_pad,):
        fail(f"{what}: solution is not finite or has the wrong shape")
    return res


def model_takes_xl(M) -> bool:
    """Whether the time model puts BDIA operator ``M`` on K5: the decision
    the layout makes (``ShardedMatrix.with_kernel``, priced on the segments
    its mask keeps and on steps balanced by the work K5 reads)."""
    return M.with_kernel().uses_bdia_xl


def gate4_phase(side: int, device_name: str, counters):
    """The gate-4 path; returns (launches, K4/K5 timing rows of its four
    operators on their BDIA layouts, K2 rows of those that run K2, the
    old-against-new rows of :func:`moved_timings` for all four, K5's
    launches by update form, the warm-solve profile, the ELL device
    factorization's trial on its A, :func:`gate4_rcm_ell_trial`, and the
    k-column forms' rows on its four operators, :func:`columns_check`,
    timed).  The factors' old kernel is K4 on the same BDIA layout: the one
    they ran before K5's segment mask priced K5 below it."""
    rc, system, wall, launches = run_cli(
        fixture_yaml(4, side, "gate4.yaml"), counters)
    print(f"gate-4 path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-4")
    pre = system._precond
    ops = (("A", system.A), ("A_lo", system.A_lo), ("L", pre.L),
           ("U", pre.U))
    print("gate-4 layouts: " + "; ".join(f"{name} {M.layout}"
                                         for name, M in ops), flush=True)
    # each operator runs the kernel the time model prices faster
    # (matrix/sharded.py:choose_layout, choose_xl) and launched it
    for name, M in ops:
        if M.uses_bdia and M.uses_bdia_xl != model_takes_xl(M):
            fail(f"gate-4 {name} runs {M.layout}, not the model's kernel")
        fn = launch_counter(M)
        if launches[fn.__name__] <= 0:
            fail(f"the gate-4 path launched no {fn.__name__} for {name} "
                 f"({M.layout})")
    if launches["bdia_spmv_xl"] > 0 and not any(M.uses_bdia_xl
                                                 for _, M in ops):
        fail(f"gate-4 launched K5 {launches['bdia_spmv_xl']} times with "
             "no BDIA-XL operator")
    if launches["bdia_spmv"] > 0 and not any(
            M.uses_bdia and not M.uses_bdia_xl for _, M in ops):
        fail(f"gate-4 launched K4 {launches['bdia_spmv']} times with no "
             "operator on K4")
    from tpusolve_torch.kernels.bdia import bdia_spmv_xl
    from tpusolve_torch.kernels.dia import epilogue_mode
    xl_forms = {epilogue_mode(*(True if f else None for f in form)): n
                for form, n in bdia_spmv_xl.launches_by_form.items()}
    print(f"gate-4 K5 launches by update form {xl_forms}", flush=True)
    print("gate-4 kernels, as the model prices them: " + ", ".join(
        f"{name} {kernel_of(M)}" for name, M in ops), flush=True)
    passes = res.passes or []
    print(f"gate-4 {side}^3: {res.iters} BiCGSTAB iterations over "
          f"{len(passes)} refinement passes {passes}, relres "
          f"{float(res.relres):.3e}, golden check PASSED", flush=True)
    if side == 96:
        gap = res.iters - TPUSOLVE_ITERS_96
        verdict = ("within one per pass" if abs(gap) <= len(passes)
                   else "MORE than one per pass")
        print(f"iterations: port {res.iters}, tpusolve (CPU, same fixture) "
              f"{TPUSOLVE_ITERS_96}: gap {gap:+d} over {len(passes)} passes, "
              f"{verdict}", flush=True)
        if res.iters != PORT_ITERS_96:
            fail(f"gate-4 took {res.iters} iterations, not the port's "
                 f"{PORT_ITERS_96}")
    # K2's and K5's k-column forms on the four operators at this size,
    # first: a long process's later traces lose device events
    col_rows = columns_check(dict(ops), card_line(), 15, timed=True)
    # the layouts before K2 was priced: BDIA for all four (A_lo is A's f32
    # twin; an operator still on BDIA is its own); K4 and K5 rows on them,
    # and old against new
    old_a = system.A if system.A.uses_bdia else old_layout(system.A)
    olds = {"A": old_a, "A_lo": system.A_lo if system.A_lo.uses_bdia
            else old_a.astype(system.A_lo.dtype)}
    for name, M in (("L", pre.L), ("U", pre.U)):
        olds[name] = (M._with_xl(None) if M.uses_bdia else old_layout(M))
    bdia_ops = [(name, M, M if M.uses_bdia else olds[name])
                for name, M in ops]
    bdia_ops = [op for op in bdia_ops if op[2].uses_bdia]
    rows = bdia_timings([(name, B) for name, _, B in bdia_ops],
                        device_name, 9)
    for row, (_, M, _) in zip(rows, bdia_ops):
        row["main_path"] = bool(M.uses_bdia)
    k2_rows = ell_timings([(f"gate-4 {name}", M) for name, M in ops
                           if M.uses_ell], device_name, 32)
    moved = moved_timings([(f"gate-4 {name}", M, olds[name])
                           for name, M in ops], device_name, 31)
    prof = solve_profile(system, "gate-4")
    trial = (gate4_rcm_ell_trial(system, card_line())
             if system.A.uses_ell else None)
    system.destroy_system()
    return launches, rows, k2_rows, moved, xl_forms, prof, trial, col_rows


# the kernel each layout runs, by the first word of its name
KERNEL_OF = {"DIA": "K1", "BDIA": "K4", "BDIA-XL": "K5", "BELL": "K6",
             "ELL": "K2 padded", "ELL-RP": "K2 row-pointer"}


def kernel_of(M) -> str:
    return KERNEL_OF[M.layout.split()[0]]


def launch_counter(M):
    """The wrapper (and launch counter) of the kernel operator ``M`` runs."""
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
    from tpusolve_torch.kernels.bell import bell_spmv
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv
    return {"K1": dia_spmv, "K4": bdia_spmv, "K5": bdia_spmv_xl,
            "K6": bell_spmv}.get(kernel_of(M), ell_spmv)


def check_launched(pre, launches: dict, what: str) -> None:
    """Fail unless every layout the cycle of hierarchy ``pre`` applies
    launched its kernel in the run: each level's A, and P and R where they
    are sparse operators (an algebraic hierarchy's are ELL, K2), K2 in each
    of its storage forms the hierarchy holds."""
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is None:
                continue
            name = launch_counter(M).__name__
            if M.uses_ell:
                name += " rowptr" if M.uses_ell_rowptr else " padded"
            if not launches[name]:
                fail(f"{what}: level {i}'s {key} ({M.layout}) launched no "
                     f"{name}")


def padded_copy(M):
    """ELL operator ``M`` in the padded form (itself if it is padded), at
    its ``row_width``."""
    import dataclasses
    from tpusolve_torch.kernels.ell import rowptr_to_padded
    if not M.uses_ell_rowptr:
        return M
    pv, pc = rowptr_to_padded(M.ell_rowptr[0], M.ell_vals[0],
                              M.ell_cols[0], M.row_width)
    return dataclasses.replace(M, diag_vals=pv[None], diag_cols=pc[None],
                               ell_rowptr=None, ell_vals=None, ell_cols=None)


def old_layout(M, tiles: bool = True):
    """Operator ``M`` as the assembly laid it out before K2 was priced
    among the layouts: with ``tiles`` (an operator that could take BDIA or
    BELL), the choice of ``allow_ell=False`` on its entries; ELL in the
    padded form, as every ELL operator was."""
    import numpy as np
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.vectors import numpy_dtype
    if tiles:
        M = ShardedMatrix.from_csr_host(
            M.to_scipy(), device=M.device, dtype=numpy_dtype(M.dtype),
            row_offsets=np.asarray(M.row_offsets),
            col_offsets=np.asarray(M.col_offsets), allow_ell=False)
    return padded_copy(M) if M.uses_ell else M


def moved_pairs(pre, what: str) -> list:
    """(name, operator, its old layout) of every operator of hierarchy
    ``pre`` whose kernel differs from the one it ran before K2 was priced
    (:func:`old_layout`): a coarse A that left BDIA or BELL for K2, or an
    ELL operator that took the row-pointer form.  P and R, and the card's
    level-0 operators, were padded ELL."""
    device_made = {(0, "P"), (0, "R"), (1, "A")} if any(
        n.startswith(DEVICE_NOTE) for n in pre.notes) else set()
    pairs = []
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is None or M.uses_dia:
                continue
            old = old_layout(M, key == "A" and (i, key) not in device_made)
            if kernel_of(old) != kernel_of(M):
                pairs.append((f"{what} level {i} {key}", M, old))
    return pairs


def k6_model_ms(M) -> float:
    """The layout model's price (ms) of K6 on BELL operator ``M``: its
    frozen constants (``SPMV_MODEL["bell"]``) on the tiles' and ids'
    bytes."""
    from tpusolve_torch.matrix import sharded
    _, G, K = M.bell_ids.shape
    return 1e3 * sharded.spmv_model_s(
        sharded.SPMV_MODEL["bell"], nbytes_of(M.bell_vals, M.bell_ids),
        sharded.bell_threads(G, K))


def k2_model_ms(M) -> float:
    """The layout model's price (ms) of K2 on ELL operator ``M`` in its
    form (``matrix/sharded.py:ell_model_s``)."""
    from tpusolve_torch.matrix import sharded
    form = "rowptr" if M.uses_ell_rowptr else "padded"
    K = M.row_width if M.uses_ell_rowptr else M.diag_vals.shape[-1]
    return 1e3 * sharded.ell_model_s(form, M.row_pad, M.col_pad, K, M.nnz,
                                     M.diag.element_size(), M.row_width)


# traces more of each kernel, in turn, where a moved operator's first
# reading is slower than its old kernel's
SLOWER_REPEATS = 4


def moved_timings(pairs, device_name: str, seed: int) -> list:
    """At each (name, operator, old layout) of ``pairs``: the device time
    of the kernel it runs now and of the one its old layout ran, on the
    same x (the two products agree to the dtype's tolerance), beside the
    library's CSR SpMV and the bound.  Where the first reading of the new
    kernel is slower, ``SLOWER_REPEATS`` more traces of each, in turn,
    judge it: slower where the median of its times exceeds the old one's
    by more than the wider spread of either's.  Fails if a new kernel is
    slower, but where K6 ran it before and K2's price is at least K6's
    measured time: then only K6's frozen constants (its ramp prices a small
    operator at twice its time) put it on K2.  Returns one row per
    operator."""
    import statistics
    import numpy as np
    import torch
    from tpusolve_torch.matrix.spmv import spmv

    rng = np.random.default_rng(seed)
    rows, slower = [], []
    for name, M, old in pairs:
        dt = str(M.dtype).replace("torch.", "")
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        err = rel_err(spmv(M, x), spmv(old, x))
        if not err <= RTOL[dt]:
            fail(f"{name}: {kernel_of(M)} vs {kernel_of(old)} rel err "
                 f"{err:.3e}")
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        calls = {"new": lambda: spmv(M, x), "old": lambda: spmv(old, x)}
        dev = device_times(dict(calls, lib=lib_call))
        runs = {k: [dev[k]] for k in calls}
        if dev["new"] > dev["old"]:
            for r in range(SLOWER_REPEATS):
                order = ("old", "new") if r % 2 else ("new", "old")
                for k, t in device_times({k: calls[k]
                                          for k in order}).items():
                    runs[k].append(t)
        med = {k: statistics.median(ts) for k, ts in runs.items()}
        spread = max(max(ts) - min(ts) for ts in runs.values())
        row = dict(op=name, dtype=dt, rows=M.shape[0], nnz=M.nnz,
                   old=old.layout, new=M.layout, old_kernel=kernel_of(old),
                   new_kernel=kernel_of(M), old_dev_ms=med["old"],
                   new_dev_ms=med["new"], old_runs=runs["old"],
                   new_runs=runs["new"], lib_dev_ms=dev["lib"],
                   bound_ms=bound_ms(spmv_nbytes(M), device_name),
                   rel_err=err,
                   no_slower=not med["new"] > med["old"] + spread)
        if kernel_of(old) == kernel_of(M):
            verdict = "the same kernel"
        elif row["no_slower"]:
            verdict = "no slower" if len(runs["new"]) == 1 else (
                f"no slower beyond the spread of {len(runs['new'])} "
                f"traces each, {spread:.5f} ms")
        else:
            verdict = (f"SLOWER by more than the spread of "
                       f"{len(runs['new'])} traces each, {spread:.5f} ms")
            row["k2_model_ms"] = k2_model_ms(M) if M.uses_ell else None
            if kernel_of(old) == "K6" and M.uses_ell:
                row["k6_model_ms"] = k6_model_ms(old)
                row["k6_conflict"] = row["k2_model_ms"] >= med["old"]
            if row.get("k6_conflict"):
                verdict += (f"; K6's frozen constants price it at "
                            f"{row['k6_model_ms']:.5f} ms, K2 at "
                            f"{row['k2_model_ms']:.5f}")
            else:
                slower.append(name)
        print(f"moved {name} {dt} ({M.shape[0]} rows, {M.nnz} nnz): "
              f"{row['old_kernel']} on {old.layout} device "
              f"{med['old']:.5f} ms -> {row['new_kernel']} on {M.layout} "
              f"device {med['new']:.5f} ms ({verdict}); library "
              f"(torch.sparse CSR) device {dev['lib']:.5f} ms; bound "
              f"{row['bound_ms']:.5f} ms; rel err {err:.1e}", flush=True)
        rows.append(row)
    if slower:
        fail(f"moved operators slower than their old kernel: {slower}")
    return rows


def print_timers(system, what: str) -> dict:
    """Print the run's timer rows on one line; returns them."""
    timers = system.timers.as_dict()
    print(f"{what} timer rows (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in timers.items()), flush=True)
    return timers


def run_gate3(side: int, counters, what: str, edit=None):
    """Run the gate-3 fixture at side^3 (its YAML passed through ``edit``;
    :func:`fixture_yaml`) through the CLI; returns :func:`run_cli`'s
    (exit code, system, wall, launches)."""
    name = what.replace(" ", "_") + ".yaml"
    return run_cli(fixture_yaml(3, side, name, edit), counters)


def gate3_phase(side: int, device_name: str, counters):
    """The gate-3 path; returns a dict of its launches, K4/K5 and K6 timing
    rows (on the BDIA and BELL levels, and on the old layouts of the levels
    that left them for K2), K2 rows of its ELL operators, the moved
    operators' old-against-new rows, timer rows and warm-solve profile."""
    rc, system, wall, launches = run_gate3(side, counters, "gate-3")
    print(f"gate-3 path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-3")
    pre = system._precond
    for line in pre.layouts():
        print(f"gate-3 {line}", flush=True)
    timers = print_timers(system, "gate-3")
    check_launched(pre, launches, "gate-3")
    print(f"gate-3 {side}^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; Preconditioner "
          f"setup {timers['Preconditioner setup']:.3f} s", flush=True)
    ref = TPUSOLVE_GATE3_ITERS.get(side)
    if ref is not None:
        print(f"iterations: port {res.iters}, tpusolve (CPU, same fixture) "
              f"{ref}", flush=True)
        if res.iters != ref:
            fail(f"gate-3 took {res.iters} GMRES iterations, tpusolve {ref}")
    moved = moved_pairs(pre, "gate-3")
    rows6, bdia_rows = tile_timings(pre, moved, "gate-3", device_name, 11)
    k2_rows = ell_timings(ell_ops(pre, "gate-3"), device_name, 25)
    moved_rows = moved_timings(moved, device_name, 26)
    prof = solve_profile(system, "gate-3")
    # phase (g)'s crossover: the generic-ELL setup of this operator's level
    # 0 against the host pipeline, the floors at 1 row
    crossover = ell_against_host(system, f"gate-3 {side}^3", card_line(), 1)
    system.destroy_system()
    return dict(launches=launches, k6_rows=rows6, k4_rows=bdia_rows,
                k2_rows=k2_rows, moved_rows=moved_rows, timers=timers,
                profile=prof, iters=int(res.iters),
                ell_against_host=crossover)


def tile_timings(pre, moved, what: str, device_name: str, seed: int):
    """(K6 rows, K4/K5 rows) of :func:`bell_timings` and
    :func:`bdia_timings` at the BELL and BDIA levels of hierarchy ``pre``
    and at the old BELL and BDIA layouts of the ``moved`` operators
    (:func:`moved_pairs`)."""
    ops = [(f"{what} level {i}", lev.A) for i, lev in enumerate(pre.levels)]
    ops += [(f"{name} (old layout)", old) for name, _, old in moved]
    return (bell_timings([op for op in ops if op[1].uses_bell],
                         device_name, seed),
            bdia_timings([op for op in ops if op[1].uses_bdia],
                         device_name, seed + 1))


def gate3_rs_phase(side: int, device_name: str, counters) -> dict:
    """Gate 3 with ``coarsen_type: 6`` (Falgout, run as serial RS by the
    native kernel): the same fixture through the CLI, every layout of the
    hierarchy launched, the moved operators' old-against-new rows, and
    tpusolve's iteration count (``TPUSOLVE_GATE3_RS_ITERS``)."""
    rc, system, wall, launches = run_gate3(
        side, counters, "gate-3 RS",
        lambda t: t.replace("coarsen_type: 8", "coarsen_type: 6"))
    print(f"gate-3 RS path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-3 RS")
    pre = system._precond
    if not any("serial RS" in n for n in pre.notes):
        fail("gate-3 RS: the hierarchy was not coarsened by serial RS")
    for line in pre.describe().splitlines()[1:] + pre.layouts():
        print(f"gate-3 RS {line}", flush=True)
    timers = print_timers(system, "gate-3 RS")
    check_launched(pre, launches, "gate-3 RS")
    moved_rows = moved_timings(moved_pairs(pre, "gate-3 RS"), device_name,
                               29)
    print(f"gate-3 RS {side}^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; Preconditioner "
          f"setup {timers['Preconditioner setup']:.3f} s; tpusolve (CPU, "
          f"same fixture and settings) {TPUSOLVE_GATE3_RS_ITERS}",
          flush=True)
    if res.iters != TPUSOLVE_GATE3_RS_ITERS:
        fail(f"gate-3 RS took {res.iters} GMRES iterations, tpusolve "
             f"{TPUSOLVE_GATE3_RS_ITERS}")
    out = dict(launches=launches, timers=timers, iters=int(res.iters),
               relres=float(res.relres), levels=[lev.n for lev in pre.levels],
               layouts=pre.layouts(), moved_rows=moved_rows)
    system.destroy_system()
    return out


def dia_check(ops, seed: int) -> tuple:
    """K1 against its plain version on each (name, DIA operator) of ``ops``
    in the operator's dtype and cast to the other one.  Returns (largest
    relative error, largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain

    rng = np.random.default_rng(seed)
    worst = worst_abs = 0.0
    for name, M in ops:
        if not M.uses_dia or M.device.type != "cuda":
            fail(f"operator {name} is not box DIA on the card ({M.layout})")
        for dt in (np.float32, np.float64):
            Mc = M.astype(dt)
            x = torch.tensor(rng.standard_normal(Mc.col_pad), dtype=Mc.dtype,
                             device=Mc.device)
            y = dia_spmv(Mc.dia_vals, Mc.dia_offsets, x)
            y_p = dia_spmv_plain(Mc.dia_vals, Mc.dia_offsets, x)
            err = rel_err(y, y_p)
            key = np.dtype(dt).name
            if not err <= RTOL[key]:
                fail(f"{name} {key}: K1 vs plain rel err {err:.3e} > "
                     f"{RTOL[key]}")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((y - y_p).abs().max()))
    return worst, worst_abs


def four_wide_check(device) -> float:
    """K1 on the 4^3 coarse level of the structured hierarchy at 16^3 (125
    planes; tpusolve's flat offsets collide there) against the exact CSR
    product of its DIA dict, in both dtypes.  Returns the largest relative
    error."""
    import numpy as np
    import torch
    from tpusolve_torch.amg import structured
    from tpusolve_torch.amg.dia_rap import dia_rap
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.stencil import laplace27_host_parts

    dia, box = laplace27_host_parts(1, 16, 16, 16)[0], (16, 16, 16)
    for _ in range(2):
        dia, box = dia_rap(dia, box)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    H = structured._structured_to_csr(dia, box, [empty], 1)
    x = np.random.default_rng(13).standard_normal(H.shape[0])
    y_ref = H @ x
    worst = 0.0
    for dt in (np.float32, np.float64):
        M = structured._dia_matrix(dia, [empty], box, 1, device, dt)
        y = dia_spmv(M.dia_vals, M.dia_offsets, torch.tensor(
            x, dtype=M.dtype, device=device)).double().cpu().numpy()
        err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        key = np.dtype(dt).name
        limit = 1e-14 if dt == np.float64 else RTOL[key]
        print(f"K1 4-wide box {box} D={len(M.dia_offsets)} {key}: against "
              f"the exact CSR product rel err {err:.3e} (limit {limit:.0e})",
              flush=True)
        if not err <= limit:
            fail(f"K1 on the 4-wide box {key} out of tolerance")
        worst = max(worst, err)
    return worst


def spmv_timings(ops, device_name: str, seed: int, key: str, kernel, plain,
                 layout) -> list:
    """At each (name, operator) of ``ops``: the kernel ``kernel(M, x)``
    (``key`` names it: ``"k1"``, ``"k6"``) against its plain version
    ``plain(M, x)``, its device and per-call time, the plain version's, the
    library's CSR SpMV and the bound (:func:`spmv_nbytes` over the card's
    HBM rate), beside the bytes the layout stores (the tensors
    ``layout(M)``).  Returns one row per operator."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.calibrate import time_ms

    rng = np.random.default_rng(seed)
    rows = []
    for name, M in ops:
        dt = str(M.dtype).replace("torch.", "")
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        y = kernel(M, x)
        y_p = plain(M, x)
        err = rel_err(y, y_p)
        if not err <= RTOL[dt]:
            fail(f"{name}: {key.upper()} vs plain rel err {err:.3e} > "
                 f"{RTOL[dt]}")
        lib_call, xlib = library_spmv(M)
        xlib.copy_(x[:xlib.numel()])
        y_lib = lib_call()
        err_lib = rel_err(y_lib, y_p[:y_lib.numel()])
        calls = [("plain", lambda: plain(M, x)), (key, lambda: kernel(M, x)),
                 ("lib", lib_call)]
        runs = {k: [] for k, _ in calls}
        for k, call in calls + calls[::-1]:
            runs[k].append(time_ms(call))
        row = dict(op=name, dtype=dt, layout=M.layout, rows=M.shape[0],
                   nnz=M.nnz, rel_err=err,
                   max_abs_err=float((y - y_p).abs().max()),
                   lib_rel_err=err_lib,
                   bound_ms=bound_ms(spmv_nbytes(M), device_name),
                   layout_mb=nbytes_of(*layout(M)) / 1e6)
        dev = device_times(dict(calls))
        for k, ts in runs.items():
            row[k + "_ms"] = min(ts)
            row[k + "_runs"] = ts
            row[k + "_dev_ms"] = dev[k]
        print(f"{name} {dt} {M.layout} ({M.shape[0]} rows, {M.nnz} nnz): "
              f"{key.upper()} device {row[key + '_dev_ms']:.5f} ms, per call "
              f"{row[key + '_ms']:.5f} ms (runs {ts_str(row[key + '_runs'])})"
              f", rel err {err:.3e}; plain device {row['plain_dev_ms']:.5f} "
              f"ms, per call {row['plain_ms']:.5f} ms; library (torch.sparse "
              f"CSR) device {row['lib_dev_ms']:.5f} ms, per call "
              f"{row['lib_ms']:.5f} ms (rel err {err_lib:.1e}); bound "
              f"{row['bound_ms']:.5f} ms (nnz, x, y; the layout stores "
              f"{row['layout_mb']:.3f} MB)", flush=True)
        rows.append(row)
    return rows


def dia_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K1 on DIA operators."""
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain
    return spmv_timings(
        ops, device_name, seed, "k1",
        lambda M, x: dia_spmv(M.dia_vals, M.dia_offsets, x),
        lambda M, x: dia_spmv_plain(M.dia_vals, M.dia_offsets, x),
        lambda M: (M.dia_vals,))


def bell_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K6 on BELL operators."""
    from tpusolve_torch.kernels.bell import bell_spmv, bell_spmv_plain
    args = lambda M, x: (M.bell_vals, M.bell_ids, x, M.bell_nwin, M.row_pad)
    return spmv_timings(
        ops, device_name, seed, "k6",
        lambda M, x: bell_spmv(*args(M, x)),
        lambda M, x: bell_spmv_plain(*args(M, x)),
        lambda M: (M.bell_vals, M.bell_ids))


def ell_timings(ops, device_name: str, seed: int) -> list:
    """:func:`spmv_timings` of K2 on ELL operators, each row with its
    storage form and K2's device times on it in both forms
    (:func:`k2_forms`)."""
    from tpusolve_torch.kernels.ell import ell_rowptr_plain, ell_spmv_plain
    from tpusolve_torch.matrix.spmv import spmv

    def plain(M, x):
        vals, cols, rowptr = M.ell_arrays
        if rowptr is None:
            return ell_spmv_plain(vals, cols, x)
        return ell_rowptr_plain(rowptr, vals, cols, x)

    rows = spmv_timings(
        ops, device_name, seed, "k2", spmv, plain,
        lambda M: (M.ell_rowptr, M.ell_vals, M.ell_cols)
        if M.uses_ell_rowptr else (M.diag_vals, M.diag_cols))
    for row, (name, M) in zip(rows, ops):
        row["form"] = "rowptr" if M.uses_ell_rowptr else "padded"
        row["forms_dev_ms"], row["forms_model_ms"] = k2_forms(name, M, seed)
    return rows


def k2_forms(name: str, M, seed: int) -> dict:
    """(device ms, modelled ms) of K2 on ELL operator ``M`` in both storage
    forms, each at its plan's G (the device ms also of the library's CSR
    SpMV; each against the plain version), the model's
    (``matrix/sharded.py:ell_model_s``) at the padded width."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.ell import (
        FORMS, ell_spmv, ell_spmv_plain, padded_to_rowptr)
    from tpusolve_torch.matrix.sharded import ell_model_s

    P = padded_copy(M)
    pv, pc = P.diag_vals[0], P.diag_cols[0]
    if M.uses_ell_rowptr:
        rv, rc, rp = M.ell_arrays
    else:
        rp, rv, rc = padded_to_rowptr(pv, pc)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                     device=M.device)
    calls = {"rowptr": lambda: ell_spmv(rv, rc, x, rowptr=rp),
             "padded": lambda: ell_spmv(pv, pc, x)}
    ref = ell_spmv_plain(pv, pc, x)
    dt = str(M.dtype).replace("torch.", "")
    for key, call in calls.items():
        err = rel_err(call(), ref)
        if not err <= RTOL[dt]:
            fail(f"{name}: K2 {key} vs plain rel err {err:.3e}")
    lib_call, xlib = library_spmv(M)
    xlib.copy_(x[:xlib.numel()])
    calls["library"] = lib_call
    dev = device_times(calls)
    model = {f: 1e3 * ell_model_s(f, M.row_pad, M.col_pad, pv.shape[-1],
                                  rv.numel(), pv.element_size(), M.row_width)
             for f in FORMS}
    form = "row-pointer" if M.uses_ell_rowptr else "padded"
    print(f"{name} {dt} K2 forms ({form} form runs): device ms "
          + ", ".join(f"{k} {v:.5f}" for k, v in dev.items())
          + "; model ms " + ", ".join(f"{k} {v:.5f}" for k, v in
                                     model.items()), flush=True)
    return dev, model


def ell_ops(pre, what: str) -> list:
    """(name, operator) of every padded-ELL operator of hierarchy ``pre``
    that its cycle applies: each level's A, P and R on that layout."""
    ops = []
    for i, lev in enumerate(pre.levels):
        for key in ("A", "P", "R"):
            M = getattr(lev, key)
            if M is not None and M.uses_ell:
                ops.append((f"{what} level {i} {key}", M))
    return ops


# K2 check shapes: (rows, x length, K); square and rectangular, K as on the
# BoomerAMG paths (1 and 8 as P, 40 as the weak-scaling level 1, 131 and
# 638 as gate 3's level-3 A and level-2 R)
K2_CHECKS = ((50_000, 50_000, 1), (200_000, 25_000, 8),
             (30_000, 30_000, 40), (3_000, 24_000, 131), (700, 6_000, 638))


def ell_check(device) -> tuple:
    """K2 against its plain version on random ragged ELL operators
    (``K2_CHECKS``: each row 0 to K entries, about 3 in 4 slots filled, at
    its first slots; the last rows empty) in f32 and f64, in the padded
    and the row-pointer form, at every threads-a-row count G, in the plain form and every update form, the
    accumulate form into ``c`` in place too; the same bits in two runs,
    and the same bits in both forms at the same G.  Returns (largest
    relative error, largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels import ell

    rng = np.random.default_rng(13)
    forms = (("Ax", {}), ("b-Ax", dict(b=1)), ("c+w*s*(b-Ax)",
             dict(b=1, s=1, c=1, w=0.8)), ("s*(b-Ax)", dict(b=1, s=1)),
             ("c-s*Ax", dict(s=1, c=1)), ("c+Ax", dict(c=1, w=-1.0)))
    worst = worst_abs = 0.0
    for rows, ncols, K in K2_CHECKS:
        counts = rng.binomial(K, 0.75, rows)
        counts[-max(1, rows // 64):] = 0
        pad = np.arange(K)[None] >= counts[:, None]
        cols = rng.integers(0, ncols, (rows, K))
        cols[pad] = 0
        vals = rng.standard_normal((rows, K))
        vals[pad] = 0
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            V = torch.tensor(vals, dtype=dtype, device=device)
            C = torch.tensor(cols, dtype=torch.int32, device=device)
            rp, rv, rc = ell.padded_to_rowptr(V, C)
            vec = lambda n: torch.tensor(rng.standard_normal(n), dtype=dtype,
                                         device=device)
            x, b, s, c = vec(ncols), vec(rows), vec(rows), vec(rows)
            errs = []
            for form, kw in forms:
                kw = {k: (v if k == "w" else dict(b=b, s=s, c=c)[k])
                      for k, v in kw.items()}
                ref = ell.ell_spmv_plain(V, C, x, **kw)
                for g in ell.GROUPS:
                    y = ell.ell_spmv(V, C, x, **kw, groups=g)
                    errs.append(rel_err(y, ref))
                    worst_abs = max(worst_abs, float((y - ref).abs().max()))
                    runs = [ell.ell_spmv(V, C, x, **kw, groups=g)] + [
                        ell.ell_spmv(rv, rc, x, **kw, rowptr=rp, groups=g)
                        for _ in range(2)]
                    if not all(torch.equal(y, r) for r in runs):
                        fail(f"K2 {form} G={g}: other bits on a rerun or in "
                             "the row-pointer form")
                if "c" in kw:
                    for rowptr in (None, rp):
                        out = c.clone()
                        args = (V, C) if rowptr is None else (rv, rc)
                        ell.ell_spmv(*args, x, **dict(kw, c=out), out=out,
                                     rowptr=rowptr)
                        errs.append(rel_err(out, ref))
            torch.cuda.synchronize()
            err = max(errs)
            print(f"K2 check rows={rows} x={ncols} K={K} nnz={rv.numel()} "
                  f"{dt}: both forms (padded, row-pointer), every G "
                  f"{ell.GROUPS} and form ({len(forms)}, "
                  f"in place into c too) against the plain version: max "
                  f"rel err {err:.3e} (limit {RTOL[dt]:.0e}), the same "
                  f"bits in both forms and on a rerun; plans: padded "
                  f"G={ell.k2_plan(rows, K)}, row-pointer "
                  f"G={ell.k2_rowptr_plan(rows, rv.numel())}", flush=True)
            if not err <= RTOL[dt]:
                fail(f"K2 check rows={rows} K={K} {dt} out of tolerance")
            worst = max(worst, err)
    return worst, worst_abs


# K1's update forms in the V-cycle: (keyword arguments, weight); the
# Jacobi form updates the x it multiplies, as the smoother does
K1_FORMS = (("residual b - A x", ("b",), 1.0),
            ("Jacobi x + w s (b - A x)", ("b", "s", "x"), 0.9),
            ("Chebyshev s (b - A x)", ("b", "s"), 1.0),
            ("Chebyshev r - s A d", ("s", "c"), 1.0))


def dia_mode_check(ops, seed: int) -> tuple:
    """K1 against its plain version on each (name, DIA operator) of ``ops``
    in f32 and f64, in the plain form and in each update form of
    ``K1_FORMS``, and each launch's output the same bits in a second run.
    Returns (largest relative error, largest absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv, dia_spmv_plain

    rng = np.random.default_rng(seed)
    worst = worst_abs = 0.0
    for name, M in ops:
        for dt in (np.float32, np.float64):
            Mc = M.astype(dt)
            vec = {k: torch.tensor(rng.standard_normal(Mc.col_pad),
                                   dtype=Mc.dtype, device=Mc.device)
                   for k in ("x", "b", "s", "c")}
            key = np.dtype(dt).name
            for form, names, w in (("A x", (), 1.0),) + K1_FORMS:
                kw = {("c" if k == "x" else k): vec[k] for k in names}
                args = (Mc.dia_vals, Mc.dia_offsets, vec["x"])
                y = dia_spmv(*args, w=w, **kw)
                again = dia_spmv(*args, w=w, **kw)
                y_p = dia_spmv_plain(*args, w=w, **kw)
                err = rel_err(y, y_p)
                if not err <= RTOL[key] or not torch.equal(y, again):
                    fail(f"{name} {key} K1 {form}: rel err {err:.3e} > "
                         f"{RTOL[key]} or not the same bits twice")
                worst = max(worst, err)
                worst_abs = max(worst_abs, float((y - y_p).abs().max()))
    return worst, worst_abs


def cold_warm(name: str, M, device_name: str) -> dict:
    """K1's device time on operator ``M`` warm (the loop keeps its planes
    in the 50 MB L2 where they fit), cold (256 MB written between calls
    flushes the L2, as the solve's larger level evicts it) and warm but
    spaced (a kernel that spins about as long as the flush, touching no
    memory, between calls), in one call."""
    import torch
    from tpusolve_torch.kernels.dia import dia_spmv
    x = torch.randn(M.col_pad, dtype=M.dtype, device=M.device)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=M.device)
    call = lambda: dia_spmv(M.dia_vals, M.dia_offsets, x)
    out = device_times({
        "warm_ms": call, "cold_ms": lambda: (flush.zero_(), call()),
        "spaced_ms": lambda: (torch.cuda._sleep(200_000), call())},
        only="dia_spmv")
    out.update(op=name, bound_ms=bound_ms(spmv_nbytes(M), device_name))
    print(f"{name} K1 device warm {out['warm_ms']:.5f} ms, cold (L2 flushed "
          f"before each call) {out['cold_ms']:.5f} ms, warm and spaced (a "
          f"spin kernel between calls) {out['spaced_ms']:.5f} ms; bound "
          f"{out['bound_ms']:.5f} ms", flush=True)
    return out


# K3's library yardsticks: one PyTorch call each that computes the same
# function (the port calls neither)
LIBRARY = {"prolong": "torch.nn.functional.interpolate (trilinear; P xc "
                      "alone)",
           "restrict": "torch.ops.aten.upsample_trilinear3d_backward"}


def transfer_check(pre, what: str, device_name: str, seed: int) -> list:
    """K3 on every transition of the structured hierarchy ``pre``: the
    prolongation with its add and the restriction against their plain
    versions in f32 and f64 (relative error under RTOL; whether equal bit
    for bit), the adjoint identity <P u, v> = <u, P^T v> on the card in f64,
    the library's prolongation (``interpolate``, trilinear,
    ``align_corners=False``) and restriction (that interpolation's
    backward, ``upsample_trilinear3d_backward``: its adjoint) against the
    plain ones, and in the level's dtype each kernel's device and per-call
    time beside the plain version's, the library's and the bound (the
    coarse vector read, the fine one read and written, or the fine read and
    the coarse written, over the card's HBM rate).  Returns one row per
    (transition, kernel)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_restrict, prolong_plain, restrict_plain)

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(len(pre.levels) - 1):
        fine = tuple(pre.levels[i].A.dia_shape)
        coarse = tuple(pre.levels[i + 1].A.dia_shape)
        nf, nc = int(np.prod(fine)), int(np.prod(coarse))
        dev = pre.levels[i].A.device
        name = (f"{what} transfer {i}->{i + 1} ({'x'.join(map(str, fine))}"
                f" <-> {'x'.join(map(str, coarse))})")

        def vec(n, dt):
            return torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)
        errs = {"prolong": [], "restrict": []}
        for dt in (torch.float32, torch.float64):
            xc, rf, x = vec(nc, dt), vec(nf, dt), vec(nf, dt)
            key = str(dt).replace("torch.", "")
            for kind, y, y_p in (
                    ("prolong", box_prolong(fine, coarse, xc, x),
                     prolong_plain(fine, coarse, xc, x)),
                    ("restrict", box_restrict(fine, coarse, rf),
                     restrict_plain(fine, coarse, rf))):
                err = rel_err(y, y_p)
                if not err <= RTOL[key]:
                    fail(f"{name} {key}: K3 {kind} vs plain rel err "
                         f"{err:.3e} > {RTOL[key]}")
                errs[kind].append((err, float((y - y_p).abs().max()),
                                   bool(torch.equal(y, y_p))))
        u, v = vec(nc, torch.float64), vec(nf, torch.float64)
        lhs = float(torch.dot(box_prolong(fine, coarse, u), v))
        rhs = float(torch.dot(u, box_restrict(fine, coarse, v)))
        adj = abs(lhs - rhs) / abs(rhs)
        if not adj <= 1e-12:
            fail(f"{name}: <P u, v> - <u, P^T v> relative {adj:.3e}")
        dt = pre.levels[i].A.dtype
        xc, rf, x = vec(nc, dt), vec(nf, dt), vec(nf, dt)
        lib = lambda: F.interpolate(xc.reshape((1, 1) + coarse),
                                    scale_factor=2, mode="trilinear",
                                    align_corners=False)
        lib_t = lambda: torch.ops.aten.upsample_trilinear3d_backward(
            rf.reshape((1, 1) + fine), list(fine), [1, 1] + list(coarse),
            False, 2.0, 2.0, 2.0)
        err_lib = {"prolong": rel_err(lib().reshape(-1),
                                      prolong_plain(fine, coarse, xc)),
                   "restrict": rel_err(lib_t().reshape(-1),
                                       restrict_plain(fine, coarse, rf))}
        item = xc.element_size()
        calls = {"prolong": [
            ("plain", lambda: prolong_plain(fine, coarse, xc, x)),
            ("kernel", lambda: box_prolong(fine, coarse, xc, x, out=x)),
            ("lib", lib)],
            "restrict": [
            ("plain", lambda: restrict_plain(fine, coarse, rf)),
            ("kernel", lambda: box_restrict(fine, coarse, rf)),
            ("lib", lib_t)]}
        nbytes = {"prolong": (nc + 2 * nf) * item,
                  "restrict": (nf + nc) * item}
        dev = device_times({f"{kind} {k}": call
                              for kind, cl in calls.items() for k, call in cl})
        for kind, cl in calls.items():
            runs = {k: [] for k, _ in cl}
            for k, call in cl + cl[::-1]:
                runs[k].append(time_ms(call))
            row = dict(op=name, kernel=kind, dtype=str(dt).replace(
                "torch.", ""), fine=fine, coarse=coarse,
                rel_err=max(e[0] for e in errs[kind]),
                max_abs_err=max(e[1] for e in errs[kind]),
                equal_to_plain=all(e[2] for e in errs[kind]),
                adjoint_rel=adj, lib_rel_err=err_lib[kind],
                bound_ms=bound_ms(nbytes[kind], device_name))
            for k, ts in runs.items():
                row[k + "_ms"] = min(ts)
                row[k + "_runs"] = ts
                row[k + "_dev_ms"] = dev[f"{kind} {k}"]
            lib_note = (f"library ({LIBRARY[kind]}; rel err "
                        f"{err_lib[kind]:.1e}) device "
                        f"{row['lib_dev_ms']:.5f} ms, per call "
                        f"{row['lib_ms']:.5f} ms")
            print(f"{name} {row['dtype']} K3 {kind}: device "
                  f"{row['kernel_dev_ms']:.5f} ms, per call "
                  f"{row['kernel_ms']:.5f} ms (runs "
                  f"{ts_str(row['kernel_runs'])}); plain device "
                  f"{row['plain_dev_ms']:.5f} ms, per call "
                  f"{row['plain_ms']:.5f} ms; {lib_note}; bound "
                  f"{row['bound_ms']:.5f} ms; vs plain rel err "
                  f"{row['rel_err']:.3e} (f32 and f64), equal bit for bit: "
                  f"{row['equal_to_plain']}; adjoint rel {adj:.1e}",
                  flush=True)
            rows.append(row)
    return rows


# the fused kernels' library note: no single PyTorch call computes either
FUSED_LIBRARY = ("none: no single PyTorch call computes the fused function; "
                 "the reference beside it is the sum of the CSR SpMV "
                 "(cuSPARSE) and the transfer's library call")


def fused_check(pre, what: str, device_name: str, seed: int) -> list:
    """The fused cycle kernels (``csrc/box_cycle.cu``) on every transition
    of the structured hierarchy ``pre``, on the level's own operator, in
    f32 and f64: ``box_restrict_residual`` against its plain version
    (relative error under RTOL) and against the pair it replaces, K1's
    residual then K3's restriction (bit for bit); ``box_prolong_update`` in
    the Jacobi form (c = x') and in Chebyshev's first step (x' written out)
    the same way against K3's prolongation then K1's update.  Then in the
    level's dtype each kernel's device and per-call time, in turns with the
    pair's two launches (fused, pair, pair, fused), the plain version's,
    the library reference (the CSR SpMV plus ``interpolate``'s backward, or
    ``interpolate``) and the bound: A's planes (its nonzeros), x, b (and s,
    ec) read once and the outputs written once, over the card's HBM rate.
    Returns one row per (transition, kernel)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_prolong_update, box_restrict, box_restrict_residual,
        prolong_update_plain, restrict_residual_plain)

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(len(pre.levels) - 1):
        A = pre.levels[i].A
        fine = tuple(A.dia_shape)
        coarse = tuple(pre.levels[i + 1].A.dia_shape)
        offs = A.dia_offsets
        nf, nc = int(np.prod(fine)), int(np.prod(coarse))
        dev = A.device
        name = (f"{what} transition {i}->{i + 1} ({'x'.join(map(str, fine))}"
                f" <-> {'x'.join(map(str, coarse))}, D={len(offs)})")

        def vec(n, dt):
            return torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)
        errs = {"restrict": [], "prolong": []}
        for dt in (torch.float32, torch.float64):
            vals = A.dia_vals.to(dt)
            x, b, s, ec = vec(nf, dt), vec(nf, dt), vec(nf, dt), vec(nc, dt)
            key = str(dt).replace("torch.", "")
            xn = torch.empty_like(x)
            xp = box_prolong(fine, coarse, ec, x)
            cases = (
                ("restrict", box_restrict_residual(fine, coarse, vals, offs,
                                                   x, b),
                 box_restrict(fine, coarse, dia_spmv(vals, offs, x, b=b)),
                 restrict_residual_plain(fine, coarse, vals, offs, x, b)),
                ("prolong", box_prolong_update(fine, coarse, vals, offs, ec,
                                               x, b, s, 1.0, True),
                 dia_spmv(vals, offs, xp, b, s, xp, 1.0),
                 prolong_update_plain(fine, coarse, vals, offs, ec, x, b, s,
                                      1.0, True)),
                ("prolong", box_prolong_update(fine, coarse, vals, offs, ec,
                                               x, b, s, 1.0, False, xn),
                 dia_spmv(vals, offs, xp, b, s),
                 prolong_update_plain(fine, coarse, vals, offs, ec, x, b, s,
                                      1.0, False)))
            torch.cuda.synchronize()
            for kind, y, y_pair, y_plain in cases:
                err = rel_err(y, y_plain)
                if not err <= RTOL[key]:
                    fail(f"{name} {key}: fused {kind} vs plain rel err "
                         f"{err:.3e} > {RTOL[key]}")
                same = bool(torch.equal(y, y_pair))
                if not same:
                    fail(f"{name} {key}: fused {kind} differs from the pair "
                         "of launches it replaces")
                errs[kind].append((err, float((y - y_plain).abs().max())))
            if not torch.equal(xn, xp):
                fail(f"{name} {key}: the fused prolongation's x' differs "
                     "from K3's")
        dt = A.dtype
        vals = A.dia_vals
        x, b, s, ec = vec(nf, dt), vec(nf, dt), vec(nf, dt), vec(nc, dt)
        lib_spmv, lx = library_spmv(A)
        lx.copy_(x)
        rf = vec(nf, dt)
        lib_up = lambda: F.interpolate(ec.reshape((1, 1) + coarse),
                                       scale_factor=2, mode="trilinear",
                                       align_corners=False)
        lib_down = lambda: torch.ops.aten.upsample_trilinear3d_backward(
            rf.reshape((1, 1) + fine), list(fine), [1, 1] + list(coarse),
            False, 2.0, 2.0, 2.0)
        calls = {
            "restrict": {
                "fused": lambda: box_restrict_residual(fine, coarse, vals,
                                                       offs, x, b),
                "pair": lambda: box_restrict(fine, coarse, dia_spmv(
                    vals, offs, x, b=b)),
                "plain": lambda: restrict_residual_plain(fine, coarse, vals,
                                                         offs, x, b)},
            "prolong": {
                "fused": lambda: box_prolong_update(fine, coarse, vals, offs,
                                                    ec, x, b, s, 1.0, True),
                "pair": lambda: dia_spmv(vals, offs, box_prolong(
                    fine, coarse, ec, x), b, s, None, 1.0),
                "plain": lambda: prolong_update_plain(fine, coarse, vals,
                                                      offs, ec, x, b, s, 1.0,
                                                      True)}}
        lib = {"restrict": (lib_spmv, lib_down), "prolong": (lib_spmv,
                                                             lib_up)}
        item = x.element_size()
        nbytes = {"restrict": (A.nnz + 2 * nf + nc) * item,
                  "prolong": (A.nnz + 4 * nf + nc) * item}
        dev_ms = device_times({f"{kind} {k}": call
                               for kind, cl in calls.items()
                               for k, call in cl.items()})
        dev_ms.update(device_times({
            f"{kind} lib {j}": call for kind, pair in lib.items()
            for j, call in enumerate(pair)}))
        for kind, cl in calls.items():
            runs = {k: [] for k in cl}
            for k in ("fused", "pair", "pair", "fused", "plain"):
                runs[k].append(time_ms(cl[k]))
            row = dict(op=name, kernel=kind, dtype=str(dt).replace(
                "torch.", ""), fine=fine, coarse=coarse, slots=len(offs),
                rel_err=max(e[0] for e in errs[kind]),
                max_abs_err=max(e[1] for e in errs[kind]),
                equal_to_pair=True,
                bound_ms=bound_ms(nbytes[kind], device_name),
                library=FUSED_LIBRARY,
                library_reference_dev_ms=dev_ms[f"{kind} lib 0"]
                + dev_ms[f"{kind} lib 1"])
            for k, ts in runs.items():
                row[k + "_ms"] = min(ts)
                row[k + "_runs"] = ts
                row[k + "_dev_ms"] = dev_ms[f"{kind} {k}"]
            print(f"{name} {row['dtype']} fused {kind}: device "
                  f"{row['fused_dev_ms']:.5f} ms, per call "
                  f"{row['fused_ms']:.5f} ms (runs "
                  f"{ts_str(row['fused_runs'])}); the pair device "
                  f"{row['pair_dev_ms']:.5f} ms, per call "
                  f"{row['pair_ms']:.5f} ms (runs "
                  f"{ts_str(row['pair_runs'])}); plain device "
                  f"{row['plain_dev_ms']:.5f} ms, per call "
                  f"{row['plain_ms']:.5f} ms; library none (reference: CSR "
                  f"SpMV + {'interpolate backward' if kind == 'restrict' else 'interpolate'} "
                  f"device {row['library_reference_dev_ms']:.5f} ms); bound "
                  f"{row['bound_ms']:.5f} ms; vs plain rel err "
                  f"{row['rel_err']:.3e} (f32 and f64), equal to the pair "
                  "bit for bit (f32 and f64)", flush=True)
            rows.append(row)
    return rows


def cycle_check(pre, what: str, seed: int) -> dict:
    """One V-cycle of the hierarchy ``pre`` as the run built it (the fused
    kernels on every transition) against the same cycle built in the pair
    form (``amg/builder.py:_build_cycle(..., fused=False)``), on one random
    vector, bit for bit; fails otherwise."""
    import numpy as np
    import torch
    from tpusolve_torch.amg import builder
    cfg = pre.config
    kind_down, kind_up, kind_coarse, _ = builder._resolve_kinds(cfg)
    kind_coarse, coarse_sweeps = builder._guard_coarse(
        kind_coarse, pre.levels[-1].n, cfg, [])
    pair = builder._build_cycle(pre, kind_down, kind_up, cfg,
                                kind_coarse=kind_coarse,
                                coarse_sweeps=coarse_sweeps, fused=False)
    A = pre.levels[0].A
    r = torch.tensor(np.random.default_rng(seed).standard_normal(
        A.row_pad), dtype=A.dtype, device=A.device)
    z, z_pair = pre.apply(r), pair(r)
    same = bool(torch.equal(z, z_pair))
    print(f"{what} one V-cycle, fused against the pair form "
          f"{pre.cycle.fused} vs {pair.fused}: equal bit for bit: {same}",
          flush=True)
    if not same or not all(all(f) for f in pre.cycle.fused):
        fail(f"{what}: the fused V-cycle differs from the pair form, or a "
             "transition runs the pair")
    return dict(equal=same, fused=pre.cycle.fused)


def ts_str(ts) -> str:
    return ", ".join(f"{t:.5f}" for t in ts)


# kernel-name classes of the solve profile, first match wins
PROFILE_CLASSES = (("K4 and K5", ("bdia_spmv",)),
                   ("K1 with K3", ("restrict_residual", "prolong_update")),
                   ("K1", ("dia_spmv",)),
                   ("K3", ("box_prolong", "box_restrict")),
                   ("K6", ("bell_spmv",)),
                   ("K2", ("ell_spmv", "ell_rowptr", "ell_pack")),
                   ("ELL gathers", ("scatter_gather", "indexselect")),
                   ("coarse matmul", ("gemv", "gemm", "cublas", "sm90_")),
                   ("reductions", ("reduce",)),
                   ("copies and cat", ("copy", "cat", "memcpy", "memset")),
                   ("elementwise", ("elementwise",)))


def solve_profile(system, what: str) -> dict:
    """One warm solve of ``system`` (its solver as the run built it): the
    wall time (host clock, synchronised), then the same solve under
    ``torch.profiler``: its device operations (kernel launches, copies and
    sets) and their device time, in all and by kernel class, the device's
    idle share of the wall time, K1's and K2's launches by form in that
    solve, and the names of the kernels in the "ELL gathers" class."""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpusolve_torch.kernels import dia

    # an earlier package (profile_solves.py) counts no launches by form,
    # or has no K2
    forms = getattr(dia, "launches_by_mode", dict)
    try:
        k2 = importlib.import_module("tpusolve_torch.kernels.ell").ell_spmv
        k2_forms = lambda: dict(k2.launches_by_form)
        k2_layouts = lambda: dict(getattr(k2, "launches_by_layout", {}))
    except ImportError:
        k2_forms = k2_layouts = dict
    solver, b = system._solver, system.rhs[0]
    solver(b)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * min(walls)
    before, before2, before3 = forms(), k2_forms(), k2_layouts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver(b)
        torch.cuda.synchronize()
    k1_modes = {k: n - before.get(k, 0) for k, n in forms().items()
                if n > before.get(k, 0)}
    k2_modes = {k: n - before2.get(k, 0) for k, n in k2_forms().items()
                if n > before2.get(k, 0)}
    k2_layout = {k: n - before3.get(k, 0) for k, n in k2_layouts().items()
                 if n > before3.get(k, 0)}
    by_class, ops, by_name, gathers = {}, {}, {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        cls = next((c for c, keys in PROFILE_CLASSES
                    if any(k in low for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        ops[cls] = ops.get(cls, 0) + 1
        if cls == "ELL gathers":
            gathers[e.name] = gathers.get(e.name, 0) + 1
    busy_ms = sum(by_class.values()) / 1e3
    out = dict(wall_ms=wall_ms, walls_ms=[1e3 * w for w in walls],
               iters=int(res.iters), busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               device_ops=sum(ops.values()),
               by_class_ms={k: v / 1e3 for k, v in sorted(
                   by_class.items(), key=lambda kv: -kv[1])},
               ops_by_class=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
               k1_launches_by_form=k1_modes, k2_launches_by_form=k2_modes,
               k2_launches_by_layout=k2_layout,
               gathers=gathers,
               top=[(n, us / 1e3) for n, us in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:8]])
    print(f"{what} warm solve: {out['iters']} iterations, wall "
          f"{wall_ms:.3f} ms (runs {ts_str(out['walls_ms'])}); device busy "
          f"{busy_ms:.3f} ms in the profiled solve, idle share "
          f"{out['idle_share']:.3f}; {out['device_ops']} device operations "
          f"(kernel launches, copies, sets); by class, ms (operations): "
          + ", ".join(f"{k} {v:.3f} ({ops[k]})"
                      for k, v in out["by_class_ms"].items())
          + f"; K1 launches by form {k1_modes}; K2 launches by form "
          f"{k2_modes} and by storage form {k2_layout}; gathers {gathers}; "
          "top kernels "
          + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in out["top"]),
          flush=True)
    return out


def structured_phase(what: str, yaml_name: str, tol: float, device_name,
                     counters, seed: int, side: int | None = None):
    """Gate 1 or 2 (``examples/<yaml_name>``, its box at side^3 where
    ``side`` is given) through the CLI, counting the preconditioner's
    applications; returns (launches, K1's launches by form, system, result,
    K1 check errors, K1 timing rows, K3 rows, fused rows, cycle check).
    The system is left for the caller to destroy."""
    from tpusolve_torch.amg import builder
    from tpusolve_torch.kernels.dia import dia_spmv, launches_by_mode
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_prolong_update, box_restrict, box_restrict_residual)
    yaml_path = os.path.join(REPO, "examples", yaml_name)
    if side is not None:
        with open(yaml_path) as fh:
            text = "".join(
                f"{ln.split(':')[0]}: {side}\n"
                if ln.strip().split(":")[0] in ("nx", "ny", "nz") else ln
                for ln in fh)
        os.makedirs(FIXTURES, exist_ok=True)
        yaml_path = os.path.join(FIXTURES, f"{side}_{yaml_name}")
        with open(yaml_path, "w") as fh:
            fh.write(text)
    apply, applied = builder.AMGPreconditioner.apply, [0]

    def counted(self, r):
        applied[0] += 1
        return apply(self, r)
    builder.AMGPreconditioner.apply = counted
    try:
        rc, system, wall, launches = run_cli(yaml_path, counters)
    finally:
        builder.AMGPreconditioner.apply = apply
    by_form = launches_by_mode()
    print(f"{what} path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}; K1 by form {by_form}; {applied[0]} preconditioner "
          "applications", flush=True)
    res = check_solve(system, rc, what, tol)
    pre = system._precond
    for line in pre.layouts():
        print(f"{what} {line}", flush=True)
    path = (dia_spmv, box_restrict_residual, box_prolong_update)
    for fn in path:
        if launches[fn.__name__] <= 0:
            fail(f"the {what} path launched no {fn.__name__}")
    transitions = len(pre.levels) - 1
    want = transitions * applied[0]
    for fn in path[1:]:
        if launches[fn.__name__] != want:
            fail(f"the {what} path launched {fn.__name__} "
                 f"{launches[fn.__name__]} times, not {transitions} "
                 f"transitions x {applied[0]} applications = {want}")
    for fn in (box_prolong, box_restrict):
        if launches[fn.__name__]:
            fail(f"the {what} path launched the standalone {fn.__name__}")
    other = {k: v for k, v in launches.items()
             if k not in {fn.__name__ for fn in path}}
    if any(other.values()):
        fail(f"the {what} path launched other kernels: {other}")
    ops = [(f"{what} level {i}", lev.A) for i, lev in enumerate(pre.levels)]
    if system.A_lo is not None:
        ops.append((f"{what} A", system.A))
    errs = dia_check(ops, seed)
    mode_errs = dia_mode_check(ops, seed + 2)
    errs = (max(errs[0], mode_errs[0]), max(errs[1], mode_errs[1]))
    rows = dia_timings(ops, device_name, seed + 1)
    k3_rows = transfer_check(pre, what, device_name, seed + 3)
    fused_rows = fused_check(pre, what, device_name, seed + 4)
    cycle = cycle_check(pre, what, seed + 5)
    return (launches, by_form, system, res, errs, rows, k3_rows, fused_rows,
            cycle)


def gate1_phase(device_name, counters):
    (launches, by_form, system, res, errs, rows, k3_rows, fused_rows,
     cycle) = structured_phase("gate-1", "gate1_64cube_pcg_amg.yaml", 1e-8,
                               device_name, counters, 14)
    passes = res.passes or []
    gap = res.iters - TPUSOLVE_GATE1_ITERS
    print(f"gate-1 64^3: {res.iters} PCG iterations over {len(passes)} "
          f"refinement passes {passes}, relres {float(res.relres):.3e}, "
          f"golden check PASSED; tpusolve (CPU, same YAML) "
          f"{TPUSOLVE_GATE1_ITERS}: gap {gap:+d}", flush=True)
    if not passes or abs(gap) > len(passes):
        fail(f"gate-1 took {res.iters} iterations, more than one per pass "
             f"from tpusolve's {TPUSOLVE_GATE1_ITERS}")
    cold = cold_warm("gate-1 level 1", system._precond.levels[1].A,
                     device_name)
    prof = solve_profile(system, "gate-1")
    system.destroy_system()
    return (launches, by_form, errs, rows, k3_rows, fused_rows, cycle, prof,
            cold)


def gate2_phase(device_name, counters):
    (launches, by_form, system, res, errs, rows, k3_rows, fused_rows,
     cycle) = structured_phase("gate-2", "gate2_weakscale_gmres_cheby.yaml",
                               1e-6, device_name, counters, 16, GATE2_SIDE)
    print(f"gate-2 {GATE2_SIDE}^3: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; the port's count "
          f"{PORT_GATE2_ITERS}; tpusolve (CPU, same YAML, its f32 "
          f"projection stalls) {TPUSOLVE_GATE2_ITERS}", flush=True)
    if abs(res.iters - PORT_GATE2_ITERS) > 1:
        fail(f"gate-2 took {res.iters} iterations, not within one of the "
             f"port's {PORT_GATE2_ITERS}")
    prof = solve_profile(system, "gate-2")
    system.destroy_system()
    return (launches, by_form, errs, rows, k3_rows, fused_rows, cycle,
            prof)


def rel_sparse(M, M_ref) -> float:
    """max |M - M_ref| / max |M_ref| of two scipy matrices."""
    d = abs(M - M_ref)
    return (d.max() if d.nnz else 0.0) / max(abs(M_ref).max(), 1e-300)


def device_setup_check(device) -> list:
    """Level 0 of the 32^3 stencil in f64 set up on the card
    (``device_setup.device_level0``, the row floor forced) for interp types
    0 and 3, against the port's host pipeline on the same operator: the C/F
    split equal, P, R and the coarse A to 1e-12 relative.  Returns one row
    per interp type, with the seconds of each stage."""
    import numpy as np
    import torch
    from tpusolve_torch.amg import builder, device_setup
    from tpusolve_torch.config import BoomerAMGConfig
    from tpusolve_torch.stencil import laplace27

    A, _, _ = laplace27(32, 32, 32, device=device, dtype=np.float64)
    rows = []
    for itype in (0, 3):
        # CF order keeps the host pipeline's split on its level 0
        cfg = BoomerAMGConfig(max_coarse_size=64, interp_type=itype,
                              relax_order=1)
        if not device_setup.eligible(A, cfg, min_n=1):
            fail("device setup check: the 32^3 stencil is not eligible")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = device_setup.device_level0(A, cfg)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        pre_h = builder.boomeramg_setup(A, cfg, device_min_n=None)
        t_host = time.perf_counter() - t0
        lev0, lev1 = pre_h.levels[0], pre_h.levels[1]
        same_split = bool(torch.equal(res["Cmask"], lev0.cmask))
        errs = {key: rel_sparse(res[key].to_scipy(), M.to_scipy())
                for key, M in (("P", lev0.P), ("R", lev0.R),
                               ("Ac", lev1.A))}
        print(f"device setup 32^3 float64 interp_type {itype} on the card: "
              f"{res['nc']} C points, split equal to the host pipeline's: "
              f"{same_split}; rel err P {errs['P']:.2e}, R {errs['R']:.2e}, "
              f"coarse A {errs['Ac']:.2e} (limit 1e-12); {t_dev:.3f} s "
              "(stages: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     res["seconds"].items())
              + f"), host pipeline's whole setup {t_host:.3f} s", flush=True)
        if not same_split or not max(errs.values()) <= 1e-12:
            fail(f"device setup interp_type {itype} differs from the host "
                 "pipeline")
        rows.append(dict(interp_type=itype, nc=res["nc"],
                         same_split=same_split, stages=res["seconds"],
                         device_s=t_dev, host_pipeline_s=t_host, **errs))
    return rows


def weakscale_phase(device_name: str, counters):
    """``examples/weakscale_pcg_boomeramg_devsetup.yaml`` as it is through
    the CLI; returns a dict of its launches, setup seconds, K1, K6, K4 and
    K2 rows (K6 and K4 also on the old layouts of the levels that left
    them for K2), the moved operators' old-against-new rows, warm-solve
    profile, timer rows and layouts."""
    yaml_path = os.path.join(REPO, "examples",
                             "weakscale_pcg_boomeramg_devsetup.yaml")
    with host_generation_forbidden():
        rc, system, wall, launches = run_cli(yaml_path, counters)
    print(f"weakscale path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "weakscale", tol=1e-6)
    pre = system._precond
    note = next((n for n in pre.notes if n.startswith(DEVICE_NOTE)), None)
    if note is None:
        fail("weakscale: level 0 was not set up on the device")
    print(f"weakscale note: {note}", flush=True)
    for line in pre.describe().splitlines()[1:]:
        print(f"weakscale hierarchy {line}", flush=True)
    layouts = pre.layouts()
    for line in layouts:
        print(f"weakscale {line}", flush=True)
    stages = dict(pre.setup_seconds)
    print("weakscale setup seconds (the card's level-0 stages, then the "
          "host levels): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stages.items()),
          flush=True)
    timers = print_timers(system, "weakscale")
    print(f"weakscale Build 27Pt Stencil HYPRE matrix "
          f"{timers['Build 27Pt Stencil HYPRE matrix']:.6f} s, generated on "
          f"the card (the host generation's: {WEAKSCALE_HOST_BUILD_S} s)",
          flush=True)
    setup = timers["Preconditioner setup"]
    print(f"weakscale Preconditioner setup {setup:.3f} s, of it the host "
          f"levels {stages.get('host levels', 0.0):.3f} s", flush=True)
    check_launched(pre, launches, "weakscale")
    ls = system.config.linear_system
    print(f"weakscale {ls.nx}x{ls.ny}x{ls.nz}: {res.iters} PCG iterations, "
          f"relres "
          f"{float(res.relres):.3e}, golden check PASSED; tpusolve (CPU, same "
          f"YAML) {TPUSOLVE_WEAKSCALE_ITERS}; kernel "
          f"launches: K1 {launches['dia_spmv']}, K2 {launches['ell_spmv']}"
          f", K4 {launches['bdia_spmv']}, K5 {launches['bdia_spmv_xl']}, K6 "
          f"{launches['bell_spmv']}", flush=True)
    if abs(res.iters - TPUSOLVE_WEAKSCALE_ITERS) > 1:
        fail(f"weakscale took {res.iters} PCG iterations, not within one of "
             f"tpusolve's {TPUSOLVE_WEAKSCALE_ITERS}")
    dia_ops = [(f"weakscale level {i}", lev.A)
               for i, lev in enumerate(pre.levels) if lev.A.uses_dia]
    errs = dia_check(dia_ops, 21)
    rows1 = dia_timings(dia_ops, device_name, 22)
    moved = moved_pairs(pre, "weakscale")
    rows6, rows4 = tile_timings(pre, moved, "weakscale", device_name, 23)
    ell = ell_ops(pre, "weakscale")
    rows2 = ell_timings(ell, device_name, 27)
    # K2's headline (the operator of largest bound): where this process's
    # traces lost its device events, they are taken in a fresh one
    head, M = max(zip(rows2, (M for _, M in ell)),
                  key=lambda p: p[0]["bound_ms"])
    if head["k2_dev_ms"] != head["k2_dev_ms"]:
        import numpy as np
        import torch
        x = torch.tensor(np.random.default_rng(27).standard_normal(M.col_pad),
                         dtype=M.dtype, device=M.device)
        head["k2_dev_ms"] = fresh_device_ms(M, x, f"{head['op']} K2")
        head["k2_dev_ms_from"] = "a fresh process"
    moved_rows = moved_timings(moved, device_name, 28)
    prof = solve_profile(system, "weakscale")
    system.destroy_system()
    return dict(launches=launches, stages=stages, k1_rows=rows1,
                k1_errs=errs, k6_rows=rows6, k4_rows=rows4, k2_rows=rows2,
                moved_rows=moved_rows, profile=prof, timers=timers,
                layouts=layouts, iters=int(res.iters),
                relres=float(res.relres))


# --------------------------------------------------------------------------
# the generic-ELL device setup and on-device generation: (f) weak scaling
# at 256^3, (g) gate 3 at 96^3


class host_generation_forbidden:
    """Within the block, the stencil's host generators (its numpy plane
    tables and the host CSR of them) fail: a run that completes generated
    its system on the device."""

    def __enter__(self):
        from tpusolve_torch import stencil
        from tpusolve_torch.amg import spk

        def forbidden(*a, **k):
            fail("the stencil was generated on the host")

        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (stencil, "_dia_box"), (stencil, "_dia_box_lattice"),
            (spk, "dia_to_csr"))]
        for mod, name, _ in self.saved:
            setattr(mod, name, forbidden)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


class setup_peak:
    """Within the block, the CLI's BoomerAMG setup records the peak of
    ``torch.cuda.max_memory_allocated`` during it (``self.peak_gb``)."""

    def __enter__(self):
        import torch
        from tpusolve_torch.harness import system as system_mod
        self.orig = system_mod.boomeramg_setup
        self.peak_gb = None

        def measured(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.peak_gb = torch.cuda.max_memory_allocated() / 1e9
            return out

        system_mod.boomeramg_setup = measured
        return self

    def __exit__(self, *exc):
        from tpusolve_torch.harness import system as system_mod
        system_mod.boomeramg_setup = self.orig
        return False


def level_stages(pre) -> dict:
    """The setup's stage seconds by level: level 0's (the unprefixed
    stages), each later device level's ("level i <stage>"), and the host
    levels' in all."""
    out = {}
    for k, v in pre.setup_seconds.items():
        if k == "host levels":
            lvl, stage = "host", k
        elif k.startswith("level "):
            _, lvl, stage = k.split(" ", 2)
        else:
            lvl, stage = "0", k
        out.setdefault(lvl, {})[stage] = v
    return out


def check_ell_levels(pre, what: str) -> None:
    """Fail unless every level of ``tpusolve``'s generic-ELL floor or more
    below level 0 was set up on the device (its stages recorded) and no
    coarse operator of that size was fetched to the host."""
    from tpusolve_torch.amg import device_setup_ell
    floor = device_setup_ell.MIN_DEVICE_N
    for i, lev in enumerate(pre.levels[1:-1], start=1):
        if lev.n >= floor and f"level {i} R@(AP)" not in pre.setup_seconds:
            fail(f"{what}: level {i} ({lev.n} rows) was set up on the host")
    big = [f for f in pre.host_fetches if f[1] >= floor]
    if big:
        fail(f"{what}: coarse operators of {floor} rows or more fetched to "
             f"the host: {big}")


def weakscale_large_phase(side: int, card: str, counters) -> dict:
    """(f) The weak-scaling YAML at side^3 (the example's settings) through
    the CLI: the system generated on the card (the host generators fail in
    the run), level 0 set up on the card by the DIA setup and every level
    of 2^19 rows or more below it by the generic-ELL setup (fails
    otherwise, or if such a level's coarse operator was fetched to the
    host), K1 and K2 launched, golden check; prints the hierarchy, each
    level's setup stages, the timer rows and the setup's peak of allocated
    device memory.  Returns its numbers."""
    from tpusolve_torch import fixtures
    from tpusolve_torch.amg.builder import DIA_NOTE, RECURSION_NOTE
    what = f"weakscale {side}^3"
    yaml_path = fixtures.write_weakscale(
        os.path.join(FIXTURES, f"weakscale_{side}"), side)
    with host_generation_forbidden(), setup_peak() as peak:
        rc, system, wall, launches = run_cli(yaml_path, counters)
    print(f"{what} path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, what, tol=1e-6)
    pre = system._precond
    for line in pre.describe().splitlines()[1:]:
        print(f"{what} hierarchy {line}", flush=True)
    for line in pre.layouts():
        print(f"{what} {line}", flush=True)
    if DIA_NOTE not in pre.notes or RECURSION_NOTE not in pre.notes:
        fail(f"{what}: notes {pre.notes} lack the DIA device setup of level "
             "0 or the device recursion")
    check_ell_levels(pre, what)
    check_launched(pre, launches, what)
    if not launches["dia_spmv"] or not launches["ell_spmv"]:
        fail(f"{what}: K1 or K2 was not launched")
    stages = level_stages(pre)
    for lvl, st in stages.items():
        print(f"{what} setup stages, level {lvl} (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()), flush=True)
    timers = print_timers(system, what)
    print(f"{what}: {res.iters} PCG iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; Build 27Pt Stencil "
          f"{timers['Build 27Pt Stencil HYPRE matrix']:.3f} s on the card, "
          f"Preconditioner setup {timers['Preconditioner setup']:.3f} s, "
          f"peak allocated during setup {peak.peak_gb:.2f} GB; host fetches "
          f"{pre.host_fetches} ({card})", flush=True)
    out = dict(iters=int(res.iters), relres=float(res.relres),
               levels=[lev.n for lev in pre.levels], layouts=pre.layouts(),
               stages=stages, timers=timers, setup_peak_gb=peak.peak_gb,
               host_fetches=pre.host_fetches, launches=launches, card=card)
    system.destroy_system()
    return out


def sparse_bits(M) -> tuple:
    """An ELL operator's stored arrays on the host, to compare bit for bit."""
    arrs = ((M.ell_rowptr, M.ell_vals, M.ell_cols) if M.uses_ell_rowptr
            else (M.diag_vals, M.diag_cols))
    return tuple(a.cpu() for a in arrs + (M.diag,))


def same_bits(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def ell_against_host(system, what: str, card: str, min_n) -> dict:
    """The generic-ELL setup of level 0 of ``system``'s operator on the card
    (``device_level0_ell``) against the port's host pipeline on the same
    operator: the same C/F split, P to 1e-11 and the coarse A to 1e-10
    relative, R = P^T exactly; the whole setup timed with the device
    floors ``min_n`` and by the host pipeline (the card's crossover); the
    ELL setup's wall, device operations, busy time and idle share
    (:func:`factor_profile`), each of its runs, and the CLI run's level 0
    where the CLI set it up on the card, the same bits."""
    import dataclasses
    import torch
    from tpusolve_torch.amg import builder, device_setup_ell
    A, H = system._A_solve, system.A_host
    cfg = system.config.boomeramg
    if not device_setup_ell.eligible(A, cfg, H, min_n=1):
        fail(f"{what}: level 0 is not eligible for the generic-ELL setup")
    first, runs = [], [0]

    def bits(P, R, Ac, cmask=None):
        out = sparse_bits(P) + sparse_bits(R) + sparse_bits(Ac)
        return out if cmask is None else out + (cmask.cpu(),)

    def level0():
        res = device_setup_ell.device_level0_ell(A, cfg, A_host=H)
        if res is None:
            fail(f"{what}: the ELL setup's coarsening stalled")
        b = bits(res["P"], res["R"], res["Ac"])
        if not first:
            first.extend([res, b])
        elif not same_bits(b, first[1]):
            fail(f"{what}: the ELL setup's P, R or Ac changed from run to "
                 "run")
        runs[0] += 1
        return res

    prof = factor_profile(level0, f"{what} generic-ELL level-0 setup", card)
    res = first[0]
    cli = system._precond
    if builder.ELL_NOTE in cli.notes:
        if not same_bits(bits(cli.levels[0].P, cli.levels[0].R,
                              cli.levels[1].A), first[1]):
            fail(f"{what}: the CLI run's level 0 differs from the ELL "
                 "setup run again")
        runs[0] += 1
    # CF order keeps the host pipeline's level-0 split on its level
    cfg_cf = dataclasses.replace(cfg, relax_order=1)
    pre_h, host_s = timed(lambda: builder.boomeramg_setup(
        A, cfg_cf, A_host=H, device_min_n=None))
    pre_d, dev_s = timed(lambda: builder.boomeramg_setup(
        A, cfg, A_host=H, device_min_n=min_n))
    lev0, lev1 = pre_h.levels[0], pre_h.levels[1]
    same_split = bool(torch.equal(res["Cmask"], lev0.cmask))
    P = res["P"].to_scipy()
    errs = dict(P=rel_sparse(P, lev0.P.to_scipy()),
                Ac=rel_sparse(res["Ac"].to_scipy(), lev1.A.to_scipy()),
                R_vs_PT=rel_sparse(res["R"].to_scipy(), P.T.tocsr()))
    print(f"{what}: level 0 by the generic-ELL setup on the card against "
          f"the host pipeline: {res['nc']} C points, split equal: "
          f"{same_split}; rel err P {errs['P']:.2e} (limit 1e-11), coarse A "
          f"{errs['Ac']:.2e} (limit 1e-10), R - P^T {errs['R_vs_PT']:.1e}; "
          f"{runs[0]} runs the same bits; whole setup "
          f"{dev_s:.3f} s with level 0 on the card, {host_s:.3f} s by the "
          f"host pipeline ({card}); stages "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["seconds"].items()),
          flush=True)
    if not (same_split and errs["P"] <= 1e-11 and errs["Ac"] <= 1e-10
            and errs["R_vs_PT"] == 0.0):
        fail(f"{what}: the card's ELL level 0 differs from the host "
             "pipeline's")
    return dict(rows=A.shape[0], nc=res["nc"], same_split=same_split,
                same_bits_runs=runs[0], stages=res["seconds"],
                setup_card_s=dev_s, setup_host_pipeline_s=host_s,
                profile=prof, **errs)


def gate3_ell_phase(side: int, card: str, counters) -> dict:
    """(g) The gate-3 fixture at side^3 through the CLI: level 0 set up on
    the card by the generic-ELL setup (fails otherwise, or if a level of
    2^19 rows or more went to the host), K2 on every ELL level, golden
    check, the count held to tpusolve's (``TPUSOLVE_GATE3_ITERS``); then
    :func:`ell_against_host` on its operator (gate 3's phase runs it on
    its own operator with the floors at 1 row)."""
    from tpusolve_torch.amg.builder import DEVICE_MIN_N, ELL_NOTE
    what = f"gate-3 {side}^3"
    rc, system, wall, launches = run_gate3(side, counters, f"gate-3 ell "
                                           f"{side}")
    print(f"{what} ELL path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, what)
    pre = system._precond
    for line in pre.describe().splitlines()[1:]:
        print(f"{what} hierarchy {line}", flush=True)
    for line in pre.layouts():
        print(f"{what} {line}", flush=True)
    if ELL_NOTE not in pre.notes:
        fail(f"{what}: level 0 was not set up by the generic-ELL setup "
             f"(notes {pre.notes})")
    check_ell_levels(pre, what)
    check_launched(pre, launches, what)
    timers = print_timers(system, what)
    ref = TPUSOLVE_GATE3_ITERS.get(side)
    print(f"{what}: {res.iters} GMRES iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; tpusolve (CPU, "
          f"same fixture) {ref}; Preconditioner setup "
          f"{timers['Preconditioner setup']:.3f} s ({card})", flush=True)
    if ref is not None and res.iters != ref:
        fail(f"{what} took {res.iters} GMRES iterations, tpusolve {ref}")
    out = dict(iters=int(res.iters), relres=float(res.relres),
               levels=[lev.n for lev in pre.levels], layouts=pre.layouts(),
               stages=level_stages(pre), timers=timers, launches=launches,
               card=card)
    out["against_host"] = ell_against_host(system, what, card,
                                           DEVICE_MIN_N)
    system.destroy_system()
    return out


# --------------------------------------------------------------------------
# ILU made whole: the device ILU(0) (DIA and ELL), the host ILU options, ILU
# smoothers on AMG levels, and the lifecycle's output, reuse and memory


def host_factorizations(run):
    """Run ``run()`` with the host Chow-Patel factorization of ILU's setup
    counted; returns (its result, how often the host factored)."""
    from tpusolve_torch.ilu import ilu as ilu_mod
    orig = ilu_mod.chow_patel_ilu
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    ilu_mod.chow_patel_ilu = counted
    try:
        return run(), calls[0]
    finally:
        ilu_mod.chow_patel_ilu = orig


def timed(fn):
    """(result, wall seconds) of ``fn()``, the card synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def factor_profile(fn, what: str, card: str) -> dict:
    """``fn()`` (a device factorization) timed warm, then once under
    ``torch.profiler``: its wall seconds, the device operations it puts on
    the card, their device time and the device's idle share of the wall,
    which says whether the eager factorization is host-issue-bound.  Every
    device event of the trace counts, so nothing hangs on matching the
    device's clock to the host's; a trace with no device event (seen late
    in a long process) is taken again, and after ``TRACE_TRIES`` the busy
    time is "not measured" (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpusolve_torch.kernels.calibrate import TRACE_TRIES
    fn()
    _, wall = timed(fn)
    out = dict(wall_s=wall, wall_profiled_s=None, device_ops=None,
               busy_s=None, idle_share=None)
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_p = timed(fn)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ev:
            busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
            out.update(wall_profiled_s=wall_p, device_ops=len(ev),
                       busy_s=busy, idle_share=1.0 - busy / wall_p)
            break
    busy = ("not measured" if out["busy_s"] is None else
            f"{out['device_ops']} device operations, busy "
            f"{out['busy_s']:.4f} s, idle share {out['idle_share']:.3f}")
    print(f"{what} device factorization ({card}): wall {wall:.4f} s (warm); "
          f"{busy}", flush=True)
    return out


def factors_rel(pre, L_ref, d_ref, U_ref) -> float:
    """Largest difference of ``pre``'s factors and 1 / u_ii from the
    reference ones, relative to each one's largest magnitude."""
    import numpy as np
    n = L_ref.shape[0]
    errs = []
    for M, M_ref in ((pre.L, L_ref), (pre.U, U_ref)):
        d = abs(M.to_scipy() - M_ref)
        errs.append((d.max() if d.nnz else 0.0) / abs(M_ref).max())
    dinv = pre.udiag_inv.cpu().numpy()[:n]
    errs.append(float(np.abs(dinv - d_ref).max() / np.abs(d_ref).max()))
    return max(errs)


def device_against_host(what: str, A, H, device_setup_fn,
                        card: str) -> dict:
    """The device factorization of ``A`` (``device_setup_fn``) against the
    port's host ``chow_patel_ilu`` of ``H`` (the same operator on the same
    pattern), each timed once warm, with the factors' largest difference."""
    from tpusolve_torch.config import ILUConfig
    from tpusolve_torch.ilu.ilu import chow_patel_ilu
    cfg = ILUConfig()
    device_setup_fn(A, cfg)
    pre, dev_s = timed(lambda: device_setup_fn(A, cfg))
    (L, ujj, U), host_s = timed(lambda: chow_patel_ilu(H, sweeps=5))
    err = factors_rel(pre, L, 1.0 / ujj, U)
    print(f"{what} ({card}): device factorization {dev_s:.4f} s, the "
          f"port's host "
          f"chow_patel_ilu {host_s:.3f} s on the same operator and pattern "
          f"({A.shape[0]} rows); factors' largest relative difference "
          f"{err:.2e}", flush=True)
    if not err <= 1e-12:
        fail(f"{what}: device and host factors differ by {err:.2e}")
    return dict(rows=A.shape[0], device_s=dev_s, host_s=host_s,
                max_rel_diff=err)


def stencil_ilu_run(side: int, counters) -> tuple:
    """One CLI run of ``fixtures.STENCIL_ILU_YAML`` at side^3; fails unless
    ILU(0) was factored on the card (no host factorization), the factors
    are DIA and K1 ran A and the factors' sweeps (the upper sweeps are
    K1's only launches with s = 1 / u_ii, the lower as many without it) and
    nothing else.  Returns (system, result, launches, K1's launches by
    form)."""
    from tpusolve_torch import fixtures
    from tpusolve_torch.kernels.dia import launches_by_mode
    work = os.path.join(REPO, "build", f"stencil_ilu_{side}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        yaml_path = fixtures.write_stencil_ilu(work, side)
        (rc, system, wall, launches), host = host_factorizations(
            lambda: run_cli(yaml_path, counters))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    forms = launches_by_mode()
    what = f"stencil-ILU {side}^3"
    print(f"{what} path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}; K1 by form {forms}", flush=True)
    res = check_solve(system, rc, what)
    pre = system._precond
    print(f"{what} layouts: A {system.A.layout}; L {pre.L.layout}; U "
          f"{pre.U.layout}; notes {pre.notes}", flush=True)
    if host or not any("on device (DIA" in n for n in pre.notes):
        fail(f"{what}: ILU(0) was not factored on the device ({host} host "
             f"factorizations; notes {pre.notes})")
    if not (pre.L.uses_dia and pre.U.uses_dia) or launches["dia_spmv"] <= 0:
        fail(f"{what}: the factors are not DIA on K1")
    other = {k: n for k, n in launches.items()
             if n and not k.startswith("dia_spmv")}
    upper = forms.get("w*s*(b-Ax)", 0)
    if other or upper <= 0 or forms.get("w*(b-Ax)", 0) < upper:
        fail(f"{what} launched {other}, or K1 did not run the factors' "
             f"sweeps ({forms})")
    return system, res, launches, forms


def stencil_ilu_phase(side: int, card: str, counters) -> dict:
    """(a) The stencil under BiCGSTAB + ILU(0) in double
    (``fixtures.STENCIL_ILU_YAML``) through the CLI at side^3 and at 64^3
    (:func:`stencil_ilu_run`): at 64^3 the count is tpusolve's exactly; at
    side^3 it follows the summation order (``STENCIL_ILU_SPREAD``) and is
    held within that spread of tpusolve's.  Then K1 on the side^3 factors
    against its plain version, the device factorization's profile and, at
    64^3, the device factorization against the port's host
    ``chow_patel_ilu`` on the same band."""
    import numpy as np
    import torch
    from tpusolve_torch.ilu import device_setup
    from tpusolve_torch.stencil import laplace27
    iters, total = {}, {}
    for s in sorted({side, 64}, reverse=True):
        system, res, launches, forms = stencil_ilu_run(s, counters)
        iters[s] = int(res.iters)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        ref = TPUSOLVE_STENCIL_ILU_ITERS.get(s)
        gap = STENCIL_ILU_SPREAD if s == 128 else 0
        print(f"stencil-ILU {s}^3: {res.iters} BiCGSTAB iterations, relres "
              f"{float(res.relres):.3e}, golden check PASSED; tpusolve (CPU, "
              f"same YAML) {ref}" + (f", held within {gap}" if gap else ""),
              flush=True)
        if ref is not None and abs(res.iters - ref) > gap:
            fail(f"stencil-ILU {s}^3 took {res.iters} iterations, tpusolve "
                 f"{ref}")
        if s != side:
            system.destroy_system()
            continue
        big = dict(relres=float(res.relres), k1_by_form=forms,
                   timers=print_timers(system, f"stencil-ILU {s}^3"))
        pre = system._precond
        ops = [(f"stencil-ILU {k}", M) for k, M in (("L", pre.L),
                                                    ("U", pre.U))]
        errs = dia_check(ops, 41)
        prof = factor_profile(
            lambda: device_setup.ilu_setup_device(system.A,
                                                  system.config.ilu),
            f"stencil-ILU {s}^3 DIA", card)
        system.destroy_system()
    A64 = laplace27(64, 64, 64, device=torch.device("cuda", 0),
                    dtype=np.float64)[0]
    pair = device_against_host("stencil-ILU 64^3 DIA", A64,
                               device_setup.band_csr(A64),
                               device_setup.ilu_setup_device, card)
    return dict(big, launches=total, iters=iters, k1_errs=errs,
                factorization=prof, against_host=pair)


def ell_plain_check(ops, seed: int) -> tuple:
    """K2 against its plain version on each (name, ELL operator) of
    ``ops`` in its storage form.  Returns (largest relative error, largest
    absolute error)."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.ell import ell_rowptr_plain, ell_spmv_plain
    from tpusolve_torch.matrix.spmv import spmv
    rng = np.random.default_rng(seed)
    worst = worst_abs = 0.0
    for name, M in ops:
        x = torch.tensor(rng.standard_normal(M.col_pad), dtype=M.dtype,
                         device=M.device)
        vals, cols, rowptr = M.ell_arrays
        y_p = (ell_spmv_plain(vals, cols, x) if rowptr is None
               else ell_rowptr_plain(rowptr, vals, cols, x))
        y = spmv(M, x)
        err = rel_err(y, y_p)
        key = str(M.dtype).replace("torch.", "")
        if not err <= RTOL[key]:
            fail(f"{name}: K2 vs plain rel err {err:.3e} > {RTOL[key]}")
        worst = max(worst, err)
        worst_abs = max(worst_abs, float((y - y_p).abs().max()))
    return worst, worst_abs


def gate4_ell_phase(side: int, card: str, counters) -> dict:
    """(b) The gate-4 fixture at side^3 as written (``matrix_ordering:
    none``) in double through the CLI: tpusolve stores it ELL, so ILU(0) is
    factored on the card by the ELL path, no host factorization, K2 running
    A, L and U (each in its storage form), the count held to tpusolve's;
    then K2 on the three against its plain version, the device
    factorization's profile and, at 64^3, the device factorization against
    the host's on the same operator (assembled as ELL directly: no layout
    is priced)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpusolve_torch import fixtures
    from tpusolve_torch.ilu import device_setup
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    yaml_path = fixture_yaml(4, side, "gate4_ell.yaml", solver_settings={
        "precision": "double", "matrix_ordering": "none"})
    (rc, system, wall, launches), host = host_factorizations(
        lambda: run_cli(yaml_path, counters))
    print(f"gate-4 ELL path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, "gate-4 ELL")
    pre = system._precond
    ops = (("A", system.A), ("L", pre.L), ("U", pre.U))
    print("gate-4 ELL layouts: " + "; ".join(
        f"{k} {M.layout}" for k, M in ops) + f"; notes {pre.notes}",
        flush=True)
    if host or not any("generic-ELL" in n for n in pre.notes):
        fail(f"gate-4 ELL: ILU(0) was not factored on the device "
             f"({host} host factorizations; notes {pre.notes})")
    for k, M in ops:
        form = "rowptr" if M.uses_ell_rowptr else "padded"
        if not M.uses_ell or not launches[f"ell_spmv {form}"]:
            fail(f"gate-4 ELL: {k} ({M.layout}) launched no K2 {form}")
    timers = print_timers(system, "gate-4 ELL")
    ref = TPUSOLVE_GATE4_ELL_ITERS.get(side)
    print(f"gate-4 ELL {side}^3: {res.iters} BiCGSTAB iterations, relres "
          f"{float(res.relres):.3e}, golden check PASSED; tpusolve (CPU, "
          f"same fixture and YAML) {ref}", flush=True)
    if ref is not None and res.iters != ref:
        fail(f"gate-4 ELL took {res.iters} iterations, tpusolve {ref}")
    errs = ell_plain_check([(f"gate-4 ELL {k}", M) for k, M in ops], 43)
    prof = factor_profile(
        lambda: device_setup.ilu_setup_device_ell(system.A,
                                                  system.config.ilu),
        f"gate-4 ELL {side}^3", card)
    # the ELL sweeps scatter one lower slot at a time, with no two terms on
    # one destination: the card's factors have the same bits on every run
    again = device_setup.ilu_setup_device_ell(system.A, system.config.ilu)
    same = (torch.equal(again.udiag_inv, pre.udiag_inv) and all(
        (a.to_scipy() != b.to_scipy()).nnz == 0
        for a, b in ((again.L, pre.L), (again.U, pre.U))))
    print(f"gate-4 ELL {side}^3: the device factorization run again gives "
          f"the CLI run's factors bit for bit: {same}", flush=True)
    if not same:
        fail("gate-4 ELL: the device factors differ from run to run")
    system.destroy_system()
    r, c, v, _, n = fixtures.make_system(64, 64, 64, seed=11, nonsym=0.35)
    H = sp.csr_matrix((v, (r, c)), shape=(n, n))
    A64 = ShardedMatrix.from_csr_host(
        H, device=torch.device("cuda", 0), dtype=np.float64,
        allow_dia=False, allow_bdia=False, allow_bell=False)
    pair = device_against_host("gate-4 ELL 64^3", A64, H,
                               device_setup.ilu_setup_device_ell, card)
    return dict(launches=launches, iters=int(res.iters),
                relres=float(res.relres), timers=timers, k2_errs=errs,
                factorization=prof, against_host=pair)


def gate4_rcm_ell_trial(system, card: str) -> dict:
    """The ELL device factorization of gate 4's RCM'd A (the port stores it
    ELL; tpusolve stores it BDIA and factors on the host, as the port's
    main path does), timed and held against the host factors the run used:
    measured for a later decision, not adopted."""
    import numpy as np
    from tpusolve_torch.ilu import device_setup
    pre = system._precond
    A = system.A
    prof = factor_profile(
        lambda: device_setup.ilu_setup_device_ell(A, system.config.ilu),
        "gate-4 RCM'd A (f64, not adopted)", card)
    trial = device_setup.ilu_setup_device_ell(A, system.config.ilu)
    n = A.shape[0]
    d_ref = pre.udiag_inv.double().cpu().numpy()[:n]
    err = factors_rel(trial, pre.L.to_scipy().astype(np.float64), d_ref,
                      pre.U.to_scipy().astype(np.float64))
    setup = system.timers.as_dict()["Preconditioner setup"]
    print(f"gate-4 RCM'd A: the ELL device factorization takes "
          f"{prof['wall_s']:.4f} s against this run's host ILU setup "
          f"{setup:.3f} s; factors' largest relative difference from the "
          f"host factors (stored f32) {err:.2e}; not adopted", flush=True)
    return dict(prof, host_setup_s=setup, max_rel_diff=err)


def ilu_options_phase(side: int, counters) -> dict:
    """(c) The RCM'd gate-4 fixture at side^3 in double with each host ILU
    option (``fixtures.ILU_OPTIONS``: ILU(1), ILUT, RCM local reordering)
    through the CLI: each factor's kernel launched, each count held to
    tpusolve's."""
    from tpusolve_torch import fixtures
    out = {}
    total = {}
    for name, keys in fixtures.ILU_OPTIONS.items():
        rc, system, wall, launches = run_cli(fixture_yaml(
            4, side, f"ilu_{name}.yaml",
            solver_settings={"precision": "double"},
            ilu_preconditioner_settings=keys), counters)
        res = check_solve(system, rc, f"ILU {name}")
        pre = system._precond
        for k, M in (("A", system.A), ("L", pre.L), ("U", pre.U)):
            if not launches[launch_counter(M).__name__]:
                fail(f"ILU {name}: {k} ({M.layout}) launched no "
                     f"{kernel_of(M)}")
        ref = TPUSOLVE_ILU_OPTION_ITERS.get((name, side))
        print(f"ILU {name} {side}^3: {res.iters} BiCGSTAB iterations, "
              f"relres {float(res.relres):.3e}; tpusolve {ref}; L "
              f"{pre.L.layout}, U {pre.U.layout}; notes {pre.notes}; "
              f"launches {launches}", flush=True)
        if ref is not None and res.iters != ref:
            fail(f"ILU {name} took {res.iters} iterations, tpusolve {ref}")
        out[name] = dict(iters=int(res.iters), relres=float(res.relres))
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        system.destroy_system()
    return dict(launches=total, runs=out)


def gate3_ilu_smoother_phase(side: int, counters) -> dict:
    """(d) Gate 3 at side^3 with ``smooth_type: 5`` on the finest level
    (ILU(0) smoothing in place of the relaxation there) through the CLI:
    every operator's kernel launched, the ILU factors' too, the count held
    to tpusolve's."""
    rc, system, wall, launches = run_gate3(
        side, counters, "gate-3 ILU smoother",
        edit=lambda t: t.replace("relax_type: 18", "relax_type: 18\n"
                                 "  smooth_type: 5\n  smooth_num_levels: 1"))
    res = check_solve(system, rc, "gate-3 ILU smoother")
    pre = system._precond
    check_launched(pre, launches, "gate-3 ILU smoother")
    lev = pre.levels[0]
    if lev.ilu_L is None or not any("smooth_type 5" in n for n in pre.notes):
        fail("gate-3 ILU smoother: level 0 carries no ILU factors")
    for k, M in (("L", lev.ilu_L), ("U", lev.ilu_U)):
        if not launches[launch_counter(M).__name__]:
            fail(f"gate-3 ILU smoother: {k} ({M.layout}) launched nothing")
    timers = print_timers(system, "gate-3 ILU smoother")
    ref = TPUSOLVE_GATE3_ST5_ITERS.get(side)
    print(f"gate-3 ILU smoother {side}^3: {res.iters} GMRES iterations, "
          f"relres {float(res.relres):.3e}; tpusolve {ref}; level 0 L "
          f"{lev.ilu_L.layout}, U {lev.ilu_U.layout}; launches {launches}; "
          f"wall {wall:.1f} s", flush=True)
    if ref is not None and res.iters != ref:
        fail(f"gate-3 ILU smoother took {res.iters} iterations, tpusolve "
             f"{ref}")
    system.destroy_system()
    return dict(launches=launches, iters=int(res.iters),
                relres=float(res.relres), timers=timers)


def lifecycle_phase(side: int, device, counters) -> dict:
    """(e) Gate 3 at side^3: with ``write_outputs``, ``write_solution`` and
    ``write_amg_matrices`` (run inside its work directory), the files read
    back by the port's IJ reader equal the system (to the 16 digits
    written); then two tests with ``reuse_preconditioner``, the second's
    setup row under 1 % of the first's; then the memory probe on the card."""
    import numpy as np
    import scipy.sparse as sp
    from tpusolve_torch.formats import ij, mmio
    from tpusolve_torch.harness.memory import check_memory
    work = os.path.join(REPO, "build", f"lifecycle_{side}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    total = {}
    try:
        yaml_path = fixture_yaml(3, side, "lifecycle.yaml", linear_system={
            "write_outputs": True, "write_solution": True,
            "write_amg_matrices": True})
        data = os.path.dirname(yaml_path)
        os.chdir(work)
        rc, system, wall, launches = run_cli(yaml_path, counters)
        check_solve(system, rc, "lifecycle")
        nlev = len(system._precond.levels)
        r, c, v, shape = mmio.read_matrix(os.path.join(data, "pressure.mm"))
        A = sp.csr_matrix((v, (r, c)), shape=shape)
        r2, c2, v2 = ij.read_matrix("IJM.mat", 1)
        dA = abs(sp.csr_matrix((v2, (r2, c2)), shape=shape) - A).max()
        b = mmio.read_vector(os.path.join(data, "pressure_rhs.mm"))
        db = np.abs(ij.read_dense_vector("IJV0.rhs", 1) - b).max()
        xs = ij.read_dense_vector("IJV0.sln", 1)
        res_x = np.abs(A @ xs - b).max() / np.abs(b).max()
        levels = sorted(f for f in os.listdir(work)
                        if f.startswith("IJM.mat_level_"))
        lev0 = ij.read_matrix("IJM.mat_level_0", 1)
        L0 = sp.csr_matrix((lev0[2], (lev0[0], lev0[1])), shape=shape)
        dL0 = abs(L0 - system._precond.levels[0].A.to_scipy()).max()
        print(f"lifecycle files: {sorted(os.listdir(work))}; read back: A "
              f"{dA:.2e}, b {db:.2e} from the fixture's, level 0 {dL0:.2e} "
              f"from the hierarchy's (16 digits written), |A x - b| / |b| "
              f"{res_x:.2e} on the written x; {len(levels)} level files for "
              f"{nlev} levels", flush=True)
        scale = abs(A).max()
        if not (dA <= 1e-15 * scale and db <= 1e-15 * np.abs(b).max()
                and dL0 <= 1e-15 * scale and res_x <= 1e-6
                and len(levels) == nlev):
            fail("lifecycle: the written files do not read back as the "
                 "system")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        system.destroy_system()
        reuse = fixture_yaml(3, side, "reuse.yaml", solver_settings={
            "num_tests": 2, "reuse_preconditioner": True,
            "check_memory": True})
        systems = []
        rc, _, wall, launches = run_cli(reuse, counters, keep=systems)
        if rc != 0 or len(systems) != 2:
            fail(f"lifecycle reuse: cli exit {rc}, {len(systems)} tests")
        setup = [s.timers.as_dict()["Preconditioner setup"]
                 for s in systems]
        iters = [int(s.solve_results[0].iters) for s in systems]
        print(f"lifecycle reuse: Preconditioner setup {setup[0]:.4f} s, then "
              f"{setup[1]:.6f} s ({setup[1] / setup[0]:.5f} of it); "
              f"iterations {iters}", flush=True)
        if not (setup[1] < 0.01 * setup[0] and iters[0] == iters[1]
                and systems[1]._precond is systems[0]._precond):
            fail("lifecycle reuse: the second test did not reuse the setup")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        for s in systems:
            s.destroy_system()
        rep = check_memory(device)
        if "in_use=" not in rep or "limit=" not in rep:
            fail(f"lifecycle: the memory probe read nothing: {rep}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches=total, setup_s=setup, iters=iters, memory=rep,
                read_back=dict(A=float(dA), b=float(db), level0=float(dL0),
                               residual=float(res_x)))


def model_constants():
    """Measured layout-model constants beside the ones in the code."""
    from tpusolve_torch.kernels import calibrate
    from tpusolve_torch.matrix import sharded
    got = calibrate.measure(log=lambda s: print(f"calibrate {s}",
                                                flush=True))
    for k, by_size in got["rate"].items():
        for size, rate in sorted(by_size.items()):
            if k in sharded.SPMV_MODEL:
                code = sharded.SPMV_MODEL[k]
                print(f"layout model {k} f{8 * size}: rate "
                      f"{rate / 1e12:.3f} TB/s (code {code[0] / 1e12:.3f}), "
                      f"threads_full {got['threads_full'][k][size]:.0f} "
                      f"(code {code[1]})", flush=True)
            else:
                code = sharded.BAND_RATE[k.replace("_band", ""), size]
                print(f"band model {k} f{8 * size}: rate {rate / 1e12:.3f} "
                      f"TB/s (code {code / 1e12:.3f})", flush=True)
    return got


def k3_entry(name: str, kind: str, line: int, rows: list,
             launches: dict) -> dict:
    """The ``kernels`` line's entry of K3's ``kind`` kernel: its launches,
    errors and, at gate 1's first transition (64^3 <-> 32^3, f32), its
    times; every transition's row under ``shapes``."""
    rs = [r for r in rows if r["kernel"] == kind]
    hl = rs[0]
    return dict(name=name, route="cuda",
                source="tpusolve_torch/csrc/box_transfer.cu",
                replaces=f"tpusolve/amg/structured.py:{line}", **launches,
                held_by="transfer_check, and fused_check as the pair the "
                        "fused kernels equal",
                max_abs_err=max(r["max_abs_err"] for r in rs),
                ms=hl["kernel_ms"], device_ms=hl["kernel_dev_ms"],
                plain_ms=hl["plain_ms"], plain_device_ms=hl["plain_dev_ms"],
                bound_ms=hl["bound_ms"], bound_by="bytes",
                library_ms=hl["lib_ms"], library_device_ms=hl["lib_dev_ms"],
                library=LIBRARY[kind],
                shape=hl["op"], max_rel_err=max(r["rel_err"] for r in rs),
                equal_to_plain=all(r["equal_to_plain"] for r in rs),
                shapes=rs)


def fused_entry(name: str, kind: str, rows: list, launches: dict,
                cycles: dict) -> dict:
    """The ``kernels`` line's entry of the fused ``kind`` kernel: its
    launches, errors and, at gate 1's first transition (64^3 -> 32^3, f32),
    its times beside the pair's; every transition's row under ``shapes``."""
    rs = [r for r in rows if r["kernel"] == kind]
    hl = rs[0]
    return dict(name=name, route="cuda",
                source="tpusolve_torch/csrc/box_cycle.cu",
                replaces=("tpusolve/amg/structured.py:129 with "
                          "tpusolve/matrix/spmv.py:79" if kind == "restrict"
                          else "tpusolve/amg/structured.py:122 with "
                          "tpusolve/matrix/spmv.py:79"), **launches,
                max_abs_err=max(r["max_abs_err"] for r in rs),
                ms=hl["fused_ms"], device_ms=hl["fused_dev_ms"],
                plain_ms=hl["plain_ms"], plain_device_ms=hl["plain_dev_ms"],
                pair_ms=hl["pair_ms"], pair_device_ms=hl["pair_dev_ms"],
                bound_ms=hl["bound_ms"], bound_by="bytes", library_ms=None,
                library=FUSED_LIBRARY,
                library_reference_device_ms=hl["library_reference_dev_ms"],
                shape=hl["op"], max_rel_err=max(r["rel_err"] for r in rs),
                equal_to_pair=all(r["equal_to_pair"] for r in rs),
                cycle_equal_to_pair=cycles, shapes=rs)


# ----------------------------------------------------------------------
# The coupled multi-component solve and the bfloat16 smoother twin

# tpusolve's counts on the paths below, each measured on a CPU with one
# device (JAX_PLATFORMS=cpu python -m tpusolve.harness.cli YAML, the
# fixture written by tools/gatefix.py):
#   GATE4_YAML_3COMP with segregated_solve: no and matrix_ordering: rcm at
#   64^3 (mixed), tpusolve's vmap path, where the smoke runs it since the
#   multi-part phases: 41, 39, 42 (at 96^3 52, 49, 55, PERF.md section 4)
TPUSOLVE_COUPLED_RCM = (41, 39, 42)
COUPLED_SIDE = 64
#   the same in natural order, precision double, at 64^3: 32, 34, 32
TPUSOLVE_COUPLED_64 = (32, 34, 32)
#   examples/weakscale_pcg_boomeramg_devsetup.yaml with smoother_dtype:
#   bfloat16 (TPUSOLVE_PMIS_HOST_RANK=1): 23 (relres 5.478e-07)
TPUSOLVE_WEAKSCALE_BF16_ITERS = 23
#   examples/gate1_64cube_pcg_amg.yaml with smoother_dtype: bfloat16: 14
TPUSOLVE_GATE1_BF16_ITERS = 14
# a coupled count in mixed may lie 4 iterations or 10 % (the larger) from
# its segregated one: tpusolve's own gap between the two at 16^3 (18, 20,
# 20 against 22, 20, 19), where the order of the f32 sums moves the count
COUPLED_SPREAD = (4, 0.10)
COLS = (1, 3, 8)      # the k-column forms the checks hold
ILU_SWEEPS = 5        # launches of one ILU apply on each factor


def check_components(system, rc: int, what: str, tol: float = 1e-8):
    """Fail unless every component of the run passed its golden check,
    converged to ``tol`` and is finite of the padded shape."""
    import torch
    if rc != 0:
        fail(f"the {what} run failed (cli exit {rc})")
    for i, (res, x) in enumerate(zip(system.solve_results, system.sln)):
        if not (float(res.relres) <= tol and bool(res.converged)):
            fail(f"{what}: component {i} relres {float(res.relres):.3e} "
                 f"above {tol:g} or not converged")
        if not bool(torch.isfinite(x).all()) or \
                x.shape != (system.A.row_pad,):
            fail(f"{what}: component {i} is not finite or of the wrong "
                 "shape")


def coupled_launches(passes: list, factors: tuple = ("K5", "K5")) -> tuple:
    """({k: launches} of K5 and of K2) that the coupled BiCGSTAB(ILU(0))
    inside refinement makes when each application of A, A_lo, L or U is one
    launch for all the batch's columns: pass p of the refinement solves the
    k_p columns still running as one batch, whose inner loop runs m_p
    iterations (their most), each two ILU applies (``ILU_SWEEPS`` launches
    on each factor, L's and U's on the kernels ``factors`` names, K5 or
    K2) and two A_lo products, after one residual; the outer residual with
    A, on all columns, once and after every pass."""
    k5, k2 = {}, {}
    npass = max(len(p) for p in passes)
    add = lambda d, k, n: d.__setitem__(k, d.get(k, 0) + n)
    add(k2, len(passes), 1 + npass)
    for p in range(npass):
        run = [c for c in range(len(passes)) if len(passes[c]) > p]
        m = max(passes[c][p] for c in run)
        for kernel in factors:
            add(k5 if kernel == "K5" else k2, len(run), 2 * ILU_SWEEPS * m)
        add(k2, len(run), 1 + 2 * m)
    return k5, k2


def profile_call(fn, what: str) -> dict:
    """One warm call of ``fn`` (a solve): wall time (host clock,
    synchronised, the least of three), then the same call under
    ``torch.profiler``: its device operations, their busy time, the idle
    share, and K2's and K5's device time in it (K2's with the packs of
    its k-column form's x, ``pack_ms`` apart)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, busy, k2, k5, pack = 0, 0.0, 0.0, 0.0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        ops += 1
        busy += us
        k2 += us if any(n in e.name for n in ("ell_spmv", "ell_rowptr",
                                               "ell_pack")) else 0
        pack += us if "ell_pack" in e.name else 0
        k5 += us if "bdia_spmv_xl" in e.name else 0
    wall = 1e3 * min(walls)
    out = dict(wall_ms=wall, walls_ms=[1e3 * w for w in walls],
               device_ops=ops, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / 1e3 / wall, k2_ms=k2 / 1e3,
               k5_ms=k5 / 1e3, pack_ms=pack / 1e3)
    print(f"{what}: wall {wall:.3f} ms (runs {ts_str(out['walls_ms'])}), "
          f"{ops} device operations, busy {out['busy_ms']:.3f} ms, idle "
          f"share {out['idle_share']:.3f}, K2 {out['k2_ms']:.3f} ms (its "
          f"packs {out['pack_ms']:.3f}), K5 {out['k5_ms']:.3f} ms, K2 + K5 "
          f"{out['k2_ms'] + out['k5_ms']:.3f} ms", flush=True)
    return out


def coupled_phase(side: int, card: str, counters) -> dict:
    """(h) Gate 4's three momentum components, coupled, at side^3: the
    CLI's run of ``GATE4_YAML_3COMP`` with ``segregated_solve: no`` and
    ``matrix_ordering: rcm`` (gate 4's settings), the layouts it chose (A
    and A_lo K2, L and U K5), every application of A, A_lo, L and U one
    k-column launch for all the batch's columns (the launches by columns
    equal :func:`coupled_launches` of the run's passes), the golden check
    on every component; then the same solver on each component alone, each
    coupled count within ``COUPLED_SPREAD`` of its segregated one, beside
    ``tpusolve``'s coupled counts; and the warm coupled solve's profile
    against the three segregated solves'."""
    import torch
    from tpusolve_torch.kernels.bdia import bdia_spmv_xl
    from tpusolve_torch.kernels.ell import ell_spmv
    what = f"coupled gate-4 {side}^3"
    tp_counts = TPUSOLVE_COUPLED_RCM
    path = fixture_yaml("4c", side, "coupled.yaml",
                        linear_system={"segregated_solve": False},
                        solver_settings={"matrix_ordering": "rcm"})
    rc, system, wall, launches = run_cli(path, counters)
    check_components(system, rc, what)
    ops = {"A": system.A, "A_lo": system.A_lo, "L": system._precond.L,
           "U": system._precond.U}
    kernels = {k: kernel_of(M).split()[0] for k, M in ops.items()}
    print(f"{what} layouts: " + "; ".join(
        f"{k} {M.layout} ({kernels[k]})" for k, M in ops.items()), flush=True)
    if kernels["A"] != "K2" or kernels["A_lo"] != "K2" \
            or "K5" not in (kernels["L"], kernels["U"]) \
            or any(M.uses_bdia and M.uses_bdia_xl != model_takes_xl(M)
                   for M in ops.values()):
        fail(f"{what}: the model chose {kernels}, not K2 for A and A_lo "
             "and K5 for a factor, or a factor left the model's kernel")
    passes = [r.passes for r in system.solve_results]
    want5, want2 = coupled_launches(passes, (kernels["L"], kernels["U"]))
    got5 = dict(bdia_spmv_xl.launches_by_cols)
    got2 = dict(ell_spmv.launches_by_cols)
    print(f"{what}: refinement passes {passes}; K5 launches by columns "
          f"{got5} (one a batch: {want5}); K2 {got2} (one a batch: {want2})",
          flush=True)
    if got5 != want5 or got2 != want2 or not any(k > 1 for k in got5):
        fail(f"{what}: an application of A, A_lo, L or U was not one "
             "k-column launch for all the batch's columns")
    counts = [int(r.iters) for r in system.solve_results]
    seg = [system._solver(b) for b in system.rhs]
    torch.cuda.synchronize()
    seg_counts = [int(r.iters) for r in seg]
    print(f"{what} counts: coupled {counts}, segregated (the same solver, "
          f"one component a call) {seg_counts}, tpusolve coupled (CPU) "
          f"{list(tp_counts)}", flush=True)
    for c, s_ in zip(counts, seg_counts):
        if abs(c - s_) > max(COUPLED_SPREAD[0], COUPLED_SPREAD[1] * s_):
            fail(f"{what}: coupled count {c} too far from the segregated "
                 f"{s_}")
    rhs = torch.stack(system.rhs)
    prof = {"coupled": profile_call(lambda: system._solver(rhs),
                                    f"{what} warm coupled solve"),
            "segregated": profile_call(
                lambda: [system._solver(b) for b in system.rhs],
                f"{what} warm segregated solves (three)")}
    return dict(iters=counts, segregated=seg_counts,
                tpusolve=list(tp_counts), passes=passes,
                layouts={k: M.layout for k, M in ops.items()},
                launches=launches, k5_by_cols=got5, k2_by_cols=got2,
                wall_s=wall, profile=prof, ops=ops)


def coupled_double_phase(side: int, counters) -> dict:
    """(i) The same three components in natural order, ``double``, at
    side^3: the ELL device ILU(0) path (K2 on A, L and U, k-column), each
    coupled count ``tpusolve``'s exactly and the port's segregated one in
    the same run."""
    import torch
    from tpusolve_torch.kernels.ell import ell_spmv
    what = f"coupled gate-4 {side}^3 double"
    path = fixture_yaml("4c", side, "coupled_double.yaml",
                        linear_system={"segregated_solve": False},
                        solver_settings={"precision": "double"})
    rc, system, wall, launches = run_cli(path, counters)
    check_components(system, rc, what)
    ops = {"A": system.A, "L": system._precond.L, "U": system._precond.U}
    kernels = {k: kernel_of(M).split()[0] for k, M in ops.items()}
    by_cols = dict(ell_spmv.launches_by_cols)
    counts = [int(r.iters) for r in system.solve_results]
    seg = [int(system._solver(b).iters) for b in system.rhs]
    torch.cuda.synchronize()
    print(f"{what}: layouts " + "; ".join(
        f"{k} {M.layout} ({kernels[k]})" for k, M in ops.items())
        + f"; notes {system._precond.notes}; K2 launches by columns "
        f"{by_cols}; counts coupled {counts}, segregated {seg}, tpusolve "
        f"coupled (CPU) {list(TPUSOLVE_COUPLED_64)}", flush=True)
    if set(kernels.values()) != {"K2"} or not by_cols.get(3):
        fail(f"{what}: A, L and U not on K2's 3-column form ({kernels}, "
             f"{by_cols})")
    if counts != list(TPUSOLVE_COUPLED_64) or seg != counts:
        fail(f"{what}: counts {counts} (segregated {seg}), not tpusolve's "
             f"{list(TPUSOLVE_COUPLED_64)}")
    return dict(iters=counts, segregated=seg,
                tpusolve=list(TPUSOLVE_COUPLED_64), k2_by_cols=by_cols,
                launches=launches, wall_s=wall)


def twin_lines(pre, what: str) -> list:
    """Each level's twin (layout and kernel) or none, printed."""
    rows = []
    for i, lev in enumerate(pre.levels):
        T = lev.A_relax
        rows.append(dict(level=i, A=lev.A.layout,
                         tpusolve=lev.A.tpusolve_layout,
                         twin=None if T is None else T.layout,
                         kernel=None if T is None else kernel_of(T)))
    print(f"{what} twins: " + "; ".join(
        f"level {r['level']} A {r['A']} (tpusolve {r['tpusolve']}): "
        + ("no twin" if r["twin"] is None
           else f"bf16 {r['twin']} ({r['kernel']})") for r in rows),
        flush=True)
    return rows


def weakscale_bf16_phase(side: int, counters) -> dict:
    """(j) The weak-scaling YAML at side^3 with ``smoother_dtype:
    bfloat16``: each level's twin and its kernel (K1 on the DIA level 0,
    K2 on every level ``tpusolve`` stores ELL), K1 and K2 launched on bf16
    values, the count within one of ``tpusolve``'s with the twin."""
    from tpusolve_torch import fixtures
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv
    what = f"weakscale bf16 {side}^3"
    path = fixtures.write_weakscale(os.path.join(FIXTURES, "weak_bf16"),
                                    side, bf16=True)
    rc, system, wall, launches = run_cli(path, counters)
    check_solve(system, rc, what, tol=1e-6)
    twins = twin_lines(system._precond, what)
    k1, k2 = dia_spmv.launches_bf16, ell_spmv.launches_bf16
    it = int(system.solve_results[0].iters)
    print(f"{what}: {it} PCG iterations, relres "
          f"{float(system.solve_results[0].relres):.3e} (tpusolve with the "
          f"twin, CPU: {TPUSOLVE_WEAKSCALE_BF16_ITERS}; the YAML without it: "
          f"{TPUSOLVE_WEAKSCALE_ITERS}); bf16 launches K1 {k1}, K2 {k2}",
          flush=True)
    if not twins[0]["twin"] or twins[0]["kernel"] != "K1" or k1 == 0 or \
            (any(str(t["kernel"]).startswith("K2") for t in twins)
             and k2 == 0):
        fail(f"{what}: the twins did not run K1 and K2 on bf16 values")
    if abs(it - TPUSOLVE_WEAKSCALE_BF16_ITERS) > 1:
        fail(f"{what}: {it} iterations, not within one of tpusolve's "
             f"{TPUSOLVE_WEAKSCALE_BF16_ITERS}")
    return dict(iters=it, twins=twins, k1_bf16=k1, k2_bf16=k2,
                launches=launches, wall_s=wall, system=system)


def gate1_bf16_phase(counters) -> dict:
    """(k) Gate 1 at 64^3 with ``smoother_dtype: bfloat16``: the structured
    V-cycle with K1 and the fused prolongation on bf16 planes, the count
    within one a refinement pass of ``tpusolve``'s with the twin."""
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.transfer import box_prolong_update
    what = "gate-1 bf16 64^3"
    with open(os.path.join(REPO, "examples",
                           "gate1_64cube_pcg_amg.yaml")) as fh:
        text = fh.read().replace("  relax_type: 6",
                                 "  relax_type: 6\n  smoother_dtype: bfloat16")
    path = os.path.join(FIXTURES, "gate1_bf16.yaml")
    os.makedirs(FIXTURES, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(text)
    rc, system, wall, launches = run_cli(path, counters)
    res = check_solve(system, rc, what)
    twins = twin_lines(system._precond, what)
    k1, kp = dia_spmv.launches_bf16, box_prolong_update.launches_bf16
    it = int(res.iters)
    print(f"{what}: {it} PCG iterations (passes {res.passes}), tpusolve with "
          f"the twin (CPU) {TPUSOLVE_GATE1_BF16_ITERS}; bf16 launches K1 "
          f"{k1}, fused prolongation {kp}", flush=True)
    if k1 == 0 or kp == 0 or not all(t["twin"] for t in twins):
        fail(f"{what}: K1 or the fused prolongation ran no bf16 launch")
    if abs(it - TPUSOLVE_GATE1_BF16_ITERS) > len(res.passes or [1]):
        fail(f"{what}: {it} iterations, not within one a pass of "
             f"tpusolve's {TPUSOLVE_GATE1_BF16_ITERS}")
    return dict(iters=it, passes=res.passes, twins=twins, k1_bf16=k1,
                prolong_bf16=kp, launches=launches, wall_s=wall,
                system=system)


def columns_nbytes(M, k: int, value_bytes: int | None = None) -> int:
    """The bytes a k-column SpMV of ``M`` must move: each nonzero's value
    once (``value_bytes`` each, by default M's item size), and x and y
    once a column."""
    rows, cols = M.shape
    item = M.diag.element_size()
    return M.nnz * (value_bytes or item) + k * (rows + cols) * item


def library_spmm(M, k: int):
    """(call, X) of cuSPARSE's SpMM on ``M`` (``torch.sparse`` CSR @ an (n,
    k) dense matrix, X of M's unpadded width), the port never calls it."""
    import torch
    csr = library_csr(M)
    X = torch.zeros((csr.shape[1], k), dtype=M.dtype, device=M.device)
    return (lambda: csr @ X), X


def columns_index_nbytes(M, k: int) -> int:
    """:func:`columns_nbytes` of K2 on ELL operator ``M`` with the int32
    column of every stored entry (its padded slots, or its entries and row
    pointer): the floor of a K2 launch, which reads the columns too."""
    vals, cols, rowptr = M.ell_arrays
    extra = cols.numel() * 4
    if rowptr is not None:
        extra += rowptr.numel() * rowptr.element_size()
    return columns_nbytes(M, k) + extra + (vals.numel() - M.nnz) * \
        vals.element_size()


def columns_check(ops: dict, card: str, seed: int,
                  timed: bool = False) -> list:
    """K2's and K5's k-column forms on the operators ``ops`` (gate 4's A,
    A_lo, L and U) at the main path's shapes: for k in ``COLS`` each column
    of a launch equals the single-vector kernel on it bit for bit and the
    plain version to ``RTOL``, the update form c + w s (b - A x) too.
    ``timed``: at k = 3 (the main path's) the launch's device and per-call
    time against three single launches and cuSPARSE's SpMM, with its bound
    (and K2's floor with its column indices), and for K2 its launch on an
    x packed beforehand (the interleaved layout, without the pack; the
    (n, k) layout where the package predates the pack).  Runs on the
    operators of an earlier checkout too (``profile_solves.py --only
    kcols``)."""
    import inspect
    import numpy as np
    import torch
    from tpusolve_torch.kernels import bdia, ell
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.matrix.spmv import spmv, spmv_update
    packs = "packed" in inspect.signature(ell.ell_spmv).parameters
    rng = np.random.default_rng(seed)
    rows_out = []
    for name, M in ops.items():
        dt = M.dtype
        rtol = RTOL["float32" if dt == torch.float32 else "float64"]
        rand = lambda *shape: torch.from_numpy(rng.standard_normal(
            shape)).to(M.device, dt)

        def plain(X):
            if M.uses_bdia_xl:
                return torch.stack([bdia.bdia_spmv_xl_plain(
                    M.bdia_vals, M.bdia_starts, x, M.bdia_xpad, M.row_pad,
                    M.bdia_gb, M.bdia_step_lo, M.bdia_panel, M.bdia_ovf,
                    mask=M.bdia_mask, step_b0=M.bdia_step_b0) for x in X])
            vals, cols, rowptr = M.ell_arrays
            return ell._plain(vals, cols, X, None, None, None, 1.0, None,
                              rowptr)

        worst, worst_abs, bits = 0.0, 0.0, True
        for k in COLS:
            X = rand(k, M.col_pad)
            Y = spmv(M, X)
            B, C, S = rand(k, M.row_pad), rand(k, M.row_pad), rand(M.row_pad)
            Yu = spmv_update(M, X, b=B, s=S, c=C, w=0.8)
            torch.cuda.synchronize()
            for j in range(k):
                bits &= torch.equal(Y[j], spmv(M, X[j]))
                bits &= torch.equal(Yu[j], spmv_update(
                    M, X[j], b=B[j], s=S, c=C[j], w=0.8))
            P = plain(X)
            worst_abs = max(worst_abs, float((Y - P).abs().max()))
            worst = max(worst, float((Y - P).abs().max() / P.abs().max()))
        if not bits or worst > rtol:
            fail(f"{name}: the k-column form is not the single kernel's "
                 f"bits or is off its plain version ({worst:.2e})")
        row = dict(op=name, kernel=kernel_of(M), layout=M.layout,
                   max_rel_err=worst, max_abs_err=worst_abs,
                   bits_equal=bits)
        rows_out.append(row)
        if not timed:
            print(f"{name} {M.layout} {str(dt)[6:]} {row['kernel']}: k in "
                  f"{COLS} each column the single kernel's bits: {bits}, "
                  f"max rel err {worst:.2e}", flush=True)
            continue
        k = 3
        X = rand(k, M.col_pad)
        lib, Xl = library_spmm(M, k)
        Xl.copy_(X[:, :Xl.shape[0]].T)
        calls = {"cols": lambda: spmv(M, X),
                 "singles": lambda: [spmv(M, X[j]) for j in range(k)],
                 "library": lib}
        vals, cols, rowptr = M.ell_arrays if M.uses_ell else (None,) * 3
        if M.uses_ell and packs:
            Xp = ell.pack_columns(X)
            calls["interleaved"] = lambda: ell.ell_spmv(
                vals, cols, Xp, rowptr=rowptr, packed=True)
        elif M.uses_ell:
            Xi = X.T.contiguous()
            calls["interleaved"] = lambda: ell.ell_spmv(
                vals, cols, Xi, rowptr=rowptr, interleaved=True)
        dev = device_times(calls)
        per = {key: time_ms(fn) for key, fn in calls.items()}
        plain_ms = time_ms(lambda: plain(X))
        row.update(k=k, dev_ms=dev["cols"], ms=per["cols"],
                   singles_dev_ms=dev["singles"], singles_ms=per["singles"],
                   interleaved_dev_ms=dev.get("interleaved"),
                   interleaved_ms=per.get("interleaved"),
                   lib_dev_ms=dev["library"], lib_ms=per["library"],
                   plain_ms=plain_ms, bound_ms=bound_ms(
                       columns_nbytes(M, k), card),
                   single_bound_ms=bound_ms(columns_nbytes(M, 1), card),
                   index_floor_ms=(bound_ms(columns_index_nbytes(M, k), card)
                                   if M.uses_ell else None))
        if M.uses_bdia_xl:
            op = M.xl_cols_op(k)
            row.update(steps=op.ints[9], panel=op.ints[10])
        if M.uses_ell and packs:
            # the pack against its plain version: the transpose; its bound
            # reads and writes k entries a row of x
            pack = lambda: ell.pack_columns(X)
            plain_pack = lambda: X.T.contiguous()
            pack_equal = torch.equal(pack(), plain_pack())
            if not pack_equal:
                fail(f"{name}: the pack is not the transpose of x")
            row.update(pack_dev_ms=device_times({"pack": pack})["pack"],
                       pack_ms=time_ms(pack), pack_plain_ms=time_ms(
                           plain_pack), pack_bound_ms=bound_ms(
                               2 * X.numel() * X.element_size(), card),
                       pack_equal=pack_equal)
        print(f"{name} {M.layout} {str(dt)[6:]} {row['kernel']} {k}-column: "
              f"device {row['dev_ms']:.5f} ms, per call {row['ms']:.5f} "
              f"ms; {k} single launches device {row['singles_dev_ms']:.5f} "
              f"ms, per call {row['singles_ms']:.5f}; "
              + (f"interleaved ({'packed beforehand' if packs else '(n, k)'}"
                 f") device {row['interleaved_dev_ms']}; " if M.uses_ell
                 else f"{row['steps']} steps, panel {row['panel']}; ")
              + f"cuSPARSE SpMM device {row['lib_dev_ms']:.5f} ms; plain "
              f"{plain_ms:.5f} ms; bound {row['bound_ms']:.5f} ms ({k} "
              f"single bounds {k * row['single_bound_ms']:.5f}"
              + (f"; with the column indices {row['index_floor_ms']:.5f}"
                 if M.uses_ell else "")
              + (f"; the pack device {row['pack_dev_ms']:.5f} ms, per call "
                 f"{row['pack_ms']:.5f}, plain {row['pack_plain_ms']:.5f}, "
                 f"bound {row['pack_bound_ms']:.5f}, equal to the transpose"
                 if "pack_ms" in row else "")
              + f"); k in {COLS} each column the single kernel's bits: "
              f"{bits}, max rel err {worst:.2e} ({card})", flush=True)
    return rows_out


def bf16_check(pre_ws, pre_g1, card: str, seed: int) -> list:
    """K1, K2 and the fused prolongation on bf16 values at the main paths'
    shapes: the weak-scaling levels' twins (K1 on level 0, K2 on the first
    ELL twin) and gate 1's level 0 (the fused prolongation); each equals
    its f32 or f64 launch on the values rounded to bf16 bit for bit (in
    f32 and in f64) and the plain version to ``RTOL``, and is timed against
    the f32 form on the same operator (no library call takes bf16 values
    with an f32 x); K2's twin also over 3 columns (the coupled solve's
    k-column form, each column the single bf16 launch's bits) against its
    f32 form over 3 columns and three single bf16 launches."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels import dia, ell, transfer
    from tpusolve_torch.kernels.calibrate import time_ms
    rng = np.random.default_rng(seed)
    rows_out = []
    ops = [("weakscale level 0", pre_ws.levels[0])]
    ell_lev = next((i, lev) for i, lev in enumerate(pre_ws.levels)
                   if lev.A_relax is not None and lev.A_relax.uses_ell)
    ops.append((f"weakscale level {ell_lev[0]}", ell_lev[1]))
    for name, lev in ops:
        T, A = lev.A_relax, lev.A
        worst, worst_abs, bits = 0.0, 0.0, True
        for dt in (torch.float32, torch.float64):
            vec = lambda n: torch.from_numpy(rng.standard_normal(n)).to(
                A.device, dt)
            x, b, c = vec(T.col_pad), vec(T.row_pad), vec(T.row_pad)
            s = b.abs() + 1
            if T.uses_dia:
                run = lambda v, **kw: dia.dia_spmv(v, T.dia_offsets, x, **kw)
                vb = T.dia_vals
            else:
                vals, cols, rowptr = T.ell_arrays
                run = lambda v, **kw: ell.ell_spmv(v, cols, x, rowptr=rowptr,
                                                   **kw)
                vb = vals
            vr = vb.to(dt)
            for kw in ({}, dict(b=b, s=s, c=c, w=0.8)):
                got, want = run(vb, **kw), run(vr, **kw)
                torch.cuda.synchronize()
                bits &= torch.equal(got, want)
            p = (dia.dia_spmv_plain(vr, T.dia_offsets, x) if T.uses_dia
                 else ell._plain(vr, cols, x, None, None, None, 1.0, None,
                                 rowptr))
            d = float((run(vb) - p).abs().max())
            worst_abs = max(worst_abs, d)
            worst = max(worst, d / float(p.abs().max()))
        if not bits or worst > RTOL["float64"] * 1e7:
            fail(f"{name}: the bf16 form is not the full-precision one on "
                 f"the rounded values ({bits}, {worst:.2e})")
        x = torch.from_numpy(rng.standard_normal(T.col_pad)).to(
            A.device, A.dtype)
        if T.uses_dia:
            f16 = lambda: dia.dia_spmv(T.dia_vals, T.dia_offsets, x)
            f32 = lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets, x)
            plain = lambda: dia.dia_spmv_plain(T.dia_vals, T.dia_offsets, x)
            kern = "K1"
        else:
            vals, cols, rowptr = T.ell_arrays
            a_vals, a_cols, a_rowptr = A.ell_arrays
            f16 = lambda: ell.ell_spmv(vals, cols, x, rowptr=rowptr)
            f32 = lambda: ell.ell_spmv(a_vals, a_cols, x, rowptr=a_rowptr)
            plain = lambda: ell._plain(vals, cols, x, None, None, None, 1.0,
                                       None, rowptr)
            kern = "K2"
        calls = {"bf16": f16, "full": f32}
        if kern == "K2":
            X = torch.from_numpy(rng.standard_normal((3, T.col_pad))).to(
                A.device, A.dtype)
            Y = ell.ell_spmv(vals, cols, X, rowptr=rowptr)
            torch.cuda.synchronize()
            if not all(torch.equal(Y[j], ell.ell_spmv(
                    vals, cols, X[j], rowptr=rowptr)) for j in range(3)):
                fail(f"{name}: K2's 3-column form on bf16 values is not "
                     "the single bf16 launch's bits")
            calls.update(
                bf16_cols=lambda: ell.ell_spmv(vals, cols, X, rowptr=rowptr),
                full_cols=lambda: ell.ell_spmv(a_vals, a_cols, X,
                                               rowptr=a_rowptr),
                bf16_singles=lambda: [ell.ell_spmv(vals, cols, X[j],
                                                   rowptr=rowptr)
                                      for j in range(3)])
        dev = device_times(calls)
        row = dict(op=name, kernel=kern, layout=T.layout, dev_ms=dev["bf16"],
                   ms=time_ms(f16), full_dev_ms=dev["full"],
                   full_ms=time_ms(f32), plain_ms=time_ms(plain),
                   bound_ms=bound_ms(columns_nbytes(T, 1, 2), card),
                   full_bound_ms=bound_ms(columns_nbytes(A, 1), card),
                   cols3_dev_ms=dev.get("bf16_cols"),
                   cols3_full_dev_ms=dev.get("full_cols"),
                   singles3_dev_ms=dev.get("bf16_singles"),
                   max_rel_err=worst, max_abs_err=worst_abs,
                   bits_equal=bits)
        rows_out.append(row)
        print(f"{name} bf16 twin {T.layout} {kern}: device "
              f"{row['dev_ms']:.5f} ms, per call {row['ms']:.5f} ms; the "
              f"f32 form on A device {row['full_dev_ms']:.5f} ms; plain "
              f"{row['plain_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms "
              f"(f32 {row['full_bound_ms']:.5f}); library none; equal to the "
              f"rounded f32 and f64 forms bit for bit: {bits}, max rel err "
              f"{worst:.2e}"
              + (f"; 3 columns device {row['cols3_dev_ms']:.5f} ms (f32 "
                 f"values {row['cols3_full_dev_ms']:.5f}, three single bf16 "
                 f"launches {row['singles3_dev_ms']:.5f}), each column the "
                 "single launch's bits" if kern == "K2" else "")
              + f" ({card})", flush=True)
    # the fused prolongation on gate 1's level 0 -> 1 (64^3 -> 32^3)
    lev = pre_g1.levels[0]
    T, A = lev.A_relax, lev.A
    fine, coarse = tuple(A.dia_shape), tuple(pre_g1.levels[1].A.dia_shape)
    bits, worst, worst_abs = True, 0.0, 0.0
    for dt in (torch.float32, torch.float64):
        vec = lambda n: torch.from_numpy(rng.standard_normal(n)).to(
            A.device, dt)
        n = A.row_pad
        ec, x, b, s = vec(n // 8), vec(n), vec(n), vec(n).abs() + 1
        xb, xr = torch.empty_like(x), torch.empty_like(x)
        got = transfer.box_prolong_update(fine, coarse, T.dia_vals,
                                          T.dia_offsets, ec, x, b, s, 1.0,
                                          True, xb)
        want = transfer.box_prolong_update(fine, coarse, T.dia_vals.to(dt),
                                           T.dia_offsets, ec, x, b, s, 1.0,
                                           True, xr)
        torch.cuda.synchronize()
        bits &= torch.equal(got, want) and torch.equal(xb, xr)
        p = transfer.prolong_update_plain(fine, coarse, T.dia_vals.to(dt),
                                          T.dia_offsets, ec, x, b, s, 1.0,
                                          True)
        worst_abs = max(worst_abs, float((got - p).abs().max()))
        worst = max(worst, float((got - p).abs().max() / p.abs().max()))
    if not bits:
        fail("gate-1 level 0 fused prolongation: bf16 is not the "
             "full-precision form on the rounded values")
    n = A.row_pad
    vec = lambda m: torch.from_numpy(rng.standard_normal(m)).to(A.device,
                                                                A.dtype)
    ec, x, b, s = vec(n // 8), vec(n), vec(n), vec(n)
    f16 = lambda: transfer.box_prolong_update(
        fine, coarse, T.dia_vals, T.dia_offsets, ec, x, b, s, 1.0, True)
    f32 = lambda: transfer.box_prolong_update(
        fine, coarse, A.dia_vals, A.dia_offsets, ec, x, b, s, 1.0, True)
    dev = device_times({"bf16": f16, "full": f32})
    # the planes once (bf16), ec, x, b and s read, y and x' written
    nbytes = A.nnz * 2 + (5 * n + n // 8) * A.diag.element_size()
    row = dict(op="gate-1 level 0 -> 1", kernel="fused prolongation",
               layout=T.layout, dev_ms=dev["bf16"], ms=time_ms(f16),
               full_dev_ms=dev["full"], full_ms=time_ms(f32),
               plain_ms=time_ms(lambda: transfer.prolong_update_plain(
                   fine, coarse, T.dia_vals, T.dia_offsets, ec, x, b, s, 1.0,
                   True)),
               bound_ms=bound_ms(nbytes, card),
               full_bound_ms=bound_ms(nbytes + A.nnz * 2, card),
               max_rel_err=worst, max_abs_err=worst_abs, bits_equal=bits)
    rows_out.append(row)
    print(f"gate-1 level 0 -> 1 fused prolongation bf16: device "
          f"{row['dev_ms']:.5f} ms, per call {row['ms']:.5f} ms; f32 "
          f"planes device {row['full_dev_ms']:.5f} ms; plain "
          f"{row['plain_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms; "
          f"library none; bits equal {bits}, max rel err {worst:.2e} "
          f"({card})", flush=True)
    return rows_out


# ----------------------------------------------------------------------
# (l)-(n): multi-part operators, PARTS parts stacked on the card

def parts_run(what: str, yaml_path: str, counters, tol: float = 1e-8):
    """Run ``yaml_path`` on ``PARTS`` parts through the CLI; returns
    (system, result, launches, timer rows).  Prints the launches (K2's on
    offd blocks as ``ell_spmv offd``) and every operator's layout, and
    fails unless the golden check passed on an operator of ``PARTS`` parts
    with an offd block, and K2 ran on offd blocks."""
    rc, system, wall, launches = run_cli(yaml_path, counters, parts=PARTS)
    print(f"{what} path: cli exit {rc}, {wall:.1f} s wall, launches "
          f"{launches}", flush=True)
    res = check_solve(system, rc, what, tol)
    if system.A.nparts != PARTS or not system.A.has_offd:
        fail(f"{what}: the operator has {system.A.nparts} parts, offd "
             f"block {system.A.has_offd}")
    print(f"{what} layouts: A {system.A.layout}"
          + (f"; A_lo {system.A_lo.layout}" if system.A_lo is not None
             else ""), flush=True)
    pre = system._precond
    lines = (pre.layouts() if hasattr(pre, "layouts")
             else [f"ILU L: {pre.L.layout}", f"ILU U: {pre.U.layout}"])
    for line in lines:
        print(f"{what} {line}", flush=True)
    timers = print_timers(system, what)
    if launches["ell_spmv offd"] <= 0:
        fail(f"{what}: K2 ran on no offd block")
    return system, res, launches, timers


def parts_count(what: str, key: str, res, spread: int) -> dict:
    """Hold the count of result ``res`` within ``spread`` of
    ``tpusolve``'s 8-part count ``TPUSOLVE_PARTS_ITERS[key]``."""
    want = TPUSOLVE_PARTS_ITERS[key]
    passes = res.passes or []
    gap = int(res.iters) - want
    print(f"{what}: {res.iters} iterations (refinement passes {passes}), "
          f"relres {float(res.relres):.3e}, golden check PASSED; tpusolve on "
          f"{PARTS} devices (CPU, same input) {want}: gap {gap:+d}, held "
          f"within {spread}", flush=True)
    if abs(gap) > spread:
        fail(f"{what} took {res.iters} iterations, {gap:+d} from "
             f"tpusolve's {want} (held within {spread})")
    return dict(iters=int(res.iters), passes=passes,
                relres=float(res.relres), tpusolve=want, gap=gap)


def offd_timing(name: str, M, launches: int, card: str, seed: int) -> dict:
    """K2 on the stacked offd block of multi-part operator ``M`` (one
    launch, ``M.offd_k2``, over the ghosts of a random x) against its plain
    version: device and per-call time, the plain version's, cuSPARSE's CSR
    SpMV on the same block (``torch.sparse``, never called by the port)
    and the bound (each entry's value once, the ghosts and y once, over
    the card's HBM rate); beside it the halo's one index gather
    (``halo_gather``) and its bound (the ghosts read and written, their
    int64 indices read).  ``launches``: K2's offd launches on the path."""
    import numpy as np
    import torch
    from tpusolve_torch.kernels.calibrate import time_ms
    from tpusolve_torch.kernels.ell import (ell_rowptr_plain, ell_spmv,
                                            ell_spmv_plain)
    from tpusolve_torch.matrix.spmv import halo_gather

    vals, cols, rowptr = M.offd_k2
    dt = str(M.dtype).replace("torch.", "")
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(M.nparts * M.col_pad),
                     dtype=M.dtype, device=M.device)
    g = halo_gather(M, x)
    kern = lambda: ell_spmv(vals, cols, g, rowptr=rowptr)
    plain = ((lambda: ell_spmv_plain(vals, cols, g)) if rowptr is None
             else (lambda: ell_rowptr_plain(rowptr, vals, cols, g)))
    y, y_p = kern(), plain()
    err = rel_err(y, y_p)
    if not err <= RTOL[dt]:
        fail(f"{name}: K2 on the offd block vs plain rel err {err:.3e}")
    if rowptr is None:
        keep = vals != 0
        ptr = torch.zeros(vals.shape[0] + 1, dtype=torch.int64,
                          device=M.device)
        torch.cumsum(keep.sum(1), 0, out=ptr[1:])
        lv, lc = vals[keep], cols[keep].long()
    else:
        ptr, lv, lc = rowptr.long(), vals, cols.long()
    csr = torch.sparse_csr_tensor(ptr, lc, lv, size=(y.numel(), g.numel()))
    err_lib = rel_err(csr @ g, y_p)
    calls = [("plain", plain), ("k2", kern), ("lib", lambda: csr @ g),
             ("gather", lambda: halo_gather(M, x))]
    runs = {k: [] for k, _ in calls}
    for k, call in calls + calls[::-1]:
        runs[k].append(time_ms(call))
    dev = device_times(dict(calls))
    item = vals.element_size()
    nnz = int(torch.count_nonzero(M.offd_vals))
    row = dict(op=name, dtype=dt, layout=M.layout,
               form="padded" if rowptr is None else "rowptr",
               rows=int(y.numel()), ghosts=int(g.numel()), nnz=nnz,
               launches=int(launches), rel_err=err, max_rel_err=err,
               max_abs_err=float((y - y_p).abs().max()), lib_rel_err=err_lib,
               bound_ms=bound_ms((nnz + y.numel() + g.numel()) * item, card),
               gather_bound_ms=bound_ms(g.numel() * (2 * item + 8), card))
    for k, ts in runs.items():
        row[k + "_ms"] = min(ts)
        row[k + "_runs"] = ts
        row[k + "_dev_ms"] = dev[k]
    row["ms"], row["dev_ms"] = row["k2_ms"], row["k2_dev_ms"]
    row["_arrays"] = (vals, cols, rowptr, x, M.halo_src)
    print(f"{name} {dt} offd {row['form']} ({row['rows']} rows over "
          f"{row['ghosts']} ghosts, {nnz} nnz; {launches} launches on the "
          f"path): K2 device {row['k2_dev_ms']:.5f} ms, per call "
          f"{row['k2_ms']:.5f} ms (runs {ts_str(row['k2_runs'])}), rel err "
          f"{err:.3e}; plain device {row['plain_dev_ms']:.5f} ms, per call "
          f"{row['plain_ms']:.5f} ms; library (torch.sparse CSR) device "
          f"{row['lib_dev_ms']:.5f} ms, per call {row['lib_ms']:.5f} ms "
          f"(rel err {err_lib:.1e}); bound {row['bound_ms']:.5f} ms; halo "
          f"gather device {row['gather_dev_ms']:.5f} ms, per call "
          f"{row['gather_ms']:.5f} ms, bound {row['gather_bound_ms']:.5f} "
          f"ms ({card})", flush=True)
    return row


def fresh_offd_ms(rows) -> None:
    """Every row of :func:`offd_timing`'s ``rows`` timed again in one fresh
    process (``python -m tpusolve_torch.kernels.calibrate --retrace FILE``,
    the blocks' arrays and x saved to FILE): cuSPARSE's device time on the
    block (``lib_dev_ms_fresh``, and the library's ``lib_dev_ms`` where this
    process's trace lost it) with the device events of one library call
    (``lib_kernels``), and K2's and the halo gather's where this process's
    traces lost them (NaN where that fails too, printed); every row's
    arrays are dropped after."""
    import torch
    arrays = {r["op"]: r["_arrays"] for r in rows}
    for r in rows:
        del r["_arrays"]
    if not rows:
        return
    path = os.path.join(REPO, "build", "retrace_offd.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"offd": arrays}, path)
    del arrays
    try:
        out = subprocess.run(
            [sys.executable, "-m", "tpusolve_torch.kernels.calibrate",
             "--retrace", path], cwd=REPO, capture_output=True, text=True,
            timeout=300)
    finally:
        os.remove(path)
    try:
        got = json.loads(out.stdout.strip().splitlines()[-1])["device_ms"]
    except (ValueError, IndexError, KeyError):
        print(f"offd rows: device times not measured in a fresh process "
              f"either (exit {out.returncode}): "
              f"{out.stderr.strip()[-400:]}", flush=True)
        return
    lost = lambda v: v != v
    for r in rows:
        g = got[r["op"]]
        r["lib_dev_ms_fresh"] = g["lib"]
        r["lib_kernels"] = g["lib_kernels"]
        taken = []
        if lost(r["k2_dev_ms"]):
            r["k2_dev_ms"] = r["dev_ms"] = g["k2"]
            taken.append("K2")
        if lost(r["gather_dev_ms"]):
            r["gather_dev_ms"] = g["gather"]
            taken.append("the halo gather")
        if lost(r["lib_dev_ms"]):
            r["lib_dev_ms"] = g["lib"]
            taken.append("the library")
        r["dev_ms_from"] = ("a fresh process: " + ", ".join(taken)
                            if taken else "this process")
        print(f"{r['op']} offd, in a fresh process: K2 device {g['k2']:.5f} "
              f"ms, halo gather device {g['gather']:.5f} ms, library "
              f"(torch.sparse CSR, int64 indices) device {g['lib']:.5f} ms; "
              f"one library call's device events {g['lib_kernels']}; taken "
              f"from there: {', '.join(taken) or 'nothing'}", flush=True)


def gate4_parts_phase(card: str, counters) -> dict:
    """(m) Gate 4 at 96^3 from 8 files on ``PARTS`` parts: every operator
    (A, A_lo, L, U) launched the kernel of its diag block's layout, K2 ran
    on the offd blocks, the ILU was factored where ``tpusolve`` factors it
    (``device_path`` on the layout it gives A_lo's parts: block-Jacobi on
    the card, L and U without offd blocks, or the host factors of the
    whole operator with theirs), the count within one a refinement pass of
    ``tpusolve``'s 8-part count; K2 on A_lo's offd block timed."""
    what = f"gate-4 96^3 {PARTS} parts"
    system, res, launches, timers = parts_run(
        what, fixture_yaml("4p8", 96, "gate4_parts.yaml"), counters)
    pre = system._precond
    ops = (("A", system.A), ("A_lo", system.A_lo), ("L", pre.L),
           ("U", pre.U))
    for name, M in ops:
        fn = launch_counter(M).__name__
        if M.uses_ell:
            fn += " rowptr" if M.uses_ell_rowptr else " padded"
        if launches[fn] <= 0:
            fail(f"{what}: {name} ({M.layout}) launched no {fn}")
    # the ILU is factored where tpusolve factors it: on the device, part by
    # part (block-Jacobi, no offd block), where device_path holds on the
    # layout tpusolve gives A_lo's parts, else on the host, the whole
    # operator (offd blocks kept)
    from tpusolve_torch.ilu.device_setup import device_path
    on_card = device_path(system.A_lo, system.config.ilu) is not None
    blockj = any("block-Jacobi" in n for n in pre.notes)
    print(f"{what}: A_lo's layout in tpusolve {system.A_lo.tpusolve_layout}"
          f", the ILU factored "
          f"{'on the card, block-Jacobi' if on_card else 'on the host'} as "
          f"tpusolve factors it; notes {pre.notes}", flush=True)
    for name, M in ops:
        if M.has_offd != (name in ("A", "A_lo") or not on_card):
            fail(f"{what}: {name} has offd block {M.has_offd}")
    if blockj != on_card:
        fail(f"{what}: the ILU's notes {pre.notes} do not match tpusolve's "
             f"path ({'device' if on_card else 'host'})")
    print(f"{what} kernels, as the model prices them: " + ", ".join(
        f"{name} {kernel_of(M)}" for name, M in ops), flush=True)
    out = parts_count(what, "gate4", res, len(res.passes or []))
    row = offd_timing(f"{what} A_lo", system.A_lo, launches["ell_spmv offd"],
                      card, 41)
    prof = solve_profile(system, what)
    system.destroy_system()
    return dict(out, launches=launches, timers=timers, offd_rows=[row],
                layouts={k: M.layout for k, M in ops}, profile=prof)


def gate1_parts_phase(card: str, counters) -> dict:
    """(l) Gate 1 on ``PARTS`` parts (64^3 a part): K1 and both fused
    transfers ran, the standalone K3 kernels did not, K2 ran on the offd
    shells, the count within one a pass of ``tpusolve``'s 8-part count;
    K2 on level 0's offd block timed."""
    what = f"gate-1 {PARTS} parts"
    system, res, launches, timers = parts_run(
        what, os.path.join(REPO, "examples", "gate1_64cube_pcg_amg.yaml"),
        counters)
    for fn in ("dia_spmv", "box_restrict_residual", "box_prolong_update"):
        if launches[fn] <= 0:
            fail(f"{what}: the path launched no {fn}")
    for fn in ("box_prolong", "box_restrict"):
        if launches[fn]:
            fail(f"{what}: the path launched the standalone {fn}")
    # one K2 launch on the box prolongation's rows at the ghosts' sources
    # before each fused prolongation of a level with an offd block
    ghosts = launches["ell_spmv ghost prolong"]
    print(f"{what}: K2 on offd blocks {launches['ell_spmv offd']}, on the "
          f"prolongation's ghost rows {ghosts} (the fused prolongations "
          f"{launches['box_prolong_update']})", flush=True)
    if not 0 < ghosts <= launches["box_prolong_update"]:
        fail(f"{what}: {ghosts} ghost prolongations for "
             f"{launches['box_prolong_update']} fused prolongations")
    out = parts_count(what, "gate1", res, len(res.passes or []))
    lev0 = system._precond.levels[0].A
    row = offd_timing(f"{what} level 0", lev0, launches["ell_spmv offd"],
                      card, 42)
    prof = solve_profile(system, what)
    system.destroy_system()
    return dict(out, launches=launches, timers=timers, offd_rows=[row],
                profile=prof)


def gate3_parts_phase(card: str, counters) -> dict:
    """(n) Gate 3 at 64^3 on ``PARTS`` parts, host BoomerAMG: every
    level's A, P and R launched its kernel, K2 ran on the offd blocks,
    exactly ``tpusolve``'s 8-part count."""
    what = f"gate-3 64^3 {PARTS} parts"
    system, res, launches, timers = parts_run(
        what, fixture_yaml(3, 64, "gate3_parts.yaml"), counters)
    check_launched(system._precond, launches, what)
    out = parts_count(what, "gate3", res, 0)
    row = offd_timing(f"{what} level 0", system.A, launches["ell_spmv offd"],
                      card, 43)
    system.destroy_system()
    return dict(out, launches=launches, timers=timers, offd_rows=[row])


# ----------------------------------------------------------------------
# (o), (p): the multi-part device AMG setups on PARTS parts, and their bits


def ranks_env() -> dict:
    """The ranks' environment: the checkout on ``PYTHONPATH``, and each
    rank's share of the host's cores for torch's threads (the launcher
    would give each one thread; the ranks' host assembly runs torch
    operations on the CPU)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // RANKS)))
    return env


def run_group(cmd, timeout: int) -> subprocess.CompletedProcess:
    """Run ``cmd`` (a launcher of ranks) from the checkout in a process
    group of its own, its output captured; past ``timeout`` seconds the
    whole group (the launcher and its ranks) is killed and the phase
    fails."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=ranks_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"{' '.join(cmd[-8:])} ran past {timeout} s; its processes "
             "were killed")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def ranks_launch(yaml_path: str, backend: str, logdir: str,
                 timeout: int = 600) -> tuple:
    """Run the port's CLI on ``yaml_path`` as ``RANKS`` processes through
    ``torch.distributed.run`` (``--parts PARTS --dist-backend backend``),
    each rank's output in its own file under ``logdir``; returns (exit
    code, wall seconds, [each rank's output], the launcher's output)."""
    import glob
    shutil.rmtree(logdir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS), "--log-dir", logdir,
           "--redirects", "3", "-m", "tpusolve_torch", yaml_path,
           "--parts", str(PARTS), "--dist-backend", backend]
    t0 = time.perf_counter()
    proc = run_group(cmd, timeout)
    wall = time.perf_counter() - t0
    outs = []
    for r in range(RANKS):
        found = glob.glob(os.path.join(logdir, "**", "attempt_*", str(r),
                                       "stdout.log"), recursive=True)
        outs.append(open(found[0]).read() if found else "")
    return proc.returncode, wall, outs, proc.stdout + proc.stderr


def rank_summary(out: str, r: int) -> dict:
    """Rank ``r``'s JSON line of the CLI (``tpusolve_torch rank r/R:``)."""
    line = next((ln for ln in out.splitlines()
                 if ln.startswith(f"tpusolve_torch rank {r}/")), None)
    if line is None:
        fail(f"rank {r} printed no summary line:\n{out[-3000:]}")
    return json.loads(line.split(": ", 1)[1])


def ranks_phase(key: str, yaml_path: str, card: str, spread) -> dict:
    """(q), (r): the gate ``key`` on ``RANKS`` ranks x ``PARTS`` parts
    sharing the card through gloo.  Prints each rank's line (device,
    backend, parts, rows and files read, K2's launches and its offd
    launches, K5's, the count, the check, the timer rows) and fails unless
    every rank exited 0, passed the check, launched K2 on an offd block,
    read only its own rows (its share of the matrix entries, and from IJ
    files only its own part files)
    and took ``tpusolve``'s 8-device count within ``spread`` (a number, or
    "passes": one a refinement pass)."""
    side = RANKS_SIDES[key]
    what = f"{key.replace('gate', 'gate-')} {side}^3 {RANKS} ranks x " \
           f"{PARTS // RANKS} parts"
    logdir = os.path.join(FIXTURES, f"ranks_{key}")
    rc, wall, outs, launcher = ranks_launch(yaml_path, "gloo", logdir)
    if rc != 0:
        fail(f"{what}: torch.distributed.run exit {rc}:\n"
             f"{launcher[-3000:]}\n{outs[0][-2000:]}\n{outs[1][-2000:]}")
    lines = [rank_summary(out, r) for r, out in enumerate(outs)]
    want = TPUSOLVE_RANKS_ITERS[key]
    from tpusolve_torch.parts import row_decomposition
    offsets = row_decomposition(side ** 3, PARTS)
    for r, (ln, out) in enumerate(zip(lines, outs)):
        k2, offd = ln["launches"]["ell_spmv"], ln["launches"]["ell_spmv offd"]
        it, passes = ln["iters"][0], ln["passes"][0] or []
        print(f"{what} rank {r}: {ln['device']}, backend {ln['backend']}, "
              f"parts {ln['parts']}, rows {ln['rows']}, files "
              f"{[os.path.basename(f) for f in ln['files']]}; launches K2 "
              f"{k2} (offd blocks {offd}), K5 "
              f"{ln['launches']['bdia_spmv_xl']}, K1 "
              f"{ln['launches']['dia_spmv']}, K4 "
              f"{ln['launches']['bdia_spmv']}; {it} iterations (passes "
              f"{passes}), relres {ln['relres'][0]:.3e}, check "
              f"{ln['check']}; tpusolve on {PARTS} devices (CPU, same YAML) "
              f"{want}", flush=True)
        print(f"{what} rank {r} layouts: {ln['layouts']}", flush=True)
        print(f"{what} rank {r} timer rows (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in ln["timers"].items()), flush=True)
        if ln["check"] != "PASSED" or "Check solution: PASSED" not in out:
            fail(f"{what}: rank {r}'s check {ln['check']}")
        if offd <= 0:
            fail(f"{what}: rank {r} ran K2 on no offd block")
        if ln["parts"] != [r * PARTS // RANKS, (r + 1) * PARTS // RANKS]:
            fail(f"{what}: rank {r} holds parts {ln['parts']}")
        lo, hi = ln["rows"]
        if (lo, hi) != (int(offsets[ln["parts"][0]]),
                        int(offsets[ln["parts"][1]]) - 1):
            fail(f"{what}: rank {r} read rows {lo}..{hi}")
        if key == "gate4":
            per = PARTS // RANKS
            names = sorted(os.path.basename(f) for f in ln["files"])
            own = sorted(f"{stem}.{p:05d}" for p in range(r * per,
                                                          (r + 1) * per)
                         for stem in ("momentum.IJ.mat",
                                      "momentum_rhs.IJ.vec",
                                      "momentum_sln.IJ.vec"))
            if names != own:
                fail(f"{what}: rank {r} parsed {names}, its own are {own}")
        slack = len(passes) if spread == "passes" else spread
        if abs(it - want) > slack:
            fail(f"{what}: rank {r} took {it} iterations, {it - want:+d} "
                 f"from tpusolve's {want} (held within {slack})")
    if lines[0]["iters"] != lines[1]["iters"]:
        fail(f"{what}: the ranks' counts differ {lines[0]['iters']} "
             f"{lines[1]['iters']}")
    entries = [ln["entries"] for ln in lines]
    print(f"{what}: matrix entries kept by rank {entries}", flush=True)
    if not all(0 < e < sum(entries) for e in entries):
        fail(f"{what}: a rank kept every entry or none ({entries})")
    launches = {k: sum(ln["launches"][k] for ln in lines)
                for k in lines[0]["launches"]}
    print(f"{what}: {wall:.1f} s wall for the launch, both ranks; launches "
          f"of both {launches}; {card}", flush=True)
    return dict(ranks=lines, wall_s=wall, launches=launches,
                tpusolve=want)


def timed_collectives(dist_mod) -> dict:
    """Wrap ``dist_mod``'s collectives (the halo's ``exchange``, the
    reductions' ``all_reduce``, the coarse solve's ``all_gather_cat``) so
    that each call is timed on the host between two synchronisations of
    the card (the kernels queued before it finished first); returns the
    {name: [calls, seconds]} the wrapped calls add to."""
    import torch
    stats = {}

    def wrap(name):
        fn = getattr(dist_mod, name)
        stats[name] = [0, 0.0]

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stats[name][0] += 1
            stats[name][1] += time.perf_counter() - t0
            return out
        setattr(dist_mod, name, timed)
        return fn

    originals = {n: wrap(n) for n in ("exchange", "all_reduce",
                                      "all_gather_cat")}
    stats["_restore"] = lambda: [setattr(dist_mod, n, f)
                                 for n, f in originals.items()]
    return stats


def rank_profile_main(yaml_path: str) -> int:
    """``chip_smoke.py --rank-profile Y``: one rank of a run under
    ``torch.distributed.run`` (``ranks_profile``): the port's CLI on ``Y``
    (``--parts PARTS --dist-backend gloo``), then one warm solve's profile
    (:func:`solve_profile`: device operations, busy time, idle share by
    kernel class) and one more warm solve with the collectives timed
    (:func:`timed_collectives`), printed as one ``rank-profile`` JSON
    line."""
    import torch
    sys.path.insert(0, REPO)
    from tpusolve_torch import dist
    from tpusolve_torch.harness import cli
    keep = []
    rc = cli.main([yaml_path, "--parts", str(PARTS), "--dist-backend",
                   "gloo"], keep=keep)
    if rc != 0:
        return rc
    system, r = keep[0], dist.rank()
    prof = solve_profile(system, f"rank {r}")
    stats = timed_collectives(dist)
    t0 = time.perf_counter()
    system._solver(system.rhs[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats.pop("_restore")()
    coll = {k: dict(calls=n, ms=1e3 * t) for k, (n, t) in stats.items()}
    print("rank-profile " + json.dumps(dict(
        rank=r, profile=prof, collectives=coll, timed_wall_ms=1e3 * wall)),
        flush=True)
    dist.destroy()
    return 0


def ranks_profile(yaml_path: str, what: str, card: str) -> list:
    """One warm solve of ``yaml_path`` profiled in each of ``RANKS`` ranks
    (:func:`rank_profile_main`, launched as the CLI is in
    :func:`ranks_launch`): each rank's device operations, busy time and
    idle share, and the halo exchange's and the reductions' host time
    against the warm solve's wall."""
    import glob
    logdir = os.path.join(FIXTURES, "ranks_profile")
    shutil.rmtree(logdir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS), "--log-dir", logdir,
           "--redirects", "3", os.path.abspath(__file__), "--rank-profile",
           yaml_path]
    proc = run_group(cmd, 600)
    out = []
    for r in range(RANKS):
        found = glob.glob(os.path.join(logdir, "**", "attempt_*", str(r),
                                       "stdout.log"), recursive=True)
        text = open(found[0]).read() if found else ""
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("rank-profile ")), None)
        if proc.returncode != 0 or line is None:
            fail(f"{what} profile: exit {proc.returncode}\n"
                 f"{(proc.stdout + proc.stderr)[-3000:]}\n{text[-2000:]}")
        d = json.loads(line.split(" ", 1)[1])
        p, c = d["profile"], d["collectives"]
        ex, red = c["exchange"], c["all_reduce"]
        print(f"{what} rank {r} warm solve: {p['iters']} iterations, wall "
              f"{p['wall_ms']:.3f} ms; {p['device_ops']} device operations, "
              f"busy {p['busy_ms']:.3f} ms, idle share "
              f"{p['idle_share']:.3f}; by class, ms (operations): "
              + ", ".join(f"{k} {v:.3f} ({p['ops_by_class'][k]})"
                          for k, v in p["by_class_ms"].items())
              + f"; in a solve with each collective timed between two "
              f"synchronisations (wall {d['timed_wall_ms']:.3f} ms): the "
              f"halo exchange {ex['calls']} calls {ex['ms']:.3f} ms "
              f"({ex['ms'] / d['timed_wall_ms']:.3f} of it), all_reduce "
              f"{red['calls']} calls {red['ms']:.3f} ms "
              f"({red['ms'] / d['timed_wall_ms']:.3f}), all_gather "
              f"{c['all_gather_cat']['calls']} calls "
              f"{c['all_gather_cat']['ms']:.3f} ms; {card}", flush=True)
        out.append(d)
    return out


def ranks_profile_main(card: str, build) -> int:
    """``python3 chip_smoke.py --ranks-profile``: the kernels built, (q)'s
    fixture written, and (q)'s warm solve profiled in each rank
    (:func:`ranks_profile`) alone, apart from the smoke's run (which it
    would take past its time); ends with the contract's last line."""
    import torch
    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    q_yaml = fixture_yaml(3, RANKS_SIDES["gate3"], "gate3_ranks.yaml",
                          solver_settings={"matrix_ordering": "none"})
    prof = ranks_profile(q_yaml, f"gate-3 {RANKS_SIDES['gate3']}^3 {RANKS} "
                         "ranks", card)
    shutil.rmtree(FIXTURES, ignore_errors=True)
    print(json.dumps(no_nan({"ranks_profile": prof})), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def nccl_phase(yaml_path: str) -> dict:
    """(q) with ``nccl``, one card a rank, where the machine has
    ``RANKS`` cards; otherwise says that NCCL was not run."""
    import torch
    cards = torch.cuda.device_count()
    if cards < RANKS:
        print(f"NCCL not run: {cards} card(s), the nccl backend needs one a "
              f"rank ({RANKS}); the ranks above shared the card through gloo",
              flush=True)
        return dict(run=False, cards=cards)
    rc, wall, outs, launcher = ranks_launch(
        yaml_path, "nccl", os.path.join(FIXTURES, "ranks_nccl"))
    if rc != 0:
        fail(f"gate 3 on {RANKS} ranks over nccl: exit {rc}\n"
             f"{launcher[-3000:]}")
    lines = [rank_summary(out, r) for r, out in enumerate(outs)]
    print(f"gate-3 {RANKS} ranks over nccl: {[ln['iters'] for ln in lines]} "
          f"iterations, {wall:.1f} s", flush=True)
    return dict(run=True, cards=cards, ranks=lines, wall_s=wall)


def parts_bits(M) -> tuple:
    """A multi-part ELL operator's stored arrays on the host, its offd
    block and halo plan too, to compare bit for bit."""
    return sparse_bits(M) + tuple(a.cpu() for a in (
        M.offd_vals, M.offd_cols, M.send_idx, M.ghost_slot))


def setup_levels(pre, what: str) -> None:
    """Print the hierarchy, each level's layout and setup stages."""
    for line in pre.describe().splitlines()[1:]:
        print(f"{what} hierarchy {line}", flush=True)
    for lvl, st in level_stages(pre).items():
        print(f"{what} setup stages, level {lvl} (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()), flush=True)
    print(f"{what} device setups (level, setup, parts): "
          f"{pre.device_setups}; host fetches {pre.host_fetches}",
          flush=True)


def setup_profile(fn, what: str) -> dict:
    """One more run of the setup ``fn``: its wall time (host clock,
    synchronised), then one under ``torch.profiler``: its device
    operations, their busy time and the idle share of the first wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, busy = 0, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops += 1
            busy += e.time_range.elapsed_us() / 1e3
    out = dict(wall_ms=wall, device_ops=ops, busy_ms=busy,
               idle_share=1.0 - busy / wall)
    print(f"{what} setup, run again: wall {wall:.1f} ms; profiled: {ops} "
          f"device operations, busy {busy:.1f} ms, idle share "
          f"{out['idle_share']:.3f}", flush=True)
    return out


def weakscale_parts_phase(side: int, card: str, counters) -> dict:
    """(o) The weak-scaling YAML as written, at side^3 a part on ``PARTS``
    parts: level 0 set up by the sharded lattice setup and level 1 by the
    N-part ELL setup (it fails otherwise, or without the notes), K1 and K2
    launched, golden check, the count within one of ``tpusolve``'s 8-part
    count; the generator on the card at this size against the CLI's
    planes, lattice and RHS bit for bit; the hierarchy, setup stages, timer
    rows, the setup's peak of allocated memory, and a second setup's
    device operations, busy time and idle share."""
    import numpy as np
    import torch
    from tpusolve_torch import fixtures, stencil
    from tpusolve_torch.amg.builder import (DIA_NOTE, RECURSION_NOTE,
                                            boomeramg_setup)
    what = f"weakscale {side}^3 {PARTS} parts"
    yaml_path = fixtures.write_weakscale(
        os.path.join(FIXTURES, f"weakscale_{side}_p{PARTS}"), side)
    with setup_peak() as peak:
        system, res, launches, timers = parts_run(what, yaml_path, counters,
                                                  tol=1e-6)
    pre = system._precond
    setup_levels(pre, what)
    if DIA_NOTE not in pre.notes or RECURSION_NOTE not in pre.notes:
        fail(f"{what}: notes {pre.notes} lack the device setup of level 0 "
             "or the device recursion")
    if pre.device_setups[:2] != [(0, "lattice", PARTS), (1, "ell", PARTS)]:
        fail(f"{what}: device setups {pre.device_setups}")
    check_ell_levels(pre, what)
    check_launched(pre, launches, what)
    if not launches["dia_spmv"] or not launches["ell_spmv"]:
        fail(f"{what}: K1 or K2 was not launched")
    # the generator on the card at this size: the CLI's rule generated on
    # the host below a 128 MB plane stack a part, as tpusolve's does
    rule = stencil.generates_on_device(side, side, side, np.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_d, b_d, _, lat_d = stencil.laplace27(
        side, side, side, device="cuda", dtype=np.float32, nparts=PARTS,
        on_device=True, with_lattice=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    same = (torch.equal(A_d.dia_vals, system.A.dia_vals)
            and torch.equal(lat_d["stack"], system._lattice["stack"])
            and torch.equal(b_d, system.rhs[0]))
    print(f"{what}: the CLI generated on the "
          f"{'card' if rule else 'host'} (tpusolve's rule); generated on "
          f"the card in {gen_s:.3f} s: box planes, lattice and RHS equal "
          f"to the CLI's bit for bit: {same}", flush=True)
    if not same:
        fail(f"{what}: the card's generator differs from the host's")
    del A_d, b_d, lat_d
    prof = setup_profile(lambda: boomeramg_setup(
        system._A_solve, system.config.boomeramg,
        lattice_parts=system._lattice), what)
    out = parts_count(what, f"weakscale_{side}", res, 1)
    print(f"{what}: Build 27Pt Stencil "
          f"{timers['Build 27Pt Stencil HYPRE matrix']:.3f} s, "
          f"Preconditioner setup {timers['Preconditioner setup']:.3f} s, "
          f"peak allocated during setup {peak.peak_gb:.2f} GB ({card})",
          flush=True)
    out.update(levels=[lev.n for lev in pre.levels], layouts=pre.layouts(),
               stages=level_stages(pre), timers=timers,
               setup_peak_gb=peak.peak_gb, setup_profile=prof,
               generated_on_card_s=gen_s, launches=launches, card=card)
    system.destroy_system()
    return out


def gate3_parts96_phase(card: str, counters) -> dict:
    """(p) Gate 3 at 96^3 on ``PARTS`` parts (double, extended+i): level 0
    set up by the N-part ELL setup, every level's A, P and R launched its
    kernel, exactly ``tpusolve``'s 8-part count; the layouts, launches,
    setup stages and the setup's peak of allocated memory printed."""
    what = f"gate-3 96^3 {PARTS} parts"
    with setup_peak() as peak:
        system, res, launches, timers = parts_run(
            what, fixture_yaml(3, 96, "gate3_parts96.yaml"), counters)
    pre = system._precond
    setup_levels(pre, what)
    if not pre.device_setups or pre.device_setups[0] != (0, "ell", PARTS):
        fail(f"{what}: device setups {pre.device_setups}")
    check_ell_levels(pre, what)
    check_launched(pre, launches, what)
    out = parts_count(what, "gate3_96", res, 0)
    print(f"{what}: Preconditioner setup "
          f"{timers['Preconditioner setup']:.3f} s, peak allocated during "
          f"setup {peak.peak_gb:.2f} GB ({card})", flush=True)
    out.update(levels=[lev.n for lev in pre.levels], layouts=pre.layouts(),
               stages=level_stages(pre), timers=timers,
               setup_peak_gb=peak.peak_gb, launches=launches, card=card)
    system.destroy_system()
    return out


def parts_bits_check() -> dict:
    """The bit check: the weak-scaling YAML's settings at 16^3 a part on
    ``PARTS`` parts, every device floor at one row, set up on the CPU and
    twice on the card in this process: level 0's P and R (the sharded
    lattice setup) and level 1's A, and level 1's P and R (the N-part ELL
    setup) and level 2's A, every stored array (offd blocks and halo plans
    too) equal bit for bit."""
    import numpy as np
    import torch
    from tpusolve_torch import fixtures
    from tpusolve_torch.amg.builder import boomeramg_setup
    from tpusolve_torch.config import load_config
    from tpusolve_torch.stencil import laplace27
    cfg = load_config(fixtures.write_weakscale(
        os.path.join(FIXTURES, "weakscale_bits"), 16)).boomeramg

    def setup(device):
        A, _, _, lat = laplace27(16, 16, 16, device=device, dtype=np.float32,
                                 nparts=PARTS, with_lattice=True)
        pre = boomeramg_setup(A, cfg, lattice_parts=lat, device_min_n=1)
        if [k for _, k, _ in pre.device_setups[:2]] != ["lattice", "ell"]:
            fail(f"bit check: device setups {pre.device_setups}")
        lv = pre.levels
        ops = {"level 0 P": lv[0].P, "level 0 R": lv[0].R,
               "level 1 A": lv[1].A, "level 1 P": lv[1].P,
               "level 1 R": lv[1].R, "level 2 A": lv[2].A}
        return {k: parts_bits(M) for k, M in ops.items()}

    cpu = setup(torch.device("cpu"))
    runs = [setup(torch.device("cuda")) for _ in range(2)]
    out = {k: [same_bits(r[k], cpu[k]) for r in runs] for k in cpu}
    out["second_run_equal"] = all(same_bits(runs[0][k], runs[1][k])
                                  for k in cpu)
    print(f"bit check, weak-scaling settings 16^3 x {PARTS} parts (float32): "
          "the card's setups against the CPU's, each run: "
          + ", ".join(f"{k} {v}" for k, v in out.items()), flush=True)
    if not all(all(v) for k, v in out.items() if k != "second_run_equal") \
            or not out["second_run_equal"]:
        fail("bit check: the card's setups differ from the CPU's")
    return out


def multipart_check(device) -> list:
    """K2 on a stacked offd block (an 8-part operator's, ``PARTS * row_pad``
    rows over ``PARTS * G`` ghosts) in both storage forms, for 1 and 3
    columns, in y = A g, b - A g and c + A g in place, against its plain
    version; then one ``PARTS``-part SpMV and residual on each layout (DIA,
    ELL padded and row-pointer, BDIA on K4 and on K5, BELL) against
    ``to_scipy() @ x``.  Returns each check's (name, rel err) rows."""
    from unittest import mock

    import numpy as np
    import torch
    from tpusolve_torch.kernels.ell import (ell_rowptr_plain, ell_spmv,
                                            ell_spmv_plain)
    from tpusolve_torch.matrix import sharded
    from tpusolve_torch.matrix.sharded import ShardedMatrix
    from tpusolve_torch.matrix.spmv import spmv, spmv_update
    from tpusolve_torch.matrix.vectors import to_device_vector
    from tpusolve_torch.stencil import laplace27

    rng = np.random.default_rng(44)
    rows = []

    def record(name, got, want, dt):
        err = rel_err(got, want)
        print(f"multipart {name} {dt}: rel err {err:.3e}", flush=True)
        if not err <= RTOL[dt]:
            fail(f"multipart {name} {dt}: rel err {err:.3e} > {RTOL[dt]}")
        rows.append(dict(op=name, dtype=dt, rel_err=err,
                         max_abs_err=float((got - want).abs().max())))

    n = 40_003
    r = np.repeat(np.arange(n), 9)
    c = np.clip(r + rng.integers(-3000, 3000, r.size), 0, n - 1)
    key = np.unique(np.concatenate([r * n + c, np.arange(n) * (n + 1)]))
    r, c = key // n, key % n
    v = rng.standard_normal(r.size)
    for dtype in (np.float32, np.float64):
        dt = np.dtype(dtype).name
        A = ShardedMatrix.from_coo((n, n), r, c, v, device=device,
                                   dtype=dtype, nparts=PARTS,
                                   allow_dia=False, allow_bdia=False,
                                   allow_bell=False)
        G = A.ghost_slot.shape[1]
        pv, pc, _ = sharded._flat_padded(A.offd_vals, A.offd_cols, G)
        rp, rv, rc = sharded.offd_rowptr(A.offd_vals, A.offd_cols, G)
        if rv.numel() >= pv.numel():
            fail("multipart: the offd block's row-pointer form keeps its "
                 "padding")
        for k in (1, 3):
            shape = (PARTS * G,) if k == 1 else (k, PARTS * G)
            g = torch.tensor(rng.standard_normal(shape), dtype=pv.dtype,
                             device=device)
            yshape = (pv.shape[0],) if k == 1 else (k, pv.shape[0])
            b = torch.tensor(rng.standard_normal(yshape), dtype=pv.dtype,
                             device=device)
            for form, args, plain in (
                    ("padded", (pv, pc), ell_spmv_plain),
                    ("rowptr", (rv, rc),
                     lambda vv, cc, *a, **kw: ell_rowptr_plain(
                         rp, vv, cc, *a, **kw))):
                kw = {} if form == "padded" else {"rowptr": rp}
                cols = [g] if k == 1 else list(g)
                bs = [b] if k == 1 else list(b)
                want = torch.stack([plain(*args, gj) for gj in cols])
                got = ell_spmv(*args, g, **kw).reshape(want.shape)
                record(f"offd K2 {form} k={k} A g", got, want, dt)
                want = torch.stack([plain(*args, gj, b=bj)
                                    for gj, bj in zip(cols, bs)])
                got = ell_spmv(*args, g, b=b, **kw).reshape(want.shape)
                record(f"offd K2 {form} k={k} b - A g", got, want, dt)
                y = b.clone()
                ell_spmv(*args, g, c=y, w=-1.0, out=y, **kw)
                want = torch.stack([plain(*args, gj, c=bj, w=-1.0)
                                    for gj, bj in zip(cols, bs)])
                record(f"offd K2 {form} k={k} c + A g in place",
                       y.reshape(want.shape), want, dt)

    def layout_check(name, M):
        S = M.to_scipy()
        dt = str(M.dtype).replace("torch.", "")
        x = rng.standard_normal(S.shape[1])
        b = rng.standard_normal(S.shape[0])
        vec = lambda a, off, pad: to_device_vector(a, off, pad, device,
                                                   dtype=np.dtype(dt))
        xd = vec(x, M.col_offsets, M.col_pad)
        bd = vec(b, M.row_offsets, M.row_pad)
        t = lambda a: torch.tensor(a, dtype=M.dtype, device=device)
        un = lambda y: torch.cat([
            y[p * M.row_pad:p * M.row_pad + M.row_offsets[p + 1]
              - M.row_offsets[p]] for p in range(M.nparts)])
        record(f"{name} {M.layout} SpMV", un(spmv(M, xd)), t(S @ x), dt)
        record(f"{name} residual", un(spmv_update(M, xd, b=bd)),
               t(b - S @ x), dt)

    dia = laplace27(32, 32, 32, device=device, nparts=PARTS)[0]
    layout_check("DIA", dia)
    for form in ("padded", "rowptr"):
        with mock.patch.object(sharded, "ell_form",
                               lambda *a, **kw: (form, 1.0)):
            E = ShardedMatrix.from_coo((n, n), r, c, v, device=device,
                                       nparts=PARTS, allow_dia=False,
                                       allow_bdia=False, allow_bell=False)
        layout_check(f"ELL {form}", E)
    nb = 80_000
    rr = np.arange(nb)
    br = np.concatenate([rr[max(0, -o):nb - max(0, o)]
                         for o in (-600, -599, -1, 0, 1, 599, 600)])
    bc = np.concatenate([rr[max(0, o):nb - max(0, -o)]
                         for o in (-600, -599, -1, 0, 1, 599, 600)])
    bv = rng.standard_normal(br.size)
    B = ShardedMatrix.from_coo((nb, nb), br, bc, bv, device=device,
                               nparts=PARTS, allow_dia=False,
                               allow_bell=False, allow_ell=False)
    if not B.uses_bdia:
        fail(f"multipart: the band took {B.layout}, not BDIA")
    layout_check("BDIA K4", B._with_xl(None))
    xl = sharded.plan_xl(B.bdia_starts.cpu().numpy(), B.bdia_block,
                         B.bdia_xpad, 8, B.bdia_nbytes, B.bdia_live,
                         B.xl_work())
    if xl is None:
        fail("multipart: no K5 step plan fits the 8-part band")
    layout_check("BDIA-XL K5", B._with_xl(xl[:5]))
    # BELL's tiles take a band dense within its 128-column windows
    nt = 16_000
    rr = np.arange(nt)
    offs = range(-32, 33)
    tr = np.concatenate([rr[max(0, -o):nt - max(0, o)] for o in offs])
    tc = np.concatenate([rr[max(0, o):nt - max(0, -o)] for o in offs])
    E = ShardedMatrix.from_coo((nt, nt), tr, tc,
                               rng.standard_normal(tr.size), device=device,
                               nparts=PARTS, allow_dia=False,
                               allow_bdia=False, allow_ell=False)
    if not E.uses_bell:
        fail(f"multipart: the band took {E.layout}, not BELL")
    layout_check("BELL", E)
    return rows


def form_entry(name: str, base: str, source: str, replaces: str, row: dict,
               launches: dict, rows: list, library) -> dict:
    """A kernels-line entry of a new form of kernel ``base``."""
    return dict(name=name, form_of=base, route="cuda", source=source,
                replaces=replaces, **launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_rel_err=max(r["max_rel_err"] for r in rows),
                ms=row["ms"], device_ms=row["dev_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by="bytes", library_ms=library, shape=row["op"],
                shapes=rows)


def main(argv) -> int:
    if argv[:1] == ["--rank-profile"]:
        return rank_profile_main(argv[1])
    t_start = time.perf_counter()
    sides = {"--side": 96, "--side3": 48, "--side-ilu": 64}
    profile_only = "--ranks-profile" in argv
    it = iter(a for a in argv if a != "--ranks-profile")
    for a in it:
        if a not in sides:
            print("usage: python3 chip_smoke.py [--side N] [--side3 N] "
                  "[--side-ilu N] | --ranks-profile", file=sys.stderr)
            return 1
        sides[a] = int(next(it, "0"))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tpusolve_torch")):
        print("chip_smoke: no tpusolve_torch package beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpusolve_torch.kernels import build

    card = card_line()
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(device)
    print(card, flush=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{device_name}", flush=True)
    import yaml
    print(f"PyYAML {yaml.__version__}", flush=True)

    # gate 4's fixture, the first a phase reads, is written during the
    # kernel build and checks; the others from the gate-4 phase on
    shutil.rmtree(FIXTURES, ignore_errors=True)
    if profile_only:
        return ranks_profile_main(card, build)
    start_fixture_writers([(4, sides["--side"])])
    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    from tpusolve_torch.kernels.bdia import bdia_spmv, bdia_spmv_xl
    from tpusolve_torch.kernels.bell import bell_spmv
    from tpusolve_torch.kernels.dia import dia_spmv
    from tpusolve_torch.kernels.ell import ell_spmv, pack_columns
    from tpusolve_torch.kernels.transfer import (
        box_prolong, box_prolong_update, box_restrict, box_restrict_residual)

    def phase_done(what):
        print(f"chip_smoke: {what} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # the ILU paths run at smaller depths than before phases (f) and (g)
    # came (the gate-4 fixture as written at 64^3, 48^3 since phases (o)
    # and (p) came; gate 3 with ILU smoothing at 32^3, the stencil with ILU
    # at 64^3 alone), so that the run keeps inside its time on a slow host
    ell_side, st5_side = 48, 32
    worst4, worst5 = banded_check(device)
    worst4 = max(worst4, k4_launch_check(device))
    worst6 = bell_check(device)
    worst2 = ell_check(device)

    worst1 = four_wide_check(device)
    dev_rows = device_setup_check(device)
    phase_done("the kernel checks")
    model_constants()
    phase_done("the models' constants")
    start_fixture_writers([("4c", COUPLED_SIDE)])
    start_fixture_writers(sorted({(4, ell_side), (4, 32), (3, 96),
                                  (3, GATE3_ELL_SIDE),
                                  (3, sides["--side3"]), (3, st5_side),
                                  (3, 32), (3, 64)} - set(WRITERS)))
    start_fixture_writers([("4p8", 96)])

    counters = (bdia_spmv, bdia_spmv_xl, bell_spmv, dia_spmv, box_prolong,
                box_restrict, box_restrict_residual, box_prolong_update,
                ell_spmv, pack_columns)
    (l4, rows4, k2_rows4, moved4, xl_forms4, prof4, trial4,
     col_rows) = gate4_phase(sides["--side"], device_name, counters)
    phase_done("gate 4")
    # (h) the coupled solve of gate 4's three components, and K2's and
    # K5's k-column forms on its operators (timed on gate 4's above)
    coupled = coupled_phase(COUPLED_SIDE, card, counters)
    coupled["columns"] = columns_check(coupled.pop("ops"), card, 15)
    phase_done("the coupled gate 4")
    # (i)-(k): the coupled solve in double on the ELL device ILU, and the
    # bfloat16 smoother twin on the weak-scaling cell and gate 1, early in
    # the process, where its traces keep their device events
    coupled64 = coupled_double_phase(64, counters)
    phase_done("the coupled gate 4 in double")
    wsb = weakscale_bf16_phase(128, counters)
    phase_done("the weak-scaling cell with the bf16 twin")
    g1b = gate1_bf16_phase(counters)
    phase_done("gate 1 with the bf16 twin")
    bf16_rows = bf16_check(wsb.pop("system")._precond,
                           g1b.pop("system")._precond, card, 16)
    phase_done("the bf16 kernel checks")
    g3 = gate3_phase(sides["--side3"], device_name, counters)
    l3, rows3, bdia_rows3 = g3["launches"], g3["k6_rows"], g3["k4_rows"]
    phase_done("gate 3")
    rs = gate3_rs_phase(GATE3_RS_SIDE, device_name, counters)
    phase_done("gate 3 RS")
    (l1, forms1, errs1, rows1, k3_rows1, fused_rows1, cycle1, prof1,
     cold1) = gate1_phase(device_name, counters)
    (l2, forms2, errs2, rows2, k3_rows2, fused_rows2, cycle2,
     prof2) = gate2_phase(device_name, counters)
    phase_done("gates 1 and 2")
    ws = weakscale_phase(device_name, counters)
    phase_done("the weak-scaling cell")
    ws256 = weakscale_large_phase(256, card, counters)
    print(f"weakscale 256^3: port {ws256['iters']} PCG iterations, "
          f"tpusolve (CPU, same YAML) {TPUSOLVE_WEAKSCALE_ITERS_256}",
          flush=True)
    if abs(ws256["iters"] - TPUSOLVE_WEAKSCALE_ITERS_256) > 1:
        fail(f"weakscale 256^3 took {ws256['iters']} PCG iterations, not "
             f"within one of tpusolve's {TPUSOLVE_WEAKSCALE_ITERS_256}")
    phase_done("the weak-scaling cell at 256^3")
    g3_ell = gate3_ell_phase(GATE3_ELL_SIDE, card, counters)
    phase_done(f"gate 3 at {GATE3_ELL_SIDE}^3 (generic-ELL setup)")
    # the ILU paths and the lifecycle's steps time no kernel by a trace
    # (calibrate.device_ms_each), which a long process can lose; their
    # factorization profiles count every device event of a trace
    st_ilu = stencil_ilu_phase(sides["--side-ilu"], card, counters)
    phase_done("the stencil ILU path")
    g4_ell = gate4_ell_phase(ell_side, card, counters)
    phase_done("the gate-4 ELL ILU path")
    ilu_opts = ilu_options_phase(32, counters)
    phase_done("the host ILU options")
    st5 = gate3_ilu_smoother_phase(st5_side, counters)
    phase_done("gate 3 with ILU smoothing")
    life = lifecycle_phase(32, device, counters)
    phase_done("the lifecycle's steps")
    # (m), (l), (n): the multi-part operators, PARTS parts on the card, last
    # (run earlier, they moved the lost traces into gates 1 and 2, where a
    # lost trace costs some 11 s: 1,066 s against 947); the device times
    # their traces lose come from one fresh process (fresh_offd_ms)
    g4p = gate4_parts_phase(card, counters)
    phase_done(f"gate 4 on {PARTS} parts")
    g1p = gate1_parts_phase(card, counters)
    phase_done(f"gate 1 on {PARTS} parts")
    g3p = gate3_parts_phase(card, counters)
    phase_done(f"gate 3 on {PARTS} parts")
    # (o), (p): the multi-part device AMG setups, and their bits
    wsp = weakscale_parts_phase(WEAKSCALE_PARTS_SIDE, card, counters)
    phase_done(f"the weak-scaling YAML on {PARTS} parts")
    g3p96 = gate3_parts96_phase(card, counters)
    phase_done(f"gate 3 at 96^3 on {PARTS} parts")
    bits = parts_bits_check()
    phase_done("the multi-part setups' bit check")
    fresh_offd_ms(g4p["offd_rows"] + g1p["offd_rows"] + g3p["offd_rows"])
    mp_rows = multipart_check(device)
    phase_done("the multi-part checks")
    # (q), (r): the file-loaded gates as RANKS processes sharing the card
    # through gloo, each holding PARTS / RANKS parts
    q_yaml = fixture_yaml(3, RANKS_SIDES["gate3"], "gate3_ranks.yaml",
                          solver_settings={"matrix_ordering": "none"})
    g3r = ranks_phase("gate3", q_yaml, card, 0)
    phase_done(f"gate 3 on {RANKS} ranks")
    g4r = ranks_phase("gate4", fixture_yaml(
        "4p8", RANKS_SIDES["gate4"], "gate4_ranks.yaml",
        solver_settings={"matrix_ordering": "none"}), card, "passes")
    phase_done(f"gate 4 on {RANKS} ranks")
    nccl = nccl_phase(q_yaml)
    shutil.rmtree(FIXTURES, ignore_errors=True)

    paths = {"gate4": l4, "stencil_ilu": st_ilu["launches"],
             "gate4_ell": g4_ell["launches"],
             "ilu_options": ilu_opts["launches"], "gate3": l3,
             "gate3_ilu_smoother": st5["launches"],
             "gate3_rs": rs["launches"], "lifecycle": life["launches"],
             "gate1": l1, "gate2": l2, "weakscale": ws["launches"],
             "weakscale_256": ws256["launches"],
             "gate3_ell": g3_ell["launches"],
             "coupled": coupled["launches"],
             "coupled_double": coupled64["launches"],
             "weakscale_bf16": wsb["launches"], "gate1_bf16": g1b["launches"],
             "gate4_parts": g4p["launches"], "gate1_parts": g1p["launches"],
             "gate3_parts": g3p["launches"],
             "weakscale_parts": wsp["launches"],
             "gate3_96_parts": g3p96["launches"],
             "gate3_ranks": g3r["launches"], "gate4_ranks": g4r["launches"]}
    rows1_all = rows1 + rows2 + ws["k1_rows"]
    rows4_all = rows4 + bdia_rows3 + ws["k4_rows"]
    rows6_all = rows3 + ws["k6_rows"]
    rows2_all = k2_rows4 + g3["k2_rows"] + ws["k2_rows"]

    def launches(name):
        return dict(launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()})

    moved_all = moved4 + g3["moved_rows"] + rs["moved_rows"] \
        + ws["moved_rows"]
    # headline shapes: K4 and K5 on gate 4's L, K6 on the BELL layout of
    # largest bound
    k4 = k5 = next(r for r in rows4 if r["op"] == "L")
    if not rows6_all:
        fail("no BELL layout to time K6 on")
    k6 = max(rows6_all, key=lambda r: r["bound_ms"])
    k1 = rows1[0]            # gate 1 level 0, the f32 stencil
    # K2's headline: the weak-scaling ELL operator with the largest bound
    k2 = max(ws["k2_rows"], key=lambda r: r["bound_ms"])
    kernels = [
        dict(name="dia_spmv", route="cuda",
             source="tpusolve_torch/csrc/dia_spmv.cu",
             replaces="tpusolve/matrix/spmv.py:79", **launches("dia_spmv"),
             max_abs_err=max([errs1[1], errs2[1], ws["k1_errs"][1],
                              st_ilu["k1_errs"][1]]
                             + [r["max_abs_err"] for r in rows1_all]),
             ms=k1["k1_ms"], device_ms=k1["k1_dev_ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by="bytes", library_ms=k1["lib_ms"],
             library_device_ms=k1["lib_dev_ms"], shape=k1["op"],
             max_rel_err=max([worst1, errs1[0], errs2[0], ws["k1_errs"][0],
                              st_ilu["k1_errs"][0]]
                             + [r["rel_err"] for r in rows1_all]),
             launches_by_form={"gate1": forms1, "gate2": forms2,
                               "stencil_ilu": st_ilu["k1_by_form"]},
             shapes=rows1_all, cold_warm=cold1, gate1_profile=prof1,
             gate2_profile=prof2, weakscale_profile=ws["profile"]),
        fused_entry("box_restrict_residual", "restrict",
                    fused_rows1 + fused_rows2,
                    launches("box_restrict_residual"),
                    {"gate1": cycle1, "gate2": cycle2}),
        fused_entry("box_prolong_update", "prolong",
                    fused_rows1 + fused_rows2,
                    launches("box_prolong_update"),
                    {"gate1": cycle1, "gate2": cycle2}),
        k3_entry("box_prolong", "prolong", 122, k3_rows1 + k3_rows2,
                 launches("box_prolong")),
        k3_entry("box_restrict", "restrict", 129, k3_rows1 + k3_rows2,
                 launches("box_restrict")),
        dict(name="bdia_spmv", route="cuda",
             source="tpusolve_torch/csrc/bdia_spmv.cu",
             replaces="tpusolve/kernels/bdia.py:252", **launches("bdia_spmv"),
             max_abs_err=max(r["max_abs_err"] for r in rows4_all),
             ms=k4["k4_ms"], device_ms=k4["k4_dev_ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             plain_device_ms=k4["plain_dev_ms"],
             bound_by="bytes", library_ms=k4["lib_ms"],
             library_device_ms=k4["lib_dev_ms"], shape=k4["op"],
             held_by="banded_check, k4_launch_check, bdia_timings, and "
                     "moved_timings as the factors' old kernel",
             max_rel_err=max([worst4] + [r["rel_err"] for r in rows4_all]),
             shapes=rows4_all),
        dict(name="bdia_spmv_xl", route="cuda",
             source="tpusolve_torch/csrc/bdia_spmv_xl.cu",
             replaces="tpusolve/kernels/bdia.py:336",
             **launches("bdia_spmv_xl"),
             max_abs_err=max(r["xl_max_abs_err"] for r in rows4_all
                             if "xl_max_abs_err" in r),
             ms=k5["k5_ms"], device_ms=k5["k5_dev_ms"],
             plain_ms=k5["xl_plain_ms"],
             plain_device_ms=k5["xl_plain_dev_ms"],
             bound_ms=k5["bound_ms"],
             bound_by="bytes", library_ms=k5["lib_ms"],
             library_device_ms=k5["lib_dev_ms"], shape=k5["op"],
             k4_device_ms=k5["k4_dev_ms"], stored_mb=k5["layout_mb"],
             read_mb=k5["xl_read_mb"], skipped_share=k5["skipped_share"],
             launches_by_form=xl_forms4,
             max_rel_err=max([worst5] + [r["xl_rel_err"] for r in rows4_all
                                         if "xl_rel_err" in r]),
             update_forms_equal=[r["update_forms_equal"] for r in rows4_all
                                 if "update_forms_equal" in r],
             moved=[r for r in moved4 if r["new_kernel"] == "K5"],
             gate4_profile=prof4),
        dict(name="bell_spmv", route="cuda",
             source="tpusolve_torch/csrc/bell_spmv.cu",
             replaces="tpusolve/kernels/bell.py:159", **launches("bell_spmv"),
             max_abs_err=max(r["max_abs_err"] for r in rows6_all),
             ms=k6["k6_ms"], device_ms=k6["k6_dev_ms"],
             plain_ms=k6["plain_ms"], plain_device_ms=k6["plain_dev_ms"],
             bound_ms=k6["bound_ms"], bound_by="bytes",
             library_ms=k6["lib_ms"], library_device_ms=k6["lib_dev_ms"],
             shape=k6["op"], held_by="bell_check, tile_timings",
             max_rel_err=max([worst6] + [r["rel_err"] for r in rows6_all]),
             shapes=rows6_all),
        dict(name="ell_spmv", route="cuda",
             source="tpusolve_torch/csrc/ell_spmv.cuh",
             replaces="tpusolve/matrix/spmv.py:74", **launches("ell_spmv"),
             max_abs_err=max([worst2[1], g4_ell["k2_errs"][1]]
                             + [r["max_abs_err"] for r in rows2_all]),
             ms=k2["k2_ms"], device_ms=k2["k2_dev_ms"],
             device_ms_from=k2.get("k2_dev_ms_from", "this process"),
             plain_ms=k2["plain_ms"], plain_device_ms=k2["plain_dev_ms"],
             bound_ms=k2["bound_ms"], bound_by="bytes",
             library_ms=k2["lib_ms"], library_device_ms=k2["lib_dev_ms"],
             shape=k2["op"],
             max_rel_err=max([worst2[0], g4_ell["k2_errs"][0]]
                             + [r["rel_err"] for r in rows2_all]),
             form=k2["form"],
             forms={f: sum(r["form"] == f for r in rows2_all)
                    for f in ("padded", "rowptr")},
             launches_by_layout={k: {f: p[f"ell_spmv {f}"]
                                     for f in ("padded", "rowptr")}
                                 for k, p in paths.items()},
             launches_by_form_warm_solve={
                 "gate3": g3["profile"]["k2_launches_by_form"],
                 "weakscale": ws["profile"]["k2_launches_by_form"]},
             shapes=rows2_all, moved_operators=moved_all,
             gate3_profile=g3["profile"],
             weakscale_profile=ws["profile"])]
    cols = lambda by: sum(n for k, n in by.items() if k > 1)
    kcol = dict(coupled=cols(coupled["k2_by_cols"]),
                coupled_double=cols(coupled64["k2_by_cols"]))
    kernels += [
        form_entry("ell_spmv k-column", "ell_spmv",
                   "tpusolve_torch/csrc/ell_spmv.cuh",
                   "tpusolve/matrix/spmv.py:74",
                   next(r for r in col_rows if r["op"] == "A"),
                   dict(launches=sum(kcol.values()), launches_by_path=kcol,
                        launches_by_cols={
                            "coupled": coupled["k2_by_cols"],
                            "coupled_double": coupled64["k2_by_cols"]}),
                   [r for r in col_rows if r["kernel"].startswith("K2")],
                   next(r for r in col_rows if r["op"] == "A")["lib_ms"]),
        form_entry("bdia_spmv_xl k-column", "bdia_spmv_xl",
                   "tpusolve_torch/csrc/bdia_spmv_xl.cu",
                   "tpusolve/kernels/bdia.py:336",
                   next(r for r in col_rows if r["op"] == "L"),
                   dict(launches=cols(coupled["k5_by_cols"]),
                        launches_by_path={
                            "coupled": cols(coupled["k5_by_cols"])},
                        launches_by_cols={"coupled": coupled["k5_by_cols"]}),
                   [r for r in col_rows if r["kernel"] == "K5"],
                   next(r for r in col_rows if r["op"] == "L")["lib_ms"]),
        form_entry("dia_spmv bf16", "dia_spmv",
                   "tpusolve_torch/csrc/dia_spmv.cu",
                   "tpusolve/matrix/spmv.py:79", bf16_rows[0],
                   dict(launches=wsb["k1_bf16"] + g1b["k1_bf16"],
                        launches_by_path={"weakscale_bf16": wsb["k1_bf16"],
                                          "gate1_bf16": g1b["k1_bf16"]}),
                   [bf16_rows[0]], None),
        form_entry("ell_spmv bf16", "ell_spmv",
                   "tpusolve_torch/csrc/ell_spmv.cuh",
                   "tpusolve/matrix/spmv.py:74", bf16_rows[1],
                   dict(launches=wsb["k2_bf16"],
                        launches_by_path={"weakscale_bf16": wsb["k2_bf16"]}),
                   [bf16_rows[1]], None),
        form_entry("box_prolong_update bf16", "box_prolong_update",
                   "tpusolve_torch/csrc/box_cycle.cu",
                   "tpusolve/amg/structured.py:122 with "
                   "tpusolve/matrix/spmv.py:79", bf16_rows[2],
                   dict(launches=g1b["prolong_bf16"],
                        launches_by_path={"gate1_bf16": g1b["prolong_bf16"]}),
                   [bf16_rows[2]], None)]
    packs = {k: p.get("pack_columns", 0) for k, p in paths.items()
             if p.get("pack_columns")}
    if not packs.get("coupled") or not packs.get("coupled_double"):
        fail(f"K2's k-column form packed no x on the coupled paths ({packs})")
    pack_rows = [r for r in col_rows if "pack_ms" in r]
    prow = next(r for r in pack_rows if r["op"] == "A_lo")
    kernels.append(dict(
        name="ell_pack", form_of="ell_spmv", route="cuda",
        source="tpusolve_torch/csrc/ell_spmv.cuh",
        replaces="tpusolve/matrix/spmv.py:74 (the x gather of "
                 "ell_spmv_local, batched by tpusolve/harness/system.py:476)",
        launches=sum(packs.values()), launches_by_path=packs,
        max_abs_err=0.0, max_rel_err=0.0, ms=prow["pack_ms"],
        device_ms=prow["pack_dev_ms"], plain_ms=prow["pack_plain_ms"],
        bound_ms=prow["pack_bound_ms"], bound_by="bytes",
        # torch's transpose copy computes the same function (it is the
        # plain version too)
        library_ms=prow["pack_plain_ms"],
        shape=prow["op"], shapes=[{k: r[k] for k in (
            "op", "pack_dev_ms", "pack_ms", "pack_plain_ms", "pack_bound_ms",
            "pack_equal")} for r in pack_rows]))
    offd_rows = g4p["offd_rows"] + g1p["offd_rows"] + g3p["offd_rows"]
    offd = {k: p["ell_spmv offd"] for k, p in paths.items()
            if p.get("ell_spmv offd")}
    kernels.append(form_entry(
        "ell_spmv offd", "ell_spmv", "tpusolve_torch/csrc/ell_spmv.cuh",
        "tpusolve/matrix/spmv.py:133", offd_rows[0],
        dict(launches=sum(offd.values()), launches_by_path=offd),
        offd_rows + [dict(r, max_rel_err=r["rel_err"]) for r in mp_rows
                     if r["op"].startswith("offd")], offd_rows[0]["lib_ms"]))
    ghost = {k: p["ell_spmv ghost prolong"] for k, p in paths.items()
             if p.get("ell_spmv ghost prolong")}
    kernels[-1].update(ghost_prolong_launches=sum(ghost.values()),
                       ghost_prolong_launches_by_path=ghost,
                       library_device_ms=offd_rows[0]["lib_dev_ms"],
                       halo_gather_ms=offd_rows[0]["gather_ms"],
                       halo_gather_device_ms=offd_rows[0]["gather_dev_ms"],
                       halo_gather_bound_ms=offd_rows[0]["gather_bound_ms"])
    print(json.dumps(no_nan({"coupled": coupled, "coupled_double": coupled64,
                             "weakscale_bf16": wsb, "gate1_bf16": g1b}),
                     default=str), flush=True)
    print(json.dumps(no_nan({"weakscale": {
        k: ws[k] for k in ("iters", "relres", "stages", "timers", "layouts",
                           "launches")}, "gate3": {
        k: g3[k] for k in ("iters", "timers", "launches")}, "gate3_rs": rs,
        "device_setup_32": dev_rows, "weakscale_256": ws256,
        "gate3_ell": g3_ell,
        "gate3_ell_against_host": g3["ell_against_host"],
        "multipart": {"gate4": g4p, "gate1": g1p, "gate3": g3p,
                      "weakscale": wsp, "gate3_96": g3p96,
                      "setup_bits": bits, "checks": mp_rows},
        "ranks": {"gate3": g3r, "gate4": g4r, "nccl": nccl}, "ilu": {
            "stencil": st_ilu, "gate4_ell": g4_ell,
            "gate4_rcm_ell_trial": trial4, "options": ilu_opts,
            "gate3_ilu_smoother": st5, "lifecycle": life}})), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(no_nan({"kernels": kernels})), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
