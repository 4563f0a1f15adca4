"""Krylov solvers (PCG, BiCGSTAB, the GMRES family) and mixed-precision
iterative refinement."""
