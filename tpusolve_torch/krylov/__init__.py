"""Krylov solvers (BiCGSTAB, the GMRES family) and mixed-precision
iterative refinement."""
