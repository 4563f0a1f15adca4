"""Krylov solvers (BiCGSTAB) and mixed-precision iterative refinement."""
