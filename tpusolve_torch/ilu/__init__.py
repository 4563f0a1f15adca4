"""ILU(0) preconditioner: host Chow-Patel factors, Jacobi triangular solves."""
