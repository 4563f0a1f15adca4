"""ILU(k) preconditioner: Chow-Patel factors, on the device for ILU(0) of a
DIA or ELL operator, Jacobi triangular solves."""
