"""BoomerAMG-equivalent algebraic multigrid (the port of ``tpusolve/amg``)."""
