"""Sparse matrices: ShardedMatrix layouts, assembly and SpMV."""
