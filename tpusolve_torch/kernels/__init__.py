"""Hand-written Hopper kernels (``csrc/*.cu``), their builder and their plain
PyTorch versions."""
