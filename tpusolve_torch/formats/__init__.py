"""File formats: HYPRE-IJ multi-file text (``ij``)."""
