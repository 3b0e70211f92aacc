"""Measurement tools for the port's kernels; they run on a CUDA card only."""
