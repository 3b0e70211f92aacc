"""Measurement and verification tools for the port's kernels and entry points.

The measurement tools (``prepass_stages``, ``bitonic_stages``,
``group_sums_probe``, ``mm_drift_probe``) run on a CUDA card only; the
verification tools (``validate_kernels``, ``fuzz_differential``) run on the
card, or on the CPU when asked with ``--device cpu``.
"""
