"""Benchmark of pyloo_tpu_torch on one NVIDIA GPU (``bench_torch/bench.py``).

It imports torch, numpy and pyloo_tpu_torch, and nothing of JAX, pandas or
pyloo_tpu.
"""
