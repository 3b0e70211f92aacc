"""Profiling harness of the exact top-k kernels: layout work, kernel, full call.

Counterpart of ``scripts/profile_pallas_topk.py``, whose ``kernel_only``
runs kernel B's body (``_kernel_roll``) on pre-tiled input to time it apart
from the layout work and from the full ``pallas_topk_desc`` call.  On the
card :func:`~pyloo_tpu_torch.ops.topk.topk_desc` does no layout work (rows
are read in place, with their stride), so the first part is what the wrapper
does on the host before each launch: its checks, the launch arguments and
the output allocation.  The harness has no kernel of its own: it launches
kernel B's (``"roll"``), C's (``"reshape"``) or D's (``"natural"``) CUDA
kernel, and counts its own launches in ``profile_topk_desc.launches``.

It runs on the card only::

    from pyloo_tpu_torch.ops.topk_profile import profile_topk_desc
    print(profile_topk_desc(125_000, 4_000, 191, variant="roll"))
"""

from __future__ import annotations

import torch

from .._common import compute_device
from . import topk

__all__ = ["profile_topk_desc"]


def _median_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def profile_topk_desc(
    b: int = 125_000,
    s: int = 4_000,
    k: int = 191,
    variant: str = "roll",
    runs: int = 7,
    seed: int = 0,
) -> dict:
    """Median times (ms, CUDA events) of the three parts of a top-k call.

    The input is ``1.5 * N(0, 1)`` of shape ``(b, s)`` float32, made on the
    card from ``seed`` (the shape and scale of the TPU script).  Returns

    * ``prep_ms`` — (a) the wrapper's work before the launch on that input:
      host-side only, so the events measure how long the host takes to get
      there, not device work;
    * ``kernel_ms`` — (b) the kernel alone, launched on the prepared,
      contiguous input and output;
    * ``full_ms`` — (c) the full ``topk_desc(x, k, variant)`` call;
    * ``max_abs_err`` — of the kernel-only output against ``torch.topk``.

    Runs on ``rcParams["device.device"]``, and raises unless that is a CUDA
    device: there is no kernel to profile elsewhere.
    """
    device = compute_device()
    if device.type != "cuda":
        raise ValueError(f"profile_topk_desc times CUDA kernels; got device {device}")
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 1.5 * torch.randn(b, s, device=device, generator=gen)

    def prep():
        topk._check(x, k)
        topk._check_variant(variant, k)
        return topk._topk_prepare(x, k)

    prepared = prep()

    def kernel_only():
        topk._topk_launch(variant, x, k, prepared)
        profile_topk_desc.launches += 1

    out = {
        "prep_ms": _median_ms(prep, runs),
        "kernel_ms": _median_ms(kernel_only, runs),
        "full_ms": _median_ms(lambda: topk.topk_desc(x, k, variant), runs),
    }
    want = torch.topk(x, k, dim=1, sorted=True).values
    out["max_abs_err"] = float((prepared[3] - want).abs().max())
    return out


profile_topk_desc.launches = 0
