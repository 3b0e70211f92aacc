"""Exact top-k row selection and the float32 scorer's route.

Counterpart of ``pyloo_tpu/ops/selection.py``.  On the TPU, selection was
the XLA ``approx_max_k`` cascade with a Pallas kernel for float32 batches of
at least 128 rows (``_PALLAS_MIN_ROWS``), a gate that only existed because
one Pallas grid step padded to the TPU's 128 lanes.  On the card the kernel
runs one block per row, so the CUDA route has no row minimum.

Left out on purpose:

* ``topk_hybrid_f64`` — float64 selection through a float32 proxy, a
  workaround for the TPU's emulated float64 that measured as a loss there;
  the H100 has native float64 and ``torch.topk`` takes it directly;
* ``topk_with_idx`` — index-returning selection, used only by
  ``psislw_batch``'s scatter, which waits for a later slice.
"""

from __future__ import annotations

import torch

from .topk import multipass_parts, supports, topk_desc

__all__ = ["topk_vals_desc", "fast_path_route"]


def fast_path_route(s: int, k: int, dtype, device) -> str:
    """Which prepass ``loo_scores_psis_fast`` takes for rows of S draws and k.

    * ``"cuda"`` — kernel A in one pass (CUDA tensor, float32,
      ``supports(S, k)``);
    * ``"cuda-multipass"`` — the draw axis split into <= 16 parts, kernel A
      on each and an exact merge in torch (S beyond one pass's cap);
    * ``"torch"`` — plain PyTorch selection and reductions (float64, a
      tensor on the CPU, or k > 1024).

    The batch size does not enter the choice (the JAX package's row gate does
    not apply, see the module docstring).
    """
    if dtype != torch.float32 or torch.device(device).type != "cuda":
        return "torch"
    if supports(s, k):
        return "cuda"
    parts = multipass_parts(s, k)
    if parts is not None and parts > 1:
        return "cuda-multipass"
    return "torch"


def topk_vals_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k values of each row of ``x``, descending.  (B, S) -> (B, k).

    Float32 rows within one pass's cap go to kernel B (which, for a tensor on
    the CPU, is its plain version ``torch.topk``); everything else, float64
    included, to ``torch.topk(sorted=True)``.
    """
    if x.dtype == torch.float32 and supports(x.shape[1], k):
        return topk_desc(x, k)
    return torch.topk(x, k, dim=-1, sorted=True).values
