"""Exact top-k row selection and the float32 scorer's route.

Counterpart of ``pyloo_tpu/ops/selection.py``.  On the TPU, selection was
the XLA ``approx_max_k`` cascade with a Pallas kernel for float32 batches of
at least 128 rows (``_PALLAS_MIN_ROWS``), a gate that only existed because
one Pallas grid step padded to the TPU's 128 lanes.  On the card the kernel
runs one block per row, so the CUDA route has no row minimum.

Left out on purpose: ``topk_hybrid_f64``, float64 selection through a
float32 proxy, a workaround for the TPU's emulated float64 that measured as
a loss there; the H100 has native float64 and ``torch.topk`` takes it
directly.  The segmented ``approx_max_k`` cascade of ``topk_with_idx`` is an
XLA artefact too: here the selection with indices is ``torch.topk`` plus the
tie order that ``jax.lax.top_k`` promises and ``torch.topk`` does not.
"""

from __future__ import annotations

import torch

from .topk import multipass_parts, supports, topk_desc

__all__ = ["topk_vals_desc", "topk_with_idx", "fast_path_route"]


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


def topk_with_idx(x: torch.Tensor, k: int):
    """Exact top-k values and source indices per row, descending.

    Like ``jax.lax.top_k``: within each run of equal values the indices
    ascend.  ``_smoothed_tail_desc`` depends on that order (its plotting
    positions reverse each tied run to match a stable ascending argsort),
    and ``torch.topk`` promises no order among ties, so the order is made
    here, on the CPU and on the card alike: ``torch.topk``, then two stable
    sorts over the narrow (B, k) result, by index and then by value
    descending.  (A stable descending sort of the whole row cut at k gives
    the same order.  On an NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py``
    phase 6, it is 1.7 ms faster at 65,536 x 4,000 float32, 8.9 against
    10.6 ms, and 4 to 5 times slower past 4,096 draws, 22.2 against 5.1 ms
    at 16,384 x 16,000, and it holds the row's int64 indices besides.)

    One difference from ``lax.top_k`` remains: when a run of equal values
    straddles slot ``k``, *which* members of the run are returned is
    ``torch.topk``'s choice (``lax.top_k`` takes the lowest indices).  In
    PSIS those members equal the cutoff, are outside the strict tail and are
    written back unchanged, so the weights do not depend on the choice.
    """
    vals, idx = torch.topk(x, k, dim=-1, sorted=True)
    idx, by_index = torch.sort(idx, dim=-1, stable=True)
    vals, by_value = torch.sort(
        torch.gather(vals, -1, by_index), dim=-1, descending=True, stable=True
    )
    return vals, torch.gather(idx, -1, by_value)
