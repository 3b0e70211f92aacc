"""Device logsumexp."""

from __future__ import annotations

import math

import torch

__all__ = ["logsumexp"]


def logsumexp(x: torch.Tensor, dim: int = -1, b_inv=None, keepdim: bool = False):
    """Max-shifted ``log(sum(exp(x)))`` along ``dim``.

    ``b_inv`` scales the sum by ``1/b_inv`` (used for ``lppd``, where the
    average over S draws is taken in log space, reference ``pyloo/loo.py:329``).
    """
    xmax = x.amax(dim=dim, keepdim=True)
    # guard fully -inf rows: exp(-inf - -inf) would be nan
    xmax = torch.where(torch.isfinite(xmax), xmax, 0.0)
    out = torch.log(torch.exp(x - xmax).sum(dim=dim, keepdim=True)) + xmax
    if b_inv is not None:
        out = out - math.log(b_inv)
    if not keepdim:
        out = out.squeeze(dim)
    return out
