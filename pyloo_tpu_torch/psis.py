"""Pareto smoothed importance sampling: public API.

Counterpart of ``pyloo_tpu/psis.py`` (reference ``pyloo/psis.py:25-111``)
over the batched functions of :mod:`pyloo_tpu_torch.ops.psis`.  Results are
host arrays; the work runs on ``rcParams["device.device"]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ._common import compute_device
from .base import ISMethod, _host, as_sample_matrix, compute_importance_weights
from .ops import psislw_compact_batch, tail_length
from .ops.expectations import weighted_quantile_batch
from .ops.psis import compact_weighted_mean, compact_weighted_moments
from .parallel import apply_rowwise

__all__ = ["psislw", "psislw_compact", "CompactWeights", "ImportanceSamplingResult"]


@dataclass(frozen=True)
class ImportanceSamplingResult:
    """Bundle of everything an importance-sampling pass produced.

    Attributes
    ----------
    samples : np.ndarray
        The (possibly resampled) posterior draws the weights refer to.
    log_weights : np.ndarray
        Smoothed, truncated, self-normalized log importance weights.
    pareto_k : np.ndarray or float or None
        GPD shape diagnostic(s); ``None`` for methods without one (SIS/TIS).
    warnings : list of str
        Human-readable diagnostics accumulated while computing the weights.
    method : str or None
        Name of the importance-sampling method that produced the weights.
    """

    samples: np.ndarray
    log_weights: np.ndarray
    pareto_k: np.ndarray | float | None = None
    warnings: list[str] = field(default_factory=list)
    method: str | None = "psis"


def psislw(log_weights, reff: float = 1.0):
    """Pareto smoothed importance sampling (PSIS).

    Parameters
    ----------
    log_weights : DataArray or (..., S) array-like
        Log importance weights; the ``__sample__`` dimension (or last axis for
        plain arrays) indexes posterior draws.
    reff : float, default 1
        Relative MCMC efficiency ``ess / S``; sizes the smoothed tail.

    Returns
    -------
    lw_out
        Smoothed, truncated and self-normalized log weights.
    kss
        Estimated shape parameter k of the generalized Pareto distribution,
        per observation (``inf`` when fewer than 5 tail samples exist).

    References
    ----------
    Vehtari et al. (2024). Pareto smoothed importance sampling. JMLR 25(72).
    """
    lw, k = compute_importance_weights(log_weights, method=ISMethod.PSIS, reff=reff)
    if hasattr(k, "rename"):
        k = k.rename("pareto_shape")
    return lw, k


class CompactWeights(NamedTuple):
    """Scatter-free PSIS weights: a per-row scalar plus an O(M) tail patch.

    The full smoothed log-weight matrix never materializes; it is recoverable
    elementwise as

        lw[b, s] = raw[b, s] - log_norm[b]     for s not in tail_idx[b]
        lw[b, tail_idx[b, j]] = tail_lw[b, j]  for every slot j

    ``densify(raw)`` reconstructs the dense matrix (for parity checks);
    ``weighted_mean(h, raw)`` computes ``E[h]`` under the smoothed weights in
    one pass over the raw matrix plus an M-column correction.

    The fields are host arrays.  Each method copies its inputs to
    ``rcParams["device.device"]`` in the dtype of ``log_norm`` (the dtype the
    selection ran in, so that tail membership is decided on the same bits)
    and works there in row chunks.
    """

    log_norm: np.ndarray  # (B,)
    tail_idx: np.ndarray  # (B, M) int32
    tail_lw: np.ndarray  # (B, M)
    xcutoff: np.ndarray  # (B,) tail cutoff in the shifted (x - rowmax) domain
    pareto_k: np.ndarray  # (B,)

    def _on_device(self, *arrays):
        """``arrays`` as 2-D tensors of ``log_norm``'s dtype, then the fields
        a reader needs, rows first so that they chunk together."""
        device = compute_device()
        dtype = torch.float64 if self.log_norm.dtype == np.float64 else torch.float32
        rows = tuple(torch.as_tensor(np.asarray(a)).to(device, dtype) for a in arrays)
        fields = (
            torch.from_numpy(self.log_norm).to(device)[:, None],
            torch.from_numpy(self.tail_idx).to(device, torch.int64),
            torch.from_numpy(self.tail_lw).to(device),
            torch.from_numpy(self.xcutoff).to(device)[:, None],
        )
        return rows + fields

    @staticmethod
    def _dense_block(raw, log_norm, tail_idx, tail_lw):
        lw = raw - log_norm
        return lw.scatter_(1, tail_idx, tail_lw)

    def densify(self, raw_log_weights):
        """Materialize the full (B, S) smoothed log-weight matrix."""
        raw, log_norm, tail_idx, tail_lw, _ = self._on_device(raw_log_weights)
        (lw,) = apply_rowwise(
            lambda *block: (self._dense_block(*block),),
            (raw, log_norm, tail_idx, tail_lw),
            extra_buffers=1,
        )
        return _host(lw)

    def weighted_mean(self, h, raw_log_weights):
        """``E[h]`` per row under the smoothed weights, without densifying."""
        (mean,) = apply_rowwise(
            lambda h, raw, log_norm, tail_idx, tail_lw, xcutoff: (
                compact_weighted_mean(
                    h, raw, log_norm[:, 0], tail_idx, tail_lw, xcutoff[:, 0]
                ),
            ),
            self._on_device(h, raw_log_weights),
        )
        return _host(mean)

    def weighted_moments(self, h, raw_log_weights):
        """``(E[h], Var[h])`` per row, scatter-free.

        Variance is the unbiased weighted form ``(E[h^2]-E[h]^2)/(1-sum w^2)``
        clamped at 0, as in :func:`pyloo_tpu_torch.e_loo` (reference
        ``pyloo/e_loo.py:518-531``); constant-``h`` and single-dominant-weight
        rows return exactly 0.
        """
        mean, var = apply_rowwise(
            lambda h, raw, log_norm, tail_idx, tail_lw, xcutoff: compact_weighted_moments(
                h, raw, log_norm[:, 0], tail_idx, tail_lw, xcutoff[:, 0]
            ),
            self._on_device(h, raw_log_weights),
        )
        return _host(mean), _host(var)

    def weighted_sd(self, h, raw_log_weights):
        """Weighted standard deviation per row (sqrt of ``weighted_moments``)."""
        _, var = self.weighted_moments(h, raw_log_weights)
        return np.sqrt(var)

    def weighted_quantile(self, h, raw_log_weights, probs, *, chunk_rows: int = 8192):
        """Interpolated weighted quantiles per row (``(B, n_probs)``).

        Quantiles need each row's full sorted ``h`` whatever the weights'
        representation, so the smoothed log-weights are densified one chunk
        of ``chunk_rows`` rows at a time, on the device, and go through the
        function :func:`pyloo_tpu_torch.e_loo` uses: the values are those of
        the dense path for every chunking.
        """
        h, raw, log_norm, tail_idx, tail_lw, _ = self._on_device(h, raw_log_weights)
        probs = np.atleast_1d(np.asarray(probs, dtype=np.float64))
        out = np.empty((raw.shape[0], probs.size))
        for s0 in range(0, raw.shape[0], chunk_rows):
            sl = slice(s0, s0 + chunk_rows)
            lw = self._dense_block(raw[sl], log_norm[sl], tail_idx[sl], tail_lw[sl])
            out[sl] = _host(weighted_quantile_batch(h[sl], lw, probs))
        return out


def psislw_compact(log_weights, reff: float = 1.0) -> CompactWeights:
    """PSIS without materializing the smoothed matrix.

    Same smoothing semantics as :func:`psislw` (identical tail membership,
    GPD fit, tie handling, NaN poisoning and normalization), but the result
    is returned in the compact form described by :class:`CompactWeights`:
    ``B x (2M + 2)`` numbers instead of ``B x S``.

    Parameters
    ----------
    log_weights : DataArray or (..., S) array-like
        Raw log importance weights (same contract as :func:`psislw`).
    reff : float, default 1
        Relative MCMC efficiency; sizes the smoothed tail.

    Notes
    -----
    Observation dims are flattened into the leading axis of every output
    (reshape with the caller's obs shape to restore).
    """
    matrix, n_samples, _ = as_sample_matrix(log_weights)
    if n_samples < 2:
        raise ValueError(
            "importance sampling requires at least 2 draws per observation,"
            f" got {n_samples}"
        )
    m_tail = tail_length(n_samples, reff)
    # pyloo_tpu smooths every row in one call (psis.py:216): one decision group
    log_norm, tail_idx, tail_lw, xcutoff, khat = apply_rowwise(
        lambda block: psislw_compact_batch(block, m_tail), matrix, extra_buffers=1,
        decide_over="call",
    )
    return CompactWeights(
        _host(log_norm),
        _host(tail_idx.to(torch.int32)),
        _host(tail_lw),
        _host(xcutoff),
        _host(khat),
    )
