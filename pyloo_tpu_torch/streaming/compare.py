"""Streaming model comparison.

Counterpart of ``loo_compare_streaming`` in ``pyloo_tpu/streaming.py``: each
model's log-likelihood is made chunk by chunk on the device and scored by
:func:`loo_streaming` (or :func:`waic_streaming`) with ``pointwise=True``, so
only its ``(n_obs,)`` pointwise vector is kept; the results are ranked and
weighted by :func:`pyloo_tpu_torch.loo_compare`.
"""

from __future__ import annotations

from functools import partial

from ..base import ISMethod
from ..compare import loo_compare
from ..elpd import ELPDData
from .loo import loo_streaming
from .waic import waic_streaming

__all__ = ["loo_compare_streaming"]


def loo_compare_streaming(
    compare_dict,
    n_obs: int,
    n_draws: int,
    *,
    ic: str = "loo",
    method: str = "stacking",
    b_samples: int = 1000,
    alpha: float = 1,
    seed=None,
    reff: float = 1.0,
    is_method: str | ISMethod = "psis",
    scale: str | None = None,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Model comparison (:func:`pyloo_tpu_torch.loo_compare`) where each
    model's log-likelihood is streamed; no model builds its
    ``(n_obs, n_draws)`` matrix.

    Parameters
    ----------
    compare_dict : dict
        ``{name: log_lik_fn or ELPDData}`` with at least two entries; a
        generator follows the contract of :func:`loo_streaming`, an
        ``ELPDData`` must be pointwise and have ``n_obs`` observations.
    n_obs, n_draws : int
        Dataset extent shared by every generator entry.
    ic : {"loo", "waic"}
        Generator entries are scored by :func:`loo_streaming` or
        :func:`waic_streaming` (``reff`` / ``is_method`` apply to LOO only).
    method, b_samples, alpha, seed
        Weighting options, as :func:`pyloo_tpu_torch.loo_compare`.
    reff, is_method, scale, chunk_size, dtype, mesh
        Streaming options applied to every generator entry, as
        :func:`loo_streaming` (``is_method`` is its ``method``).
    on_chunk : callable, optional
        Progress hook ``on_chunk(name, next_chunk_index, n_chunks)``.

    Returns
    -------
    CompareTable ordered best to worst, as :func:`pyloo_tpu_torch.loo_compare`.
    """
    if not isinstance(compare_dict, dict):
        raise TypeError("compare_dict must be a dictionary")
    if len(compare_dict) < 2:
        raise ValueError("You must specify at least two models for comparison")
    if ic not in ("loo", "waic"):
        raise ValueError("ic must be 'loo' or 'waic'")

    elpds = {}
    for name, entry in compare_dict.items():
        if isinstance(entry, ELPDData):
            if entry["n_data_points"] != n_obs:
                raise ValueError(
                    f"Precomputed ELPDData for model '{name}' has"
                    f" {entry['n_data_points']} observations; expected {n_obs}."
                )
            elpds[name] = entry
            continue
        hook = None if on_chunk is None else partial(on_chunk, name)
        common = dict(chunk_size=chunk_size, pointwise=True, scale=scale, dtype=dtype,
                      mesh=mesh, on_chunk=hook)
        if ic == "waic":
            elpds[name] = waic_streaming(entry, n_obs, n_draws, **common)
        else:
            elpds[name] = loo_streaming(entry, n_obs, n_draws, reff=reff, method=is_method,
                                        **common)
    return loo_compare(elpds, ic=ic, method=method, b_samples=b_samples, alpha=alpha,
                       seed=seed, scale=scale)
