"""Streaming estimators: the log-likelihood made on the device chunk by chunk,
or read from disk by a chunk source (:class:`pyloo_tpu_torch.io.NpyLogLik`).

Counterpart of ``pyloo_tpu/streaming.py``, split by concern:

* ``_chunks`` — chunk geometry, indices, each chunk of a generator or a
  disk source (pinned staging and copies that overlap the scoring);
* ``_accumulate`` — per-chunk scoring and the running sums on the device;
* ``_checkpoint`` — checkpoint files for preemption-safe sweeps;
* ``loo`` — :func:`loo_streaming` itself;
* ``waic`` — :func:`waic_streaming`;
* ``score`` — :func:`loo_score_streaming`;
* ``compare`` — :func:`loo_compare_streaming`;
* ``expectations`` — :func:`e_loo_streaming`,
  :func:`loo_predictive_metric_streaming`;
* ``group`` — :func:`loo_group_streaming`;
* ``subsample`` — :func:`loo_subsample_streaming`,
  :func:`loo_approximate_posterior_streaming`;
* ``nonfactor`` — :func:`loo_nonfactor_streaming`, non-factorised LOO with
  the draws' matrices made on the device a chunk at a time.

The first nine are all of ``pyloo_tpu``'s ``*_streaming`` entry points; the
port adds the tenth.
"""

from .compare import loo_compare_streaming
from .expectations import e_loo_streaming, loo_predictive_metric_streaming
from .group import loo_group_streaming
from .loo import clear_streaming_cache, loo_streaming
from .nonfactor import loo_nonfactor_streaming
from .score import loo_score_streaming
from .subsample import loo_approximate_posterior_streaming, loo_subsample_streaming
from .waic import waic_streaming

__all__ = [
    "loo_streaming",
    "clear_streaming_cache",
    "waic_streaming",
    "loo_score_streaming",
    "loo_compare_streaming",
    "e_loo_streaming",
    "loo_predictive_metric_streaming",
    "loo_group_streaming",
    "loo_subsample_streaming",
    "loo_approximate_posterior_streaming",
    "loo_nonfactor_streaming",
]
