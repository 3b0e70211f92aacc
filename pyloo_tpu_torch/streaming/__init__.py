"""Streaming estimators: the log-likelihood made on the device chunk by chunk.

Counterpart of ``pyloo_tpu/streaming.py``, split by concern:

* ``_chunks`` — chunk geometry, indices, the call of the user's generator;
* ``_accumulate`` — per-chunk scoring and the running sums on the device;
* ``_checkpoint`` — checkpoint files for preemption-safe sweeps;
* ``loo`` — :func:`loo_streaming` itself;
* ``waic`` — :func:`waic_streaming`;
* ``score`` — :func:`loo_score_streaming`;
* ``compare`` — :func:`loo_compare_streaming`.

Of ``pyloo_tpu``'s nine ``*_streaming`` entry points this package has these
four; ``ROADMAP.md`` lists the others.
"""

from .compare import loo_compare_streaming
from .loo import clear_streaming_cache, loo_streaming
from .score import loo_score_streaming
from .waic import waic_streaming

__all__ = [
    "loo_streaming",
    "clear_streaming_cache",
    "waic_streaming",
    "loo_score_streaming",
    "loo_compare_streaming",
]
