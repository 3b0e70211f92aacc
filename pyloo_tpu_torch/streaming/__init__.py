"""Streaming LOO: the log-likelihood made on the device chunk by chunk.

Counterpart of ``pyloo_tpu/streaming.py``, split by concern:

* ``_chunks`` — chunk geometry, indices, the call of the user's generator;
* ``_accumulate`` — per-chunk scoring and the running sums on the device;
* ``_checkpoint`` — checkpoint files for preemption-safe sweeps;
* ``loo`` — :func:`loo_streaming` itself.

Of ``pyloo_tpu``'s nine ``*_streaming`` entry points this package has
``loo_streaming``; ``ROADMAP.md`` lists the others.
"""

from .loo import clear_streaming_cache, loo_streaming

__all__ = ["loo_streaming", "clear_streaming_cache"]
