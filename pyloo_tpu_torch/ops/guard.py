"""The float64 deep-tail guard, decided over ``pyloo_tpu``'s batches.

``pyloo_tpu``'s float64 PSIS fits (``ops/loo_kernels.py:202-209``,
``ops/psis.py:496-497``) take the linear Zhang-Stephens fit unless a row of
the batch has more than 4 exceedances and a quartile exceedance below
``e**-60``; then every row of the batch takes the signed-log fit (a
``lax.cond`` over the batch).  The two fits agree to ~1e-13 in elpd, but
Pareto k may move by 1e-11 to 1e-9, so a row's result depends on the rows
it was batched with, and the port decides over ``pyloo_tpu``'s batches,
the *decision groups*, whatever blocks it computes in:

* ``apply_rowwise`` over a mesh: the whole call, one sharded program whose
  ``jnp.all`` GSPMD reduces across the mesh (``parallel/sharding.py:73-82``);
  with no mesh, ``pyloo_tpu``'s chunks of rows (``:84-101``), as
  :func:`pyloo_tpu_torch.parallel.sharding.guard_groups` gives them;
* a chunk of a ``*_streaming`` call: the whole chunk, across its shards
  (``streaming.py:111-115``);
* moment matching: each lane on its own (``ops/moment_match.py:216`` runs
  under ``jax.vmap``, which makes the batched ``lax.cond`` a per-lane
  select).

A fit asks :func:`deep_rows` which of its rows take the signed-log fit and
:func:`by_branch` runs each branch on its own rows only; a batch with no
such row runs the linear code alone, as before.  What :func:`deep_rows`
answers depends on the plan in force in the thread:

* none: a decision over the fit's own batch, one host read, as a direct
  call of ``pyloo_tpu``'s fit makes it;
* :func:`per_row`: each row for itself, one host read a fit;
* the plan of a piece of :func:`run_decided`: the linear fit on every row
  while the fit's flags are recorded; the groups' flags are read once,
  after every piece is queued, and the pieces of a group that holds a deep
  row run again with the signed-log fit on that group's rows.

Every read of the host this module makes goes through :func:`host_read`.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["deep_rows", "by_branch", "per_row", "run_decided", "host_read"]

_STATE = threading.local()


def host_read(flags: torch.Tensor) -> np.ndarray:
    """The guard's one way to the host: ``flags`` as a numpy array."""
    return flags.cpu().numpy()


def _uniform(deep: np.ndarray):
    """A per-row mask as False (no row), True (every row) or itself."""
    if not deep.any():
        return False
    return True if deep.all() else deep


class _Plan:
    """The decisions of one piece's fits, fit by fit in call order (False
    where none is given yet), and the ``in_range`` flags each fit records."""

    def __init__(self, decisions=()):
        self.decisions = decisions
        self.flags = []

    def decide(self, in_range):
        call = len(self.flags)
        self.flags.append(in_range)
        return self.decisions[call] if call < len(self.decisions) else False


class _PerRow:
    def decide(self, in_range):
        return _uniform(host_read(~in_range))


@contextlib.contextmanager
def _in_force(plan):
    outer = getattr(_STATE, "plan", None)
    _STATE.plan = plan
    try:
        yield plan
    finally:
        _STATE.plan = outer


def per_row():
    """A context in which each row of a float64 fit decides its branch
    alone: the lanes of batched moment matching."""
    return _in_force(_PerRow())


def deep_rows(in_range: torch.Tensor):
    """The rows of a float64 fit's batch that take the signed-log fit:
    False (none), True (all) or a host bool array, one entry a row.
    ``in_range`` is the fit's per-row flag (False on a deep row)."""
    plan = getattr(_STATE, "plan", None)
    if plan is None:
        return not host_read(in_range.all())
    return plan.decide(in_range)


def _indices(mask: np.ndarray, device) -> torch.Tensor:
    """The rows ``mask`` holds, as an index tensor made on ``device`` from
    its runs of rows (a group's rows are one run): no copy from the host."""
    edges = np.flatnonzero(np.diff(np.concatenate(([0], mask.astype(np.int8), [0]))))
    return torch.cat([torch.arange(int(a), int(b), device=device)
                      for a, b in zip(edges[::2], edges[1::2])])


def by_branch(deep, linear, log_domain, *rows):
    """``linear(*rows)`` on the rows ``deep`` leaves out and
    ``log_domain(*rows)`` on the others, each on its own rows only, the
    outputs scattered back in row order.  ``rows`` are per-row tensors (rows
    first); both functions return tuples of per-row tensors."""
    if deep is False:
        return linear(*rows)
    if deep is True:
        return log_domain(*rows)
    device = rows[0].device
    deep_idx, lin_idx = _indices(deep, device), _indices(~deep, device)
    by_lin = linear(*(r.index_select(0, lin_idx) for r in rows))
    by_log = log_domain(*(r.index_select(0, deep_idx) for r in rows))
    outs = []
    for a, b in zip(by_lin, by_log, strict=True):
        out = a.new_empty((deep.size,) + a.shape[1:])
        out.index_copy_(0, lin_idx, a)
        out.index_copy_(0, deep_idx, b)
        outs.append(out)
    return tuple(outs)


def run_decided(pieces, groups, sink) -> None:
    """Run pieces of row-parallel work whose float64 fits decide the
    deep-tail branch over ``groups``.

    ``pieces`` yields ``(start, stop, fn)``: ``fn()`` queues the work of
    rows ``[start, stop)`` and returns its outputs; it may be called twice
    and has no effect but its result.  ``groups`` are ``pyloo_tpu``'s
    decision groups, ``(start, stop)`` ranges of the same rows that cover
    every piece.  ``sink(start, stop, outputs)`` takes a piece's outputs,
    and takes them again when the piece runs again.

    Each piece runs as it is yielded, with the linear fit on every row.  A
    call whose fits recorded no flag (float32, SIS, no PSIS at all) reads
    nothing.  Otherwise the flags of every group are reduced on the devices
    and read in one host read, after every piece is queued; the pieces that
    hold rows of a group with a deep row run again, with the signed-log fit
    on those rows.  A fit's flags depend on its piece's rows alone, never on
    an earlier fit's result (true of every function of this package), so
    the second run records the flags of the first.
    """
    kept = []  # (start, stop, fn, flags) of the pieces with a float64 fit
    for start, stop, fn in pieces:
        with _in_force(_Plan()) as plan:
            sink(start, stop, fn())
        if plan.flags:
            kept.append((start, stop, fn, plan.flags))
        del fn
    if not kept:
        return
    any_deep, where = [], []
    for start, stop, _, flags in kept:
        for g, (a, b) in enumerate(groups):
            lo, hi = max(a, start), min(b, stop)
            if lo >= hi:
                continue
            for call, in_range in enumerate(flags):
                if in_range.shape[0] != stop - start:
                    raise ValueError(
                        f"a float64 fit of rows {start}:{stop} was given"
                        f" {in_range.shape[0]} rows; the deep-tail guard needs the piece's rows"
                    )
                any_deep.append(~in_range[lo - start : hi - start].all())
                where.append((g, call))
    home = any_deep[0].device
    deep = {key for key, d in zip(where, host_read(torch.stack([t.to(home) for t in any_deep])))
            if d}
    if not deep:
        return
    for start, stop, fn, flags in kept:
        decisions = []
        for call in range(len(flags)):
            mask = np.zeros(stop - start, bool)
            for g, (a, b) in enumerate(groups):
                if (g, call) in deep:
                    mask[max(a, start) - start : max(min(b, stop) - start, 0)] = True
            decisions.append(_uniform(mask))
        if any(d is not False for d in decisions):
            with _in_force(_Plan(decisions)):
                sink(start, stop, fn())
