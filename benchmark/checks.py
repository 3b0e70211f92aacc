"""The comparison that decides ``correct``: gaps between the program's
outputs and the reference's, and the limits they are judged by.

Each entry driver turns the program's result and the reference into the
same dict of outputs and compares them with these functions; the control
is the reference computed one precision below (``CONTROL_DTYPE``), put in
the program's place and compared the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the nearest precision below the one a stage states
CONTROL_DTYPE = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
K_QUANTILE = 0.9999
# a row whose k gap is wider than this counts in ``k_rows_off``: sound float32 fits leave
# every row but the degenerate ones within 0.009 of the float64 k
K_ROW_GAP = 0.02


def judged(readings: dict, limits: dict) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``): every limited number read,
    finite, and at most its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        value = math.inf if value is None or math.isnan(value) else float(value)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    return correct, checks


def row_gaps(got, want, relative: bool = True, quantile: float | None = None) -> tuple:
    """(largest gap, mismatched rows) of per-row results: the gap
    |got - want|, relative to 1 + |want| when ``relative``, over the rows
    both sides give finite (with ``quantile``, that quantile of the gaps in
    place of the largest); a row that one side gives finite and the other
    not, or non-finite differently (NaN against inf), is mismatched."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf, max(got.size, want.size)
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    alike = (got == want) | (np.isnan(got) & np.isnan(want))
    mismatched = int(np.count_nonzero((fin_g != fin_w) | (~fin_g & ~fin_w & ~alike)))
    both = fin_g & fin_w
    d = np.abs(got[both] - want[both])
    if relative:
        d = d / (1.0 + np.abs(want[both]))
    if quantile is not None and d.size:
        return float(np.quantile(d, quantile)), mismatched
    return float(np.max(d, initial=0.0)), mismatched


def rows_beyond(got, want, gap: float) -> int:
    """Rows that both sides give finite and whose |got - want| exceeds ``gap``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return max(got.size, want.size)
    both = np.isfinite(got) & np.isfinite(want)
    return int(np.count_nonzero(np.abs(got[both] - want[both]) > gap))


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; inf where either is not finite."""
    got, want = float(got), float(want)
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / abs(want) if want != 0 else abs(got - want)


def loo_outputs(result) -> dict:
    """What a ``loo``-shaped result says: every row's loo_i and k, and the
    totals."""
    return {"loo_i": np.asarray(result["loo_i"].values, np.float64),
            "k": np.asarray(result["pareto_k"].values, np.float64),
            "elpd_loo": float(result["elpd_loo"]), "p_loo": float(result["p_loo"]),
            "se": float(result["se"])}


def compare_loo(out: dict, ref: dict, float32_fit: bool = False) -> dict:
    """``loo_i_gap`` (relative to 1 + |loo_i|) and ``k_gap`` over the rows
    both sides give finite, ``nonfinite_mismatches``, and the totals'
    relative gaps.  After a float32 fit, ``k_gap_q9999``, the 99.99th
    percentile of the k gaps, and ``k_rows_off``, the count of rows whose k
    gap exceeds ``K_ROW_GAP``, stand for ``k_gap``: the float32 fit
    degenerates (sigma <= 0) on about one row in several million, which then
    keeps its unsmoothed tail and its fit's k, as documented, 0.13 from the
    float64 k on the row seen; the quantile holds the bulk of the rows, and
    the count holds every row, so that k wrong on more rows than such
    degenerate fits explain fails."""
    loo_i_gap, loo_i_off = row_gaps(out["loo_i"], ref["loo_i"])
    readings = {"loo_i_gap": loo_i_gap}
    if float32_fit:
        readings["k_gap_q9999"], k_off = row_gaps(out["k"], ref["k"], relative=False,
                                                  quantile=K_QUANTILE)
        readings["k_rows_off"] = rows_beyond(out["k"], ref["k"], K_ROW_GAP)
    else:
        readings["k_gap"], k_off = row_gaps(out["k"], ref["k"], relative=False)
    return {**readings, "nonfinite_mismatches": loo_i_off + k_off,
            "elpd_gap": rel_gap(out["elpd_loo"], ref["elpd_loo"]),
            "p_loo_gap": rel_gap(out["p_loo"], ref["p_loo"]),
            "se_gap": rel_gap(out["se"], ref["se"])}
