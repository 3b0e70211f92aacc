"""``pyloo_tpu_torch.loo_lfo`` against ``pyloo_tpu.loo_lfo`` on the CPU.

A seeded series of ``N`` time points x 2 x 200 draws goes through both
packages: float64 rows within rtol/atol 1e-12, the report byte for byte
alike, the same warnings.  The ratio rows are summed on the host in both,
in the same order, so the tail members agree.
"""

import warnings

import numpy as np
import pytest
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

from .torch_parity import F64, assert_same_rows, both, set_precision

N, CHAINS, DRAWS = 120, 2, 200


def _series(seed, spread=0.5):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1.0, spread, size=(CHAINS, DRAWS, N))
    return {
        "posterior": {"mu": (rng.normal(size=(CHAINS, DRAWS)), ("chain", "draw"), {})},
        "log_likelihood": {"y": (ll, ("chain", "draw", "time"), {})},
    }


JID, TID = both(_series(12))


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old
    set_precision("float64")


def _call(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught]


def _both(jid=JID, tid=TID, **kw):
    jres, jmsg = _call(jpl.loo_lfo, jid, **kw)
    tres, tmsg = _call(tpl.loo_lfo, tid, **kw)
    assert tmsg == jmsg
    return tres, jres, tmsg


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("M", [1, 4])
def test_loo_lfo_matches_pyloo_tpu(M, scale):
    tres, jres, _ = _both(L=30, M=M, scale=scale, pointwise=True)
    assert tres["n_data_points"] == N - M - 30 + 1
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)


def test_not_pointwise_and_given_reff():
    tres, jres, _ = _both(L=50, M=2, pointwise=False, reff=0.8)
    assert "lfo_i" not in tres and "pareto_k" not in tres
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)


def test_high_k_warning_and_report():
    # a wide spread: the ratios of far targets are heavy-tailed
    jid, tid = both(_series(3, spread=1.5))
    tres, jres, messages = _both(jid, tid, L=10, pointwise=True)
    assert tres["warning"] is True and any("LFO targets have Pareto k" in m for m in messages)
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres) and "There has been a warning" in str(tres)
    tres, jres, messages = _both(jid, tid, L=10, pointwise=True, k_threshold=np.inf)
    assert tres["warning"] is False and messages == []
    assert_same_rows(tres, jres)


def test_nan_log_likelihood_is_cleaned_alike():
    groups = _series(5)
    groups["log_likelihood"]["y"][0][0, 3, 70] = np.nan
    jid, tid = both(groups)
    tres, jres, messages = _both(jid, tid, L=40, pointwise=True)
    assert any("ignored in the LFO calculation" in m for m in messages)
    assert_same_rows(tres, jres)


def test_float32_against_float64():
    jres, _ = _call(jpl.loo_lfo, JID, L=30, M=2, pointwise=True)
    set_precision("float32")
    try:
        tres, _ = _call(tpl.loo_lfo, TID, L=30, M=2, pointwise=True)
    finally:
        set_precision("float64")
    # the ratios are smoothed in float32, the joint log-sum-exp in float64
    assert_allclose(tres.lfo_i.values, jres.lfo_i.values, rtol=1e-5, atol=1e-5)
    assert_allclose(tres.pareto_k, jres.pareto_k, rtol=0, atol=1e-3)


def test_validation_and_wrapper():
    with pytest.raises(TypeError, match="minimum history length L"):
        tpl.loo_lfo(TID)
    with pytest.raises(ValueError, match="M must be >= 1"):
        tpl.loo_lfo(TID, L=10, M=0)
    with pytest.raises(ValueError, match=r"L must satisfy 1 <= L <= n_obs - M \(119\)"):
        tpl.loo_lfo(TID, L=120)
    with pytest.raises(ValueError, match="got L=0"):
        tpl.loo_lfo(TID, L=0)
    with pytest.raises(TypeError, match="requires `data`"):
        tpl.loo_lfo(L=10)
    # a wrapper is refit (tests/test_torch_refit.py); an object that is not
    # one fails as it does in pyloo_tpu
    with pytest.raises(AttributeError, match="n_obs"):
        jpl.loo_lfo(L=10, wrapper=object())
    with pytest.raises(AttributeError, match="n_obs"):
        tpl.loo_lfo(L=10, wrapper=object())


def test_first_targets_depend_only_on_their_rows():
    """A target's value depends on rows up to i + M - 1 only: the series cut
    after the first targets' windows gives the same values."""
    M, L, n_first = 3, 30, 20
    full, _ = _call(tpl.loo_lfo, TID, L=L, M=M, pointwise=True)
    groups = _series(12)
    ll = groups["log_likelihood"]["y"][0][:, :, : L + n_first + M - 1]
    groups["log_likelihood"]["y"] = (ll, ("chain", "draw", "time"), {})
    cut, _ = _call(tpl.loo_lfo, both(groups)[1], L=L, M=M, pointwise=True)
    assert cut["n_data_points"] == n_first
    assert_allclose(cut.lfo_i.values, full.lfo_i.values[:n_first], **F64)
    assert_allclose(cut.pareto_k, full.pareto_k[:n_first], **F64)
