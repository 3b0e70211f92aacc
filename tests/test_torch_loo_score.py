"""``pyloo_tpu_torch.loo_score``, ``crps``/``scrps`` and ``loo_score_streaming``
against ``pyloo_tpu`` on the CPU.

One seeded model (``N`` observations, 2 x 200 draws, the first three rows
heavy-tailed so that some Pareto k exceed the threshold) with two
independent predictive sample sets ``y`` and ``y2`` goes through both
packages.  Float64 results agree within rtol/atol 1e-12, the permutations
being drawn from the same seed in the same order.  The port's float32 path
is held to ``pyloo_tpu``'s float64 result within a stated tolerance.
"""

import functools
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu_torch.parallel import apply_rowwise

from .torch_parity import F64, both, set_precision

N, CHAINS, DRAWS = 60, 2, 200
S = CHAINS * DRAWS

_rng = np.random.default_rng(31)
LL = _rng.normal(-1.0, 0.5, size=(CHAINS, DRAWS, N))
LL[:, :, :3] = 2.0 * _rng.standard_t(2, size=(CHAINS, DRAWS, 3)) - 1.0
Y = _rng.normal(size=N)
X = Y + _rng.normal(size=(CHAINS, DRAWS, N))
X2 = Y + _rng.normal(size=(CHAINS, DRAWS, N))
SAMPLE = ("chain", "draw", "obs")
GROUPS = {
    "posterior": {"mu": (_rng.normal(size=(CHAINS, DRAWS)), ("chain", "draw"), {})},
    "log_likelihood": {"y": (LL, SAMPLE, {})},
    "posterior_predictive": {"y": (X, SAMPLE, {}), "y2": (X2, SAMPLE, {})},
    "observed_data": {"y": (Y, ("obs",), {})},
}
JID, TID = both(GROUPS)
tscore = importlib.import_module("pyloo_tpu_torch.loo_score")  # the package's name is the function


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


def assert_same_score(tres, jres, tol=F64, pointwise=True):
    assert tres.estimates.dtype.names == jres.estimates.dtype.names == ("Estimate", "SE")
    assert_allclose(tres.estimates["Estimate"], jres.estimates["Estimate"], **tol)
    assert_allclose(tres.estimates["SE"], jres.estimates["SE"], **tol)
    assert tres.pointwise.shape == np.shape(jres.pointwise)
    assert_allclose(tres.pointwise, jres.pointwise, **tol)
    if pointwise:
        assert tres.good_k == jres.good_k and tres.warning == jres.warning
        tk, jk = tres.pareto_k, jres.pareto_k
        if hasattr(jk, "dims"):
            assert tk.dims == jk.dims and tk.name == jk.name
        assert_allclose(np.asarray(getattr(tk, "values", tk)),
                        np.asarray(getattr(jk, "values", jk)), **tol)
    else:
        assert tres.pareto_k is None and tres.warning is None


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("permutations", [1, 3])
def test_loo_score_matches_pyloo_tpu(permutations, scale):
    kw = dict(x_var="y", x2_var="y2", permutations=permutations, scale=scale, seed=4,
              pointwise=True)
    jres, jmsg = _call(jpl.loo_score, JID, **kw)
    tres, tmsg = _call(tpl.loo_score, TID, **kw)
    assert tmsg == jmsg and any("greater than" in m for m in tmsg)
    assert tres.warning is True
    assert_same_score(tres, jres)


@pytest.mark.parametrize("kwargs", [dict(type="quantile", probs=0.5),
                                    dict(type="quantile", probs=[0.25, 0.75]),
                                    dict(type="sd")])
def test_loo_score_forwards_its_keywords_to_both_expectations(kwargs):
    # pyloo_tpu passes them to both e_loo calls: E|X-y| and E|X-X'| are
    # weighted medians with type="quantile", probs=0.5
    kw = dict(x_var="y", x2_var="y2", permutations=2, seed=6, pointwise=True, **kwargs)
    jres, jmsg = _call(jpl.loo_score, JID, **kw)
    tres, tmsg = _call(tpl.loo_score, TID, **kw)
    assert tmsg == jmsg
    assert_same_score(tres, jres)
    with pytest.raises(TypeError, match="unexpected keyword"):
        tpl.loo_score(TID, x_var="y", bogus=1)
    with pytest.raises(ValueError, match="probs must be provided"):
        tpl.loo_score(TID, x_var="y", type="quantile")


def test_loo_score_default_x2_and_not_pointwise():
    kw = dict(x_var="y", permutations=2, seed=9, pointwise=False)
    jres, _ = _call(jpl.loo_score, JID, **kw)
    tres, tmsg = _call(tpl.loo_score, TID, **kw)
    assert tmsg == []  # the Pareto warning belongs to pointwise results
    assert_same_score(tres, jres, pointwise=False)


@pytest.mark.parametrize("scale", [False, True])
def test_loo_score_chunked_equals_whole(monkeypatch, scale):
    kw = dict(x_var="y", x2_var="y2", permutations=2, scale=scale, seed=1, pointwise=True)
    whole, _ = _call(tpl.loo_score, TID, **kw)
    # a budget of ~16 rows a chunk: four chunks, the last one ragged
    monkeypatch.setattr(tscore, "apply_rowwise",
                        functools.partial(apply_rowwise, chunk_bytes=16 * 10 * S * 8))
    chunked, _ = _call(tpl.loo_score, TID, **kw)
    assert_same_score(chunked, whole)


def test_loo_score_float32_against_float64():
    kw = dict(x_var="y", x2_var="y2", permutations=2, seed=3, pointwise=True)
    jres, _ = _call(jpl.loo_score, JID, **kw)
    set_precision("float32")
    try:
        tres, _ = _call(tpl.loo_score, TID, **kw)
    finally:
        set_precision("float64")
    assert tres.pointwise.dtype == np.float32
    # measured: max |d pointwise| 4.0e-7, max |d k| 6.5e-6 on this data
    assert_allclose(tres.pointwise, jres.pointwise, rtol=1e-5, atol=1e-5)
    assert_allclose(tres.pareto_k.values, jres.pareto_k.values, rtol=0, atol=1e-4)


def test_loo_score_warns_on_nan_and_validates():
    groups = {g: dict(v) for g, v in GROUPS.items()}
    x = X.copy()
    x[0, 0, 5] = np.nan
    groups["posterior_predictive"] = {"y": (x, SAMPLE, {}), "y2": (X2, SAMPLE, {})}
    jid, tid = both(groups)
    kw = dict(x_var="y", x2_var="y2", seed=0, pointwise=True)
    _, jmsg = _call(jpl.loo_score, jid, **kw)
    _, tmsg = _call(tpl.loo_score, tid, **kw)
    assert tmsg[0] == jmsg[0] and "NaN values detected" in tmsg[0]
    with pytest.raises(ValueError, match="Multiple variables found"):
        tpl.loo_score(TID)
    with pytest.raises(ValueError, match="not found in posterior_predictive"):
        tpl.loo_score(TID, x_var="y", x2_var="nope")
    with pytest.raises(ValueError, match="does not have a nope group"):
        tpl.loo_score(TID, x_var="y", y_group="nope")
    with pytest.raises(ValueError, match="positive integer"):
        tpl.loo_score(TID, x_var="y", permutations=0)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("permutations", [1, 3])
def test_crps_and_scrps(permutations, scale):
    fn = ("scrps" if scale else "crps")
    kw = dict(permutations=permutations, seed=8)
    want = getattr(jpl, fn)(X, X2, Y, **kw)
    got = getattr(tpl, fn)(X, X2, Y, **kw)
    assert np.array_equal(got.pointwise, want.pointwise)
    assert got.estimates == want.estimates and got.pareto_k is None
    flat = tpl.crps(X.reshape(S, N), X2.reshape(S, N), Y, scale=scale, **kw)
    assert np.array_equal(flat.pointwise, got.pointwise)


def test_crps_validation():
    with pytest.raises(ValueError, match="same shape"):
        tpl.crps(X, X2[:, :-1], Y)
    with pytest.raises(ValueError, match="observation shape"):
        tpl.crps(X, X2, Y[:-1])
    with pytest.raises(ValueError, match=">= 1"):
        tpl.crps(X, X2, Y, permutations=0)


# --------------------------------------------------------------------------
# loo_score_streaming
# --------------------------------------------------------------------------

LL_ROWS = LL.reshape(S, N).T.copy()  # (N, S), the stacked sample order
X_ROWS = X.reshape(S, N).T.copy()
X2_ROWS = X2.reshape(S, N).T.copy()


def _generators(module, rows):
    if module == "jax":
        arr = jnp.asarray(rows)
        return lambda idx: arr[idx]
    t = torch.from_numpy(rows)
    return lambda idx: t[idx]


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("permutations", [1, 2])
def test_loo_score_streaming_matches_pyloo_tpu(permutations, scale):
    kw = dict(permutations=permutations, scale=scale, seed=6, chunk_size=24, reff=0.9)
    jres, jmsg = _call(jpl.loo_score_streaming, *[_generators("jax", r) for r in
                       (LL_ROWS, X_ROWS, X2_ROWS)], Y, N, S, dtype=jnp.float64, **kw)
    tres, tmsg = _call(tpl.loo_score_streaming, *[_generators("torch", r) for r in
                       (LL_ROWS, X_ROWS, X2_ROWS)], Y, N, S, dtype="float64", **kw)
    assert tmsg == jmsg and tres.warning is True
    assert tres.pointwise.dtype == np.float64 and tres.pareto_k.shape == (N,)
    assert_same_score(tres, jres)


def test_loo_score_streaming_equals_stored_loo_score():
    stored, _ = _call(tpl.loo_score, TID, x_var="y", x2_var="y2", permutations=2, seed=2,
                      reff=1.0, pointwise=True)
    gens = [_generators("torch", r) for r in (LL_ROWS, X_ROWS, X2_ROWS)]
    streamed, _ = _call(tpl.loo_score_streaming, *gens, Y, N, S, permutations=2, seed=2,
                        chunk_size=16)
    assert_allclose(streamed.pointwise, stored.pointwise, **F64)
    assert_allclose(streamed.pareto_k, stored.pareto_k.values, **F64)


def test_loo_score_streaming_validation():
    gens = [_generators("torch", r) for r in (LL_ROWS, X_ROWS, X2_ROWS)]
    with pytest.raises(ValueError, match=r"Length of y \(59\) must match n_obs \(60\)"):
        tpl.loo_score_streaming(*gens, Y[:-1], N, S)
    with pytest.raises(ValueError, match="positive integer"):
        tpl.loo_score_streaming(*gens, Y, N, S, permutations=0)
    with pytest.raises(ValueError, match="at least 2 draws"):
        tpl.loo_score_streaming(*gens, Y, N, 1)
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.loo_score_streaming(*gens, Y, N, S, mesh=object())
    bad = lambda idx: torch.zeros(len(idx), S + 1, dtype=torch.float64)  # noqa: E731
    with pytest.raises(ValueError, match="x_fn returned shape"):
        tpl.loo_score_streaming(gens[0], bad, gens[2], Y, N, S)
