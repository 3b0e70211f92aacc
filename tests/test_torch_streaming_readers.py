"""The port's streaming readers of the weights against ``pyloo_tpu`` on the CPU:
``e_loo_streaming``, ``loo_predictive_metric_streaming`` and
``loo_group_streaming``.

One seeded numpy log-likelihood (203 observations x 300 draws, a few rows
heavy-tailed), posterior-predictive draws and observed data feed a ``jnp``
generator for ``pyloo_tpu`` and a ``torch`` generator for the port, in
chunks of 64 rows (a ragged last chunk).  Float64 results agree within rtol
and atol 1e-12 (variance and sd 1e-10, as ``test_torch_expectations.py``
holds them: they divide by 1 - sum w^2; quantiles 1e-10: the interpolation
divides by a difference of cumulative weights), Pareto k within 1e-12;
float32 values within rtol and atol 1e-5 and k within 1e-3.  Each is also held to the port's
stored-matrix form on the same rows.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from .torch_parity import assert_same_rows

N, S, CHUNK = 203, 300, 64
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)

_rng = np.random.default_rng(31)
LL = _rng.normal(-1.0, 0.6, size=(N, S))
LL[:4] = 2.0 * _rng.standard_t(2, size=(4, S)) - 1.0
X = LL * 0.5 + _rng.normal(size=(N, S))
Y = _rng.normal(size=N)
PROB = 1.0 / (1.0 + np.exp(-X))  # draws in (0, 1) for the binary metrics
Y01 = (_rng.random(N) < 0.5).astype(np.float64)
GROUPS = np.array([f"school_{i % 23:02d}" for i in range(N)])


def _jgen(a):
    a = jnp.asarray(a)
    return lambda idx: a[idx]


def _tgen(a):
    a = torch.from_numpy(np.ascontiguousarray(a))
    return lambda idx: a[idx]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"], tpl.rcParams["device.precision"]
    threads = torch.get_num_threads()
    tpl.rcParams["device.device"] = "cpu"
    torch.set_num_threads(1)  # the test workers share the host's cores
    yield
    tpl.rcParams["device.device"], tpl.rcParams["device.precision"] = old
    torch.set_num_threads(threads)


def _stored(ll, x, kind, probs, precision):
    """The port's in-memory e_loo over the same rows (psislw, then e_loo)."""
    tpl.rcParams["device.precision"] = precision
    idata = tpl.from_dict(
        posterior={"b": np.zeros((1, S))},
        log_likelihood={"y": ll.T[None]},
        posterior_predictive={"y": x.T[None]},
    )
    lik = idata.log_likelihood.y.stack(__sample__=("chain", "draw"))
    lw, _ = tpl.psislw(-lik)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tpl.e_loo(idata, group="posterior_predictive", var_name="y", log_weights=lw,
                         log_ratios=-lik, type=kind, probs=probs)


@pytest.mark.parametrize("kind,probs", [("mean", None), ("variance", None), ("sd", None),
                                        ("quantile", [0.1, 0.5, 0.95])])
def test_e_loo_streaming_float64(kind, probs):
    got = tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, type=kind, probs=probs,
                              chunk_size=CHUNK, dtype="float64")
    want = jpl.e_loo_streaming(_jgen(LL), _jgen(X), N, S, type=kind, probs=probs,
                               chunk_size=CHUNK, dtype=jnp.float64)
    tol = F64 if kind == "mean" else dict(rtol=1e-10, atol=1e-10)
    assert got.value.dims == want.value.dims and got.value.name == want.value.name
    assert got.value.shape == ((N,) if probs is None else (N, len(probs)))
    assert_allclose(got.value.values, np.asarray(want.value.values), **tol)
    for field in ("pareto_k", "min_ss", "khat_threshold", "convergence_rate"):
        assert_allclose(getattr(got, field).values, np.asarray(getattr(want, field).values),
                        err_msg=field, **F64)
    stored = _stored(LL, X, kind, probs, "float64")
    assert_allclose(got.value.values, stored.value.values, **tol)
    assert_allclose(got.pareto_k.values, stored.pareto_k.values, **F64)


@pytest.mark.parametrize("kind", ["mean", "quantile"])
def test_e_loo_streaming_float32(kind):
    probs = [0.25, 0.75] if kind == "quantile" else None
    got = tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, type=kind, probs=probs,
                              chunk_size=CHUNK, dtype="float32")
    want = jpl.e_loo_streaming(_jgen(LL), _jgen(X), N, S, type=kind, probs=probs,
                               chunk_size=CHUNK, dtype=jnp.float32)
    assert got.value.values.dtype == np.float32
    assert_allclose(got.value.values, np.asarray(want.value.values), **F32)
    assert_allclose(got.pareto_k.values, np.asarray(want.pareto_k.values), rtol=0, atol=1e-3)


def test_e_loo_streaming_default_chunk_and_validation():
    got = tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, dtype="float64")  # one chunk of 208
    want = tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, chunk_size=CHUNK, dtype="float64")
    assert_allclose(got.value.values, want.value.values, **F64)
    with pytest.raises(ValueError, match="type must be"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, type="median")
    with pytest.raises(ValueError, match="probs must be provided"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, type="quantile")
    with pytest.raises(ValueError, match="between 0 and 1"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, type="quantile", probs=[0.5, 1.0])
    with pytest.raises(ValueError, match="only valid"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, probs=0.5)
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X), N, S, mesh=object())
    with pytest.raises(ValueError, match="x_fn returned shape"):
        tpl.e_loo_streaming(_tgen(LL), _tgen(X[:, :10]), N, S)


@pytest.mark.parametrize("metric,y,x", [("mae", Y, X), ("mse", Y, X), ("rmse", Y, X),
                                        ("acc", Y01, PROB), ("balanced_acc", Y01, PROB)])
def test_loo_predictive_metric_streaming(metric, y, x):
    got = tpl.loo_predictive_metric_streaming(_tgen(LL), _tgen(x), y, N, S, metric=metric,
                                              chunk_size=CHUNK, dtype="float64")
    want = jpl.loo_predictive_metric_streaming(_jgen(LL), _jgen(x), y, N, S, metric=metric,
                                               chunk_size=CHUNK, dtype=jnp.float64)
    assert got.keys() == want.keys()
    for key in got:
        assert_allclose(got[key], want[key], err_msg=key, **F64)
    # the stored-matrix form on the same rows
    idata = tpl.from_dict(posterior={"b": np.zeros((1, S))}, log_likelihood={"y": LL.T[None]},
                          posterior_predictive={"y": x.T[None]}, observed_data={"y": y})
    stored = tpl.loo_predictive_metric(idata, y, metric=metric)
    for key in got:
        assert_allclose(got[key], stored[key], err_msg=key, **F64)


def test_loo_predictive_metric_streaming_validation():
    with pytest.raises(ValueError, match="Length of y"):
        tpl.loo_predictive_metric_streaming(_tgen(LL), _tgen(X), Y[:-1], N, S)
    with pytest.raises(ValueError, match="Invalid metric"):
        tpl.loo_predictive_metric_streaming(_tgen(LL), _tgen(X), Y, N, S, metric="r2")


@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
@pytest.mark.parametrize("pointwise", [False, True])
def test_loo_group_streaming(method, pointwise):
    kw = dict(pointwise=pointwise, method=method, chunk_size=CHUNK, reff=0.9)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tpl.loo_group_streaming(_tgen(LL), GROUPS, N, S, dtype="float64", **kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jpl.loo_group_streaming(_jgen(LL), GROUPS, N, S, dtype=jnp.float64, **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert_same_rows(got, want)
    assert got["n_groups"] == 23
    if pointwise:
        assert list(got.logo_i.coords["group"]) == sorted(set(GROUPS))
    assert str(got) == str(want)


def test_loo_group_streaming_float32_and_stored():
    # float32 chunks, float64 group sums: against pyloo_tpu's float32 stream
    # and the port's stored-matrix loo_group on the same rows
    got = tpl.loo_group_streaming(_tgen(LL), GROUPS, N, S, chunk_size=CHUNK, dtype="float32",
                                  pointwise=True)
    want = jpl.loo_group_streaming(_jgen(LL), GROUPS, N, S, chunk_size=CHUNK,
                                   dtype=jnp.float32, pointwise=True)
    assert_same_rows(got, want, tol=dict(rtol=1e-5, atol=1e-5))
    tpl.rcParams["device.precision"] = "float64"
    idata = tpl.from_dict(posterior={"b": np.zeros((1, S))}, log_likelihood={"y": LL.T[None]})
    stored = tpl.loo_group(idata, GROUPS, pointwise=True, reff=1.0)
    full = tpl.loo_group_streaming(_tgen(LL), GROUPS, N, S, dtype="float64", pointwise=True)
    assert_same_rows(full, stored)


def test_loo_group_streaming_validation():
    with pytest.raises(ValueError, match="Length of group_ids"):
        tpl.loo_group_streaming(_tgen(LL), GROUPS[:-1], N, S)
    with pytest.raises(ValueError, match="Invalid method"):
        tpl.loo_group_streaming(_tgen(LL), GROUPS, N, S, method="bogus")
    with pytest.raises(ValueError, match="at least 2 draws"):
        tpl.loo_group_streaming(_tgen(LL), GROUPS, N, 1)
