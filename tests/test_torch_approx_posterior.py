"""LOO for approximate posteriors in ``pyloo_tpu_torch`` against ``pyloo_tpu``
on the CPU.

``importance_resample`` draws from numpy's ``RandomState(seed)`` on the host
in both packages, so the same seed gives the same draw indices for each
method.  One seeded model (``torch_parity.synthetic``: 80 observations,
2 x 150 draws, three heavy-tailed rows) goes through
``loo_approximate_posterior`` of both packages, and a seeded numpy matrix
through ``loo_approximate_posterior_streaming``.  Float64 rows agree within
rtol and atol 1e-12 and the reports byte for byte; float32 within rtol and
atol 1e-5, Pareto k included.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

from .torch_parity import assert_same_rows, set_precision, synthetic

F32 = dict(rtol=1e-5, atol=1e-5)
S = 300
_rng = np.random.default_rng(23)
LOG_P = _rng.normal(size=S)
LOG_Q = LOG_P + 0.3 * _rng.normal(size=S)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"], tpl.rcParams["device.precision"]
    threads = torch.get_num_threads()
    tpl.rcParams["device.device"] = "cpu"
    torch.set_num_threads(1)  # the test workers share the host's cores
    yield
    tpl.rcParams["device.device"], tpl.rcParams["device.precision"] = old
    jpl.rcParams["device.precision"] = "float64"
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return synthetic(obs_shape=(80,), chains=2, draws=150, seed=9, tail=True)


def _both_calls(fn_j, fn_t):
    out = []
    for fn in (fn_j, fn_t):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fn()
        out.append((res, [str(x.message) for x in w]))
    (jres, jw), (tres, tw) = out
    assert tw == jw
    return tres, jres


@pytest.mark.parametrize("method", ["psis", "psir", "sis"])
def test_importance_resample_same_draws(method):
    set_precision("float64")
    got = tpl.importance_resample(LOG_P, LOG_Q, method=method, seed=4)
    want = jpl.importance_resample(LOG_P, LOG_Q, method=method, seed=4)
    assert_array_equal(got, want)
    assert got.shape == (S,)
    if method == "psis":
        assert len(np.unique(got)) == S  # without replacement


def test_importance_resample_fallbacks():
    set_precision("float64")
    log_p = LOG_P.copy()
    log_p[:7] = -np.inf  # excluded, with a warning
    got, want = _both_calls(lambda: jpl.importance_resample(log_p, LOG_Q, method="psir", seed=1),
                            lambda: tpl.importance_resample(log_p, LOG_Q, method="psir", seed=1))
    assert_array_equal(got, want)
    assert not np.isin(np.arange(7), got).any()
    # too few non-zero weights to draw S without replacement: with replacement
    peaked = np.zeros(S)
    peaked[:3] = 800.0
    got, want = _both_calls(lambda: jpl.importance_resample(peaked, np.zeros(S), seed=2),
                            lambda: tpl.importance_resample(peaked, np.zeros(S), seed=2))
    assert_array_equal(got, want)
    with pytest.raises(ValueError, match="No valid importance weights"):
        tpl.importance_resample(np.full(5, -np.inf), np.zeros(5))


@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
@pytest.mark.parametrize("resample_method", ["psis", "psir", "sis"])
def test_loo_approximate_posterior(model, method, resample_method):
    set_precision("float64")
    jid, tid = model
    kw = dict(method=method, resample_method=resample_method, seed=3, pointwise=True)
    tres, jres = _both_calls(lambda: jpl.loo_approximate_posterior(jid, LOG_P, LOG_Q, **kw),
                             lambda: tpl.loo_approximate_posterior(tid, LOG_P, LOG_Q, **kw))
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)
    assert "Posterior approximation correction used." in str(tres)
    assert_array_equal(tres.approximate_posterior["log_p"], LOG_P)


def test_loo_approximate_posterior_float32_and_options(model):
    jid, tid = model
    set_precision("float32")
    tres, jres = _both_calls(lambda: jpl.loo_approximate_posterior(jid, LOG_P, LOG_Q, seed=5),
                             lambda: tpl.loo_approximate_posterior(tid, LOG_P, LOG_Q, seed=5))
    set_precision("float64")
    assert_same_rows(tres, jres, tol=F32)
    assert str(tres) == str(jres)
    tres, jres = _both_calls(
        lambda: jpl.loo_approximate_posterior(jid, LOG_P, LOG_Q, seed=5, scale="deviance",
                                              reff=0.8),
        lambda: tpl.loo_approximate_posterior(tid, LOG_P, LOG_Q, seed=5, scale="deviance",
                                              reff=0.8))
    assert_same_rows(tres, jres)
    with pytest.raises(ValueError, match="same length"):
        tpl.loo_approximate_posterior(tid, LOG_P, LOG_Q[:-1])
    with pytest.raises(ValueError, match="Invalid method"):
        tpl.loo_approximate_posterior(tid, LOG_P, LOG_Q, method="bogus")
    # a failed resample falls back to the original draws, with a warning
    bad = np.full(S, -np.inf)
    tres, jres = _both_calls(lambda: jpl.loo_approximate_posterior(jid, bad, LOG_Q),
                             lambda: tpl.loo_approximate_posterior(tid, bad, LOG_Q))
    assert_same_rows(tres, jres)


N, CHUNK = 203, 64
LL = np.random.default_rng(29).normal(-1.0, 0.6, size=(N, S))
LL[:3] = 2.0 * np.random.default_rng(30).standard_t(2, size=(3, S)) - 1.0


def _jgen():
    a = jnp.asarray(LL)
    return lambda idx: a[idx]


def _tgen():
    a = torch.from_numpy(LL)
    return lambda idx: a[idx]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["psis", "tis"])
def test_loo_approximate_posterior_streaming(dtype, method):
    kw = dict(seed=6, chunk_size=CHUNK, pointwise=True, method=method)
    tres, jres = _both_calls(
        lambda: jpl.loo_approximate_posterior_streaming(_jgen(), LOG_P, LOG_Q, N, S,
                                                        dtype=getattr(jnp, dtype), **kw),
        lambda: tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S,
                                                        dtype=dtype, **kw))
    if dtype == "float64":
        assert_same_rows(tres, jres)
    else:
        assert_same_rows(tres, jres, tol=F32)
    assert str(tres) == str(jres)
    assert_array_equal(tres.approximate_posterior["log_q"], LOG_Q)


def test_streaming_equals_the_stored_form():
    # the float64 stream takes the exact scorer, as the in-memory form does
    set_precision("float64")
    stream = tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S, seed=8,
                                                     chunk_size=CHUNK, pointwise=True,
                                                     dtype="float64")
    idata = tpl.from_dict(posterior={"b": np.zeros((1, S))}, log_likelihood={"y": LL.T[None]})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stored = tpl.loo_approximate_posterior(idata, LOG_P, LOG_Q, seed=8, pointwise=True,
                                               reff=1.0)
    assert_allclose(stream.loo_i.values, stored.loo_i.values, rtol=1e-12, atol=1e-12)
    assert_allclose(stream["elpd_loo"], stored["elpd_loo"], rtol=1e-12, atol=1e-12)
    assert str(stream) == str(stored)


def test_streaming_checkpoint_needs_a_seed(tmp_path):
    ckpt = str(tmp_path / "ap.ckpt")
    with pytest.raises(ValueError, match="requires an explicit seed"):
        tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S,
                                                checkpoint_path=ckpt)

    class Stop(Exception):
        pass

    def bomb(done, total):
        if done == 2:
            raise Stop

    kw = dict(seed=2, chunk_size=CHUNK, pointwise=True, dtype="float64",
              checkpoint_path=ckpt, checkpoint_every=1)
    with pytest.raises(Stop), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S, on_chunk=bomb, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # another seed resamples other draws: the file's geometry refuses it
        with pytest.raises(ValueError, match="colgather"):
            tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S,
                                                    **dict(kw, seed=3))
        resumed = tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S, **kw)
        whole = tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P, LOG_Q, N, S, seed=2,
                                                        chunk_size=CHUNK, pointwise=True,
                                                        dtype="float64")
    assert_array_equal(resumed.loo_i.values, whole.loo_i.values)
    with pytest.raises(ValueError, match="must match n_draws"):
        tpl.loo_approximate_posterior_streaming(_tgen(), LOG_P[:-1], LOG_Q[:-1], N, S)
