"""Subsampled LOO in ``pyloo_tpu_torch`` against ``pyloo_tpu`` on the CPU.

The estimators and the index draws are the JAX package's numpy code, copied:
the same inputs give equal estimates and the same seed the same rows.  One
seeded model (``torch_parity.synthetic``: 150 observations, 2 x 150 draws,
three heavy-tailed rows, a posterior) goes through ``loo_subsample`` and
``update_subsample`` of both packages for every approximation x estimator,
with explicit indices and with the ``log_p`` / ``log_q`` correction, and
through ``loo_compare(observations=)``; a seeded numpy matrix through
``loo_subsample_streaming``.  Float64 rows agree within rtol and atol 1e-12
and the reports byte for byte; float32 within rtol and atol 1e-4 (the
estimators sum a few hundred float32 pointwise values).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu.estimators as jest
import pyloo_tpu_torch as tpl
import pyloo_tpu_torch.estimators as t_est
from pyloo_tpu.approximations import PLPDApproximation as JPLPD
from pyloo_tpu.approximations import compute_point_estimate as j_point, thin_draws as j_thin
from pyloo_tpu_torch.approximations import PLPDApproximation as TPLPD
from pyloo_tpu_torch.approximations import compute_point_estimate as t_point, thin_draws as t_thin

from .torch_parity import F64, assert_same_rows, set_precision, synthetic

F32 = dict(rtol=1e-4, atol=1e-4)
APPROXIMATIONS = ["plpd", "lpd", "tis", "sis"]
ESTIMATORS = ["diff_srs", "hh_pps", "srs"]


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
    return synthetic(obs_shape=(150,), chains=2, draws=150, seed=4, tail=True)


def _both_calls(fn_j, fn_t, np_seed=None):
    """The same call through both packages, warnings recorded (numpy's
    global stream seeded alike first when ``np_seed`` is given)."""
    out = []
    for fn in (fn_j, fn_t):
        if np_seed is not None:
            np.random.seed(np_seed)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fn()
        out.append((res, [str(x.message) for x in w]))
    (jres, jw), (tres, tw) = out
    assert tw == jw
    return tres, jres


# --------------------------------------------------------------------------
# estimators and index draws (numpy, copied)
# --------------------------------------------------------------------------


def test_estimators_match():
    rng = np.random.default_rng(0)
    y_approx = rng.normal(-1.0, 0.3, size=400)
    idx = np.sort(rng.choice(400, 60, replace=False))
    y = y_approx[idx] + rng.normal(0, 0.05, size=60)
    z = jest.compute_sampling_probabilities(y_approx)
    assert_array_equal(t_est.compute_sampling_probabilities(y_approx), z)
    m_i = rng.integers(1, 3, size=60)
    pairs = [
        (t_est.diff_srs_estimate(y, y_approx, idx), jest.diff_srs_estimate(y, y_approx, idx)),
        (t_est.srs_estimate(y, 400), jest.srs_estimate(y, 400)),
        (t_est.hansen_hurwitz_estimate(z[idx], m_i, y, 400),
         jest.hansen_hurwitz_estimate(z[idx], m_i, y, 400)),
        (t_est.DifferenceEstimator().estimate(y_approx=y_approx, y=y[:1], y_idx=idx[:1]),
         jest.DifferenceEstimator().estimate(y_approx=y_approx, y=y[:1], y_idx=idx[:1])),
    ]
    for got, want in pairs:
        for field in ("y_hat", "v_y_hat", "hat_v_y", "m", "N", "subsampling_SE"):
            assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    for name in ESTIMATORS:
        assert type(t_est.get_estimator(name)).__name__ == type(jest.get_estimator(name)).__name__
    with pytest.raises(ValueError, match="Unknown estimator"):
        t_est.get_estimator("bogus")
    with pytest.raises(ValueError, match="positive"):
        t_est.hansen_hurwitz_estimate(np.zeros(3), np.ones(3), np.ones(3), 10)
    assert isinstance(t_est.SimpleRandomSamplingEstimator(), t_est.EstimatorProtocol)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_subsample_indices_same_rows_for_the_same_seed(estimator):
    approx = np.random.default_rng(1).normal(-1.0, 0.5, size=500)
    got = t_est.subsample_indices(estimator, approx, 80, rng=np.random.default_rng(9))
    want = jest.subsample_indices(estimator, approx, 80, rng=np.random.default_rng(9))
    assert_array_equal(got.idx, want.idx)
    assert_array_equal(got.m_i, want.m_i)
    np.random.seed(3)  # the reference's global stream when no rng is given
    got = t_est.subsample_indices(estimator, approx, 80)
    np.random.seed(3)
    want = jest.subsample_indices(estimator, approx, 80)
    assert_array_equal(got.idx, want.idx)
    diff = t_est.compare_indices(got, t_est.SubsampleIndices(idx=got.idx[:40], m_i=got.m_i[:40]))
    assert set(diff) == {"new", "add"} and len(diff["add"].idx) == 40


def test_subsample_indices_validation():
    with pytest.raises(ValueError, match="cannot exceed"):
        t_est.subsample_indices("srs", np.ones(5), 6)
    with pytest.raises(ValueError, match="Unknown estimator"):
        t_est.subsample_indices("bogus", np.ones(5), 2)


# --------------------------------------------------------------------------
# approximations
# --------------------------------------------------------------------------


def test_approximation_helpers(model):
    jid, tid = model
    jpost, tpost = jid.posterior, tid.posterior
    for (name, got), (_, want) in zip(t_point(tpost).items(), j_point(jpost).items()):
        assert_allclose(got, want, err_msg=name, **F64)
    got = t_thin(tid.log_likelihood.y, 100)
    want = j_thin(jid.log_likelihood.y, 100)
    assert got.sizes["__sample__"] == want.sizes["__sample__"] == 100
    assert_array_equal(got.values, np.asarray(want.values))
    with pytest.raises(ValueError, match="cannot exceed"):
        t_thin(tid.log_likelihood.y, 1000)


def test_plpd_with_a_likelihood_function(model):
    # the reference's per-observation host call at the posterior mean
    jid, tid = model
    data = np.random.default_rng(5).normal(size=150)

    def loglik(obs, point):
        return float(-0.5 * (obs[0] - point["mu"]) ** 2 - np.sum(point["tau"] ** 2))

    got = TPLPD(tid.posterior, loglik, data).compute_approximation(tid.log_likelihood.y)
    want = JPLPD(jid.posterior, loglik, data).compute_approximation(jid.log_likelihood.y)
    assert_allclose(got, want, **F64)
    with pytest.raises(ValueError, match="No posterior"):
        TPLPD().compute_approximation(tid.log_likelihood.y)


# --------------------------------------------------------------------------
# loo_subsample and update_subsample
# --------------------------------------------------------------------------


@pytest.mark.parametrize("approximation", APPROXIMATIONS)
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_loo_subsample_every_approximation_and_estimator(model, approximation, estimator):
    set_precision("float64")
    jid, tid = model
    kw = dict(observations=40, loo_approximation=approximation, estimator=estimator, seed=7,
              pointwise=True)
    tres, jres = _both_calls(lambda: jpl.loo_subsample(jid, **kw),
                             lambda: tpl.loo_subsample(tid, **kw))
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)
    assert_array_equal(tres.estimates.indices.idx, jres.estimates.indices.idx)


def test_loo_subsample_explicit_indices_and_update(model):
    set_precision("float64")
    jid, tid = model
    idx = np.arange(0, 150, 5)
    tres, jres = _both_calls(lambda: jpl.loo_subsample(jid, observations=idx, seed=1),
                             lambda: tpl.loo_subsample(tid, observations=idx, seed=1))
    assert_same_rows(tres, jres)
    assert tres["subsample_size"] == 30
    # update_subsample draws the new subsample from numpy's global stream
    tup, jup = _both_calls(lambda: jpl.update_subsample(jres, observations=80),
                           lambda: tpl.update_subsample(tres, observations=80), np_seed=12)
    assert_same_rows(tup, jup)
    assert tup["subsample_size"] == 80 and str(tup) == str(jup)
    tup, jup = _both_calls(lambda: jpl.update_subsample(jres, estimator="srs"),
                           lambda: tpl.update_subsample(tres, estimator="srs"), np_seed=13)
    assert_same_rows(tup, jup)
    with pytest.raises(TypeError, match="ELPDData"):
        tpl.update_subsample({"elpd_loo": 1.0})


def test_loo_subsample_posterior_correction(model):
    set_precision("float64")
    jid, tid = model
    rng = np.random.default_rng(8)
    log_p, log_q = rng.normal(size=300), rng.normal(size=300)
    kw = dict(observations=50, log_p=log_p, log_q=log_q, seed=4, pointwise=True)
    tres, jres = _both_calls(lambda: jpl.loo_subsample(jid, **kw),
                             lambda: tpl.loo_subsample(tid, **kw))
    assert_same_rows(tres, jres)
    assert tres.seed == 4 and tres.resample_method == "psis"
    tup, jup = _both_calls(lambda: jpl.update_subsample(jres, observations=70),
                           lambda: tpl.update_subsample(tres, observations=70))
    assert_same_rows(tup, jup)
    with pytest.raises(ValueError, match="same length"):
        tpl.loo_subsample(tid, observations=10, log_p=log_p, log_q=log_q[:-1])


def test_loo_subsample_float32(model):
    set_precision("float32")
    jid, tid = model
    kw = dict(observations=60, loo_approximation="lpd", seed=2, pointwise=True)
    tres, jres = _both_calls(lambda: jpl.loo_subsample(jid, **kw),
                             lambda: tpl.loo_subsample(tid, **kw))
    set_precision("float64")
    assert_same_rows(tres, jres, tol=F32)
    assert str(tres) == str(jres)


def test_loo_subsample_options_and_errors(model):
    set_precision("float64")
    jid, tid = model
    full = tpl.loo_subsample(tid, observations=None, reff=1.0)
    assert_same_rows(full, jpl.loo_subsample(jid, observations=None, reff=1.0))
    for bad, err, match in [
        (dict(observations=0), ValueError, "between 1 and 150"),
        (dict(observations=np.array([0, 150])), ValueError, "between 0 and 149"),
        (dict(observations=np.array([0.5])), TypeError, "integers"),
        (dict(observations="10"), TypeError, "integer"),
        (dict(loo_approximation="bogus"), ValueError, "Invalid loo_approximation"),
        (dict(estimator="bogus"), ValueError, "Invalid estimator"),
    ]:
        with pytest.raises(err, match=match):
            tpl.loo_subsample(tid, **bad)
    # no posterior group: PLPD warns and takes the LPD
    no_post = tpl.from_dict(log_likelihood={"y": tid.log_likelihood.y.values})
    j_no_post = jpl.from_dict(log_likelihood={"y": tid.log_likelihood.y.values})
    tres, jres = _both_calls(lambda: jpl.loo_subsample(j_no_post, observations=30, seed=0,
                                                       reff=1.0),
                             lambda: tpl.loo_subsample(no_post, observations=30, seed=0,
                                                       reff=1.0))
    assert_same_rows(tres, jres)


def test_loo_subsample_nan_rows_are_cleaned_before_the_approximation(model):
    set_precision("float64")
    jid, tid = model
    ll = tid.log_likelihood.y.values.copy()
    ll[:, :5, 3] = np.nan
    post = {"mu": tid.posterior.mu.values}
    tres, jres = _both_calls(
        lambda: jpl.loo_subsample(jpl.from_dict(posterior=post, log_likelihood={"y": ll}),
                                  observations=40, loo_approximation="lpd", seed=3),
        lambda: tpl.loo_subsample(tpl.from_dict(posterior=post, log_likelihood={"y": ll}),
                                  observations=40, loo_approximation="lpd", seed=3),
    )
    assert_same_rows(tres, jres)


def test_loo_compare_with_observations():
    set_precision("float64")
    models = [synthetic(obs_shape=(60,), chains=2, draws=100, seed=s) for s in (1, 2)]
    jd = {f"m{i}": m[0] for i, m in enumerate(models)}
    td = {f"m{i}": m[1] for i, m in enumerate(models)}
    for estimator in (None, "srs"):
        table, frame = _both_calls(
            lambda: jpl.loo_compare(jd, observations=30, estimator=estimator),
            lambda: tpl.loo_compare(td, observations=30, estimator=estimator), np_seed=21)
        assert table.index == list(frame.index)
        for column in ("rank", "elpd_loo", "p_loo", "se", "dse", "warning", "scale"):
            got, want = table[column], frame[column].to_numpy()
            if want.dtype.kind == "f":
                assert_allclose(got, want, err_msg=column, equal_nan=True, **F64)
            else:
                assert got.tolist() == want.tolist(), column


# --------------------------------------------------------------------------
# loo_subsample_streaming
# --------------------------------------------------------------------------

N, S, CHUNK = 203, 300, 64
_rng = np.random.default_rng(17)
LL = _rng.normal(-1.0, 0.6, size=(N, S))
LL[:3] = 2.0 * _rng.standard_t(2, size=(3, S)) - 1.0


def _jgen():
    a = jnp.asarray(LL)
    return lambda idx: a[idx]


def _tgen():
    a = torch.from_numpy(LL)
    return lambda idx: a[idx]


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_loo_subsample_streaming(estimator):
    kw = dict(observations=60, estimator=estimator, seed=5, chunk_size=CHUNK, pointwise=True)
    tres, jres = _both_calls(lambda: jpl.loo_subsample_streaming(_jgen(), N, S,
                                                                 dtype=jnp.float64, **kw),
                             lambda: tpl.loo_subsample_streaming(_tgen(), N, S,
                                                                 dtype="float64", **kw))
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)
    assert tres.estimates.loo_approximation == "lpd"
    # the approximation kept on the result: an update makes only the new rows
    tup, jup = _both_calls(lambda: jpl.update_subsample(jres, observations=100),
                           lambda: tpl.update_subsample(tres, observations=100), np_seed=6)
    assert_same_rows(tup, jup)
    assert_array_equal(tup.estimates.stream["elpd_loo_approximation"],
                       tres.estimates.stream["elpd_loo_approximation"])


def test_loo_subsample_streaming_float32_and_custom_approximation():
    kw = dict(observations=80, seed=2, chunk_size=CHUNK)
    tres, jres = _both_calls(lambda: jpl.loo_subsample_streaming(_jgen(), N, S,
                                                                 dtype=jnp.float32, **kw),
                             lambda: tpl.loo_subsample_streaming(_tgen(), N, S,
                                                                 dtype="float32", **kw))
    assert_same_rows(tres, jres, tol=F32)
    approx = np.random.default_rng(3).normal(-1.3, 0.2, size=N)
    tres = tpl.loo_subsample_streaming(_tgen(), N, S, elpd_loo_approximation=approx, **kw)
    jres = jpl.loo_subsample_streaming(_jgen(), N, S, elpd_loo_approximation=approx,
                                       dtype=jnp.float64, **kw)
    assert_same_rows(tres, jres)
    assert tres.estimates.loo_approximation == "custom"
    with pytest.raises(ValueError, match="length 203"):
        tpl.loo_subsample_streaming(_tgen(), N, S, 50, elpd_loo_approximation=approx[:-1])
    with pytest.raises(ValueError, match="between 1 and 203"):
        tpl.loo_subsample_streaming(_tgen(), N, S, observations=N + 1)
    with pytest.raises(ValueError, match="Invalid estimator"):
        tpl.loo_subsample_streaming(_tgen(), N, S, 50, estimator="bogus")
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.loo_subsample_streaming(_tgen(), N, S, 50, mesh=object())
