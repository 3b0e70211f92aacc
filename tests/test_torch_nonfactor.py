"""``pyloo_tpu_torch.loo_nonfactor`` against ``pyloo_tpu``'s on the CPU.

On ``tests/test_nonfactor.py``'s fixture (N = 12 observations, 2 x 150
draws of a mean vector and a covariance jittered around the truth), with a
few draws made singular or given non-positive degrees of freedom: both
conditional log-likelihoods within 1e-12, ``loo_nonfactor``'s estimates
within 1e-12 in the ``cov``, ``prec`` and ``student_t`` forms and under
``sis`` / ``tis``, a chunked run equal to an unchunked one, the same
warnings and errors, and the MVN and MVT reports byte for byte.
"""

import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.ops import nonfactor as jnf
from pyloo_tpu_torch.ops import nonfactor as tnf

from .torch_parity import F64

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


@pytest.fixture(scope="module")
def draws():
    """``tests/test_nonfactor.py``'s ``mvn_idata`` fixture, as arrays."""
    rng = np.random.default_rng(42)
    N, C, T = 12, 2, 150
    A = rng.normal(size=(N, N)) * 0.3
    true_cov = A @ A.T + np.eye(N)
    true_mu = rng.normal(size=N)
    y = rng.multivariate_normal(true_mu, true_cov)
    mus = true_mu[None, None, :] + rng.normal(0, 0.05, size=(C, T, N))
    covs = np.empty((C, T, N, N))
    for c in range(C):
        for t in range(T):
            jitter = rng.normal(0, 0.01, size=(N, N))
            covs[c, t] = true_cov + (jitter + jitter.T) / 2 + 0.01 * np.eye(N)
    df = 3.0 + 27.0 * np.random.default_rng(0).uniform(size=(C, T))
    return y, mus, covs, df


def _flat(mus, covs, df):
    C, T, N = mus.shape
    return mus.reshape(C * T, N), covs.reshape(C * T, N, N).copy(), df.reshape(C * T).copy()


def _with_faults(mus, covs, df):
    """Draw 3 not positive definite, draw 7 indefinite, draws 5 and 9 with
    df <= 0."""
    mu, cov, d = _flat(mus, covs, df)
    N = mu.shape[1]
    cov[3] = -np.eye(N)
    cov[7, 0, 1] = cov[7, 1, 0] = 50.0
    d[5], d[9] = -1.0, 0.0
    return mu, cov, d


def _same_ll(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isneginf(got) == np.isneginf(want)).all()
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    assert_allclose(got[finite], want[finite], **F64)


@pytest.mark.parametrize("form", ["cov", "prec"])
def test_conditional_logliks_match_pyloo_tpu(draws, form):
    y, mus, covs, df = draws
    mu, cov, d = _with_faults(mus, covs, df)
    mats = {"cov": cov} if form == "cov" else {"prec": np.linalg.inv(cov)}
    want = np.asarray(jnf.mvn_conditional_loglik(y, mu, **mats))
    got = tnf.mvn_conditional_loglik(y, mu, **mats)
    assert got.dtype == torch.float64 and got.shape == mu.shape
    _same_ll(got.numpy(), want)
    if form == "cov":  # the draws that cannot be factorised are -inf rows
        assert np.isneginf(want[[3, 7]]).all() and np.isfinite(np.delete(want, [3, 7], 0)).all()
    want = np.asarray(jnf.mvt_conditional_loglik(y, mu, d, **mats))
    _same_ll(tnf.mvt_conditional_loglik(y, torch.from_numpy(mu), d, **mats).numpy(), want)
    assert np.isneginf(want[[5, 9]]).all()


def test_chunked_equals_unchunked(draws, monkeypatch):
    y, mus, covs, df = draws
    mu, cov, d = _flat(mus, covs, df)
    n = mu.shape[1]
    # the module's own budget holds every draw in one chunk
    assert tnf.draws_per_chunk(n) >= len(mu)
    whole = tnf.mvn_conditional_loglik(y, mu, cov=cov)
    whole_t = tnf.mvt_conditional_loglik(y, mu, d, cov=cov)
    idata = tpl.from_dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y})
    single = _quiet(tpl.loo_nonfactor, idata, pointwise=True, reff=1.0)
    # a budget of seven draws' matrices: 43 chunks, the last one short
    monkeypatch.setattr(tnf, "_CHUNK_BUDGET_BYTES", 7 * tnf._MATRICES_PER_DRAW * 8 * n * n)
    assert tnf.draws_per_chunk(n) == 7
    assert_allclose(tnf.mvn_conditional_loglik(y, mu, cov=cov).numpy(), whole.numpy(),
                    rtol=0, atol=0)
    assert_allclose(tnf.mvt_conditional_loglik(y, mu, d, cov=cov).numpy(), whole_t.numpy(),
                    rtol=0, atol=0)
    chunked = _quiet(tpl.loo_nonfactor, idata, pointwise=True, reff=1.0)
    assert chunked["elpd_loo"] == single["elpd_loo"]
    assert_allclose(chunked.loo_i.values, single.loo_i.values, rtol=0, atol=0)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _both(posterior, y, **kwargs):
    """``loo_nonfactor`` of both packages on the same arrays, with the
    warnings each raised."""
    out = []
    for pl in (jpl, tpl):
        idata = pl.from_dict(posterior=posterior, observed_data={"y": y})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = pl.loo_nonfactor(idata, **kwargs)
        out.append((res, [(w.category, str(w.message)) for w in caught]))
    return out


def _same_result(got, want):
    assert got.index == list(want.index)
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic", "looic_se"):
        assert_allclose(got[key], want[key], **F64)
    for key in ("n_samples", "n_data_points", "warning", "scale"):
        assert got[key] == want[key]
    for key in ("loo_i", "pareto_k", "ess"):
        if key in want.index:
            assert got[key].dims == want[key].dims
            assert_allclose(got[key].values, want[key].values, **F64)
    assert got.attrs == want.attrs


@pytest.mark.parametrize(
    "form,method",
    [("cov", "psis"), ("prec", "psis"), ("student_t", "psis"), ("cov", "sis"),
     ("cov", "tis"), ("student_t", "tis")],
)
def test_loo_nonfactor_matches_pyloo_tpu(draws, form, method):
    y, mus, covs, df = draws
    posterior = {"mu": mus}
    kwargs = dict(pointwise=True, method=method)
    if form == "prec":
        posterior["prec"] = np.linalg.inv(covs)
    else:
        posterior["cov"] = covs
    if form == "student_t":
        posterior["df"] = df
        kwargs["model_type"] = "student_t"
    (want, want_w), (got, got_w) = _both(posterior, y, **kwargs)
    _same_result(got, want)
    assert got_w == want_w
    assert str(got) == str(want)  # the MVN and MVT reports, byte for byte
    assert ("Student-t" in str(got)) == (form == "student_t")


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
def test_scales_and_reff_match_pyloo_tpu(draws, scale):
    y, mus, covs, _ = draws
    (want, _), (got, _) = _both({"mu": mus, "cov": covs}, y, scale=scale, reff=0.5)
    _same_result(got, want)
    assert str(got) == str(want)


def test_faulty_draws_are_dropped_as_in_pyloo_tpu(draws):
    """Singular covariances and df <= 0: the draws go, each with its warning."""
    y, mus, covs, df = draws
    C, T, N = mus.shape
    mu, cov, d = _with_faults(mus, covs, df)
    posterior = {"mu": mus, "cov": cov.reshape(C, T, N, N), "df": d.reshape(C, T)}
    for model_type in ("normal", "student_t"):
        (want, want_w), (got, got_w) = _both(posterior, y, pointwise=True, reff=1.0,
                                             model_type=model_type)
        _same_result(got, want)
        assert got_w == want_w
        text = " ".join(message for _, message in got_w)
        assert "Covariance factorization failed for" in text
        assert ("Non-positive degrees of freedom for 2" in text) == (model_type == "student_t")


def test_diagonal_cov_matches_factorised_loo():
    """With a diagonal covariance the conditionals are the marginals
    (``tests/test_nonfactor.py``'s check, on the port)."""
    rng = np.random.default_rng(1)
    N, C, T = 10, 2, 200
    y = rng.normal(size=N)
    mus = rng.normal(0, 0.1, size=(C, T, N))
    sig2 = 1.0 + 0.1 * rng.uniform(size=(C, T))
    covs = np.einsum("ct,ij->ctij", sig2, np.eye(N))
    res_nf = _quiet(tpl.loo_nonfactor,
                    tpl.from_dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                    pointwise=True, reff=1.0)
    ll = -0.5 * np.log(2 * np.pi * sig2[..., None]) - 0.5 * (y - mus) ** 2 / sig2[..., None]
    res_f = _quiet(tpl.loo, tpl.from_dict(posterior={"mu": mus}, log_likelihood={"obs": ll}),
                   pointwise=True, reff=1.0)
    assert_allclose(res_nf["elpd_loo"], res_f["elpd_loo"], rtol=1e-8)
    assert_allclose(res_nf.loo_i.values, res_f.loo_i.values, rtol=1e-8)


def _error(fn):
    try:
        _quiet(fn)
    except Exception as err:  # noqa: BLE001 - the comparison is the point
        return type(err), str(err)
    return None


def test_errors_match_pyloo_tpu(draws):
    y, mus, covs, df = draws
    cases = {
        "missing mu": (dict(posterior={"cov": covs}, observed_data={"y": y}), {}),
        "mu by name": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                       {"mu_var_name": "missing"}),
        "no matrix": (dict(posterior={"mu": mus}, observed_data={"y": y}), {}),
        "cov by name": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                        {"cov_var_name": "sigma"}),
        "prec by name": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                         {"prec_var_name": "omega"}),
        "no df": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                  {"model_type": "student_t"}),
        "model_type": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                       {"model_type": "gamma"}),
        "method": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                   {"method": "bogus"}),
        "scale": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                  {"scale": "bogus"}),
        "no observed_data": (dict(posterior={"mu": mus, "cov": covs}), {}),
        "var_name": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}),
                     {"var_name": "z"}),
        "two observed": (dict(posterior={"mu": mus, "cov": covs},
                              observed_data={"y": y, "x": y}), {}),
        "mu width": (dict(posterior={"mu": mus[..., :5], "cov": covs}, observed_data={"y": y}),
                     {}),
        "matrix shape": (dict(posterior={"mu": mus, "cov": covs[..., :5]},
                              observed_data={"y": y}), {}),
        "2-d y": (dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y[None]}), {}),
    }
    for what, (groups, kwargs) in cases.items():
        want = _error(lambda: jpl.loo_nonfactor(jpl.from_dict(**groups), **kwargs))
        got = _error(lambda: tpl.loo_nonfactor(tpl.from_dict(**groups), **kwargs))
        assert want is not None, what
        assert got == want, (what, got, want)


def test_structure_warnings_match_pyloo_tpu(draws):
    """The model-specification warning always, and the structure warnings of
    ``_validate_model_structure`` before the errors they precede."""
    y, mus, covs, _ = draws
    for posterior, kwargs in (({"cov": covs}, {}), ({"mu": mus}, {}),
                              ({"mu": mus, "cov": covs}, {"model_type": "student_t"})):
        caught = []
        for pl in (jpl, tpl):
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                with pytest.raises(ValueError):
                    pl.loo_nonfactor(pl.from_dict(posterior=posterior, observed_data={"y": y}),
                                     **kwargs)
            caught.append([str(w.message) for w in got])
        assert caught[1] == caught[0] and len(caught[0]) == 2


def test_cuda_without_a_card_raises(draws):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    y, mus, covs, _ = draws
    tpl.rcParams["device.device"] = "cuda"
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(tpl.loo_nonfactor,
                   tpl.from_dict(posterior={"mu": mus, "cov": covs}, observed_data={"y": y}))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnf.mvn_conditional_loglik(y, mus[0], cov=covs[0])
    finally:
        tpl.rcParams["device.device"] = "cpu"
