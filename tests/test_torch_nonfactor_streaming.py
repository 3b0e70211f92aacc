"""``pyloo_tpu_torch.loo_nonfactor_streaming`` on the CPU.

A Gaussian process with a normal outcome, the latent function marginalised
out (the Stan User's Guide's model): ``N = 48`` inputs on [0, 10], 4 x 50
draws of ``(alpha, rho, sigma)`` jittered around the truth, each draw's
covariance ``alpha^2 exp(-d^2 / (2 rho^2)) + sigma^2 I`` made by a function
of the draw indices.  The entry holds to the plain reference
(``tests/plain_nonfactor.py``) and to ``pyloo_tpu.loo_nonfactor`` within
1e-12, equals ``loo_nonfactor`` on the same matrices in an InferenceData
bit for bit with the same warnings and report, in the ``cov``, ``prec``
and ``student_t`` forms, and equals itself chunked, unchunked and over a
mesh of four CPU shards bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.ops import nonfactor as jnf
from pyloo_tpu_torch.ops import nonfactor as tnf
from pyloo_tpu_torch.parallel import Mesh

from . import plain_nonfactor
from .torch_parity import F64

torch.set_num_threads(1)

N, CHAINS, DRAWS = 48, 4, 50
S = CHAINS * DRAWS


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"], tpl.rcParams["device.precision"]
    tpl.rcParams["device.device"] = "cpu"
    tpl.rcParams["device.precision"] = "float64"
    yield
    tpl.rcParams["device.device"], tpl.rcParams["device.precision"] = old


def _gp(seed=5):
    """``(y, theta, cov_fn)``: observations drawn from the GP at the truth
    (alpha 1, rho 1, sigma 0.3), the draws' ``(alpha, rho, sigma)`` the
    truth times ``exp(0.05 N(0, 1))``, and the covariances of draws
    ``idx``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 10.0, N))
    d2 = (x[:, None] - x[None, :]) ** 2
    eye = torch.eye(N, dtype=torch.float64)

    def cov(a, rho, s):
        return (a[:, None, None] ** 2 * torch.exp(-0.5 * d2 / rho[:, None, None] ** 2)
                + s[:, None, None] ** 2 * eye)

    one = torch.ones(1, dtype=torch.float64)
    truth = cov(one, one, 0.3 * one)[0].numpy()
    y = rng.multivariate_normal(np.zeros(N), truth)
    theta = torch.from_numpy(np.array([1.0, 1.0, 0.3]) * np.exp(0.05 * rng.normal(size=(S, 3))))
    return y, theta, lambda idx: cov(*theta[idx].unbind(1))


@pytest.fixture(scope="module")
def gp():
    y, theta, cov_fn = _gp()
    mats = cov_fn(torch.arange(S)).numpy()
    rng = np.random.default_rng(2)
    mu = rng.normal(0.0, 0.05, size=(S, N))
    df = rng.uniform(4.0, 30.0, size=S)
    return {"y": y, "cov_fn": cov_fn, "cov": mats, "prec": np.linalg.inv(mats), "mu": mu,
            "df": df}


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _caught(fn, *args, **kwargs):
    """``fn``'s result and the warnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = fn(*args, **kwargs)
    return res, [(w.category, str(w.message)) for w in caught]


def _streamed(gp, form="cov", model_type="normal", mats=None, df=None, **kwargs):
    mats = torch.from_numpy(gp[form] if mats is None else mats)
    return tpl.loo_nonfactor_streaming(
        gp["y"], torch.from_numpy(gp["mu"]), lambda idx: mats[idx], S, chains=CHAINS,
        form=form, model_type=model_type, df=gp["df"] if df is None else df, reff=1.0,
        pointwise=True, **kwargs)


def _idata(pl, gp, form, mats=None, df=None):
    mats = gp[form] if mats is None else mats
    return pl.from_dict(posterior={"mu": gp["mu"].reshape(CHAINS, DRAWS, N),
                                   form: mats.reshape(CHAINS, DRAWS, N, N),
                                   "df": (gp["df"] if df is None else df).reshape(CHAINS, DRAWS)},
                        observed_data={"y": gp["y"]})


def _in_idata(pl, gp, form="cov", model_type="normal", mats=None, df=None, **kwargs):
    names = {"cov_var_name": "cov"} if form == "cov" else {"prec_var_name": "prec"}
    return pl.loo_nonfactor(_idata(pl, gp, form, mats, df), pointwise=True, reff=1.0,
                            model_type=model_type, **names, **kwargs)


def _bitwise(got, want):
    assert got.index == list(want.index)
    for key in want.index:
        g, w = got[key], want[key]
        if hasattr(w, "values"):
            assert_array_equal(g.values, w.values, err_msg=key)
        else:
            assert g == w, key
    assert got.attrs == want.attrs
    assert str(got) == str(want)


def test_holds_to_the_plain_reference():
    y, _, cov_fn = _gp(seed=9)
    got = _quiet(tpl.loo_nonfactor_streaming, y, 0.0, cov_fn, S, chains=CHAINS, reff=1.0,
                 pointwise=True)
    want = plain_nonfactor.loo(y, 0.0, cov_fn, S)
    assert_allclose(got.loo_i.values, want["loo_i"], **F64)
    assert_allclose(got.pareto_k.values, want["k"], **F64)
    for key in ("elpd_loo", "p_loo", "se"):
        assert_allclose(got[key], want[key], **F64)


@pytest.mark.parametrize("form,model_type,method", [
    ("cov", "normal", "psis"), ("prec", "normal", "psis"), ("cov", "student_t", "psis"),
    ("prec", "student_t", "psis"), ("cov", "normal", "tis")])
def test_equals_loo_nonfactor_bit_for_bit(gp, form, model_type, method):
    want, want_w = _caught(_in_idata, tpl, gp, form, model_type, method=method)
    got, got_w = _caught(_streamed, gp, form, model_type, method=method)
    _bitwise(got, want)
    assert got_w == want_w
    assert ("Student-t" in str(got)) == (model_type == "student_t")


@pytest.mark.parametrize("form,model_type", [("cov", "normal"), ("prec", "normal"),
                                             ("cov", "student_t")])
def test_holds_to_pyloo_tpu(gp, form, model_type):
    """The estimates within 1e-12 end to end.  k's fit magnifies the
    densities' rounding: end to end k is held within 1e-10 (the largest
    gap here is 2.5e-12, in the Student-t form), and in two parts within
    1e-12: the conditional densities, and k of ``pyloo_tpu``'s PSIS on the
    port's densities."""
    want = _quiet(_in_idata, jpl, gp, form, model_type)
    got = _quiet(_streamed, gp, form, model_type)
    assert got.index == list(want.index)
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic", "looic_se"):
        assert_allclose(got[key], want[key], **F64)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    assert got["n_samples"] == want["n_samples"] and got["warning"] == want["warning"]
    assert np.abs(got.pareto_k.values - np.asarray(want.pareto_k.values)).max() < 1e-10
    df = (gp["df"],) if model_type == "student_t" else ()
    conditional = "mvt_conditional_loglik" if df else "mvn_conditional_loglik"
    ll = getattr(tnf, conditional)(gp["y"], gp["mu"], *df, **{form: gp[form]}).numpy()
    assert_allclose(ll, np.asarray(getattr(jnf, conditional)(gp["y"], gp["mu"], *df,
                                                            **{form: gp[form]})), **F64)
    assert_allclose(got.pareto_k.values, np.asarray(jpl.psislw(-ll.T, reff=1.0)[1]), **F64)


def test_faulty_draws_drop_as_loo_nonfactor_drops_them(gp):
    """Draw 3 not positive definite, draw 7 indefinite, draws 5 and 9 with
    df <= 0: the same draws go, with the same warnings and errors."""
    cov, df = gp["cov"].copy(), gp["df"].copy()
    cov[3] = -np.eye(N)
    cov[7, 0, 1] = cov[7, 1, 0] = 50.0
    df[5], df[9] = -1.0, 0.0
    for model_type in ("normal", "student_t"):
        want, want_w = _caught(_in_idata, tpl, gp, "cov", model_type, mats=cov, df=df)
        got, got_w = _caught(_streamed, gp, "cov", model_type, mats=cov, df=df)
        _bitwise(got, want)
        assert got_w == want_w
        text = " ".join(message for _, message in got_w)
        assert "Covariance factorization failed for 2 draws" in text
        assert ("Non-positive degrees of freedom for 2" in text) == (model_type == "student_t")
        assert got["n_samples"] == S - 2 - 2 * (model_type == "student_t")
    bad = np.full(S, -1.0)
    bad[0] = 5.0
    for mats, model_type, df_ in ((np.broadcast_to(-np.eye(N), (S, N, N)).copy(), "normal", df),
                                  (gp["cov"], "student_t", bad)):
        with pytest.raises(ValueError) as want:
            _quiet(_in_idata, tpl, gp, "cov", model_type, mats=mats, df=df_)
        with pytest.raises(ValueError) as got:
            _quiet(_streamed, gp, "cov", model_type, mats=mats, df=df_)
        assert str(got.value) == str(want.value)


def _chunks_seen(gp, mesh=None):
    """The streamed estimate and the (device, draws) of each call of the
    matrix function."""
    mats, seen = torch.from_numpy(gp["cov"]), []

    def fn(idx):
        seen.append((idx.device.type, idx.tolist()))
        return mats[idx]

    res = _quiet(tpl.loo_nonfactor_streaming, gp["y"], gp["mu"], fn, S, chains=CHAINS,
                 reff=1.0, pointwise=True, mesh=mesh)
    return res, seen


def test_chunked_and_meshed_equal_unchunked(gp, monkeypatch):
    whole, seen = _chunks_seen(gp)
    assert tnf.draws_per_chunk(N) >= S and [d for _, d in seen] == [list(range(S))]
    # seven draws a chunk: 29 chunks, the last one short
    monkeypatch.setattr(tnf, "_CHUNK_BUDGET_BYTES", 7 * tnf._MATRICES_PER_DRAW * 8 * N * N)
    chunked, seen = _chunks_seen(gp)
    assert [d for _, d in seen] == [list(range(a, min(a + 7, S))) for a in range(0, S, 7)]
    _bitwise(chunked, whole)
    meshed, seen_m = _chunks_seen(gp, Mesh(["cpu"] * 4))
    assert seen_m == seen
    _bitwise(meshed, whole)


def test_validation_errors(gp):
    y, mu, cov = gp["y"], gp["mu"], torch.from_numpy(gp["cov"])

    def fn(idx):
        return cov[idx]

    cases = [
        (dict(model_type="gamma"), ValueError, "model_type must be"),
        (dict(form="chol"), ValueError, "form must be"),
        (dict(matrix_fn=cov), TypeError, "matrix_fn must be a function"),
        (dict(n_draws=1), ValueError, "at least 2 draws"),
        (dict(chains=3), ValueError, "multiple of chains"),
        (dict(y=np.stack([y, y])), ValueError, "1-dimensional"),
        (dict(mu=mu[:, :5]), ValueError, "mu of shape"),
        (dict(model_type="student_t"), ValueError, "needs the draws' degrees of freedom"),
        (dict(model_type="student_t", df=np.ones(S + 1)), ValueError, "df of shape"),
        (dict(method="bogus"), ValueError, "Invalid method"),
        (dict(scale="bogus"), TypeError, "Valid scale values"),
        (dict(mesh=["cpu"]), TypeError, "mesh must be"),
        (dict(matrix_fn=lambda idx: cov[idx].numpy()), TypeError, "must return a torch.Tensor"),
        (dict(matrix_fn=lambda idx: cov[idx][:, :5]), ValueError, "returned shape"),
    ]
    for change, error, match in cases:
        kw = dict(y=y, mu=mu, matrix_fn=fn, n_draws=S, chains=CHAINS, reff=1.0)
        kw.update(change)
        with pytest.raises(error, match=match):
            _quiet(tpl.loo_nonfactor_streaming, kw.pop("y"), kw.pop("mu"), kw.pop("matrix_fn"),
                   kw.pop("n_draws"), **kw)


def test_exported_from_the_package_and_streaming():
    from pyloo_tpu_torch import streaming

    assert tpl.loo_nonfactor_streaming is streaming.loo_nonfactor_streaming
    assert "loo_nonfactor_streaming" in tpl.__all__
    assert "loo_nonfactor_streaming" in streaming.__all__


@pytest.mark.parametrize("n", [300, 700, 1100])
def test_the_merged_inverse_factor(n, monkeypatch):
    """The card's inverse factor beyond 256, merged from inverted diagonal
    blocks, here split unevenly (300 = 256 + 44; 1,100 = (512 + 256) +
    (256 + 76)) and taken on the CPU: it is the triangular solve's within
    rounding and lower triangular, and the conditional densities through
    it hold to ``pyloo_tpu``'s within 1e-12 with a failed factorisation's
    row ``-inf``.  The CPU itself takes the solve."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(3, n, n))
    cov = a @ a.transpose(0, 2, 1) / n + np.eye(n)
    chol = torch.linalg.cholesky(torch.from_numpy(cov))
    want = torch.linalg.solve_triangular(chol, torch.eye(n, dtype=torch.float64).expand_as(chol),
                                         upper=False)
    assert torch.equal(tnf._tri_inverse(chol), want)
    got = tnf._merged_inverse(chol)
    assert got.shape == chol.shape and torch.equal(torch.tril(got), got)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-14
    cov[1] = -np.eye(n)
    y, mu = rng.normal(size=n), rng.normal(0, 0.1, size=(3, n))
    monkeypatch.setattr(tnf, "_tri_inverse", tnf._merged_inverse)
    ll = tnf.mvn_conditional_loglik(y, mu, cov=cov).numpy()
    assert np.isneginf(ll[1]).all() and np.isfinite(ll[[0, 2]]).all()
    assert_allclose(ll, np.asarray(jnf.mvn_conditional_loglik(y, mu, cov=cov)), **F64)
