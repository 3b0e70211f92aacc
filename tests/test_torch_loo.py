"""``pyloo_tpu_torch.loo`` end to end against ``pyloo_tpu.loo`` on the CPU.

The same numpy arrays go through both packages: ``centered_eight`` is
loaded by ``pyloo_tpu`` and handed to the port through
``inference_data_from_numpy``; the synthetic matrices are drawn from a seeded
``np.random.default_rng``.  Float64 results agree within rtol and atol 1e-12
and print byte for byte alike; float32 results agree within rtol 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.ops import loo_kernels as jk
from pyloo_tpu_torch import containers as tcontainers
from pyloo_tpu_torch.ops import loo_kernels as tk
from pyloo_tpu_torch.ops.psis import tail_length
from pyloo_tpu_torch.parallel import apply_rowwise

F64 = dict(rtol=1e-12, atol=1e-12)
SUMMARY = ("elpd_loo", "se", "p_loo", "p_loo_se", "looic", "looic_se")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


@pytest.fixture
def precision():
    """Set ``device.precision`` in both packages for one test."""
    saved = (jpl.rcParams["device.precision"], tpl.rcParams["device.precision"])

    def set_(value):
        jpl.rcParams["device.precision"] = value
        tpl.rcParams["device.precision"] = value

    yield set_
    jpl.rcParams["device.precision"], tpl.rcParams["device.precision"] = saved


def _groups(idata):
    """A pyloo_tpu InferenceData in the converter's plain-numpy form."""
    return {
        group: {
            var: (np.asarray(da.values), da.dims, dict(da.coords))
            for var, da in getattr(idata, group).items()
        }
        for group in idata.groups()
    }


def _both(groups):
    """The same arrays as a pyloo_tpu and a pyloo_tpu_torch InferenceData."""
    jid = jpl.InferenceData(
        **{
            g: jpl.Dataset(
                {v: jpl.DataArray(a, d, c, v) for v, (a, d, c) in vs.items()}
            )
            for g, vs in groups.items()
        }
    )
    return jid, tpl.inference_data_from_numpy(groups)


def _eight():
    return _both(_groups(jpl.load_example_data("centered_eight")))


def _synthetic(obs_shape=(12,), chains=2, draws=300, seed=0, tail=False):
    rng = np.random.default_rng(seed)
    n = int(np.prod(obs_shape))
    ll = rng.normal(-1.0, 0.6, size=(chains, draws, n))
    if tail:
        ll[:, :, :3] = 2.0 * rng.standard_t(2, size=(chains, draws, 3)) - 1.0
    obs_dims = tuple(f"obs_{i}" for i in range(len(obs_shape)))
    coords = {obs_dims[0]: np.arange(obs_shape[0]) * 10}
    return _both(
        {
            "posterior": {
                "mu": (rng.normal(size=(chains, draws)), ("chain", "draw"), {}),
                "tau": (
                    rng.normal(size=(chains, draws, 3)),
                    ("chain", "draw", "tau_dim_0"),
                    {},
                ),
            },
            "log_likelihood": {
                "y": (
                    ll.reshape((chains, draws) + obs_shape),
                    ("chain", "draw") + obs_dims,
                    coords,
                )
            },
        }
    )


def _assert_same(tres, jres, tol=F64):
    assert list(tres.index) == list(jres.index)
    for key in tres.index:
        t, j = tres[key], jres[key]
        if hasattr(t, "values"):
            assert t.dims == j.dims
            assert_allclose(t.values, j.values, **tol)
        elif isinstance(t, (float, np.floating)):
            assert_allclose(t, j, **tol)
        else:
            assert t == j, key


def test_centered_eight_float64_matches_and_prints_alike(precision):
    precision("float64")
    jid, tid = _eight()
    jres, tres = jpl.loo(jid), tpl.loo(tid)
    _assert_same(tres, jres)
    assert str(tres) == str(jres)
    # the correctness baseline of VERDICT.md:7-9, to 4 decimals
    want = {"elpd_loo": -30.7807, "se": 1.3435, "p_loo": 0.9472, "looic": 61.5613}
    for key, value in want.items():
        assert round(tres[key], 4) == value


def test_centered_eight_float32(precision):
    precision("float32")
    jid, tid = _eight()
    jres, tres = jpl.loo(jid, pointwise=True), tpl.loo(tid, pointwise=True)
    assert str(tres) == str(jres)
    for key in SUMMARY:
        assert_allclose(tres[key], jres[key], rtol=1e-5)
    assert_allclose(tres.loo_i.values, jres.loo_i.values, rtol=1e-5, atol=1e-5)
    assert_allclose(tres.pareto_k.values, jres.pareto_k.values, atol=1e-3)
    assert tres.fast_path_degenerate == jres.fast_path_degenerate == 0


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
def test_pointwise_methods_and_scales(precision, method, scale):
    precision("float64")
    jid, tid = _eight()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = jpl.loo(jid, pointwise=True, method=method, scale=scale)
        tres = tpl.loo(tid, pointwise=True, method=method, scale=scale)
    _assert_same(tres, jres)
    assert str(tres) == str(jres)


def test_multidimensional_observations(precision):
    precision("float64")
    jid, tid = _synthetic(obs_shape=(3, 4), tail=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres, tres = jpl.loo(jid, pointwise=True), tpl.loo(tid, pointwise=True)
    _assert_same(tres, jres)
    assert tres.loo_i.dims == ("obs_0", "obs_1")
    np.testing.assert_array_equal(tres.pareto_k.coords["obs_0"], [0, 10, 20])
    assert str(tres) == str(jres)


def test_mixture_and_jacobian(precision):
    precision("float64")
    jid, tid = _eight()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres, tres = jpl.loo(jid, mixture=True), tpl.loo(tid, mixture=True)
        _assert_same(tres, jres)
        assert str(tres) == str(jres)
        jac = np.linspace(-0.5, 0.5, 8)
        jres = jpl.loo(jid, pointwise=True, jacobian=jac)
        tres = tpl.loo(tid, pointwise=True, jacobian=jac)
    _assert_same(tres, jres)
    assert str(tres) == str(jres)


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize(
    "case", ["high-k", "tis-low-ess", "nan", "mixture", "constant-pointwise"]
)
def test_warnings_match(precision, case):
    precision("float64")
    if case == "high-k":
        jid, tid = _synthetic(tail=True, seed=3)
        kwargs = {"pointwise": True}
    elif case == "tis-low-ess":
        jid, tid = _synthetic(tail=True, seed=4)
        kwargs = {"method": "tis"}
    elif case == "nan":
        jid, tid = _synthetic(seed=5)
        for idata in (jid, tid):
            idata.log_likelihood["y"].values[0, 3, 2] = np.nan
        kwargs = {}
    elif case == "mixture":
        jid, tid = _eight()
        kwargs = {"mixture": True, "pointwise": True}
    else:
        rng = np.random.default_rng(6)
        ll = np.full((2, 100, 5), -1.3)
        groups = {
            "posterior": {"mu": (rng.normal(size=(2, 100)), ("chain", "draw"), {})},
            "log_likelihood": {"y": (ll, ("chain", "draw", "obs"), {})},
        }
        jid, tid = _both(groups)
        kwargs = {"pointwise": True}
    want = _warnings_of(lambda: jpl.loo(jid, **kwargs))
    got = _warnings_of(lambda: tpl.loo(tid, **kwargs))
    assert want, "the case must raise a warning"
    assert got == want


def test_lazy_stack_goes_through_the_device_swap(monkeypatch, precision):
    precision("float64")
    jid, _ = _synthetic(obs_shape=(7,), seed=7)
    eager = tpl.loo(_both(_groups(jid))[1], pointwise=True)
    monkeypatch.setattr(tcontainers, "_LAZY_STACK_MIN_ELEMS", 0)
    tid = _both(_groups(jid))[1]
    stacked = tid.log_likelihood["y"].stack(__sample__=("chain", "draw"))
    assert stacked._lazy is not None
    lazy = tpl.loo(tid, pointwise=True)
    np.testing.assert_array_equal(lazy.loo_i.values, eager.loo_i.values)
    np.testing.assert_array_equal(lazy.pareto_k.values, eager.pareto_k.values)


def test_apply_rowwise_chunks_agree_with_one_chunk():
    rng = np.random.default_rng(8)
    ll = rng.normal(-1, 0.7, size=(37, 1000))
    ll[4] = rng.standard_t(2, size=1000) * 8.0 - 30.0  # deep tail: one decision, all rows
    m = tail_length(1000)
    x = torch.from_numpy(ll)
    one = apply_rowwise(lambda b: tk.loo_scores_psis(b, m), x)
    # 8 rows of 1000 float64 per chunk (4 live buffers): 5 chunks, one ragged
    many = apply_rowwise(lambda b: tk.loo_scores_psis(b, m), x, chunk_bytes=8 * 4 * 8000)
    for a, b in zip(one, many):
        assert a.shape == (37,)
        assert_allclose(b.numpy(), a.numpy(), **F64)


# The float32 envelope (port float32 against pyloo_tpu float64; 48 rows per
# cell, 192 at S=16000; ratios exp(-ll) with a Pareto tail of shape k),
# measured on the CPU, max |dk| / max |d elpd_i| over the non-degenerate rows:
#   k=0.3: S=1000 2.3e-6 / 7.6e-7   S=4000 2.0e-6 / 1.1e-6   S=16000 2.2e-6 / 2.0e-5
#   k=0.7: S=1000 1.9e-6 / 9.2e-7   S=4000 1.9e-6 / 8.4e-7   S=16000 5.0e-6 / 1.6e-6
#   k=1.0: S=1000 4.2e-6 / 7.9e-6   S=4000 3.1e-6 / 3.1e-6   S=16000 7.3e-6 / 1.5e-5
#   k=1.5: S=1000 3.3e-6 / 1.0e-5   S=4000 1.2e-2 / 8.8e-3   S=16000 1.3e-5 / 5.2e-5
# (pyloo_tpu's own float32 path at S=16000: 2.7e-6 / 1.4e-6, 6.0e-6 / 2.3e-6,
# 7.4e-6 / 1.3e-5, 1.8e-5 / 7.2e-5; no row of either package is degenerate.)
# pyloo_tpu's own float32 path shows the same 1.2e-2 / 8.8e-3 in the last
# cell (one row whose float32 fit differs from the float64 one), and the port
# stays within 1e-4 of it there: a property of the float32 fit, not the port.
# Bounds: tests/test_psis.py's float32 envelope (elpd 1e-4, k 2e-3), and for
# the last cell 3x its measured deviation.
@pytest.mark.parametrize("s", [1000, 4000, 16000])
@pytest.mark.parametrize("k_true", [0.3, 0.7, 1.0, 1.5])
def test_float32_envelope_against_float64(k_true, s):
    import jax.numpy as jnp

    rows = 192 if s == 16000 else 48
    rng = np.random.default_rng(int(k_true * 10) + s)
    ll = k_true * np.log(rng.uniform(size=(rows, s))) - 1.0
    m = tail_length(s)
    e64, k64, _ = (np.asarray(a) for a in jk.loo_scores_psis(jnp.asarray(ll), m))
    ll32 = ll.astype(np.float32)
    e32, k32, _, dg = (a.numpy() for a in tk.loo_scores_psis_fast(torch.from_numpy(ll32), m))
    je32 = np.asarray(jk.loo_scores_psis_fast(jnp.asarray(ll32), m)[0])
    ok = ~dg & np.isfinite(k64)
    assert ok.sum() == rows
    e_tol, k_tol = (3e-2, 4e-2) if (k_true, s) == (1.5, 4000) else (1e-4, 2e-3)
    assert np.abs(e32 - e64)[ok].max() <= e_tol
    assert np.abs(k32 - k64)[ok].max() <= k_tol
    assert_allclose(e32, je32, rtol=1e-4, atol=1e-4)


def test_unported_options_raise(precision):
    precision("float64")
    _, tid = _eight()
    # moment matching came with the model wrappers
    # (tests/test_torch_moment_match.py); without a model it raises as in pyloo_tpu
    with pytest.raises(ValueError, match="model_obj"):
        tpl.loo(tid, pointwise=True, moment_match=True)
    with pytest.raises(ValueError, match="Invalid method"):
        tpl.loo(tid, method="bogus")
    # a path that names no .csv is read as netCDF, as in pyloo_tpu
    for pkg in (jpl, tpl):
        with pytest.raises(FileNotFoundError, match="posterior.nc"):
            pkg.loo("posterior.nc")


def test_result_container_behaves_like_a_series(precision):
    precision("float64")
    jid, tid = _eight()
    jres, tres = jpl.loo(jid, pointwise=True), tpl.loo(tid, pointwise=True)
    assert "pareto_k" in tres and "ess" not in tres
    assert tres.n_samples == tres["n_samples"] == 2000
    assert tres.good_k == jres.good_k
    assert list(tres) == [tres[key] for key in tres.index]
    dup = tres.copy()
    dup["elpd_loo"] = 0.0
    assert tres["elpd_loo"] != 0.0
    assert repr(tres) == str(tres)
    with pytest.raises(AttributeError):
        tres.not_a_row
