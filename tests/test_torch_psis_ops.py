"""pyloo_tpu_torch.ops.{lse,psis} against pyloo_tpu on the same numpy inputs.

Float64 within rtol 1e-12 and atol 1e-12, the bar of
``tests/test_reference_parity.py``.  Float32 within rtol and atol 2e-5
(k, log-sigma): the two packages evaluate float32 transcendentals with
different approximations (an ulp apart) and take the M-term profile sums in
another order, so agreement is bounded by ~M * eps_f32 = 60 * 1.2e-7 ~ 7e-6;
2e-5 leaves a factor 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pyloo_tpu.ops import lse as jlse
from pyloo_tpu.ops import psis as jpsis
from pyloo_tpu_torch import rcParams
from pyloo_tpu_torch.ops import lse as tlse
from pyloo_tpu_torch.ops import psis as tpsis

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("b_inv", [None, 4000])
def test_logsumexp(b_inv):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 300)) * 20
    x[1] = -np.inf  # all -inf row: the guard keeps it -inf, not NaN
    x[2, :100] = -np.inf
    got = tlse.logsumexp(torch.from_numpy(x), dim=1, b_inv=b_inv)
    want = jlse.logsumexp(jnp.asarray(x), axis=1, b_inv=b_inv)
    assert_allclose(_np(got), _np(want), **F64)
    got0 = tlse.logsumexp(torch.from_numpy(x[2:]), dim=0, keepdim=True)
    assert_allclose(_np(got0), _np(jlse.logsumexp(jnp.asarray(x[2:]), 0, keepdims=True)), **F64)


@pytest.mark.parametrize("s,reff", [(8, 1.0), (1000, 1.0), (4000, 0.7), (32768, 1.0)])
def test_tail_length(s, reff):
    assert tpsis.tail_length(s, reff) == jpsis.tail_length(s, reff)


def _log_exceedances(b, m, seed):
    """Descending log exceedances, -inf beyond each row's count n."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(-0.3, 1.2, size=(b, 1))
    u = rng.uniform(size=(b, m))
    y = np.where(np.abs(k) < 1e-8, -np.log(u), (u ** -k - 1) / k)
    y = -np.sort(-y / y.max(axis=1, keepdims=True), axis=1)  # max-shifted, <= 1
    n = rng.integers(5, m + 1, size=b)
    n[0] = m
    n[1] = 3  # too short to smooth upstream, still fitted
    slot = np.arange(m)[None, :]
    log_y = np.where(slot < n[:, None], np.log(y), -np.inf)
    return log_y, n.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gpdfit_batch_signed_log(dtype):
    log_y, n = _log_exceedances(12, 60, seed=1)
    log_y = log_y.astype(dtype)
    q_desc = np.clip(n - 1 - np.clip((n + 2) // 4 - 1, 0, 59), 0, 59)
    log_quart = log_y[np.arange(12), q_desc]
    tol = F64 if dtype == "float64" else F32
    got = tpsis._gpdfit_batch(
        torch.from_numpy(log_y), torch.from_numpy(n),
        log_quart=torch.from_numpy(log_quart), log_last=torch.from_numpy(log_y[:, 0]),
    )
    want = jax.jit(jpsis._gpdfit_batch)(
        jnp.asarray(log_y), jnp.asarray(n),
        log_quart=jnp.asarray(log_quart), log_last=jnp.asarray(log_y[:, 0]),
    )
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **tol)


def test_gpdfit_batch_ascending_anchors():
    # no anchors given: they are gathered from ascending, left-aligned rows
    log_y, n = _log_exceedances(6, 40, seed=2)
    asc = np.full_like(log_y, -np.inf)
    for i, ni in enumerate(n):
        asc[i, :ni] = np.sort(log_y[i, :ni])
    got = tpsis._gpdfit_batch(torch.from_numpy(asc), torch.from_numpy(n))
    want = jax.jit(jpsis._gpdfit_batch)(jnp.asarray(asc), jnp.asarray(n))
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)


def test_gpdfit_from_y_product():
    log_y, n = _log_exceedances(12, 191, seed=3)
    y = np.exp(log_y)  # invalid slots exactly 0
    nf = n.astype(np.float64)
    q_desc = np.clip(n - 1 - np.clip((n + 2) // 4 - 1, 0, 190), 0, 190)
    y_quart = y[np.arange(12), q_desc]
    got = tpsis._gpdfit_from_y(
        torch.from_numpy(y), torch.from_numpy(nf),
        torch.from_numpy(y_quart), torch.from_numpy(y[:, 0]),
    )
    want = jax.jit(jpsis._gpdfit_from_y, static_argnames="product")(
        jnp.asarray(y), jnp.asarray(nf), jnp.asarray(y_quart),
        jnp.asarray(y[:, 0]), product=True,
    )
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)


def test_signed_log_helpers():
    rng = np.random.default_rng(4)
    t = np.concatenate([-np.abs(rng.normal(size=50)) * 5, [0.0, -np.inf, -1e-300]])
    assert_allclose(
        _np(tpsis._log1mexp(torch.from_numpy(t))), _np(jpsis._log1mexp(jnp.asarray(t))), **F64
    )
    u = rng.normal(size=60) * 30
    assert_allclose(
        _np(tpsis._softplus(torch.from_numpy(u))), _np(jpsis._softplus(jnp.asarray(u))), **F64
    )
    sa, la, sb, lb = (rng.choice([-1.0, 1.0], 60), u, rng.choice([-1.0, 1.0], 60), u[::-1].copy())
    lb[:5] = -np.inf
    got = tpsis._signed_add(*(torch.from_numpy(a) for a in (sa, la, sb, lb)))
    want = jpsis._signed_add(*(jnp.asarray(a) for a in (sa, la, sb, lb)))
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)
    log_by = -np.abs(u)
    got = tpsis._log1p_negby(torch.from_numpy(sa), torch.from_numpy(log_by))
    want = jpsis._log1p_negby(jnp.asarray(sa), jnp.asarray(log_by))
    assert_allclose(_np(got), _np(want), **F64)


@pytest.mark.parametrize("fn", ["sislw_batch", "tislw_batch"])
def test_sis_tis_weights(fn):
    rng = np.random.default_rng(5)
    lw = rng.normal(size=(10, 1000))
    lw[3] = rng.standard_t(2, size=1000) * 3
    got = getattr(tpsis, fn)(torch.from_numpy(lw))
    want = getattr(jpsis, fn)(jnp.asarray(lw))
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)


@pytest.mark.parametrize(
    "kwargs", [{}, {"axis": 1}, {"axis": 0, "keepdims": True}, {"axis": 1, "b_inv": 4000}, {"b": 0.5}]
)
def test_host_logsumexp(kwargs):
    from pyloo_tpu.utils import _logsumexp as j_lse
    from pyloo_tpu_torch.utils import _logsumexp as t_lse

    x = np.random.default_rng(6).normal(size=(5, 40)) * 10
    assert_allclose(t_lse(x, **kwargs), j_lse(x, **kwargs), **F64)
