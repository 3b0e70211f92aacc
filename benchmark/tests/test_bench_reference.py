"""The benchmark's references against known cases, and against each other.

``benchmark/reference.py`` (numpy, one row at a time) is the frozen copy;
``benchmark/reference_torch.py`` scores many rows at once and must give the
same numbers in float64; in a lower dtype it is the control, which has to
read far from the reference.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import reference as ref
from benchmark import reference_torch as rt


def rows(n=64, s=400, seed=1):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-0.7, 0.5, size=(n, s)) + 0.3 * rng.standard_t(3, size=(n, s))
    ll[5, :10] = ll[5, 0]  # ties inside the tail
    ll[6] = np.round(ll[6], 1)  # ties at the cutoff: a shorter tail
    ll[7] = -0.5
    ll[7, :3] = -3.0  # three values above the cutoff: no fit, k = inf
    return ll


@pytest.mark.parametrize("s, reff, want", [(4000, 1.0, 190), (400, 1.0, 60), (100, 1.0, 20),
                                           (4000, 0.5, 269)])
def test_tail_length(s, reff, want):
    assert ref.tail_length(s, reff) == want


def test_gpd_fit_recovers_the_shape():
    rng = np.random.default_rng(3)
    k, sigma = 0.4, 2.0
    u = rng.uniform(size=20000)
    y = np.sort(sigma * np.expm1(-k * np.log1p(-u)) / k)
    k_hat, sigma_hat = ref.fit_gpd_zhang_stephens(y)
    assert abs(k_hat - k) < 0.05 and abs(sigma_hat / sigma - 1) < 0.05


def test_gpd_quantile_inverts_the_cdf():
    p = np.array([0.1, 0.5, 0.9])
    q = ref.gpd_quantile(p, 0.3, 1.5)
    cdf = 1 - (1 + 0.3 * q / 1.5) ** (-1 / 0.3)
    np.testing.assert_allclose(cdf, p, rtol=1e-12)
    np.testing.assert_allclose(ref.gpd_quantile(p, 0.0, 1.5), -1.5 * np.log1p(-p))


def test_constant_row_is_its_own_loo():
    e, k = ref.loo_row(np.full(400, -1.25))
    assert e == pytest.approx(-1.25, abs=1e-12) and k == math.inf


def test_weights_are_normalised():
    lw, _ = ref.psis_row(-rows()[0])
    assert np.exp(lw).sum() == pytest.approx(1.0, abs=1e-12)


def test_ess_of_independent_and_correlated_draws():
    rng = np.random.default_rng(0)
    iid = rng.normal(size=(4, 1000))
    assert 3000 < ref.ess_mean(iid) < 5000
    ar = np.zeros((4, 1000))
    for t in range(1, 1000):
        ar[:, t] = 0.9 * ar[:, t - 1] + rng.normal(size=4)
    assert ref.ess_mean(ar) < 600
    r32 = ref.relative_eff({"b": iid[:, :, None]}, np.float32)
    assert r32 == pytest.approx(ref.relative_eff({"b": iid[:, :, None]}), rel=1e-4)


def test_torch_reference_equals_numpy_in_float64():
    ll = rows()
    tail = ref.tail_length(ll.shape[1])
    e, k, lp = rt.score_rows(torch.from_numpy(ll), tail, torch.float64, block=16)
    want_e, want_k = ref.loo_rows(ll)
    np.testing.assert_allclose(e.numpy(), want_e, rtol=0, atol=1e-12)
    np.testing.assert_allclose(k.numpy(), want_k, rtol=0, atol=1e-11)
    assert k[7] == math.inf and want_k[7] == math.inf
    want_lp = np.log(np.exp(ll).mean(axis=1))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=0, atol=1e-12)


def test_totals_are_loo_sums():
    ll = rows()
    tail = ref.tail_length(ll.shape[1])
    e, _, lp = rt.score_rows(torch.from_numpy(ll), tail, torch.float64)
    totals = rt.Totals()
    totals.add(e[:20], lp[:20])
    totals.add(e[20:], lp[20:])
    got = totals.result()
    en = e.numpy()
    assert got["elpd_loo"] == pytest.approx(en.sum(), rel=1e-13)
    assert got["p_loo"] == pytest.approx(lp.numpy().sum() - en.sum(), rel=1e-12)
    assert got["se"] == pytest.approx(math.sqrt(len(en) * en.var()), rel=1e-10)


def test_totals_leave_out_rows_not_finite():
    totals = rt.Totals()
    totals.add(torch.tensor([1.0, math.nan, 3.0]), torch.tensor([2.0, 2.0, 4.0]))
    got = totals.result()
    assert got["elpd_loo"] == 4.0 and got["p_loo"] == 2.0 and got["se"] == pytest.approx(
        math.sqrt(2 * 1.0))


@pytest.mark.parametrize("dtype, at_least", [(torch.float32, 1e-9), (torch.bfloat16, 1e-3)])
def test_control_reads_far_from_the_reference(dtype, at_least):
    ll = rows(n=256, s=1000, seed=5)
    tail = ref.tail_length(ll.shape[1])
    x = torch.from_numpy(ll)
    want = rt.score_rows(x, tail, torch.float64)[0].numpy()
    got = rt.score_rows(x, tail, dtype)[0].numpy()
    fin = np.isfinite(got)
    assert np.max(np.abs(got[fin] - want[fin])) > at_least
