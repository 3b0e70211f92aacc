"""The prepass (kernel A) and top-k (kernel B) contracts against pyloo_tpu.

On the CPU the wrappers of ``pyloo_tpu_torch.ops.topk`` run their plain
PyTorch versions; these tests hold those to the Pallas kernels themselves
(interpret mode, as ``tests/test_selection.py`` runs them) in the 256-list
tier, and to a JAX-side oracle built from ``jax.lax.top_k`` and masked sums
where interpret mode would be too slow for tier 1 (the 512 and 1024 tiers,
the multipass split).  The CUDA kernels are compared with these plain
versions on the card by ``chip_smoke.py``.

Tolerances: vals and C bitwise (the shift ``x - C`` is one float32 rounding
on both sides and selection is exact); log_ntl and log_sum_ll within rtol
2e-6, atol 1e-6 (float32 sums taken in another order), as in
``tests/test_selection.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pyloo_tpu.ops.pallas_topk import pallas_loo_prepass, pallas_topk_desc
from pyloo_tpu_torch import rcParams
from pyloo_tpu_torch.ops import topk
from pyloo_tpu_torch.ops.psis import tail_length
from pyloo_tpu_torch.ops.selection import fast_path_route, topk_vals_desc

FLOOR = float(np.log(np.finfo(np.float64).tiny))


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


def _rows(b, s, seed=0):
    """x = -log_lik with a heavy-tail row, a full-row tie and some -inf."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1, 0.8, size=(b, s))
    ll[0] = 2.0 * rng.standard_t(3, size=s) - 1.0  # heavy tail
    ll[1] = -0.25  # full-row tie (x = 0.25, the test_selection.py:110 row)
    ll[2, ::7] = np.inf  # x = -inf entries, not the whole row
    return (-ll).astype(np.float32)


def _assert_prepass(got, want, vals_exact=True):
    vals, c, log_ntl, log_sum_ll = (np.asarray(a) for a in got)
    w_vals, w_c, w_ntl, w_ll = (np.asarray(a) for a in want)
    if vals_exact:
        np.testing.assert_array_equal(vals, w_vals)
    else:  # parts rebase by C_p - C: one more float32 rounding
        assert_allclose(vals, w_vals, rtol=2e-6, atol=2e-5)
    np.testing.assert_array_equal(c, w_c)
    assert_allclose(log_ntl, w_ntl, rtol=2e-6, atol=1e-6)
    assert_allclose(log_sum_ll, w_ll, rtol=2e-6, atol=1e-6)


def _jax_oracle(x, k):
    """The prepass contract from lax.top_k and masked sums (f32, on JAX)."""
    xj = jnp.asarray(x)
    c = jnp.max(xj, axis=1)
    xs = xj - c[:, None]
    vals = jax.lax.top_k(xs, k)[0]
    xcut = jnp.maximum(vals[:, k - 1], FLOOR)
    ntl = xcut + jnp.log(
        jnp.sum(jnp.where(xs <= xcut[:, None], jnp.exp(xs - xcut[:, None]), 0.0), axis=1)
    )
    pad = jnp.isneginf(xj)
    r_min = jnp.min(jnp.where(pad, jnp.inf, xj), axis=1)
    s_ll = jnp.sum(jnp.where(pad, 0.0, jnp.exp(r_min[:, None] - xj)), axis=1)
    return vals, c, ntl, -r_min + jnp.log(s_ll)


def test_prepass_matches_pallas_interpret():
    x = _rows(16, 2000)
    got = topk.loo_prepass(torch.from_numpy(x), 192)
    want = pallas_loo_prepass(jnp.asarray(x), 192, interpret=True, blk=1)
    _assert_prepass(got, want)


def test_topk_matches_pallas_interpret():
    x = _rows(16, 2000, seed=1)
    got = topk.topk_desc(torch.from_numpy(x), 192)
    want = pallas_topk_desc(jnp.asarray(x), 192, interpret=True, blk=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [270, 545])  # the 512 and 1024 list tiers
def test_prepass_and_topk_wide_k(k):
    x = _rows(8, 4000, seed=k)
    want = _jax_oracle(x, k)
    _assert_prepass(topk.loo_prepass(torch.from_numpy(x), k), want)
    got_b = topk.topk_desc(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        got_b.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[0])
    )


def test_prepass_multi_matches_oracle():
    s = 40_000
    k = tail_length(s) + 1
    parts = topk.multipass_parts(s, k)
    assert parts == 2
    x = _rows(8, s, seed=3)
    x[3, 13_300:13_400] = 1.5  # a tie run straddling the part boundary
    x[3, 19_950:20_050] = 1.5
    got = topk.loo_prepass_multi(torch.from_numpy(x), k, parts)
    _assert_prepass(got, _jax_oracle(x, k), vals_exact=False)


def test_prepass_multi_deep_nontail_mass_stays_finite():
    # a part whose non-tail mass sits ~300 nats below the row max: pyloo_tpu's
    # exp-domain merge flushes it to 0 (log_ntl = -inf); the log-domain merge
    # keeps it
    s = 40_000
    k = tail_length(s) + 1
    x = np.full((2, s), -300.0, np.float32)
    x[:, :5000] = np.random.default_rng(0).normal(size=(2, 5000))
    got = topk.loo_prepass_multi(torch.from_numpy(x), k, 2)
    want = topk.loo_prepass_plain(torch.from_numpy(x), k)
    assert np.isfinite(got[2].numpy()).all()
    assert_allclose(got[2].numpy(), want[2].numpy(), rtol=2e-6, atol=1e-6)


def test_caps_and_routes():
    assert topk.supports(4000, 191) and topk.supports(32768, 545)
    assert topk.supports(2, 2) and not topk.supports(2, 3)  # k <= S
    assert not topk.supports(32769, 191)  # beyond one block's shared memory
    assert not topk.supports(4000, 1025)  # beyond the sort buffer
    assert topk.multipass_parts(16384, 256) == 1
    assert topk.multipass_parts(100_000, 950) == 4
    assert topk.multipass_parts(524_288, 1024) == 16
    assert topk.multipass_parts(524_289, 1024) is None  # > 16 parts
    assert topk.multipass_parts(100_000, 1087) is None  # k > 1024

    cuda = torch.device("cuda")
    assert fast_path_route(4000, 192, torch.float32, cuda) == "cuda"
    assert fast_path_route(32768, 545, torch.float32, cuda) == "cuda"
    assert fast_path_route(100_000, 950, torch.float32, cuda) == "cuda-multipass"
    assert fast_path_route(100_000, 1087, torch.float32, cuda) == "torch"
    assert fast_path_route(4000, 192, torch.float64, cuda) == "torch"
    assert fast_path_route(4000, 192, torch.float32, "cpu") == "torch"


def test_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros((4, 100), dtype=torch.float64)
    with pytest.raises(TypeError):
        topk.loo_prepass(x, 10)
    with pytest.raises(ValueError):
        topk.topk_desc(x.float(), 101)
    with pytest.raises(ValueError):
        topk.loo_prepass(torch.zeros(100), 10)


def test_topk_vals_desc_routes():
    rng = np.random.default_rng(5)
    x64 = torch.from_numpy(rng.normal(size=(3, 50_000)))
    got = topk_vals_desc(x64, 700)  # float64 and beyond the cap: torch.topk
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x64.numpy()), 700)[0])
    )
    x32 = x64[:, :3000].float()
    before = dict(topk.topk_desc.launches)
    np.testing.assert_array_equal(
        topk_vals_desc(x32, 191).numpy(), topk.topk_desc_plain(x32, 191).numpy()
    )
    assert topk.topk_desc.launches == before  # the CPU never launches a kernel


def _special_rows(s=2500, seed=11):
    """x rows for kernels A and B's selection scheme: a full-row tie; keys
    that all share their top 12 bits (the k-th bin overflows the tie
    buffer); +0.0 and -0.0 mixed; denormals; some -inf; a heavy tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 0.8, size=(8, s)).astype(np.float32)
    x[1] = 0.25
    x[2] = (1.0 + rng.integers(0, 2**20, size=s) * 2.0**-23).astype(np.float32)
    x[3] = np.where(rng.random(s) < 0.5, np.float32(0.0), np.float32(-0.0))
    x[3, ::5] = rng.normal(size=x[3, ::5].shape)
    x[4] = (rng.normal(size=s) * 1e-39).astype(np.float32)
    x[5, ::7] = -np.inf
    x[6] = 2.0 * rng.standard_t(3, size=s) + 1.0
    return x


@pytest.mark.parametrize("k", [1, 191, 545, "S"])
def test_radix_plain_on_special_rows(k):
    s = 1024 if k == "S" else 3000
    k = s if k == "S" else k
    x = _special_rows(s)
    xt = torch.from_numpy(x)
    vals, refined = topk.topk_radix_plain(xt, k)
    np.testing.assert_array_equal(vals.numpy(), torch.topk(xt, k).values.numpy())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[0]))
    # the tie row and the shared-top-bits row need a further digit when they
    # are wider than the candidate buffer
    assert refined[1] == refined[2] == (s > topk.candidate_cap(k))
    assert not refined[7]
    # kernel A selects on the raw row and shifts the winners
    c = xt.amax(dim=1)
    shifted = vals - c[:, None]
    np.testing.assert_array_equal(shifted.numpy(), topk.loo_prepass_plain(xt, k)[0].numpy())
    # XLA on the CPU flushes float32 denormals to zero in x - C: row 4 is
    # held to torch (above) only
    normal = np.arange(8) != 4
    np.testing.assert_array_equal(shifted.numpy()[normal], np.asarray(_jax_oracle(x, k)[0])[normal])


def test_radix_plain_matches_pallas_interpret():
    x = _special_rows()
    xt = torch.from_numpy(x)
    vals, _ = topk.topk_radix_plain(xt, 191)
    normal = np.arange(8) != 4  # XLA flushes denormals to zero (see above)
    want_b = pallas_topk_desc(jnp.asarray(x[normal]), 191, interpret=True, blk=1)
    np.testing.assert_array_equal(vals.numpy()[normal], np.asarray(want_b))
    want_a = pallas_loo_prepass(jnp.asarray(x[normal]), 191, interpret=True, blk=1)
    shifted = vals - xt.amax(dim=1)[:, None]
    np.testing.assert_array_equal(shifted.numpy()[normal], np.asarray(want_a[0]))
    _assert_prepass(topk.loo_prepass(xt[normal], 191), want_a)


def _concentrated_rows(s=4000, seed=5):
    """x rows whose draws differ by less than one first-digit bin (an eighth
    of an octave): a posterior's spread (x = 0.7 + 0.01 z) with some -inf;
    values that share their top 24 bits (the last 8 tell them apart); two
    neighbouring values, each a tie run longer than the candidate buffer;
    and a normal row that needs no further digit."""
    rng = np.random.default_rng(seed)
    x = (0.7 + 0.01 * rng.normal(size=(4, s))).astype(np.float32)
    x[0, ::9] = -np.inf
    x[1] = (1.0 + rng.integers(0, 256, size=s) * 2.0**-23).astype(np.float32)
    x[2] = np.where(rng.random(s) < 0.5, np.float32(1.5), np.float32(1.5 + 2.0**-22))
    x[3] = rng.normal(1.0, 0.8, size=s).astype(np.float32)
    return x


@pytest.mark.parametrize("k", [1, 191, 545])
def test_radix_plain_on_concentrated_rows(k):
    x = _concentrated_rows()
    xt = torch.from_numpy(x)
    vals, refined = topk.topk_radix_plain(xt, k)
    np.testing.assert_array_equal(vals.numpy(), torch.topk(xt, k).values.numpy())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[0]))
    assert refined.tolist() == [True, True, True, False]
    shifted = vals - xt.amax(dim=1)[:, None]
    np.testing.assert_array_equal(shifted.numpy(), topk.loo_prepass_plain(xt, k)[0].numpy())
    _assert_prepass(topk.loo_prepass(xt, k), _jax_oracle(x, k))


def test_radix_plain_concentrated_matches_pallas_interpret():
    x = _concentrated_rows(s=2500)
    vals, _ = topk.topk_radix_plain(torch.from_numpy(x), 191)
    want = pallas_topk_desc(jnp.asarray(x), 191, interpret=True, blk=1)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [200, 400])  # sort slots P = 256 and P = 512
def test_radix_plain_candidate_buffer_edge(k):
    # exactly candidate_cap(k) keys in and above the k-th key's bin fit; one
    # more needs a further digit; the result is the same either way
    cap = topk.candidate_cap(k)
    s = cap + 500
    x = np.full((2, s), 0.1, np.float32)
    x[:, :150] = 3.0  # above the bin
    rng = np.random.default_rng(2)
    x[:, 150:cap] = 1.0 + rng.integers(0, 2**20, size=(2, cap - 150)) * 2.0**-23
    x[1, cap] = 1.0  # one more key in the bin
    xt = torch.from_numpy(x)
    vals, refined = topk.topk_radix_plain(xt, k)
    assert refined.tolist() == [False, True]
    np.testing.assert_array_equal(vals.numpy(), torch.topk(xt, k).values.numpy())


def test_candidate_cap_matches_the_kernel_source():
    from pathlib import Path

    import pyloo_tpu_torch

    src = (Path(pyloo_tpu_torch.__file__).parent / "csrc" / "topk_prepass.cu").read_text()
    bins1 = int(re.search(r"constexpr int kBins1 = (\d+);", src).group(1))
    bins2 = int(re.search(r"constexpr int kBins2 = (\d+);", src).group(1))
    assert "return kBins1 / 2 - kBins2 / 2 + (P > 256 ? P / 2 : 0);" in src
    for k, p in [(1, 32), (191, 256), (256, 256), (257, 512), (545, 1024), (1024, 1024)]:
        assert topk.candidate_cap(k) == bins1 // 2 - bins2 // 2 + (p // 2 if p > 256 else 0)
