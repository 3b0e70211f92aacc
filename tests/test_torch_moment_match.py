"""``pyloo_tpu_torch``'s moment matching against ``pyloo_tpu``'s on the CPU.

The draws come from ``pyloo_tpu``'s ``fit`` of an outlier model (two
outliers, so the batched loop runs more than one lane), once for the module,
as numpy; both packages' wrappers and ``loo`` results are built on them.
``loo_moment_match`` on the device-batched path and on the host loop, with
``split`` and ``cov`` both ways, matches ``pyloo_tpu``'s ``loo_i``,
``pareto_k``, ``elpd_loo`` and ``p_loo`` within rtol/atol 1e-10, the bar
``pyloo_tpu`` holds between its own two paths
(``tests/test_moment_match.py:513-560``).  The transforms and the split
weights are held within 1e-12.
"""

import importlib
import logging
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.models import examples as jex
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu.ops import moment_match as jops
from pyloo_tpu_torch.models import examples as tex
from pyloo_tpu_torch.models import wrapper as twrap
from pyloo_tpu_torch.ops import moment_match as tops

from .torch_parity import F64

# the packages export functions named as these modules
jmm = importlib.import_module("pyloo_tpu.loo_moment_match")
tmm = importlib.import_module("pyloo_tpu_torch.loo_moment_match")

torch.set_num_threads(1)
MM = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)
    tpl.rcParams["device.device"] = old


Y = np.random.default_rng(0).normal(1.0, 1.0, size=30)
Y[0], Y[1] = 8.5, -5.5


def _jlogp(p, d):
    s = jnp.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return (-0.5 * (p["mu"] / 10) ** 2 - 0.5 * (p["log_s"] / 2) ** 2
            + jnp.sum(-0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2))


def _jll(p, d):
    s = jnp.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return -0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2


def _tlogp(p, d):
    s = torch.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return (-0.5 * (p["mu"] / 10) ** 2 - 0.5 * (p["log_s"] / 2) ** 2
            + torch.sum(-0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2))


def _tll(p, d):
    s = torch.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return -0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2


SHAPES = {"mu": (), "log_s": ()}


@pytest.fixture(scope="module")
def fitted():
    jm = jwrap.Model("ls", {"y": Y}, SHAPES, _jlogp, _jll, obs_keys=("y",))
    tm = twrap.Model("ls", {"y": Y}, SHAPES, _tlogp, _tll, obs_keys=("y",))
    jid = jwrap.fit(jm, draws=500, tune=500, chains=2, seed=7)
    flat = np.array(jid.sample_stats._flat_draws.values)
    tid = twrap.idata_from_flat_draws(tm, flat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jloo = jpl.loo(jid, pointwise=True, reff=1.0)
        tloo = tpl.loo(tid, pointwise=True, reff=1.0)
    assert np.sum(jloo.pareto_k.values > 0.7) >= 2
    return {
        "jw": jpl.JAXModelWrapper(jm, jid), "tw": tpl.JAXModelWrapper(tm, tid),
        "jid": jid, "tid": tid, "jloo": jloo, "tloo": tloo, "flat": flat.reshape(-1, 2),
    }


def _call(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, sorted(str(w.message) for w in caught)


def _same_result(t, j):
    assert_allclose(t.loo_i.values, j.loo_i.values, **MM)
    assert_allclose(t.pareto_k.values, j.pareto_k.values, **MM)
    for row in ("elpd_loo", "p_loo", "se", "p_loo_se", "looic"):
        assert_allclose(t[row], j[row], **MM)
    assert str(t) == str(j)


@pytest.mark.parametrize("cov", [True, False])
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("device_batched", [True, False])
def test_loo_moment_match_matches_pyloo_tpu(fitted, device_batched, split, cov):
    kw = dict(split=split, cov=cov, device_batched=device_batched)
    j, jmsg = _call(jpl.loo_moment_match, fitted["jw"], fitted["jloo"], **kw)
    t, tmsg = _call(tpl.loo_moment_match, fitted["tw"], fitted["tloo"], **kw)
    _same_result(t, j)
    assert tmsg == jmsg
    before = np.sum(fitted["tloo"].pareto_k.values > 0.7)
    assert np.sum(t.pareto_k.values > 0.7) < before
    # the input is not written to
    assert np.sum(fitted["tloo"].pareto_k.values > 0.7) == before
    if device_batched:
        assert 1 <= t.moment_match_passes <= 2 * 30 + 2  # groups x (max_iters + 1)


def test_loo_with_moment_match_matches_pyloo_tpu(fitted):
    kw = dict(pointwise=True, reff=1.0, moment_match=True, split=True)
    j, _ = _call(jpl.loo, fitted["jid"], wrapper=fitted["jw"], **kw)
    t, _ = _call(tpl.loo, fitted["tid"], wrapper=fitted["tw"], **kw)
    _same_result(t, j)
    with pytest.raises(ValueError, match="pointwise"):
        tpl.loo(fitted["tid"], pointwise=False, moment_match=True, wrapper=fitted["tw"])
    with pytest.raises(ValueError, match="model_obj"):
        tpl.loo(fitted["tid"], pointwise=True, moment_match=True)


def _callables(draws):
    """The five-callable interface over plain numpy, shared by both packages."""

    def ll_at(upars):
        s = np.exp(upars[:, 1:2])
        r = (Y[None, :] - upars[:, 0:1]) / s
        return -0.5 * np.log(2 * np.pi) - upars[:, 1:2] - 0.5 * r**2

    def logp_at(upars):
        return (-0.5 * (upars[:, 0] / 10) ** 2 - 0.5 * (upars[:, 1] / 2) ** 2
                + ll_at(upars).sum(axis=1))

    return dict(
        post_draws=lambda model, **kw: {"mu": draws[:, 0], "log_s": draws[:, 1]},
        log_lik_i=lambda model, i, **kw: ll_at(draws)[:, i],
        unconstrain_pars=lambda model, pars, **kw: np.column_stack([pars["mu"], pars["log_s"]]),
        log_prob_upars_fn=lambda model, upars, **kw: logp_at(upars),
        log_lik_i_upars_fn=lambda model, upars, i, **kw: ll_at(upars)[:, i],
    )


@pytest.mark.parametrize("method", ["psis", "tis"])
@pytest.mark.parametrize("split", [True, False])
def test_five_callable_interface_matches_pyloo_tpu(fitted, split, method):
    fns = _callables(fitted["flat"])
    j, jmsg = _call(jpl.loo_moment_match, object(), fitted["jloo"], split=split, method=method,
                    **fns)
    t, tmsg = _call(tpl.loo_moment_match, object(), fitted["tloo"], split=split, method=method,
                    **fns)
    _same_result(t, j)
    assert tmsg == jmsg


def test_five_callable_interface_through_loo(fitted):
    fns = _callables(fitted["flat"])
    kw = dict(pointwise=True, reff=1.0, moment_match=True, model_obj=object(), split=False)
    j, _ = _call(jpl.loo, fitted["jid"], **kw, **fns)
    t, _ = _call(tpl.loo, fitted["tid"], **kw, **fns)
    _same_result(t, j)


def test_interface_errors_match_pyloo_tpu(fitted):
    for pkg, loo_data in ((jpl, fitted["jloo"]), (tpl, fitted["tloo"])):
        with pytest.raises(ValueError, match="Missing"):
            pkg.loo_moment_match(object(), loo_data, post_draws=lambda m, **kw: None)
        fns = dict(_callables(fitted["flat"]), log_lik_i_upars_fn=lambda wrong_name: None)
        with pytest.raises(ValueError, match="missing required arguments"):
            pkg.loo_moment_match(object(), loo_data, **fns)
        with pytest.raises(ValueError, match="device_batched=True requires"):
            pkg.loo_moment_match(object(), loo_data, device_batched=True)


def _upars_lw(seed, S=600, P=3):
    rng = np.random.default_rng(seed)
    upars = rng.normal(size=(S, P)) @ np.array([[1.0, 0.3, 0.0], [0.0, 1.0, 0.5],
                                                 [0.0, 0.0, 1.0]])[:P, :P]
    lw = -0.2 * upars[:, 0] ** 2 + 0.1 * rng.normal(size=S)
    return upars, lw - np.log(np.sum(np.exp(lw)))


@pytest.mark.parametrize("name", ["shift", "shift_and_scale", "shift_and_cov"])
def test_host_transforms_match_pyloo_tpu(name):
    upars, lw = _upars_lw(1)
    j = getattr(jmm, name)(upars, lw)
    t = getattr(tmm, name)(upars, lw)
    assert sorted(t) == sorted(j)
    for key in j:
        assert_allclose(t[key], j[key], **F64)


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_batched_transform_matches_pyloo_tpu(kind):
    lanes = [_upars_lw(seed) for seed in (2, 3, 4)]
    upars = np.stack([u for u, _ in lanes])
    lw = np.stack([w for _, w in lanes])
    got = tops._transform(torch.from_numpy(upars), torch.from_numpy(lw), kind)
    for lane in range(3):
        want = jops._transform(jnp.asarray(upars[lane]), jnp.asarray(lw[lane]), kind)
        for g, w in zip(got, want):
            assert_allclose(g[lane].numpy(), np.asarray(w), **F64)
    # the covariance map of the batched transform is the host transform's
    if kind == 2:
        host = tmm.shift_and_cov(upars[0], lw[0])
        assert_allclose(got[3][0].numpy(), host["mapping"], **F64)
        assert_allclose(got[0][0].numpy(), host["upars"], **F64)


def test_non_positive_definite_covariance_takes_the_identity():
    """A lane whose covariance is singular takes the identity mapping, in
    both packages and on both paths; the other lane keeps its own map."""
    good, lw_good = _upars_lw(5, P=2)
    flat = np.zeros_like(good)  # every draw equal: both covariances are 0
    lw_flat = np.full(len(flat), -np.log(len(flat)))
    for pkg in (jmm, tmm):
        with pytest.warns(UserWarning, match="Cholesky"):
            out = pkg.shift_and_cov(flat, lw_flat)
        assert_allclose(out["mapping"], np.eye(2), rtol=0, atol=0)
    upars = np.stack([flat, good])
    lw = np.stack([lw_flat, lw_good])
    got = tops._transform(torch.from_numpy(upars), torch.from_numpy(lw), 2)[3].numpy()
    want = jops._transform(jnp.asarray(flat), jnp.asarray(lw_flat), 2)[3]
    assert_allclose(got[0], np.eye(2), rtol=0, atol=0)
    assert_allclose(np.asarray(want), np.eye(2), rtol=0, atol=0)
    assert_allclose(got[1], tmm.shift_and_cov(good, lw_good)["mapping"], **F64)


@pytest.mark.parametrize("use_cov", [True, False])
def test_split_functions_match_pyloo_tpu(use_cov):
    upars, lw = _upars_lw(6)
    rng = np.random.default_rng(7)
    shift, scaling = rng.normal(size=3) * 0.1, rng.uniform(0.8, 1.2, size=3)
    mapping = np.eye(3) + 0.1 * np.tril(rng.normal(size=(3, 3)))
    inv = np.linalg.inv(mapping)
    got = tops.split_transform_halves(*map(torch.from_numpy, (upars, shift, scaling, mapping,
                                                              inv)), use_cov=use_cov)
    want = jops.split_transform_halves(upars, shift, scaling, mapping, inv, use_cov=use_cov)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **F64)
    a, b, c = rng.normal(size=(3, 50))
    b[3], c[3], a[4] = np.inf, np.inf, np.nan
    got = tops.split_mixture_log_weights(*map(torch.from_numpy, (a, b, c))).numpy()
    assert_allclose(got, np.asarray(jops.split_mixture_log_weights(a, b, c)), **F64)


@pytest.mark.parametrize("cov", [True, False])
def test_loo_moment_match_split_matches_pyloo_tpu(fitted, cov):
    upars = fitted["flat"]
    rng = np.random.default_rng(8)
    shift, scaling = rng.normal(size=2) * 0.2, rng.uniform(0.8, 1.2, size=2)
    mapping = np.array([[1.1, 0.0], [0.2, 0.9]])
    args = (upars, cov, shift, scaling, mapping, 0, 0.9)
    j = jpl.loo_moment_match_split(fitted["jw"], *args)
    t = tpl.loo_moment_match_split(fitted["tw"], *args)
    for key in ("lwi", "lwfi", "log_liki"):
        assert_allclose(t[key], j[key], **F64)
    assert_allclose(t["r_eff_i"], j["r_eff_i"], **F64)


def test_helpers_match_pyloo_tpu(fitted):
    jw, tw, upars = fitted["jw"], fitted["tw"], fitted["flat"]
    assert_allclose(tpl.log_prob_upars(tw, upars), jpl.log_prob_upars(jw, upars), **F64)
    for pointwise in (True, False):
        assert_allclose(tpl.log_lik_i_upars(tw, upars, pointwise=pointwise),
                        jpl.log_lik_i_upars(jw, upars, pointwise=pointwise), **F64)
    conv_t, conv_j = tpl.ParameterConverter(tw), jpl.ParameterConverter(jw)
    named = conv_j.matrix_to_dict(upars)
    assert_allclose(conv_t.dict_to_matrix(conv_t.matrix_to_dict(upars)), upars, rtol=0, atol=0)
    for k, v in conv_t.matrix_to_dict(upars).items():
        assert_allclose(v, named[k], rtol=0, atol=0)
    assert_allclose(tpl.log_prob_upars(tw, named), jpl.log_prob_upars(jw, named), **F64)
    ll = fitted["tid"].log_likelihood["obs"]
    for i in (0, 5):
        assert_allclose(tpl.extract_log_likelihood_for_observation(ll, i),
                        jpl.extract_log_likelihood_for_observation(
                            fitted["jid"].log_likelihood["obs"], i), **F64)
    col = ll.values[:, :, 0].reshape(-1)
    assert_allclose(tpl.compute_updated_r_eff(tw, 0, col, len(col) // 2, 0.9),
                    jpl.compute_updated_r_eff(jw, 0, col, len(col) // 2, 0.9), **F64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jq = jmm.update_quantities_i(jw, upars, 0, jpl.log_prob_upars(jw, upars), 0.9)
        tq = tmm.update_quantities_i(tw, upars, 0, tpl.log_prob_upars(tw, upars), 0.9)
    for key in jq:
        assert_allclose(tq[key], jq[key], **F64)


@pytest.mark.parametrize("name", ["roaches_model", "eight_schools_centered"])
def test_own_rows_log_lik_equals_the_full_vector(name):
    """The batched loop's per-observation log-lik (own rows without a
    builder, the full vector indexed with one) against the full vector."""
    model = getattr(tex, name)()
    _, col_fn = tmm._wrapper_model_fns(model)
    rng = np.random.default_rng(9)
    obs = [5, 0, 7, 5]
    draws = torch.from_numpy(rng.normal(0.0, 0.1, size=(len(obs), 40, model.flat_dim)))
    got = col_fn(draws, torch.tensor(obs))
    for lane, i in enumerate(obs):
        full = torch.stack([model.log_lik_flat(q) for q in draws[lane]])
        assert_allclose(got[lane].numpy(), full[:, i].numpy(), **F64)
    jm = getattr(jex, name)()
    want = jax.vmap(jax.vmap(jm.log_lik_flat))(jnp.asarray(draws.numpy()))
    assert_allclose(got.numpy(), np.asarray(want)[np.arange(len(obs)), :, obs], **F64)


def _batched_inputs(fitted, lanes):
    tw = fitted["tw"]
    upars = torch.from_numpy(fitted["flat"].copy())
    log_prob_fn, col_fn = tmm._wrapper_model_fns(tw.model)
    obs = torch.tensor(lanes)
    log_liki0 = col_fn(upars.expand(len(lanes), *upars.shape), obs)
    lwi0, k0 = tpl.ops.psislw_batch(-log_liki0, 120)
    orig = log_prob_fn(upars[None])[0]
    return (upars, obs, orig, log_liki0, lwi0, k0), dict(
        log_prob_fn=log_prob_fn, log_lik_col_fn=col_fn, tail_max=120, max_iters=30,
        use_cov=True)


def test_batched_lanes_are_independent_and_inactive_lanes_keep_their_state(fitted):
    args, kw = _batched_inputs(fitted, [0, 1, 2])
    upars, obs, orig, ll0, lw0, k0 = args
    k0 = k0.clone()
    k0[2] = -math.inf  # this lane's loop condition is false from the start
    together = tops.batched_moment_match(upars, obs, orig, ll0, lw0, k0, 0.7, **kw)
    assert together.pop("passes") >= 1
    assert int(together["n_accepted"][0]) > 0 and int(together["n_accepted"][1]) > 0
    for lane in (0, 1):
        alone = tops.batched_moment_match(upars, obs[lane:lane + 1], orig, ll0[lane:lane + 1],
                                          lw0[lane:lane + 1], k0[lane:lane + 1], 0.7, **kw)
        alone.pop("passes")
        for key, value in alone.items():
            assert_allclose(together[key][lane].numpy(), value[0].numpy(), **F64)
    assert torch.equal(together["lwi"][2], lw0[2])
    assert torch.equal(together["log_liki"][2], ll0[2])
    assert torch.equal(together["ki"][2], k0[2])
    assert torch.equal(together["total_mapping"][2], torch.eye(2, dtype=torch.float64))
    assert int(together["n_accepted"][2]) == 0 and not bool(together["reached_max"][2])


def test_degenerate_weights_split_the_packages_decisions_pinned():
    """ROADMAP Queue 3 item 23, pinned: on a short, poorly mixed roaches fit
    (2 chains x 100 + 100 draws, r_eff ~0.03) the weights of observation 15
    concentrate on a few draws, and shift-and-scale's weighted second moment
    ``sum(w u^2) - (sum(w u))^2`` cancels below its rounding: both packages
    get NaN or absurd scalings, and where the port's candidate comes out
    finite and lowers k (scaling entries ~6.5e3), ``pyloo_tpu``'s comes out
    NaN and is rejected.  The two greedy loops then part, and the port's
    split weights for observations 15 and 129 are all NaN."""
    tm, jm = tex.roaches_model(), jex.roaches_model()
    fit = twrap.fit(tm, draws=100, tune=100, chains=2, num_leapfrog=4, seed=0)
    flat = np.array(fit.sample_stats["_flat_draws"].values)
    jid = jwrap.idata_from_flat_draws(jm, flat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tloo, jloo = tpl.loo(fit, pointwise=True), jpl.loo(jid, pointwise=True)
        bad = np.nonzero(tloo.pareto_k.values > 0.5)[0]
        assert bad.tolist() == np.nonzero(jloo.pareto_k.values > 0.5)[0].tolist()
        assert {15, 129} <= set(bad.tolist())
        for res in (tloo, jloo):  # match observations 15 and 129 alone
            k = np.array(res.pareto_k.values)
            k[np.setdiff1d(bad, [15, 129])] = 0.0
            res.pareto_k.values = k
        tres = tpl.loo_moment_match(tpl.JAXModelWrapper(tm, fit), tloo, split=True)
        jres = jpl.loo_moment_match(jpl.JAXModelWrapper(jm, jid), jloo, split=True)
    assert np.nonzero(~np.isfinite(tres.loo_i.values))[0].tolist() == [15, 129]
    assert np.isfinite(jres.loo_i.values).all()
    same = np.setdiff1d(np.arange(262), [15, 129])
    assert_allclose(tres.loo_i.values[same], jres.loo_i.values[same], **F64)


# -- the float64 deep-tail guard, one lane at a time --------------------------

_A, _C = np.array([10.0, 0.45, 0.4]), np.array([0.3, 0.2, -0.4])


def _t_lp(u):
    return -0.5 * (u**2).sum(-1)


def _t_col(u, obs):
    a, c = torch.from_numpy(_A)[obs], torch.from_numpy(_C)[obs]
    return -a[:, None] * (u[..., 0] - c[:, None]) ** 2


def _j_lp(u):
    return -0.5 * jnp.sum(u**2, -1)


def _j_col(u, i):
    return -jnp.asarray(_A)[i] * (u[:, 0] - jnp.asarray(_C)[i]) ** 2


def test_batched_lanes_decide_the_deep_tail_guard_one_by_one(monkeypatch):
    """Lane 0's ratios ``10 (u_0 - 0.3)^2`` put its tail far below e^-60;
    lanes 1 and 2 are ordinary.  Lane 0 is inactive (k = -inf), so its
    state stays, but its rows go through every re-fit beside the others.
    ``pyloo_tpu`` vmaps the loop, and each lane takes its own branch of the
    guard: lanes 1 and 2 the linear fit, lane 0 the signed-log one."""
    from pyloo_tpu_torch.ops import guard, psis as tpsis

    rng = np.random.default_rng(3)
    upars = rng.normal(size=(1000, 2))
    obs = np.arange(3)
    ll0 = np.stack([-_A[i] * (upars[:, 0] - _C[i]) ** 2 for i in obs])
    lw0, k0 = tpsis.psislw_batch(torch.from_numpy(-ll0), 95)
    k0[0] = -math.inf
    orig = _t_lp(torch.from_numpy(upars))
    decided = []
    real = guard.by_branch

    def spy(deep, *args):
        decided.append(deep if isinstance(deep, bool) else tuple(deep))
        return real(deep, *args)

    monkeypatch.setattr(tpsis, "by_branch", spy)
    kw = dict(tail_max=95, max_iters=4, use_cov=True)
    got = tops.batched_moment_match(torch.from_numpy(upars), torch.from_numpy(obs), orig,
                                    torch.from_numpy(ll0), lw0, k0, 0.3, log_prob_fn=_t_lp,
                                    log_lik_col_fn=_t_col, **kw)
    want = jops.batched_moment_match(
        jnp.asarray(upars), jnp.asarray(obs, jnp.int32), jnp.asarray(orig.numpy()),
        jnp.asarray(ll0), jnp.asarray(lw0.numpy()), jnp.asarray(k0.numpy()), jnp.asarray(0.3),
        log_prob_fn=_j_lp, log_lik_col_fn=_j_col, **kw)
    assert (True, False, False) in decided  # one lane deep: the others stay linear
    assert True not in decided
    assert int(got["n_accepted"][1]) > 0 and int(got["n_accepted"][2]) > 0
    for key in ("ki", "kfi", "lwi", "log_liki", "total_shift", "total_scaling"):
        assert_allclose(np.asarray(got[key])[1:], np.asarray(want[key])[1:], **F64)
    assert_allclose(np.asarray(got["n_accepted"]), np.asarray(want["n_accepted"]))
    assert torch.equal(got["lwi"][0], lw0[0]) and torch.equal(got["ki"][0], k0[0])
    assert_allclose(np.asarray(want["lwi"])[0], lw0[0].numpy(), **F64)


def test_a_near_flat_tail_carries_the_last_bit_of_its_ratios_into_k():
    """Why moment matching over the mesh is held to ``pyloo_tpu`` at 1e-10
    (``tests/test_torch_parallel.py``): a transform that works flattens the
    ratios, and once the tail spans ~1e-3 nats the exceedances
    ``exp(x) - exp(cutoff)`` are made by cancellation, so a last-bit change
    of the ratios (as the two packages' ``log_prob`` evaluations make)
    moves k by ~1e-11.  The fits agree on equal inputs."""
    from pyloo_tpu.ops import psis as jpsis
    from pyloo_tpu_torch.ops import psis as tpsis

    rng = np.random.default_rng(0)
    x = 5.0 + 1e-3 * rng.uniform(size=(4, 1000))
    k = tpsis.psislw_batch(torch.from_numpy(x), 95)[1].numpy()
    assert (k < -0.5).all()
    assert_allclose(k, np.asarray(jpsis.psislw_batch(jnp.asarray(x), 95)[1]), rtol=0, atol=1e-13)
    nudged = x * (1 + rng.choice([-1, 1], size=x.shape) * np.finfo(np.float64).eps / 2)
    for fit in (lambda a: tpsis.psislw_batch(torch.from_numpy(a), 95)[1].numpy(),
                lambda a: np.asarray(jpsis.psislw_batch(jnp.asarray(a), 95)[1])):
        assert np.abs(fit(nudged) - fit(x)).max() > 1e-11
