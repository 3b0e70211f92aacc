"""``pyloo_tpu_torch.tools.fuzz_differential`` against ``pyloo_tpu`` on the CPU.

A few seeded trials of each of the tool's seven modes: the trial's inputs,
drawn with numpy by the tool's own ``draw_<mode>``, go through the port on
the CPU (the tool's ``run_<mode>``) and through ``pyloo_tpu`` on the CPU in
float64 (the same calls, as ``scripts/fuzz_differential.py`` makes them), and
every float64 result agrees within rtol and atol 1e-12; the float32 results
of ``fast32`` within the float32 envelope of the tool (loo_i 1e-4 relative
to 1 + |loo_i|, k 2e-3, cutoff-tie rows 1e-2).  Each mode's own checks pass
on those trials, and a broken entry point
makes a trial fail.
"""

import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.containers import DataArray as JDA
from pyloo_tpu.models.wrapper import Model as JModel
from pyloo_tpu.models.wrapper import idata_from_flat_draws as j_idata_from_flat_draws
from pyloo_tpu_torch.tools import fuzz_differential as fz

torch.set_num_threads(1)
F64 = dict(rtol=1e-12, atol=1e-12)
SEED = 20260818
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _specs(mode, n, seed=SEED):
    rng = np.random.default_rng(seed)
    return [getattr(fz, f"draw_{mode}")(rng, trial) for trial in range(n)]


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _port(mode, spec):
    with fz.on_device("cpu"):
        return _quiet(getattr(fz, f"run_{mode}"), spec, CPU)


_TRIALS: dict = {}


def _trials(mode):
    """The mode's first ``N_TRIALS[mode]`` trials and the port's results on
    them, run once for the module's tests."""
    if mode not in _TRIALS:
        _TRIALS[mode] = [(spec, _port(mode, spec)) for spec in _specs(mode, N_TRIALS[mode])]
    return _TRIALS[mode]


def _j(v):
    return np.asarray(getattr(v, "values", v), dtype=np.float64).ravel()


def _held(port, jax_res, keys=None):
    for key in keys or jax_res:
        got, want = port[key], jax_res[key]
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        close = np.abs(got - want) <= F64["atol"] + F64["rtol"] * np.abs(want)
        assert (same | close).all(), (key, got[~(same | close)][:4], want[~(same | close)][:4])


def _jax_idata(ll):
    return jpl.from_dict(log_likelihood={"obs": ll.T[None]})


def jax_streaming(spec):
    B, S, ll, reff, chunk = spec["B"], spec["S"], spec["ll"], spec["reff"], spec["chunk"]
    llj, xj = jnp.asarray(ll), jnp.asarray(spec["x"])
    ll_fn = lambda i: llj[i]  # noqa: E731
    idata = _jax_idata(ll)
    out = {}
    ref = jpl.loo(idata, reff=reff, pointwise=True)
    got = jpl.loo_streaming(ll_fn, B, S, reff=reff, chunk_size=chunk, pointwise=True,
                            dtype=jnp.float64)
    for name, res in (("loo", ref), ("loo_streaming", got)):
        out[f"{name}.elpd"] = _j(res["elpd_loo"])
        out[f"{name}.loo_i"] = _j(res.loo_i)
        out[f"{name}.pareto_k"] = _j(res.pareto_k)
    out["psislw"] = _j(jpl.psislw(-ll, reff=reff)[0])
    out["densify"] = _j(jpl.psislw_compact(-ll, reff=reff).densify(-ll))
    wref = jpl.waic(idata, pointwise=True)
    wgot = jpl.waic_streaming(ll_fn, B, S, chunk_size=chunk, dtype=jnp.float64, pointwise=True)
    for name, res in (("waic", wref), ("waic_streaming", wgot)):
        out[f"{name}.elpd"] = _j(res["elpd_waic"])
        out[f"{name}.waic_i"] = _j(res.waic_i)
    lwm = jpl.psislw(-ll)[0]
    for kind in ("mean", "sd"):
        er = jpl.e_loo_streaming(ll_fn, lambda i: xj[i], B, S, type=kind,  # noqa: B023
                                 chunk_size=chunk, dtype=jnp.float64)
        eref = jpl.e_loo(JDA(spec["x"], ("obs", "__sample__")),
                         log_weights=JDA(np.asarray(lwm), ("obs", "__sample__")),
                         log_ratios=JDA(-ll, ("obs", "__sample__")), type=kind)
        out[f"e_loo_streaming.{kind}"] = _j(er.value)
        out[f"e_loo.{kind}"] = _j(eref.value)
    out["loo_group_streaming.elpd"] = _j(jpl.loo_group_streaming(
        ll_fn, spec["gids"], B, S, chunk_size=chunk, dtype=jnp.float64)["elpd_logo"])
    out["loo_group.elpd"] = _j(jpl.loo_group(idata, spec["gids"], reff=1.0)["elpd_logo"])
    return out


def jax_nonfactor(spec):
    idata = jpl.from_dict(posterior={"mu": spec["mus"], "cov": spec["covs"]},
                          observed_data={"y": spec["y"]})
    res = jpl.loo_nonfactor(idata, pointwise=True)
    return {"loo_nonfactor.loo_i": _j(res.loo_i), "loo_nonfactor.elpd": _j(res["elpd_loo"])}


def jax_fast32(spec):
    B, S, ll, chunk = spec["B"], spec["S"], spec["ll"], spec["chunk"]
    out = {}
    for name, dtype in (("exact", jnp.float64), ("fast", jnp.float32)):
        llj = jnp.asarray(ll, dtype)
        res = jpl.loo_streaming(lambda i: llj[i], B, S, chunk_size=chunk,  # noqa: B023
                                pointwise=True, dtype=dtype)
        out[f"{name}.elpd"] = _j(res["elpd_loo"])
        out[f"{name}.loo_i"] = _j(res.loo_i)
        out[f"{name}.pareto_k"] = _j(res.pareto_k)
    return out


def jax_subsample(spec):
    llj = jnp.asarray(spec["ll"])
    got = jpl.loo_subsample_streaming(lambda i: llj[i], spec["B"], spec["S"],
                                      observations=spec["idx"], estimator=spec["est"],
                                      dtype=jnp.float64)
    ref = jpl.loo_subsample(_jax_idata(spec["ll"]), observations=spec["idx"],
                            estimator=spec["est"], loo_approximation="lpd", reff=1.0)
    out = {f"streaming.{key}": _j(got[key]) for key in fz.SUBSAMPLE_KEYS}
    out.update({f"loo_subsample.{key}": _j(ref[key]) for key in fz.SUBSAMPLE_KEYS})
    return out


def jax_mesh(spec):
    from jax.sharding import Mesh

    llj = jnp.asarray(spec["ll"])
    out = {}
    for name, mesh in (("sharded", Mesh(np.asarray(jax.devices()[:4]), ("obs",))),
                       ("plain", None)):
        res = jpl.loo_streaming(lambda i: llj[i], spec["B"], spec["S"],
                                chunk_size=spec["chunk"], pointwise=True, mesh=mesh,
                                dtype=jnp.float64)
        out[f"{name}.elpd"], out[f"{name}.loo_i"] = _j(res["elpd_loo"]), _j(res.loo_i)
    return out


def jax_lfo(spec):
    n, s, ll = spec["n"], spec["s"], spec["ll"]
    res = jpl.loo_lfo(jpl.from_dict(log_likelihood={"obs": ll.T.reshape(1, s, n)}), spec["L"],
                      M=spec["M"], reff=spec["reff"], pointwise=True)
    return {"lfo.lfo_i": _j(res["lfo_i"]), "lfo.pareto_k": _j(res["pareto_k"])}


def jax_mm(spec):
    def logp(params, data):
        b = params["beta"]
        r = data["y"] - data["X"] @ b
        return -0.5 * jnp.sum(b**2) - 0.5 * jnp.sum(r**2)

    def log_lik(params, data):
        r = data["y"] - data["X"] @ params["beta"]
        return -0.5 * jnp.log(2 * jnp.pi) - 0.5 * r**2

    model = JModel(f"reg{spec['trial']}", {"y": spec["y"], "X": spec["X"]},
                   {"beta": (spec["p"],)}, logp, log_lik, obs_keys=("y", "X"))
    idata = j_idata_from_flat_draws(model, spec["draws"].reshape(1, spec["s"], spec["p"]))
    wrapper = jpl.JAXModelWrapper(model, idata)
    orig = jpl.loo(idata, pointwise=True, reff=1.0)
    thresh = float(np.quantile(_j(orig.pareto_k), spec["quantile"]))
    out = {"threshold": np.array([thresh])}
    for name, batched in (("host", False), ("device", True)):
        res = jpl.loo_moment_match(wrapper, orig, k_threshold=thresh, split=spec["split"],
                                   cov=spec["cov"], device_batched=batched)
        out[f"{name}.loo_i"] = _j(res.loo_i)
        out[f"{name}.pareto_k"] = _j(res.pareto_k)
        out[f"{name}.elpd"] = _j(res["elpd_loo"])
    return out


# trials a mode: enough to reach several families, few enough for the suite
N_TRIALS = {"streaming": 1, "nonfactor": 1, "fast32": 2, "subsample": 1, "mesh": 1, "lfo": 1,
            "mm": 1}


# moment matching's pareto_k after the transforms: 1e-10 (ROADMAP Queue 3
# item 45, shown by test_mm_pareto_k_carries_the_last_bit_of_the_draws)
MM_K = dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("mode", ["streaming", "nonfactor", "subsample", "mesh", "lfo", "mm"])
def test_float64_mode_matches_pyloo_tpu(mode):
    """Every float64 result of the port's trial equals pyloo_tpu's on the
    same numpy inputs within 1e-12 (moment matching's pareto_k within
    1e-10, ROADMAP Queue 3 item 45)."""
    jax_run = globals()[f"jax_{mode}"]
    for spec, port in _trials(mode):
        want = _quiet(jax_run, spec)
        _held(port, want, [key for key in want if not key.endswith(".pareto_k")
                           or mode != "mm"])
        if mode == "mm":
            for key in ("host.pareto_k", "device.pareto_k"):
                np.testing.assert_allclose(port[key], want[key], **MM_K)


def test_mm_pareto_k_carries_the_last_bit_of_the_draws():
    """Why moment matching's k is held at 1e-10: the same trial with every
    draw moved by one unit in the last place (a relative 2^-52, the size of
    the two packages' rounding differences in the transformed draws) moves
    the port's own k by more than 1e-12, while loo_i stays within 1e-12."""
    spec, a = _trials("mm")[0]
    b = _port("mm", dict(spec, draws=spec["draws"] * (1 + 2.0**-52)))
    for key in ("host", "device"):
        assert np.max(np.abs(a[f"{key}.pareto_k"] - b[f"{key}.pareto_k"])) > 1e-12
        np.testing.assert_allclose(a[f"{key}.pareto_k"], b[f"{key}.pareto_k"], **MM_K)
        np.testing.assert_allclose(a[f"{key}.loo_i"], b[f"{key}.loo_i"], **F64)


def test_fast32_matches_pyloo_tpu():
    """fast32: the float64 results within 1e-12 of pyloo_tpu's; the float32
    loo_i and k within the tool's float32 envelope."""
    for spec, port in _trials("fast32"):
        want = _quiet(jax_fast32, spec)
        _held(port, want, ["exact.elpd", "exact.loo_i", "exact.pareto_k"])
        fails = []
        fz.held_f32(port["fast.loo_i"], port["fast.pareto_k"], want["fast.loo_i"],
                    want["fast.pareto_k"], fz.fast32_ties(spec), "float32", fails)
        assert fails == [], fails


@pytest.mark.parametrize("mode", fz.MODES)
def test_mode_passes_its_checks(mode):
    """The mode's own invariants hold on its first trials on the CPU (the
    port's results that the tests above hold to pyloo_tpu)."""
    check = getattr(fz, f"check_{mode}")
    for spec, port in _trials(mode):
        assert check(spec, port) == [], spec["tag"]


def test_draws_follow_the_script():
    """The trial draws are the JAX script's: the first streaming trial of
    seed 20260818 (B, S and the family from the same generator calls)."""
    rng = np.random.default_rng(SEED)
    B, S = int(rng.integers(5, 120)), int(rng.integers(8, 600))
    dist = fz.DISTS[int(rng.integers(len(fz.DISTS)))]
    ll = fz.gen_ll(rng, dist, B, S)
    spec = _specs("streaming", 1)[0]
    assert (spec["B"], spec["S"], spec["dist"]) == (B, S, dist)
    assert np.array_equal(spec["ll"], ll)
    assert fz.trials_of("streaming", 40) == 40 and fz.trials_of("nonfactor", 40) == 13
    assert fz.trials_of("lfo", 40) == 20 and fz.trials_of("mm", 40) == 8


def test_a_broken_entry_point_fails_a_trial(monkeypatch):
    """The checks can fail: waic_streaming's pointwise values off by 1e-6
    fail the streaming mode's first trial."""
    from pyloo_tpu_torch.streaming import waic as swaic

    real = swaic.waic_streaming

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        res["elpd_waic"] = res["elpd_waic"] + 1e-6
        return res

    monkeypatch.setattr(tpl, "waic_streaming", broken)
    res = fz.fuzz_mode("streaming", 1, SEED, CPU)
    assert res["failures"] == 1


def test_card_against_cpu_flags_a_difference():
    """On the card each trial is held to the CPU: a float64 result off by
    more than 1e-10, or a float32 loo_i beyond the envelope, fails."""
    spec, cpu = _trials("fast32")[0]
    card = {key: value.copy() for key, value in cpu.items()}
    fails = []
    fz.card_against_cpu("fast32", spec, card, cpu, fails)
    assert fails == []
    card["exact.loo_i"][0] += 1e-9 * (1 + abs(card["exact.loo_i"][0]))
    card["fast.loo_i"][1] += 1e-3 * (1 + abs(card["fast.loo_i"][1]))
    fz.card_against_cpu("fast32", spec, card, cpu, fails)
    assert len(fails) == 2, fails


def test_no_card_exits_2_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exit:
        fz.main(["1", "1", "streaming"])
    assert exit.value.code == 2
    assert fz.main(["1", "3", "subsample", "--device", "cpu"]) == 0


def test_mesh_of_one_device_is_four_shards():
    mesh = fz.fuzz_mesh_of(CPU)
    assert [str(d) for d in mesh.devices] == ["cpu"] * 4
    assert math.isfinite(_trials("mesh")[0][1]["sharded.elpd"][0])


def test_group_sums_add_one_row_of_each_group_a_round(monkeypatch):
    """The fault the streaming mode found on the card: ``loo_group`` and
    ``loo_group_streaming`` summed a group's rows with one ``index_add_``
    over repeated indices, which the card adds with atomics in no fixed
    order, so tied draws' group sums came apart differently from call to
    call (elpd_logo off by up to 0.27 against the CPU).  Off the CPU the
    sums are now ``ordered_group_sums``: a ``cumsum`` over blocks that hold
    one row of each group a round.  Run here on the CPU, it equals a
    sequential ``index_add_`` bit for bit, into zeros and into sums already
    made (the streamed chunks after the first), with rows left out, one
    column, and slabs cut small; and through both entry points the streamed
    sums equal the in-memory ones, and the CPU's, on tied rows."""
    lg = importlib.import_module("pyloo_tpu_torch.loo_group")
    sg = importlib.import_module("pyloo_tpu_torch.streaming.group")

    spec = next(s for s in _specs("streaming", 40) if s["dist"] == "ties")
    ll, gids = spec["ll"], spec["gids"]
    rows = torch.from_numpy(ll)
    rng = np.random.default_rng(SEED)
    skewed = np.minimum(rng.geometric(0.2, spec["B"]) - 1, gids.max())
    skewed[rng.random(spec["B"]) < 0.1] = -1
    for slab in (lg._SLAB, 7):
        monkeypatch.setattr(lg, "_SLAB", slab)
        for index, width in ((gids, spec["S"]), (skewed, spec["S"]), (skewed, 1),
                             (np.zeros_like(gids), 1)):
            x = rows[:, :width]
            start = torch.from_numpy(rng.normal(size=(int(gids.max()) + 1, width)))
            for out in (torch.zeros_like(start), start):
                sequential = out.clone()
                for r in np.flatnonzero(index >= 0):
                    sequential[index[r]] += x[r]
                assert torch.equal(lg.add_group_sums(out.clone(), index, x), sequential)
                assert torch.equal(lg.ordered_group_sums(out.clone(), index, x), sequential)

    def run():
        streamed = _quiet(tpl.loo_group_streaming, lambda i: rows[i], gids, spec["B"],
                          spec["S"], chunk_size=spec["chunk"], dtype=torch.float64,
                          pointwise=True)
        in_memory = _quiet(tpl.loo_group, tpl.from_dict(log_likelihood={"obs": ll.T[None]}),
                           gids, reff=1.0, pointwise=True)
        return streamed.logo_i.values, in_memory.logo_i.values

    cpu = run()
    ordered = lambda out, index, x: lg.ordered_group_sums(  # noqa: E731
        out, np.asarray(index, np.int64).reshape(-1), x)
    monkeypatch.setattr(lg, "add_group_sums", ordered)
    monkeypatch.setattr(sg, "add_group_sums", ordered)
    assert spec["chunk"] < spec["B"]
    for got in (*run(), cpu[1]):
        assert np.array_equal(got, cpu[0])


def test_modes_run_in_float64_whatever_the_caller_left(monkeypatch):
    """The fault the whole-script run found: phase 16 follows phases that
    leave ``rcParams["device.precision"]`` at float32, and the tool's float64
    checks then ran in float32 and failed.  The tool sets float64 itself, as
    the script ported runs JAX with x64, and restores the caller's value."""
    monkeypatch.setitem(tpl.rcParams, "device.precision", "float32")
    res = fz.fuzz_mode("streaming", 1, SEED, CPU)
    assert res["failures"] == 0
    assert tpl.rcParams["device.precision"] == "float32"


def test_mm_drift_probe_counts_units_in_the_last_place():
    """The unit of moment matching's card reading (ROADMAP Queue 3 item 45):
    float64 steps between two arrays, across zero too, where both are
    finite."""
    from pyloo_tpu_torch.tools.mm_drift_probe import ulps

    a = np.array([1.0, -2.0, 0.0, np.inf, 5e-324])
    assert ulps(a, a) == 0
    b = a.copy()
    b[0], b[2] = np.nextafter(1.0, 2.0), -0.0
    assert ulps(a, b) == 1
    b[1] = np.nextafter(np.nextafter(-2.0, 0.0), 0.0)
    b[3], b[4] = 1.0, -5e-324
    assert ulps(a, b) == 2
