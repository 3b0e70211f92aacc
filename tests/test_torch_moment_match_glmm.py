"""Moment matching of the benchmark's Poisson GLMM on the CPU.

The configuration of the cell ``loo_mm_glmm_epilepsy_2048_x_4k_f64``
(``benchmark/configs/glmm_poisson_epilepsy_j512_s4000.json``) at 16
patients x 4 visits and 4 x 250 Laplace draws (P = 21), made by
``benchmark/model_glmm.py`` from a data seed and a seed that flag 4 rows,
each of which moment matching improves: the port's
``loo(moment_match=True, split=True|False)`` on its device-batched path is
held to the benchmark's plain reference (``benchmark/reference_mm.py``),
and with ``split=True`` to ``pyloo_tpu`` on the same draws and data at
1e-12 (its host loop, to which its own tests hold its batched loop; the
batched program takes ~30 s to compile here).  Under a profiler the call's
spans and counters record the lanes, passes, accepted transforms and split
lanes that the reference counts.
"""

import contextlib
import importlib
import json
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from benchmark import reference_mm
from benchmark.model_glmm import GLMM
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu_torch import profiling

from .torch_parity import F64

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "benchmark" / "configs" / "glmm_poisson_epilepsy_j512_s4000.json"
DATA_SEED, SEED, N_OBS, DRAWS = 2, 7, 64, 250
OBS_KEYS = ("x", "y", "patient")
# the reference fits its own PSIS: a lane's final ratios are near flat, and their
# last bits move k by up to ~1e-11 (ROADMAP Queue 3 items 39 and 45)
K_TOL = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    saved = tpl.rcParams["device.device"], tpl.rcParams["device.precision"]
    tpl.rcParams["device.device"] = "cpu"
    tpl.rcParams["device.precision"] = "float64"
    yield
    tpl.rcParams["device.device"], tpl.rcParams["device.precision"] = saved


@pytest.fixture(scope="module")
def glmm():
    config = {**json.loads(CONFIG.read_text()), "draws": DRAWS, "data_seed": DATA_SEED}
    g = GLMM(config, N_OBS, SEED, "cpu")
    model = tpl.models.Model("glmm", g.data(), g.param_shapes(), g.logp, g.log_lik,
                             obs_keys=OBS_KEYS)
    idata = tpl.models.idata_from_flat_draws(model, g.flat.numpy())
    return {"g": g, "model": model, "idata": idata,
            "wrapper": tpl.JAXModelWrapper(model, idata)}


def _port(glmm, split):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tpl.loo(glmm["idata"], pointwise=True, moment_match=True,
                       wrapper=glmm["wrapper"], split=split)


def _reference(glmm, split):
    g = glmm["g"]
    return reference_mm.loo_moment_match({"x": g.x, "y": g.y, "patient": g.patient},
                                         g.flat.numpy(), g.tau, g.prior_sd, split=split)


@pytest.fixture(scope="module")
def runs(glmm):
    return {split: (_port(glmm, split), _reference(glmm, split)) for split in (True, False)}


@pytest.mark.parametrize("split", [True, False])
def test_the_port_equals_the_plain_reference(glmm, runs, split):
    got, ref = runs[split]
    lanes = ref["accepted"] >= 0
    assert lanes.sum() >= 3
    assert_array_equal(got.moment_match_accepted, ref["accepted"])
    assert_allclose(got.loo_i.values, ref["loo_i"], **F64)
    assert_allclose(got.pareto_k.values, ref["k"], **K_TOL)
    for row in ("elpd_loo", "p_loo", "se"):
        assert_allclose(got[row], ref[row], **F64)
    # the matched rows moved; the others keep their first PSIS values
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = tpl.loo(glmm["idata"], pointwise=True)
    assert_array_equal(got.loo_i.values[~lanes], first.loo_i.values[~lanes])
    assert (got.pareto_k.values[lanes] < first.pareto_k.values[lanes]).all()


def _jax_model(g):
    sd, tau = g.prior_sd.numpy(), g.tau

    def log_lik(p, d):
        b = p["b"]
        eta = b[0] + d["x"] @ b[1:] + p["a"][d["patient"]]
        return d["y"] * eta - jnp.exp(eta) - jax.scipy.special.gammaln(d["y"] + 1.0)

    def logp(p, d):
        b, a = p["b"], p["a"]
        return (-0.5 * jnp.sum((b / sd) ** 2) - 0.5 * jnp.sum(a * a) / (tau * tau)
                + jnp.sum(log_lik(p, d)))

    return jwrap.Model("glmm", g.data(), g.param_shapes(), logp, log_lik, obs_keys=OBS_KEYS)


def test_the_port_equals_pyloo_tpu(glmm, runs):
    jm = _jax_model(glmm["g"])
    jid = jwrap.idata_from_flat_draws(jm, glmm["g"].flat.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jpl.loo(jid, pointwise=True, moment_match=True,
                       wrapper=jpl.JAXModelWrapper(jm, jid), split=True, device_batched=False)
    got = runs[True][0]
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    assert_allclose(got.pareto_k.values, want.pareto_k.values, **F64)
    for row in ("elpd_loo", "p_loo", "se", "p_loo_se", "looic"):
        assert_allclose(got[row], want[row], **F64)


def _traced(glmm, monkeypatch):
    """The call with its spans and counters recording, as under a profiler,
    and the spans entered and left, in order.  (A profiler's own trace of
    the call holds ~640,000 CPU operations and takes ~40 s to read.)"""
    # the modules, not the functions the package exports under their names
    modules = [importlib.import_module(f"pyloo_tpu_torch.{name}")
               for name in ("loo", "loo_moment_match", "ops.moment_match")]
    entered = []

    @contextlib.contextmanager
    def spy(name, **args):
        entered.append(("enter", name, args))
        yield
        entered.append(("exit", name, args))

    monkeypatch.setattr(profiling, "_recording", lambda: True)
    for module in modules:
        monkeypatch.setattr(module, "span", spy)
    profiling.reset_counters()
    result = _port(glmm, True)
    counted = profiling.counters()
    profiling.reset_counters()
    return result, entered, counted


def test_a_traced_call_counts_the_reference_lanes_and_passes(glmm, runs, monkeypatch):
    result, entered, counted = _traced(glmm, monkeypatch)
    spans, open_spans = {}, []
    for what, name, args in entered:
        if what == "enter":
            if name.startswith("pyloo.moment_match."):
                assert open_spans[-1] == "pyloo.moment_match", (name, open_spans)
            if name == "pyloo.moment_match":
                assert open_spans == ["pyloo.loo"]  # the root sits under loo()'s
            open_spans.append(name)
            spans.setdefault(name, []).append(args)
        else:
            assert open_spans.pop() == name
    got, ref = runs[True]
    assert_array_equal(result.loo_i.values, got.loo_i.values)  # the same bit for bit
    lanes = ref["accepted"] >= 0
    n_lanes, matched = int(lanes.sum()), int((ref["accepted"] > 0).sum())
    passes = int(ref["passes"].max())  # every lane in one batch
    assert counted["mm_lanes"] == {"batched": n_lanes}
    assert counted["mm_passes"] == {"batched": passes}
    assert counted["mm_lane_passes"] == {"loop": int(ref["passes"].sum())}
    assert set(counted["mm_accepted"]) == {"shift", "scale", "cov"}
    assert sum(counted["mm_accepted"].values()) == int(ref["accepted"][lanes].sum())
    assert counted["mm_split_lanes"] == {"batched": matched}
    assert counted["mm_cov_failures"] == {"batched": 0}
    S = 4 * DRAWS
    # one block of lanes (well within the budget); its split evaluates every lane
    assert counted["mm_evals"] == {"original": S, "loop": 3 * S * n_lanes * passes,
                                   "split": 2 * S * n_lanes}
    reads = counted["host_reads"]
    assert reads["moment_match.lanes"] == 1
    assert reads["moment_match.pass"] == 1 + passes
    assert reads["moment_match.result"] == 9  # the block's results, a read each
    assert "moment_match.split" not in reads  # the split stays on the device
    assert len(spans["pyloo.moment_match"]) == 1 and len(spans["pyloo.moment_match.lanes"]) == 1
    assert [a["p"] for a in spans["pyloo.moment_match.pass"]] == list(range(passes))
    assert [a["i"] for a in spans["pyloo.moment_match.split"]] == [
        int(np.nonzero(lanes)[0][0])]
    assert len(spans["pyloo.moment_match.update"]) == n_lanes


def test_no_profiler_counts_nothing(glmm):
    profiling.reset_counters()
    _port(glmm, False)
    assert profiling.counters() == {}


def test_the_float64_fit_takes_its_candidates_in_blocks_bit_for_bit():
    """The linear float64 fit evaluates its grid's candidates together
    (``ops/psis._CANDIDATE_BLOCK_BYTES``): each candidate's profile
    log-likelihood is the one a call of its own gives, bit for bit, and the
    fit of a few lanes' rows, as moment matching makes them, equals
    ``pyloo_tpu``'s."""
    from pyloo_tpu.ops import psis as jpsis
    from pyloo_tpu_torch.ops import psis as tpsis

    rng = np.random.default_rng(11)
    lr = torch.from_numpy(2.0 * rng.standard_t(3, size=(6, 4000)))
    lr[1] = 5.0 + 1e-3 * torch.from_numpy(rng.uniform(size=4000))  # a near-flat tail
    y = torch.from_numpy(rng.uniform(0.0, 1.0, size=(6, 190)))
    b = torch.from_numpy(rng.uniform(-3.0, 0.9, size=(6, 43)))
    block = tpsis._log_prod_terms(y, b)
    one_by_one = torch.stack([tpsis._log_prod_terms(y, b[:, j:j + 1])[:, 0]
                              for j in range(b.shape[1])], dim=1)
    assert torch.equal(block.nan_to_num(7.0), one_by_one.nan_to_num(7.0))
    got = tpsis.psislw_batch(lr, 190)
    want = jpsis.psislw_batch(jnp.asarray(lr.numpy()), 190)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **F64)


def test_lanes_in_blocks_within_the_budget_give_the_same_result(glmm, runs, monkeypatch):
    """With a lane budget of two lanes' draws the flagged rows run in blocks
    of two, each block's loop and split on its own: the result is the one
    block's, row for row."""
    tmm = importlib.import_module("pyloo_tpu_torch.loo_moment_match")
    g = glmm["g"]
    monkeypatch.setattr(tmm, "_LANE_BLOCK_BYTES", 2 * g.n_draws * g.n_params * 8)
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    profiling.reset_counters()
    got = _port(glmm, True)
    counted = profiling.counters()
    profiling.reset_counters()
    want, ref = runs[True]
    assert_array_equal(got.moment_match_accepted, want.moment_match_accepted)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    assert_allclose(got.pareto_k.values, want.pareto_k.values, **K_TOL)
    n_blocks = -(-int((ref["accepted"] >= 0).sum()) // 2)
    assert counted["host_reads"]["moment_match.result"] == 9 * n_blocks


def test_a_singular_lane_keeps_its_last_transform_and_the_others_split(glmm):
    """A block's lane whose accumulated map is singular keeps its last
    transform's weights, and every other lane of the block takes its split
    as ``pyloo_tpu``'s split of that lane alone gives it; there the singular
    map raises, and its loop drops that observation's split."""
    from pyloo_tpu_torch.helpers import _wrapper_model_fns
    from pyloo_tpu_torch.ops.psis import tail_length

    tmm = importlib.import_module("pyloo_tpu_torch.loo_moment_match")
    g = glmm["g"]
    upars = g.flat.reshape(-1, g.n_params).to(torch.float64)
    S, P = upars.shape
    rng = np.random.default_rng(5)
    obs, r_effs = [3, 17, 40], [1.0, 0.8, 0.6]
    shift = 0.05 * rng.standard_normal((3, P))
    scaling = 1.0 + 0.05 * rng.uniform(size=(3, P))
    mapping = np.eye(P) + 0.02 * rng.standard_normal((3, P, P))
    mapping[1, 0, :] = 0.0  # lane 1's map is singular
    tails = [tail_length(S, r) for r in r_effs]
    last_ll = torch.from_numpy(rng.standard_normal((3, S)))
    last_lw = torch.from_numpy(rng.standard_normal((3, S)))
    part = {"total_shift": torch.from_numpy(shift), "total_scaling": torch.from_numpy(scaling),
            "total_mapping": torch.from_numpy(mapping), "n_accepted": torch.tensor([2, 1, 3]),
            "log_liki": last_ll.clone(), "lwi": last_lw.clone()}
    lanes = SimpleNamespace(obs_idx=torch.tensor(obs), row_tails=torch.tensor(tails))
    tmm._split_part(part, lanes, upars, True, max(tails), *_wrapper_model_fns(glmm["model"]))
    assert part["split_failed"].tolist() == [False, True, False]
    assert torch.equal(part["log_liki"][1], last_ll[1])
    assert torch.equal(part["lwi"][1], last_lw[1])

    jm = _jax_model(g)
    jw = jpl.JAXModelWrapper(jm, jwrap.idata_from_flat_draws(jm, g.flat.numpy()))
    for lane in (0, 2):
        want = jpl.loo_moment_match_split(jw, upars.numpy(), True, shift[lane], scaling[lane],
                                          mapping[lane], obs[lane], r_effs[lane])
        assert_allclose(part["log_liki"][lane].numpy(), np.asarray(want["log_liki"]), **F64)
        assert_allclose(part["lwi"][lane].numpy(), np.asarray(want["lwi"]), **F64)
    with pytest.raises(np.linalg.LinAlgError):
        jpl.loo_moment_match_split(jw, upars.numpy(), True, shift[1], scaling[1], mapping[1],
                                   obs[1], r_effs[1])


def test_a_failed_split_warns_and_keeps_that_rows_loop_result(glmm, runs, monkeypatch):
    """Through ``loo()``: where one matched lane's split fails, that row
    takes its loop's result, the one ``split=False`` gives, with a warning
    that names it, and every other row keeps its split."""
    tmm = importlib.import_module("pyloo_tpu_torch.loo_moment_match")
    ref = runs[True][1]
    bad = np.nonzero(ref["accepted"] >= 0)[0]
    lane = int(np.nonzero(ref["accepted"][bad] > 0)[0][0])
    row = int(bad[lane])
    real = tmm.split_lanes

    def lane_fails(*args, **kwargs):
        ll, lw, ok = real(*args, **kwargs)
        return ll, lw, ok & (torch.arange(ok.shape[0]) != lane)

    monkeypatch.setattr(tmm, "split_lanes", lane_fails)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tpl.loo(glmm["idata"], pointwise=True, moment_match=True,
                      wrapper=glmm["wrapper"], split=True)
    failed = [str(w.message) for w in caught if "Split transformation failed" in str(w.message)]
    assert len(failed) == 1 and f"observation {row}:" in failed[0]
    with_split, without = runs[True][0].loo_i.values, runs[False][0].loo_i.values
    others = np.arange(len(with_split)) != row
    assert_array_equal(got.loo_i.values[others], with_split[others])
    assert_allclose(got.loo_i.values[row], without[row], **F64)
    assert got.loo_i.values[row] != with_split[row]
