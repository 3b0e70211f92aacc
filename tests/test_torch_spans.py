"""The package's spans and counters (``pyloo_tpu_torch.profiling``) on the CPU.

Each entry point that the benchmark times (``loo()`` on host draws,
``loo_streaming``, ``loo_subsample_streaming``) names its phases with spans
and counts its reads of the device, its copies to it and the deep-tail
guard's reruns.  Both record only while a profiler records: with none,
no span is entered and no counter moves.  Under ``profiling.trace`` the
Chrome trace holds each entry's span tree, the counters file what the
block counted, and the results are the same bit for bit.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import pyloo_tpu_torch as tpl
from pyloo_tpu_torch import profiling
from pyloo_tpu_torch.parallel import Mesh

torch.set_num_threads(1)

N_OBS, N_DRAWS, CHUNK = 300, 200, 128  # three chunks, the last one ragged
N_CHUNKS = 3


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"], tpl.rcParams["device.precision"]
    tpl.rcParams["device.device"] = "cpu"
    tpl.rcParams["device.precision"] = "float64"
    yield
    tpl.rcParams["device.device"], tpl.rcParams["device.precision"] = old


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _ll(n=N_OBS, s=N_DRAWS, seed=0):
    return np.random.default_rng(seed).normal(-1.0, 0.7, size=(n, s))


def _deep(n=256, s=1000, rows=(5,), seed=8):
    """Rows like ``_ll``'s and, at ``rows``, a t(2) row whose quartile
    exceedance lies far below e^-60: its float64 fit takes the signed-log
    branch, so the guard runs its piece again."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1, 0.7, size=(n, s))
    for r in rows:
        ll[r] = rng.standard_t(2, size=s) * 8.0 - 30.0
    return ll


def _idata(ll):
    n, s = ll.shape
    draws = np.ascontiguousarray(ll.T.reshape(4, s // 4, n))  # (chain, draw, obs)
    mu = np.random.default_rng(1).normal(size=(4, s // 4))
    return tpl.inference_data_from_numpy({
        "posterior": {"mu": (mu, ("chain", "draw"), {})},
        "log_likelihood": {"y": (draws, ("chain", "draw", "obs"), {})},
    })


def _call(entry, ll, dtype="float32", mesh=None):
    """One call of ``entry`` on the rows ``ll`` at the test's chunking."""
    n, s = ll.shape
    rows = torch.from_numpy(ll)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if entry == "loo":
            return tpl.loo(_idata(ll), pointwise=True)
        if entry == "loo_streaming":
            return tpl.loo_streaming(lambda idx: rows[idx], n, s, chunk_size=CHUNK,
                                     pointwise=True, dtype=dtype, mesh=mesh)
        return tpl.loo_subsample_streaming(lambda idx: rows[idx], n, s, observations=50,
                                           chunk_size=CHUNK, dtype=dtype, seed=3,
                                           pointwise=True, mesh=mesh)


CASES = {  # name: (entry, shards)
    "loo": ("loo", 1),
    "loo_streaming": ("loo_streaming", 1),
    "loo_streaming-mesh2": ("loo_streaming", 2),
    "loo_subsample_streaming": ("loo_subsample_streaming", 1),
}


def _run(case, ll=None):
    entry, shards = CASES[case]
    mesh = Mesh(["cpu"] * shards) if shards > 1 else None
    return _call(entry, _ll() if ll is None else ll, mesh=mesh)


def _traced(tmp_path, fn):
    """``fn()`` under ``profiling.trace``: (its result, the trace's span
    events in start order, the counters file)."""
    with profiling.trace(str(tmp_path)):
        result = fn()
    pid = os.getpid()
    events = json.loads((tmp_path / f"trace_{pid}_0.json").read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("name", "").startswith("pyloo.")), key=lambda e: e["ts"])
    return result, spans, json.loads((tmp_path / f"counters_{pid}_0.json").read_text())


def _parent(spans, e):
    """The innermost span that holds ``e`` (µs rounded to the ns)."""
    holders = [p for p in spans if p is not e and p["ts"] <= e["ts"] + 1e-3
               and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3]
    return min(holders, key=lambda p: p["dur"], default=None)


def _rows(result):
    """Every row of an ELPDData as a numpy array, for a bitwise comparison."""
    return {k: np.asarray(getattr(v, "values", v)) for k, v in result._rows.items()
            if isinstance(v, (int, float, bool, str, np.generic, np.ndarray))
            or hasattr(v, "values")}


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_enters_no_span_and_counts_nothing(case, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler recording")

    monkeypatch.setattr(profiling, "_range", refused)
    assert profiling.span("pyloo.loo") is profiling.span("pyloo.chunk.score", c=0, j=0)
    _run(case)
    assert profiling.counters() == {}


def _children(spans, root):
    return [e["name"] for e in spans if _parent(spans, e) is root]


@pytest.mark.parametrize("case", CASES)
def test_the_chrome_trace_holds_each_entry_span_tree(case, tmp_path):
    entry, shards = CASES[case]
    _, spans, _ = _traced(tmp_path, lambda: _run(case))
    roots = [e for e in spans if _parent(spans, e) is None]
    assert [e["name"] for e in roots] == [f"pyloo.{entry}"]
    root = roots[0]
    chunks = [(c, j) for c in range(N_CHUNKS) for j in range(shards)]
    if entry == "loo":
        assert _children(spans, root) == ["pyloo.loo.reff", "pyloo.loo.ingest",
                                          "pyloo.loo.score", "pyloo.loo.readback",
                                          "pyloo.loo.assemble"]
    elif entry == "loo_streaming":
        assert _children(spans, root) == (["pyloo.chunk.generate", "pyloo.chunk.score"]
                                          * len(chunks)
                                          + ["pyloo.stream.readback", "pyloo.stream.assemble"])
    else:
        assert _children(spans, root) == ["pyloo.subsample.lpd", "pyloo.subsample.readback",
                                          "pyloo.subsample.draw", "pyloo.subsample.exact_rows",
                                          "pyloo.subsample.estimate"]
        lpd = next(e for e in spans if e["name"] == "pyloo.subsample.lpd")
        assert _children(spans, lpd) == ["pyloo.chunk.generate"] * len(chunks)

    def args(name):
        return [(e["args"]["c"], e["args"]["j"]) for e in spans if e["name"] == name]

    assert args("pyloo.chunk.generate") == (chunks if entry != "loo" else [])
    assert args("pyloo.chunk.score") == (chunks if entry == "loo_streaming" else [])


def _expected_counters(case, ll):
    if case == "loo":
        return {"host_reads": {"base._host": 4, "guard.host_read": 1},  # the NaN scan, 3 scores
                "h2d_bytes": {"ingest": ll.nbytes}}
    if case == "loo_streaming":
        return {"host_reads": {"Shards.host": 2, "combine_carries": 1}}
    if case == "loo_streaming-mesh2":
        return {"host_reads": {"Shards.host": 4, "combine_carries": 2}}
    return {"host_reads": {"Shards.host": 1, "guard.host_read": 1, "base._host": 3},
            "h2d_bytes": {"indices": 50 * 8}}  # the sampled rows' indices


@pytest.mark.parametrize("case", CASES)
def test_counters_count_each_path_exactly(case, tmp_path):
    ll = _ll()
    _, _, written = _traced(tmp_path, lambda: _run(case, ll))
    assert profiling.counters() == _expected_counters(case, ll)
    assert written == profiling.counters()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ingest_counts_the_host_bytes_of_each_form(dtype):
    """``as_sample_matrix``'s sites: host bytes whatever the dtype they are
    cast to; a tensor already on the computation device counts too on the
    CPU, as it lies in host memory."""
    from pyloo_tpu_torch.base import as_sample_matrix

    tpl.rcParams["device.precision"] = str(dtype).removeprefix("torch.")
    try:
        ll = _ll(40, 20)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            as_sample_matrix(ll)
            as_sample_matrix(ll.astype(np.float32))
            as_sample_matrix(torch.from_numpy(ll))
            as_sample_matrix(_idata(ll).log_likelihood["y"])
            assert profiling.counters() == {"h2d_bytes": {"ingest": 3 * ll.nbytes
                                                          + ll.nbytes // 2}}
    finally:
        tpl.rcParams["device.precision"] = "float64"


@pytest.mark.parametrize("entry", ["loo", "loo_streaming"])
def test_guard_reruns_count_the_pieces_run_again(entry, tmp_path):
    ll = _deep()
    result, spans, written = _traced(tmp_path, lambda: _call(entry, ll, dtype="float64"))
    assert written["guard_reruns"] == {"run_decided": 1}
    if entry == "loo_streaming":
        # chunk 0 holds the deep row: its piece is scored twice, a span each time
        scores = [e["args"]["c"] for e in spans if e["name"] == "pyloo.chunk.score"]
        assert scores == [0, 0, 1]  # the guard reads chunk 0's flags before chunk 1
        assert written["host_reads"]["guard.host_read"] == 2  # one a chunk
    assert_array_equal(result.loo_i.values, _call(entry, ll, dtype="float64").loo_i.values)


@pytest.mark.parametrize("case", CASES)
def test_results_are_the_same_bit_for_bit_with_a_profiler_on(case, tmp_path):
    ll = _ll(seed=5)
    off = _rows(_run(case, ll))
    on, _, _ = _traced(tmp_path, lambda: _run(case, ll))
    on = _rows(on)
    assert list(on) == list(off)
    for key in off:
        assert_array_equal(on[key], off[key], err_msg=key)


def test_counters_add_up_under_a_profiler_and_reset():
    profiling.count("host_reads", "x")  # no profiler: nothing
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("host_reads", "x")
        profiling.count("host_reads", "x", 2)
        profiling.count("h2d_bytes", "ingest", 8)
    got = profiling.counters()
    assert got == {"host_reads": {"x": 3}, "h2d_bytes": {"ingest": 8}}
    got["host_reads"]["x"] = 0  # a copy
    assert profiling.counters()["host_reads"]["x"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_the_counters_file_holds_only_the_block_counts(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("host_reads", "before")
    with profiling.trace(str(tmp_path)):
        profiling.count("host_reads", "inside", 2)
    with profiling.trace(str(tmp_path)):
        pass
    pid = os.getpid()
    assert json.loads((tmp_path / f"counters_{pid}_0.json").read_text()) == {
        "host_reads": {"inside": 2}}
    assert json.loads((tmp_path / f"counters_{pid}_1.json").read_text()) == {}
    assert profiling.counters() == {"host_reads": {"before": 1, "inside": 2}}


# -- non-factorised LOO: loo_nonfactor and loo_nonfactor_streaming ---------

NF_N, NF_CHAINS, NF_DRAWS, NF_CHUNK = 24, 2, 30, 25  # three chunks of draws, the last short
NF_S = NF_CHAINS * NF_DRAWS


def _nf_draws(broken=()):
    """Covariances ``exp(-d^2 / 2) + 0.09 I`` at 24 inputs, scaled by a
    jitter a draw, ``y`` and a mean of zero; the draws in ``broken`` made
    not positive definite."""
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.0, 10.0, NF_N))
    base = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 0.09 * np.eye(NF_N)
    cov = base * np.exp(0.05 * rng.normal(size=(NF_S, 1, 1)))
    cov[list(broken)] = -np.eye(NF_N)
    return rng.multivariate_normal(np.zeros(NF_N), base), cov


def _nf_call(entry, broken=()):
    y, cov = _nf_draws(broken)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if entry == "loo_nonfactor":
            idata = tpl.from_dict(
                posterior={"mu": np.zeros((NF_CHAINS, NF_DRAWS, NF_N)),
                           "cov": cov.reshape(NF_CHAINS, NF_DRAWS, NF_N, NF_N)},
                observed_data={"y": y})
            return tpl.loo_nonfactor(idata, pointwise=True, reff=1.0)
        mats = torch.from_numpy(cov)
        return tpl.loo_nonfactor_streaming(y, torch.zeros(NF_S, NF_N, dtype=torch.float64),
                                           lambda idx: mats[idx], NF_S, chains=NF_CHAINS,
                                           pointwise=True)


@pytest.fixture
def _nf_chunks(monkeypatch):
    from pyloo_tpu_torch.ops import nonfactor as tnf

    monkeypatch.setattr(tnf, "_CHUNK_BUDGET_BYTES",
                        NF_CHUNK * tnf._MATRICES_PER_DRAW * 8 * NF_N * NF_N)


@pytest.mark.parametrize("entry", ["loo_nonfactor", "loo_nonfactor_streaming"])
def test_nonfactor_span_tree_and_counters(entry, tmp_path, _nf_chunks):
    """Both entries: a chunk is a ``pyloo.draws.generate`` and a
    ``pyloo.draws.factor`` span, then the readback, the weights and the
    assembly; ``factor_draws`` counts every draw, ``factor_failures`` none,
    three reads of the host, and the host form's chunk copies in
    ``h2d_bytes``.  The estimate is the same bit for bit with the profiler
    on."""
    result, spans, written = _traced(tmp_path, lambda: _nf_call(entry))
    roots = [e for e in spans if _parent(spans, e) is None]
    assert [e["name"] for e in roots] == ["pyloo.loo_nonfactor"]
    assert _children(spans, roots[0]) == (
        ["pyloo.draws.generate", "pyloo.draws.factor"] * 3
        + ["pyloo.nonfactor.readback", "pyloo.nonfactor.weights", "pyloo.nonfactor.assemble"])
    for name in ("pyloo.draws.generate", "pyloo.draws.factor"):
        assert [(e["args"]["c"], e["args"]["j"]) for e in spans if e["name"] == name] == [
            (0, 0), (1, 0), (2, 0)]
    want = {"factor_draws": {"cov": NF_S}, "factor_failures": {"cov": 0},
            "host_reads": {"nonfactor.draws": 1, "guard.host_read": 1, "nonfactor.scores": 1}}
    if entry == "loo_nonfactor":  # the matrices and the means, from the host
        want["h2d_bytes"] = {"draws": NF_S * NF_N * (NF_N + 1) * 8}
    assert profiling.counters() == want
    del want["factor_failures"]  # the counters file leaves out what counted 0
    assert written == want
    off = _rows(_nf_call(entry))
    on = _rows(result)
    assert list(on) == list(off)
    for key in off:
        assert_array_equal(on[key], off[key], err_msg=key)


def test_nonfactor_counts_the_failed_factorisations(_nf_chunks):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = _nf_call("loo_nonfactor_streaming", broken=(3, 40))
    assert profiling.counters()["factor_failures"] == {"cov": 2}
    assert res["n_samples"] == NF_S - 2


@pytest.mark.parametrize("entry", ["loo_nonfactor", "loo_nonfactor_streaming"])
def test_nonfactor_no_profiler_enters_no_span_and_counts_nothing(entry, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler recording")

    monkeypatch.setattr(profiling, "_range", refused)
    _nf_call(entry)
    assert profiling.counters() == {}
