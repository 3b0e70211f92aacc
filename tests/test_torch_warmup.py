"""``pyloo_tpu_torch.warmup`` and ``profiling`` against ``pyloo_tpu``'s on the CPU.

``warmup`` resolves the geometry ``pyloo_tpu``'s does and returns the same
dict but for ``wall_s`` and ``compilation_cache`` (here: whether the CUDA
kernel library was loaded rather than built; on the CPU no library is
used).  A ``loo_streaming`` call after it equals one without it.
``trace`` writes a Chrome trace that names the ``annotate`` regions, and
the package's counters beside it; ``Throughput`` does ``pyloo_tpu``'s
arithmetic.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu import profiling as jprof
from pyloo_tpu_torch import profiling as tprof
from pyloo_tpu_torch.streaming._chunks import resolve_chunk

torch.set_num_threads(1)

# `pl.warmup` is the function; the module is shadowed by the export
twarm = importlib.import_module("pyloo_tpu_torch.warmup")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _same_dict(n_obs, n_draws, **kwargs):
    t = tpl.warmup(n_obs, n_draws, **kwargs)
    j = jpl.warmup(n_obs, n_draws, **kwargs)
    assert t["wall_s"] > 0 and t["compilation_cache"] is False
    drop = ("wall_s", "compilation_cache")
    assert {k: v for k, v in t.items() if k not in drop} == {
        k: v for k, v in j.items() if k not in drop}
    assert list(t) == list(j)
    return t


@pytest.mark.parametrize("kwargs", [
    {"method": "sis"},
    {"mixture": True},
    {"source": True},
    {"pointwise": True},
])
def test_warmup_variants_return_pyloo_tpu_dict(kwargs):
    res = _same_dict(256, 50, chunk_size=64, dtype="float64", **kwargs)
    assert res["chunk_size"] == 64 and res["n_draws"] == 50


@pytest.mark.parametrize("n_obs, n_draws, chunk_size, dtype", [
    (1000, 40, None, "float64"),
    (1000, 40, None, "float32"),
    (300, 30, 100, "float32"),
    (5, 30, 100, "float64"),
])
def test_warmup_resolves_the_geometry_of_pyloo_tpu(n_obs, n_draws, chunk_size, dtype):
    res = _same_dict(n_obs, n_draws, chunk_size=chunk_size, dtype=dtype)
    assert res["chunk_size"] == resolve_chunk(chunk_size, n_obs, n_draws, getattr(torch, dtype))[0]


def test_warmup_default_dtype_follows_rcparams():
    old = tpl.rcParams["device.precision"]
    tpl.rcParams["device.precision"] = "float32"
    try:
        assert tpl.warmup(100, 20)["dtype"] == "float32"
    finally:
        tpl.rcParams["device.precision"] = old


def test_loo_streaming_after_warmup_equals_one_without():
    ll = torch.from_numpy(np.random.default_rng(1).normal(-1, 0.5, size=(200, 64)))
    kw = dict(chunk_size=64, dtype="float64", pointwise=True)
    ref = tpl.loo_streaming(lambda idx: ll[idx], 200, 64, **kw)
    tpl.warmup(200, 64, **kw)
    res = tpl.loo_streaming(lambda idx: ll[idx], 200, 64, **kw)
    assert res["elpd_loo"] == ref["elpd_loo"]
    np.testing.assert_array_equal(res.loo_i.values, ref.loo_i.values)
    np.testing.assert_array_equal(res.pareto_k.values, ref.pareto_k.values)


def test_warmup_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.warmup(100, 20, mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tpl.rcParams["device.device"] = "cuda"
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpl.warmup(100, 20)
    finally:
        tpl.rcParams["device.device"] = "cpu"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_warmup_loads_the_kernel_library_only_for_float32(monkeypatch, dtype):
    # a CUDA device as compute_device() reports it; the chunk itself is a stub
    loads, calls = [], []
    monkeypatch.setattr(twarm, "compute_device", lambda: torch.device("cuda"))
    monkeypatch.setattr(twarm._build, "load", lambda: loads.append(1))
    monkeypatch.setattr(twarm._build, "is_built", lambda: True)
    monkeypatch.setattr(twarm, "loo_streaming", lambda *a, **k: calls.append(k["dtype"]))
    res = tpl.warmup(1_000, 40, dtype=dtype)
    assert calls == [getattr(torch, dtype)]
    if dtype == "float64":  # the float64 path uses no kernel of the library
        assert loads == [] and res["compilation_cache"] is False
    else:
        assert loads == [1] and res["compilation_cache"] is True


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    ll = torch.randn(64, 40, dtype=torch.float64)
    with pytest.raises(ZeroDivisionError):
        with tprof.trace(str(tmp_path)):
            with tprof.annotate("before_the_fault"):
                tpl.loo_streaming(lambda idx: ll[idx], 64, 40, chunk_size=32)
            1 / 0
    pid = os.getpid()
    assert sorted(os.listdir(tmp_path)) == [f"counters_{pid}_0.json", f"trace_{pid}_0.json"]
    events = json.loads((tmp_path / f"trace_{pid}_0.json").read_text())["traceEvents"]
    assert any(e.get("name") == "before_the_fault" for e in events)


def test_zero_source_reads_rows_as_pyloo_tpu():
    jwarm = importlib.import_module("pyloo_tpu.warmup")
    src = twarm._ZeroSource(16, 12, torch.float32)
    np.testing.assert_array_equal(src.read_rows(0, 16), jwarm._ZeroSource(16, 12).read_rows(0, 16))
    out = torch.empty((16, 12), dtype=torch.float32)
    src._read_into(0, out)
    np.testing.assert_array_equal(out.numpy(), src.read_rows(0, 16).astype(np.float32))


def test_trace_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    ll = torch.randn(64, 40, dtype=torch.float64)
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("loo_streaming"):
            tpl.loo_streaming(lambda idx: ll[idx], 64, 40, chunk_size=32)
    pid = os.getpid()
    assert sorted(os.listdir(tmp_path)) == [f"counters_{pid}_0.json", f"trace_{pid}_0.json"]
    events = json.loads((tmp_path / f"trace_{pid}_0.json").read_text())["traceEvents"]
    assert any(e.get("name") == "loo_streaming" for e in events)
    # a second trace into the same directory gets files of its own
    with tprof.trace(str(tmp_path)):
        torch.ones(3).sum()
    assert sorted(os.listdir(tmp_path)) == [f"counters_{pid}_0.json", f"counters_{pid}_1.json",
                                            f"trace_{pid}_0.json", f"trace_{pid}_1.json"]


def test_throughput_arithmetic_equals_pyloo_tpu(monkeypatch):
    meters = []
    for prof in (jprof, tprof):
        meter = prof.Throughput()
        assert meter.items_per_sec == 0.0
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.0])
        with monkeypatch.context() as patch:
            patch.setattr(time, "perf_counter", lambda: next(ticks))
            for n in (1000, 250, 7):
                with meter.measure(n_items=n):
                    pass
        meters.append(meter)
    j, t = meters
    assert (t.total_items, t.total_seconds, t.laps) == (j.total_items, j.total_seconds, j.laps)
    assert t.items_per_sec == j.items_per_sec == 1257 / 0.75
    assert t.summary() == j.summary() and t.summary("rows") == j.summary("rows")
