"""The harness on the CPU: each cell end to end at a tiny size, the result
line, a cell, configuration and metric added by files alone, the
arithmetic of rates, shares and rooflines, and ``BENCHMARK.json``'s form.

Nothing here measures: a CPU run's numbers are no device metric.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import checks, core, measure
from benchmark import run as run_script
from benchmark.trace import Trace, free_intervals, traced_calls, union_us

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
SPEC = json.loads(BENCH.read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = ["--device", "cpu", "--n-obs", "2000", "--draws", "100", "--seconds", "0.3"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run_py(root: Path, *args, timeout=240):
    return subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), *args],
                          cwd=root, capture_output=True, text=True, timeout=timeout)


def last_line(proc) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_on_the_cpu(cell, trace):
    proc = run_py(ROOT, "--workload", cell, "--seed", "3000000019", "--trace", str(trace), *TINY)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"
    assert line["setup"] == {"library_built": False, "library_load_s": None}  # no card, no nvcc
    assert line["device"]["count"] == next(w["chips"] for w in SPEC["workloads"]
                                           if w["name"] == cell)
    if trace:
        assert line["metrics"] == {}  # every per-layer metric reads the device: none here
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    checks = line["checks"]
    assert all(c["value"] <= c["limit"] for c in checks.values())
    tail = proc.stderr.strip().splitlines()[-len(checks):]
    assert all(t.startswith("check ") for t in tail)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    proc = run_py(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_unknown_cell_no_result():
    proc = run_py(ROOT, "--workload", "no_such_cell", "--seed", "1", *TINY)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                           "1", *TINY], cwd=tmp_path, capture_output=True, text=True,
                          timeout=240, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in [root / "BENCHMARK.json", *(root / "benchmark").rglob("*")]
            if p.is_file() and "__pycache__" not in p.parts and p.name != "BENCHMARK.json"}


def test_a_cell_configuration_and_metric_added_by_files_alone(tmp_path):
    """A new configuration, traffic, cell and per-layer metric: new files and
    new entries in BENCHMARK.json, no existing file of the benchmark edited."""
    root = tmp_path / "checkout"
    root.mkdir()
    for name in ("BENCHMARK.json", "pyloo_tpu_torch", "benchmark"):
        src = ROOT / name
        if src.is_dir():
            shutil.copytree(src, root / name, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(src, root / name)
    before = _digests(root)
    b = root / "benchmark"
    config = json.loads((b / "configs" / "logit32_s4000.json").read_text())
    config.update(name="logit64_s2000", n_features=64, draws=500)
    (b / "configs" / "logit64_s2000.json").write_text(json.dumps(config))
    traffic = json.loads((b / "traffic" / "streaming_f32.json").read_text())
    traffic["dtype"] = "float64"
    (b / "traffic" / "streaming_f64.json").write_text(json.dumps(traffic))
    cell = "loo_streaming_logit64_s2000_f64"
    (b / "workloads" / f"{cell}.json").write_text(json.dumps({
        "trace_calls": 1, "limits": {"loo_i_gap": 1e-8, "nonfinite_mismatches": 0}}))
    (b / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.calls) if ctx.trace else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "logit64_s2000", "source": "https://example.org/logit64",
                            "file": "benchmark/configs/logit64_s2000.json", "reduced": [],
                            "why": "a fixture"})
    spec["workloads"].append({"name": cell, "config": "logit64_s2000", "traffic": "streaming_f64",
                              "chips": 1, "why": "a fixture"})
    spec["end_to_end"][0]["workloads"].append(cell)
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "obs_per_sec", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    for trace in (0, 1):
        proc = run_py(root, "--workload", cell, "--seed", "5", "--trace", str(trace), *TINY)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = last_line(proc)
        assert line["correct"] is True
        if trace:
            assert line["metrics"] == {"calls_traced": {"value": 1.0, "unit": "calls"}}
        else:
            assert {"obs_per_sec", "setup_s"} <= set(line["metrics"])
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_rate_roofline_and_idle_arithmetic():
    assert measure.rate(1_000_000, [0.5, 0.5, 1.0]) == pytest.approx(1.5e6)
    # 3.35 GB read at 3.35 TB/s is 1 ms; in 4 ms that is 25%
    assert measure.roofline_pct(3.35e9, 0.0, 4e-3) == pytest.approx(25.0)
    # 67 GFLOP at 67 TFLOP/s is 1 ms, longer than 0.335 GB's 0.1 ms
    assert measure.least_seconds(0.335e9, 67e9) == pytest.approx(1e-3)
    assert union_us([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_us([(0, 2), (8, 12)], 1, 10) == 3
    assert free_intervals([(1, 2), (1.5, 3), (5, 6)], 0, 10) == [(0, 1), (3, 5), (6, 10)]
    t = Trace(window=(0.0, 100.0), devices=[0, 1], calls=2,
              ops=[("k", 0, 40, 0), ("k", 50, 60, 0), ("k", 0, 20, 1)])
    # card 0 busy 50, card 1 busy 20: the mean 35 of 100
    assert measure.idle_pct(t) == pytest.approx(65.0)
    assert measure.idle_pct(Trace(window=(0, 1), devices=[0], calls=1)) is None


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"_t_{name}")


def test_metric_readers_against_hand_worked_numbers():
    a = "void loo_prepass_kernel<true>"
    ops = [("gemm", 0, 10, 0), ("logaddexp", 10, 15, 0), (a, 15, 17, 0),
           ("add", 17, 37, 0), ("Memcpy HtoD (Pageable -> Device)", 40, 70, 0),
           ("Memset (Device)", 70, 71, 0)]
    # 2 calls of 2 chunks: 4 calls of the generator; its two ops, 15 µs
    t = Trace(window=(0.0, 100.0), devices=[0], calls=2, ops=ops, generator_calls=4,
              generator_us=15.0, generator_ops=2)
    case = SimpleNamespace(generator_calls_per_chunk=1, kernel_a_bytes_per_call=6.7e3,
                           call_bytes=3.35e4, call_flops=0.0, rows_per_call=10)
    ctx = SimpleNamespace(trace=t, case=case, walls=[], setup_s=1.5, peak_bytes=2e9)
    total = 10 + 5 + 2 + 20 + 30 + 1
    for suffix in ("", ".subsample"):
        assert _reader("generator_ms_per_chunk" + suffix).read(ctx) == pytest.approx(15 / 4 / 1e3)
        # a call is 50 µs; 33,500 bytes need 10 ns: 0.02%
        assert _reader("call_mfu" + suffix).read(ctx) == pytest.approx(0.02)
    assert _reader("fit_f32_ms_per_chunk").read(ctx) == pytest.approx((total - 15 - 2) / 4 / 1e3)
    assert _reader("lse_ms_per_chunk").read(ctx) == pytest.approx((total - 15) / 4 / 1e3)
    assert _reader("device_ops_per_chunk").read(ctx) == pytest.approx((6 - 2) / 4)
    # A: 2 µs over 2 calls is 1 µs a call; 6,700 bytes need 2 ns: 0.2%
    assert _reader("kernel_a_roofline").read(ctx) == pytest.approx(0.2)
    assert _reader("h2d_copy_s").read(ctx) == pytest.approx(30 / 2 / 1e6)
    assert _reader("device_kernel_s").read(ctx) == pytest.approx((total - 31) / 2 / 1e6)
    busy = 37 + 31
    for name in ("device_idle_share", "device_idle_share.host_draws",
                 "device_idle_share.subsample"):
        assert _reader(name).read(ctx) == pytest.approx(100 - busy)
    ctx.walls = [0.5, 1.5]
    for name in ("obs_per_sec", "obs_per_sec.host_draws", "obs_per_sec.subsample"):
        assert _reader(name).read(ctx) == pytest.approx(10.0)
    assert _reader("peak_device_gb").read(ctx) == 2.0
    assert _reader("setup_s").read(ctx) == 1.5
    # over a mesh of 4 a chunk is 4 calls of the generator: 1 chunk in all
    mesh = SimpleNamespace(trace=t, case=SimpleNamespace(generator_calls_per_chunk=4))
    assert _reader("device_ops_per_chunk").read(mesh) == pytest.approx(6 - 2)
    empty = SimpleNamespace(trace=Trace(window=(0, 1), devices=[0], calls=1), case=case)
    for m in SPEC["per_layer"]:
        assert _reader(m["name"]).read(empty) is None, m["name"]
    # device operations but no call of the generator: no chunk to count
    ungenerated = SimpleNamespace(trace=Trace(window=(0, 1), devices=[0], calls=1, ops=ops),
                                  case=case)
    for name in ("generator_ms_per_chunk", "lse_ms_per_chunk", "fit_f32_ms_per_chunk",
                 "device_ops_per_chunk"):
        assert _reader(name).read(ungenerated) is None, name


def test_idle_gaps_name_what_the_host_did():
    t = Trace(window=(0.0, 100.0), devices=[0], calls=1, ops=[("k", 0, 10, 0), ("k", 60, 100, 0)],
              host=[("benchmark.traced", 0, 100), ("benchmark.call", 0.5, 99),
                    ("aten::item", 10, 59), ("cudaMemcpyAsync", 11, 59)])
    assert t.idle_gaps() == [["benchmark.call > aten::item", 50e-6]]
    assert t.top_ops() == [["k", 50e-6]]


@pytest.mark.parametrize("cell, n_obs, chunks, calls_a_chunk", [
    ("loo_streaming_logit32_1m_x_4k_f32", 2000, 1, 1),
    ("loo_streaming_logit32_1m_x_4k_f32", 2000, 1, 4),
    ("loo_subsample_logit32_4m_x_4k_f32", 2000, 1, 1)])
def test_chunks_are_counted_from_the_generator_calls(cell, n_obs, chunks, calls_a_chunk):
    """The per-chunk metrics count the chunks the program made, from the
    generator's ranges in the trace: the program's own chunk rule at the
    rehearsal's size, a call a shard over a mesh (the streaming mix with
    ``mesh`` on, over four CPU shards), and in the subsampled cell the
    sampled rows' one call besides."""
    from pyloo_tpu_torch.parallel import Mesh
    from pyloo_tpu_torch.streaming._chunks import resolve_chunk

    args = run_script.parse(["--workload", cell, "--seed", "7", "--device", "cpu",
                             "--n-obs", str(n_obs), "--draws", "100", "--seconds", "0"])
    spec = core.Spec.load(BENCH, cell)
    if calls_a_chunk > 1:
        spec.traffic = {**spec.traffic, "mesh": True}
    devices = core.resolve_devices(calls_a_chunk, "cpu")
    config = core.rehearsal_config(spec.config, args.n_obs, args.draws)
    run = core.Run(spec, args.seed, devices, config, False)
    entry = core.load_module(ROOT / "benchmark" / "entries" / f"{spec.traffic['entry']}.py",
                             "_chunk_entry")
    case = entry.prepare(run)
    _, t = traced_calls(case.call, 2, run.sync, [0], False)
    mesh = Mesh(["cpu"] * calls_a_chunk) if calls_a_chunk > 1 else None
    assert resolve_chunk(None, config["n_obs"], 400, torch.float32, mesh=mesh)[1] == chunks
    sampled = 1 if "subsample" in cell else 0
    assert case.generator_calls_per_chunk == calls_a_chunk
    assert t.generator_calls == 2 * (chunks * calls_a_chunk + sampled)


def test_judged_and_row_gaps():
    ok, judged = checks.judged({"a": 1e-9, "b": 0}, {"a": 1e-8, "b": 0})
    assert ok and judged == {"a": {"value": 1e-9, "limit": 1e-8}, "b": {"value": 0.0, "limit": 0}}
    assert not checks.judged({"a": math.nan}, {"a": 1.0})[0]
    assert not checks.judged({}, {"a": 1.0})[0]
    gap, off = checks.row_gaps([1.0, math.nan, math.inf, 2.0], [1.5, math.nan, 3.0, 2.0])
    assert gap == pytest.approx(0.5 / 2.5) and off == 1
    assert checks.rows_beyond([0.1, 0.2, math.nan, 0.7], [0.1, 0.21, 0.5, 0.3], 0.005) == 2
    assert checks.rows_beyond([0.1], [0.1, 0.2], 0.005) == 2
    assert checks.row_gaps([1.0], [1.0, 2.0]) == (math.inf, 2)
    assert checks.rel_gap(2.0, 4.0) == 0.5 and checks.rel_gap(math.nan, 1.0) == math.inf


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((BENCH.read_bytes())) <= 64 * 1024
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) <= set(json.loads((ROOT / c["file"]).read_text()))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    chips4 = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        chips4 += w["chips"] == 4
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").exists()
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{traffic['entry']}.py").exists()
        mine = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and any(m["name"] == "setup_s" for m in mine)
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])
    assert chips4 <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
