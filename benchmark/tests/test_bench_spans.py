"""The per-layer metrics that read the program's own spans and counters.

A CPU rehearsal of each cell runs the harness with one stand-in device
operation added to its traced window: the readers read a window only
where it holds device operations (a run on the card), and a plain CPU
rehearsal's line carries none of them (``test_bench_harness``).
Every metric of the cell then has a finite value, the counters repeat
exactly over two seeds, and an untraced run reports none of them.  The
arithmetic is checked against hand-worked numbers, and a program without
spans or counters gives nothing to read.

Nothing here measures: a CPU run's numbers are no device metric.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import core, spans
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
SPEC = json.loads(BENCH.read_text())
PROGRAM = ("program_span", "program_counter")
MINE = {w["name"]: [m["name"] for m in SPEC["per_layer"]
                    if m["source"] in PROGRAM and w["name"] in m["workloads"]]
        for w in SPEC["workloads"]}
COUNTED = ("host_reads_per_call", "h2d_gb_per_call")


STAND_IN = """
import sys
sys.path[0] = sys.argv.pop(1)
from benchmark import run, trace
real = trace.summarize


def with_a_device_op(events, devices, calls):
    t = real(events, devices, calls)
    t.ops.append(("stand-in", t.window[0], t.window[0] + 1.0, devices[0]))
    return t


trace.summarize = with_a_device_op
sys.exit(run.main(sys.argv[1:]))
"""


def _rehearse(cell: str, seed: int, trace: int) -> dict:
    """One run of ``cell`` on the CPU at a tiny size, in a process of its
    own; with ``trace``, its window holds one stand-in device operation."""
    proc = subprocess.run([sys.executable, "-c", STAND_IN, str(ROOT), "--workload", cell,
                           "--seed", str(seed), "--trace", str(trace), "--device", "cpu",
                           "--n-obs", "2000", "--draws", "100", "--seconds", "0.3"],
                          cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", list(MINE))
def test_a_rehearsal_reports_every_new_metric_of_its_cell(cell):
    assert MINE[cell]
    lines = [_rehearse(cell, seed, 1) for seed in (3000000019, 4100000023)]
    for line in lines:
        assert line["correct"] is True
        assert set(MINE[cell]) <= set(line["metrics"])
        for name in MINE[cell]:
            assert math.isfinite(line["metrics"][name]["value"]), name
    for name in MINE[cell]:
        if name.startswith(COUNTED):
            assert lines[0]["metrics"][name] == lines[1]["metrics"][name], name
            assert lines[0]["metrics"][name]["value"] > 0
    untraced = _rehearse(cell, 3000000019, 0)
    assert not set(MINE[cell]) & set(untraced["metrics"])


def test_the_host_draws_cell_counts_the_matrix_bytes():
    cell = "loo_logit32_262k_x_4k_f64_host"
    cfg = core.rehearsal_config(json.loads((ROOT / "benchmark" / "configs" /
                                            "logit32_s4000.json").read_text()), 2000, 100)
    line = _rehearse(cell, 3000000019, 1)
    n_bytes = cfg["n_obs_host"] * cfg["chains"] * cfg["draws"] * 8  # float64 draws
    assert line["metrics"]["h2d_gb_per_call"]["value"] == pytest.approx(n_bytes / 1e9)
    # a call: the NaN scan, three scores and the guard's one read
    assert line["metrics"]["host_reads_per_call.host_draws"]["value"] == 5.0


def _window(host, ops=(("k", 0.0, 1.0, 0),), calls=2):
    return SimpleNamespace(trace=Trace(window=(0.0, 100.0), devices=[0], calls=calls,
                                       ops=list(ops), host=list(host)))


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"_s_{name}")


def test_span_readers_against_hand_worked_numbers(monkeypatch):
    host = [("pyloo.loo.ingest", 10.0, 30.0), ("pyloo.loo.ingest", 90.0, 130.0),  # 20 + 10 in
            ("pyloo.loo.reff", 0.0, 4.0), ("pyloo.loo.assemble", 40.0, 46.0),
            ("pyloo.subsample.readback", 50.0, 60.0), ("pyloo.subsample.draw", 60.0, 62.0),
            ("pyloo.subsample.exact_rows", 62.0, 70.0), ("pyloo.subsample.estimate", 70.0, 71.0),
            ("pyloo.chunk.score", 1.0, 4.0), ("pyloo.chunk.score", 5.0, 10.0),
            ("benchmark.call", 0.0, 100.0)]
    ctx = _window(host)
    assert spans.span_s(ctx.trace, "pyloo.loo.ingest") == 30.0
    assert spans.span_count(ctx.trace, "pyloo.chunk.score") == 2
    # two calls: µs a call over 1e6 (s) or 1e3 (ms)
    assert _reader("ingest_s").read(ctx) == pytest.approx(15e-6)
    assert _reader("reff_s").read(ctx) == pytest.approx(2e-6)
    assert _reader("assemble_s").read(ctx) == pytest.approx(3e-6)
    assert _reader("lpd_readback_ms").read(ctx) == pytest.approx(5e-3)
    assert _reader("draw_ms").read(ctx) == pytest.approx(1e-3)
    assert _reader("exact_rows_ms").read(ctx) == pytest.approx(4e-3)
    assert _reader("estimate_ms").read(ctx) == pytest.approx(0.5e-3)
    # the mean span: (3 + 5) / 2 µs
    assert _reader("score_host_ms_per_chunk").read(ctx) == pytest.approx(4e-3)

    from pyloo_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"host_reads": {"a": 4, "b": 2}, "h2d_bytes": {"ingest": 3e9}})
    for suffix in ("", ".host_draws", ".subsample"):
        assert _reader("host_reads_per_call" + suffix).read(ctx) == 3.0
    assert _reader("h2d_gb_per_call").read(ctx) == pytest.approx(1.5)


def test_nothing_to_read_gives_none(monkeypatch):
    from pyloo_tpu_torch import profiling

    names = sorted({n for cell in MINE.values() for n in cell})
    spanned = _window([(n, 0.0, 1.0) for n in ("pyloo.loo.ingest", "pyloo.loo.reff",
                                              "pyloo.loo.assemble", "pyloo.chunk.score",
                                              "pyloo.subsample.readback",
                                              "pyloo.subsample.draw",
                                              "pyloo.subsample.exact_rows",
                                              "pyloo.subsample.estimate")])
    monkeypatch.setattr(profiling, "counters", lambda: {"host_reads": {"a": 1},
                                                       "h2d_bytes": {"ingest": 8}})
    # no device operation in the window (a CPU rehearsal), or no window at all
    for ctx in (_window(spanned.trace.host, ops=()), SimpleNamespace(trace=None)):
        assert all(_reader(n).read(ctx) is None for n in names)
    # a program with neither the spans nor the counters (the parent of this change)
    monkeypatch.delattr(profiling, "counters")
    assert all(_reader(n).read(_window([])) is None for n in names)
    assert all(_reader(n).read(spanned) is None for n in names if n.startswith(COUNTED))
