"""The non-factorised cell on the CPU: its rehearsal end to end with its
metrics and ``correct``, the benchmark's reference against the tests'
plain one, the control and broken programs failing the cell's limits,
the fixed work and its readers against hand-worked numbers, and a program
without the entry point failing at once.

Nothing here measures: a CPU run's numbers are no device metric.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import checks, control, core, factor_work
from benchmark import reference_nonfactor
from benchmark import run as run_py
from benchmark.model_gp import GPModel
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "loo_nonfactor_gp2048_x_4k_f64"
TINY = ["--device", "cpu", "--n-obs", "48", "--draws", "50"]
LIMITS = json.loads((ROOT / "benchmark" / "workloads" / f"{CELL}.json").read_text())["limits"]
MINE = [m["name"] for m in SPEC["per_layer"] if CELL in m.get("workloads", [])]

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


def _rehearse(trace: int, stand_in: bool = False, seed: int = 3000000019) -> dict:
    head = ["-c", STAND_IN, str(ROOT)] if stand_in else [str(ROOT / "benchmark" / "run.py")]
    proc = subprocess.run([sys.executable, *head, "--workload", CELL, "--seed", str(seed),
                           "--trace", str(trace), "--seconds", "0.2", *TINY],
                          cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_cell_is_in_the_benchmark():
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "gp_expquad_n2048_s4000"
    config = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert config["reduced"] == []
    e2e = [m["name"] for m in SPEC["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert e2e == ["obs_per_sec", "peak_device_gb", "setup_s"]
    assert set(MINE) == {"factor_ms_per_chunk.nonfactor", "factor_roofline",
                         "call_mfu.nonfactor", "device_idle_share.nonfactor",
                         "weights_ms.nonfactor", "host_reads_per_call.nonfactor",
                         "factor_draws_per_call", "device_ops_per_chunk.nonfactor",
                         "generator_ms_per_chunk.nonfactor"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_rehearsal_is_correct(trace):
    line = _rehearse(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(LIMITS)
    assert set(line["metrics"]) == (set() if trace else {"obs_per_sec", "setup_s"})


def test_a_traced_rehearsal_reads_every_metric_of_the_cell():
    """With one stand-in device operation in the window, as on the card:
    every per-layer metric is read but the generator's time (the stand-in
    lies outside the generator's range), and the counters are exact."""
    line = _rehearse(1, stand_in=True)
    assert set(line["metrics"]) == set(MINE) - {"generator_ms_per_chunk.nonfactor"}
    assert all(math.isfinite(m["value"]) for m in line["metrics"].values())
    # the dropped-draw decision, the guard's flags, the scores
    assert line["metrics"]["host_reads_per_call.nonfactor"]["value"] == 3.0
    assert line["metrics"]["factor_draws_per_call"]["value"] == 4 * 50


def _case(seed: int = 11):
    spec = core.Spec.load(ROOT / "BENCHMARK.json", CELL)
    config = core.rehearsal_config(spec.config, 48, 50)
    run = core.Run(spec, seed, core.resolve_devices(1, "cpu"), config, False)
    entry = core.load_module(ROOT / "benchmark" / "entries" / "loo_nonfactor_streaming.py",
                             "_nf_entry")
    return entry, run


def test_the_reference_is_the_tests_plain_one():
    from tests import plain_nonfactor

    entry, run = _case()
    model = GPModel(run.config, 48, 11, "cpu")
    fn, s = model.cov_fn(), model.n_draws
    mine = reference_nonfactor.conditional_loglik(model.y, 0.0, fn, s)
    assert torch.equal(mine, plain_nonfactor.conditional_loglik(model.y, 0.0, fn, s))
    got = reference_nonfactor.loo(model.y, 0.0, fn, s, tail=int(math.ceil(min(s / 5, 3 * s ** 0.5))))
    want = plain_nonfactor.loo(model.y, 0.0, fn, s)
    np.testing.assert_allclose(got["loo_i"], want["loo_i"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["k"], want["k"], rtol=0, atol=1e-11)
    for key in ("elpd_loo", "p_loo", "se"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_a_float32_factorisation_fails_and_the_program_passes(tmp_path):
    out = tmp_path / "control.jsonl"
    assert control.main(["--workload", CELL, "--seeds", "11", "12", *TINY,
                         "--out", str(out)]) == 0
    for line in out.read_text().splitlines():
        d = json.loads(line)
        assert d["sound_within_limits"] is True and d["control_within_limits"] is False


def _drive() -> dict:
    lines = []
    args = run_py.parse(["--workload", CELL, "--seed", "3000000021", "--seconds", "0.05", *TINY])
    core.run_cell(args, time.perf_counter(), ROOT / "BENCHMARK.json", out=lines.append,
                  err=lambda line: None)
    return json.loads(lines[-1])


def _half_the_draws_left_out(mp):
    from pyloo_tpu_torch.streaming import nonfactor

    real = nonfactor.conditional_loglik

    def broken(y, mu, source, **kw):
        ll, failed = real(y, mu, source, **kw)
        half = ll.shape[0] // 2
        return ll[:half], failed[:half]

    mp.setattr(nonfactor, "conditional_loglik", broken)


def _a_diagonal_altered(mp):
    from pyloo_tpu_torch.ops import nonfactor

    real = nonfactor._precision_terms

    def broken(y, mu, cov=None, prec=None):
        g, cbar, quad, failed = real(y, mu, cov, prec)
        return g, cbar * (1 + 1e-6), quad, failed

    mp.setattr(nonfactor, "_precision_terms", broken)


@pytest.mark.parametrize("fault", [_half_the_draws_left_out, _a_diagonal_altered])
def test_a_broken_program_reads_not_correct(fault, monkeypatch):
    assert _drive()["correct"] is True
    fault(monkeypatch)
    assert _drive()["correct"] is False


def test_a_program_without_the_entry_fails_at_once(monkeypatch):
    import pyloo_tpu_torch as pl

    entry, run = _case()
    monkeypatch.delattr(pl, "loo_nonfactor_streaming")
    with pytest.raises(AttributeError):
        entry.prepare(run)


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"_nf_{name}")


def test_the_fixed_work_and_its_readers():
    assert factor_work.factor_flops(2048, 4000) == pytest.approx(4000 * 2 * 2048 ** 3 / 3)
    assert factor_work.matrix_bytes(2048, 4000) == pytest.approx(4000 * 16 * 2048 ** 2)
    # 2.29e13 flops at 67e12 flop/s: 0.342 s, longer than 268 GB at 3.35 TB/s (0.080 s)
    assert factor_work.least_seconds(2048, 4000) == pytest.approx(2.29e13 / 67e12, rel=1e-3)
    ops = [("potrf", 0, 40, 0), ("trsm", 40, 80, 0), ("exp", 80, 90, 0)]
    # 2 calls of 4 chunks: 8 calls of the generator, its op 10 µs
    t = Trace(window=(0.0, 200.0), devices=[0], calls=2, ops=ops, generator_calls=8,
              generator_us=10.0, generator_ops=1,
              host=[("pyloo.nonfactor.weights", 100.0, 130.0),
                    ("pyloo.nonfactor.weights", 150.0, 160.0)])
    case = SimpleNamespace(generator_calls_per_chunk=1, factor_flops=67e12 * 20e-6,
                           least_seconds=50e-6)
    ctx = SimpleNamespace(trace=t, case=case, walls=[], setup_s=1.0, peak_bytes=0)
    assert _reader("factor_ms_per_chunk.nonfactor").read(ctx) == pytest.approx(80 / 8 / 1e3)
    # 20 µs of work at the peak over 40 µs a call outside the generator
    assert _reader("factor_roofline").read(ctx) == pytest.approx(50.0)
    assert _reader("call_mfu.nonfactor").read(ctx) == pytest.approx(50.0)  # 50 of 100 µs
    assert _reader("device_idle_share.nonfactor").read(ctx) == pytest.approx(55.0)
    assert _reader("weights_ms.nonfactor").read(ctx) == pytest.approx(20e-3)
    assert _reader("device_ops_per_chunk.nonfactor").read(ctx) == pytest.approx(2 / 8)
    assert _reader("generator_ms_per_chunk.nonfactor").read(ctx) == pytest.approx(10 / 8 / 1e3)
    empty = SimpleNamespace(trace=Trace(window=(0, 1), devices=[0], calls=1), case=case)
    assert all(_reader(name).read(empty) is None for name in MINE)
