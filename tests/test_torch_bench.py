"""``bench_torch/``: the benchmark's cells on the CPU, and its reference.

Each cell's code path runs here on the CPU at 2,000 observations x 400
draws (``--device cpu``) and prints its metrics by name; on the card the
same code runs at full size.  ``bench_torch/reference.py``, the plain
float64 PSIS-LOO that the cells' gates hold the port to, is held to
``tests/oracle.py`` at 1e-12 and to ``pyloo_tpu.loo`` at 1e-8, the
tolerance at which ``tests/test_psis.py`` holds ``pyloo_tpu`` to the
oracle.  A cell's result equals ``pyloo_tpu``'s on the same inputs (float64
at 1e-12; float32 within the float32 envelope, 1e-4).  Asked for ``cuda``
with no card, the measuring path raises and the command exits non-zero.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
from bench_torch import bench, reference
from bench_torch import model as bench_model

from . import oracle
from .torch_parity import both

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = dict(device="cpu", n_obs=2_000, draws=100)
CPU_ARGS = ["--device", "cpu", "--n-obs", "2000", "--draws", "100"]
COMMON = {"obs_per_sec", "wall_s", "peak_device_gb", "kernel_a_launches_per_call", "elpd_loo"}
METRICS = {bench.STREAMING_CELL: COMMON,
           bench.HOST_CELL: COMMON | {"host_peak_rss_gb", "device_kernel_s"}}


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(bench.CELLS))
def test_each_cell_runs_on_the_cpu_and_prints_its_metrics_by_name(cell, capsys):
    assert bench.main(["--cell", cell, *CPU_ARGS]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("cpu: no card")
    result = _last_json(out)
    assert result["cell"] == cell and result["config"] == "logit32_s4000" and result["seed"] == 7
    assert set(result["metrics"]) == METRICS[cell]
    for name, metric in result["metrics"].items():
        assert metric["unit"], name
        assert any(line.startswith(f"metric {name}: ") for line in lines), name
    ops, wall = result["metrics"]["obs_per_sec"], result["metrics"]["wall_s"]
    repeats = bench.CELL_REPEATS[cell]
    assert ops["n"] == wall["n"] == len(wall["calls"]) == repeats >= bench.REPEATS
    assert ops["q1"] <= ops["per_call_median"] <= ops["q3"]
    # every call's rows over the summed wall, not a median of the calls' rates
    assert ops["value"] == pytest.approx(2_000 * repeats / sum(wall["calls"]), rel=1e-12)
    # no device metric comes from the CPU
    assert result["metrics"]["peak_device_gb"]["value"] is None and result["layers"] is None
    assert result["metrics"].get("device_kernel_s", {"value": None})["value"] is None
    assert result["metrics"]["kernel_a_launches_per_call"]["value"] == 0
    gate = result["gate"]
    assert gate["passed"] and gate["rows"] == bench.GATE_ROWS
    tol = bench.F32_TOL if cell == bench.STREAMING_CELL else bench.F64_TOL
    assert gate["tol_loo_i"] == tol and gate["max_abs_err_loo_i"] <= tol
    assert any(line.startswith("gate passed: 512 rows") for line in lines)


def _jax_idata(ll, beta):
    """The arrays as a pyloo_tpu InferenceData."""
    jid, _ = both({
        "posterior": {"beta": (beta, ("chain", "draw", "beta_dim_0"), {})},
        "log_likelihood": {"y": (ll, ("chain", "draw", "obs"), {})},
    })
    return jid


def test_the_float64_cell_equals_pyloo_tpu_on_its_host_array():
    res = bench.run_cell(bench.HOST_CELL, repeats=1, **CPU)
    model = bench_model.logistic_model(2_000, 4, 100, bench.SEED, "cpu")
    ll = bench_model.host_log_lik_f64(model, 2_000)
    jpl.rcParams["device.precision"] = "float64"
    want = jpl.loo(_jax_idata(ll, model[2].numpy()))["elpd_loo"]
    assert_allclose(res["metrics"]["elpd_loo"]["value"], want, rtol=1e-12)


def test_the_float32_cell_equals_pyloo_tpu_within_the_float32_envelope():
    res = bench.run_cell(bench.STREAMING_CELL, repeats=1, **CPU)
    model = bench_model.logistic_model(2_000, 4, 100, bench.SEED, "cpu")
    ll = bench_model.log_lik_fn(model)(torch.arange(2_000)).numpy()  # (obs, S)
    ll = np.ascontiguousarray(ll.T.reshape(4, 100, 2_000))
    jpl.rcParams["device.precision"] = "float32"
    try:
        want = jpl.loo(_jax_idata(ll, model[2].numpy()), reff=1.0)["elpd_loo"]
    finally:
        jpl.rcParams["device.precision"] = "float64"
    assert_allclose(res["metrics"]["elpd_loo"]["value"], want, rtol=1e-4)


def _rows(seed, n, s, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(-1.0, 0.6, size=(n, s))
    if kind == "heavy":
        return 2.0 * rng.standard_t(2, size=(n, s)) - 1.0
    return -np.logaddexp(0.0, rng.normal(0.0, 1.0, size=(n, s)))  # logistic rows


@pytest.mark.parametrize("kind", ["normal", "heavy", "logistic"])
@pytest.mark.parametrize("s,reff", [(400, 1.0), (1000, 0.7), (4000, 1.0)])
def test_reference_equals_the_oracle(kind, s, reff):
    ll = _rows(s, 8, s, kind)
    for row in ll:
        lw, k = reference.psis_row(-row, reff)
        want_lw, want_k = oracle.psis_row(-row, reff)
        assert_allclose(lw, want_lw, rtol=1e-12, atol=1e-12)
        assert_allclose(k, want_k, rtol=1e-12, atol=1e-12)
        e, k2 = reference.loo_row(row, reff)
        want_e = oracle.logmeanexp(want_lw + row) + np.log(s)
        assert_allclose(e, want_e, rtol=1e-12, atol=1e-12)
        assert k2 == k
    assert reference.tail_length(s, reff) == int(np.ceil(min(s / 5, 3 * np.sqrt(s / reff))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["normal", "heavy", "logistic"])
def test_reference_equals_pyloo_tpu_loo(seed, kind):
    rng = np.random.default_rng(seed)
    chains, draws, n = 4, 250, 12
    # autocorrelated chains, so that reff is not 1
    beta = rng.normal(size=(chains, draws, 3))
    beta = 0.5 * beta + 0.5 * np.roll(beta, 1, axis=1)
    ll = _rows(seed + 10, chains * draws, n, kind).reshape(chains, draws, n)
    jpl.rcParams["device.precision"] = "float64"
    res = jpl.loo(_jax_idata(ll, beta), pointwise=True)
    reff = reference.relative_eff({"beta": beta})
    e, k = reference.loo_rows(ll.reshape(chains * draws, n).T, reff)
    assert_allclose(e, res.loo_i.values, rtol=1e-8, atol=1e-8)
    assert_allclose(k, res.pareto_k.values, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("shape", [(4, 1000, 32), (2, 301, 1), (4, 100, 3)])
def test_reference_relative_eff_equals_pyloo_tpu(shape):
    from pyloo_tpu.ops.ess import relative_eff

    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape)
    x[1] += 0.2 * np.cumsum(rng.normal(size=shape[1:]), axis=0)  # one slow chain
    got = reference.relative_eff({"x": x})
    assert_allclose(got, relative_eff({"x": x}, shape[0] * shape[1]), rtol=1e-12)


def test_the_gate_fails_on_a_result_off_by_more_than_its_tolerance():
    want_e, want_k = np.array([-1.0, -2.0, -3.0]), np.array([0.2, 0.3, 0.4])
    assert bench.hold(want_e + 5e-5, want_k + 1e-3, want_e, want_k, 1e-4, 2e-3)["passed"]
    assert not bench.hold(want_e + [0, 0, 1e-3], want_k, want_e, want_k, 1e-4, 2e-3)["passed"]
    assert not bench.hold(want_e, want_k + [0, 5e-3, 0], want_e, want_k, 1e-4, 2e-3)["passed"]
    assert not bench.hold(want_e * np.nan, want_k, want_e, want_k, 1e-4, 2e-3)["passed"]
    # a cutoff-tie row is held to 1e-2 instead
    ties = np.array([False, True, False])
    got = bench.hold(want_e, want_k + [0, 5e-3, 0], want_e, want_k, 1e-4, 2e-3, ties)
    assert got["passed"] and got["tie_rows"] == 1 and got["max_abs_err_k"] == 0.0
    assert not bench.hold(want_e, want_k + [0, 2e-2, 0], want_e, want_k, 1e-4, 2e-3, ties)["passed"]


def test_tail_counts_see_a_tie_at_the_cutoff():
    rng = np.random.default_rng(3)
    ll = rng.normal(size=(2, 400))
    m = reference.tail_length(400)
    assert (bench.tail_counts(ll, m) == m).all()
    order = np.argsort(ll[1])  # -log_lik descending: the tail is ll's smallest
    ll[1, order[m - 1]] = ll[1, order[m]]  # the last tail value ties the cutoff
    assert list(bench.tail_counts(ll, m)) == [m, m - 1]


def test_the_model_is_the_one_described():
    model = bench_model.logistic_model(300, 2, 50, 3, "cpu")
    xw, yw, beta = model
    assert xw.shape == (300, 32) and yw.shape == (300,) and beta.shape == (2, 50, 32)
    assert set(yw.unique().tolist()) <= {0.0, 1.0}
    host = bench_model.host_log_lik_f64(model, 120)  # (chains, draws, rows)
    rows = bench_model.rows_log_lik_f64(model, np.arange(120))  # (rows, S)
    assert_allclose(host.reshape(100, 120).T, rows, rtol=1e-12, atol=1e-12)
    made = bench_model.log_lik_fn(model)(torch.arange(120)).numpy()
    assert made.dtype == np.float32
    assert_allclose(made, rows, rtol=1e-5, atol=1e-5)
    again = bench_model.logistic_model(300, 2, 50, 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model, again))


def test_bench_pys_stages_run_at_a_small_size_on_the_cpu():
    cpu = torch.device("cpu")
    base = bench.residents(cpu, rows=128, s=400)
    loop = bench.stage_kernel_loop(base, 4, 2, cpu)
    assert loop["kernel_loop_obs_per_sec"] > 0 and 0 < loop["mean_khat"] < 1
    assert bench.stage_exact_f64(base, 256, 2, cpu)["exact_f64_obs_per_sec"] > 0
    sweep = bench.stage_draw_sweep(cpu, draws=(400, 1000), chunk=64, repeats=2)
    assert list(sweep) == ["S=400", "S=1000"]
    assert all(row["route"] == "torch" and row["rows"] == 1024 for row in sweep.values())
    heavy = bench.stage_heavy_tail(cpu, rows=64, s=1000, repeats=2)
    assert list(heavy) == ["k=0.7", "k=1.0", "k=1.5"]
    assert heavy["k=0.7"]["measures_smoothing_path"]
    nonfactor = bench.stage_nonfactor(cpu, n=48, s_draws=32, repeats=2)
    assert nonfactor["n_obs"] == 48 and np.isfinite(nonfactor["elpd_sum"])


def test_the_measuring_path_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the benchmark measures on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_cell(bench.STREAMING_CELL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_stages("cuda", bench.SEED, bench.REPEATS)
    assert bench.main(["--cell", bench.HOST_CELL]) == 1
    assert "{" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="size the caller gives"):
        bench.run_cell(bench.HOST_CELL, device="cpu")
    with pytest.raises(SystemExit) as err:  # the CPU only at a given size
        bench.main(["--cell", bench.HOST_CELL, "--device", "cpu"])
    assert err.value.code == 2
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch" / "bench.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_the_copy_probe_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs there")
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch" / "copy_probe.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
