"""The comparison that decides ``correct`` has to fail: a run driven on the
CPU at a tiny size with the timed path broken underneath reads not
correct, once for each fault the cell can have (a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced; no cell spans cards, so none
has an exchange between them to leave out); and the control, the reference one precision below, fails the
limits where sound runs keep within them."""

from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, core
from benchmark import run as run_py

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
STREAMING = "loo_streaming_logit32_1m_x_4k_f32"
HOST = "loo_logit32_262k_x_4k_f64_host"
SUBSAMPLE = "loo_subsample_logit32_4m_x_4k_f32"
TINY = ["--device", "cpu", "--n-obs", "2000", "--draws", "100", "--seconds", "0.05"]


def drive(cell: str) -> dict:
    """One in-process run of ``cell``: its result line."""
    lines = []
    args = run_py.parse(["--workload", cell, "--seed", "3000000021", *TINY])
    core.run_cell(args, time.perf_counter(), ROOT / "BENCHMARK.json", out=lines.append,
                  err=lambda line: None)
    return json.loads(lines[-1])


def state_unchanged(mp):
    from pyloo_tpu_torch.streaming import _accumulate

    orig = _accumulate.accumulate_chunk

    def broken(ll, valid, carry, adj=None, **kw):
        _, elpd_i, diag = orig(ll, valid, carry, adj, **kw)
        return carry, elpd_i, diag

    mp.setattr(_accumulate, "accumulate_chunk", broken)


def half_left_out_streaming(mp):
    from pyloo_tpu_torch.streaming import _accumulate

    orig = _accumulate.accumulate_chunk

    def broken(ll, valid, carry, adj=None, **kw):
        half = ll.shape[0] // 2
        kept = valid.clone()
        kept[half:] = False
        carry, elpd_i, diag = orig(ll, kept, carry, adj, **kw)
        elpd_i = elpd_i.clone()
        elpd_i[half:] = elpd_i[:half].mean()
        return carry, elpd_i, diag

    mp.setattr(_accumulate, "accumulate_chunk", broken)


def answer_altered_streaming(mp):
    from pyloo_tpu_torch.streaming import _accumulate

    orig = _accumulate.accumulate_chunk

    def broken(*a, **kw):
        carry, elpd_i, diag = orig(*a, **kw)
        elpd_i = elpd_i.clone()
        elpd_i[0] += 0.05
        return carry, elpd_i, diag

    mp.setattr(_accumulate, "accumulate_chunk", broken)


def k_altered_on_a_few_rows(mp):
    """k wrong by 0.05 on a few more rows of each chunk than ``k_rows_off``
    lets pass, as a fault at a chunk's or a shard's edge would leave it."""
    from pyloo_tpu_torch.streaming import _accumulate

    orig = _accumulate.accumulate_chunk
    rows = int(json.loads((ROOT / "benchmark" / "workloads" / f"{STREAMING}.json").read_text())
               ["limits"]["k_rows_off"]) + 1

    def broken(*a, **kw):
        carry, elpd_i, diag = orig(*a, **kw)
        diag = diag.clone()
        diag[:rows] += 0.05
        return carry, elpd_i, diag

    mp.setattr(_accumulate, "accumulate_chunk", broken)


def half_left_out_host(mp):
    loo_mod = importlib.import_module("pyloo_tpu_torch.loo")  # the package's `loo` is the function

    orig = loo_mod.apply_rowwise

    def broken(fn, matrix, *a, **kw):
        outs = [o.clone() for o in orig(fn, matrix, *a, **kw)]
        half = outs[0].shape[0] // 2
        for o in (outs[0], outs[2]):
            o[half:] = o[:half].mean()
        return tuple(outs)

    mp.setattr(loo_mod, "apply_rowwise", broken)


def answer_altered_host(mp):
    loo_mod = importlib.import_module("pyloo_tpu_torch.loo")  # the package's `loo` is the function

    orig = loo_mod.apply_rowwise

    def broken(*a, **kw):
        outs = [o.clone() for o in orig(*a, **kw)]
        outs[0][0] += 1e-5
        return tuple(outs)

    mp.setattr(loo_mod, "apply_rowwise", broken)


def half_left_out_lpd(mp):
    from pyloo_tpu_torch.streaming import subsample

    orig = subsample.logsumexp

    def broken(x, dim, b_inv):
        half = x.shape[1] // 2
        return orig(x[:, :half], dim=dim, b_inv=half)

    mp.setattr(subsample, "logsumexp", broken)


def answer_altered_subsample(mp):
    from pyloo_tpu_torch.streaming import subsample

    orig = subsample._score_sampled

    def broken(*a, **kw):
        elpd, diag, p = orig(*a, **kw)
        elpd = np.array(elpd, copy=True)
        elpd[0] += 1e-6
        return elpd, diag, p

    mp.setattr(subsample, "_score_sampled", broken)


def other_subsample(mp):
    from pyloo_tpu_torch.streaming import subsample

    orig = subsample.subsample_indices
    mp.setattr(subsample, "subsample_indices",
               lambda **kw: orig(**{**kw, "rng": np.random.default_rng(1)}))


FAULTS = [
    (STREAMING, state_unchanged), (STREAMING, half_left_out_streaming),
    (STREAMING, answer_altered_streaming), (STREAMING, k_altered_on_a_few_rows),
    (HOST, half_left_out_host), (HOST, answer_altered_host),
    (SUBSAMPLE, half_left_out_lpd), (SUBSAMPLE, answer_altered_subsample),
    (SUBSAMPLE, other_subsample),
]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", [STREAMING, HOST, SUBSAMPLE])
def test_sound_run_is_correct(cell):
    assert drive(cell)["correct"] is True


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_reads_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = drive(cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", [STREAMING])
def test_k_wrong_on_a_few_rows_fails_the_row_count(cell, monkeypatch):
    k_altered_on_a_few_rows(monkeypatch)
    checks = drive(cell)["checks"]
    assert checks["k_rows_off"]["value"] > checks["k_rows_off"]["limit"]


@pytest.mark.parametrize("cell", [STREAMING, HOST, SUBSAMPLE])
def test_control_fails_where_the_program_passes(cell, tmp_path, capsys):
    out = tmp_path / "control.jsonl"
    assert control.main(["--workload", cell, "--seeds", "11", "12", "13", "--device", "cpu",
                         "--n-obs", "2000", "--draws", "100", "--out", str(out)]) == 0
    for line in out.read_text().splitlines():
        d = json.loads(line)
        assert d["sound_within_limits"] is True and d["control_within_limits"] is False
