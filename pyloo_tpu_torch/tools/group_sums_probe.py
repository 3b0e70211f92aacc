"""LOGO's group sums on the card: bit for bit against the CPU, and their time.

``loo_group`` and ``loo_group_streaming`` add each observation's row of
log-likelihoods into its group's row with
``pyloo_tpu_torch.loo_group.add_group_sums``, on the card through
``ordered_group_sums`` (``cumsum`` over blocks of one row of each group a
round).  This script checks on the card that those sums, and those of one
``index_put_`` with ``accumulate``, equal the CPU's sequential
``index_add_`` bit for bit: at draw counts S from 1 to 4,000, into zeros and
into sums already made (every streamed chunk after the first), three times
each; and through both entry points on the fuzz's 40 streaming trials (seed
20260818), streamed and in memory, on the card and on the CPU.  Then it times
each way of making the sums of one streamed chunk, 125,000 rows x 4,000
float64 draws (4 GB), at 4, 10, 1,000 and 125,000 groups:
``add_group_sums``; one ``index_add_`` (atomics: the order of the adds, and
so the sums' last bits, differ from run to run, which it counts); one
``index_put_`` with ``accumulate``; and one ``index_add_`` a round of one row
of each group.  Last, the wall of ``loo_group_streaming`` at 1,000,000
observations x 4,000 float32 draws in chunks of 125,000, at 4 and 1,000
groups, with ``add_group_sums`` and with one ``index_add_`` a chunk (the
sums as they were made before ``add_group_sums``), two calls each.

Usage, from the root of the repository, on a machine with a card::

    python3 -m pyloo_tpu_torch.tools.group_sums_probe
"""

from __future__ import annotations

import importlib
import json
import sys
import time
import warnings

import numpy as np
import torch

from .. import loo_group, loo_group_streaming
from ..loo_group import add_group_sums
from . import fuzz_differential as fz
from ._harness import card_of, on_device

# the module (the package's attribute of that name is the function)
group_module = importlib.import_module("pyloo_tpu_torch.streaming.group")
WIDTHS = (1, 2, 3, 7, 16, 31, 32, 33, 64, 100, 128, 255, 600, 4000)
CHUNK_ROWS, DRAWS = 125_000, 4_000
GROUPS = (4, 10, 1_000, 125_000)
REPEATS = 3


def sequential(out: torch.Tensor, index: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """The CPU's ``index_add_``: each row added in row order."""
    return out.cpu().clone().index_add_(0, torch.from_numpy(index), rows.cpu())


def rounds(out: torch.Tensor, index: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """One ``index_add_`` a round, each adding the next row of every group:
    no index repeats within a call."""
    by_group = np.argsort(index, kind="stable")
    g_sorted = index[by_group]
    rank = np.arange(len(index)) - np.searchsorted(g_sorted, g_sorted, side="left")
    by_rank = np.argsort(rank, kind="stable")
    src = torch.from_numpy(by_group[by_rank]).to(rows.device)
    dst = torch.from_numpy(g_sorted[by_rank]).to(out.device)
    start = 0
    for n in np.bincount(rank).tolist():
        out.index_add_(0, dst[start : start + n], rows.index_select(0, src[start : start + n]))
        start += n
    return out


def index_put(out: torch.Tensor, index: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    return out.index_put_((torch.from_numpy(index).to(out.device),), rows, accumulate=True)


def bitwise_widths(card: torch.device, rng) -> list:
    """Mismatching sums of ``add_group_sums`` (and of ``index_put_``) on the
    card against the CPU's sequential sums, per width, into zeros and into
    sums already made."""
    out = []
    for S in WIDTHS:
        bad = total = bad_put = 0
        for B, G in ((50, 1), (1_000, 3), (1_000, 250), (20_000, 7)):
            index = rng.integers(0, G, B)
            rows = torch.from_numpy(np.round(rng.normal(size=(B, S)) * rng.uniform(0.1, 1e3), 1)
                                    + rng.normal(size=(B, S)) * 1e-3)
            for start in (torch.zeros(G, S, dtype=torch.float64),
                          torch.from_numpy(rng.normal(size=(G, S)) * 1e2)):
                want = sequential(start, index, rows)
                for _ in range(REPEATS):
                    got = add_group_sums(start.to(card), index, rows.to(card)).cpu()
                    bad += int((got != want).sum())
                    total += got.numel()
                    got = index_put(start.to(card), index, rows.to(card)).cpu()
                    bad_put += int((got != want).sum())
        out.append({"S": S, "sums": total, "differ": bad, "index_put_differ": bad_put})
    return out


def bitwise_entry_points(card: torch.device) -> dict:
    """``loo_group`` and ``loo_group_streaming`` on the fuzz's streaming
    trials: logo_i streamed against in memory, bit for bit, on the card and
    on the CPU; and the card's against the CPU's (the fuzz's bar is 1e-10:
    the PSIS step after the sums rounds otherwise on the card)."""
    rng = np.random.default_rng(20260818)
    specs = [fz.draw_streaming(rng, trial) for trial in range(40)]
    differ = {"card": 0, "cpu": 0}
    card_cpu = 0.0
    for spec in specs:
        got = {}
        for name, device in (("card", card), ("cpu", torch.device("cpu"))):
            rows = torch.from_numpy(spec["ll"]).to(device)
            with on_device(device), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                streamed = loo_group_streaming(
                    lambda i: rows[i], spec["gids"], spec["B"], spec["S"],  # noqa: B023
                    chunk_size=spec["chunk"], dtype=torch.float64, pointwise=True,
                ).logo_i.values
                got[name] = loo_group(fz._idata(spec["ll"]), spec["gids"], reff=1.0,
                                          pointwise=True).logo_i.values
            differ[name] += int(not np.array_equal(streamed, got[name]))
        card_cpu = max(card_cpu, float(np.max(np.abs(got["card"] - got["cpu"])
                                              / (1 + np.abs(got["cpu"])))))
    return {"trials": len(specs), "ties": sum(s["dist"] == "ties" for s in specs),
            "streamed_differ_card": differ["card"], "streamed_differ_cpu": differ["cpu"],
            "card_cpu_rel": card_cpu}


def timed(fn, card, reps: int) -> float:
    """Median of ``reps`` CUDA-event times of ``fn()``, ms."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(card)
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timings(card: torch.device) -> list:
    gen = torch.Generator(device=card).manual_seed(0)
    rows = torch.randn(CHUNK_ROWS, DRAWS, dtype=torch.float64, device=card, generator=gen)
    out = []
    for G in GROUPS:
        index = np.random.default_rng(G).integers(0, G, CHUNK_ROWS)
        idx = torch.from_numpy(index).to(card)
        sums = torch.zeros(G, DRAWS, dtype=torch.float64, device=card)
        add_group_sums(sums.zero_(), index, rows)  # warm
        a = add_group_sums(sums.clone().zero_(), index, rows)
        b = add_group_sums(sums.clone().zero_(), index, rows)
        atomic = [sums.clone().zero_().index_add_(0, idx, rows) for _ in range(2)]
        out.append({
            "groups": G,
            "add_group_sums_ms": timed(lambda: add_group_sums(sums.zero_(), index, rows),  # noqa: B023
                                       card, REPEATS),
            "index_put_ms": timed(lambda: index_put(sums.zero_(), index, rows),  # noqa: B023
                                  card, REPEATS),
            "index_add_ms": timed(lambda: sums.zero_().index_add_(0, idx, rows),  # noqa: B023
                                  card, REPEATS),
            "rounds_ms": timed(lambda: rounds(sums.zero_(), index, rows), card,  # noqa: B023
                               1 if G < 100 else REPEATS),
            "rounds": int(np.bincount(index).max()),
            "add_group_sums_runs_differ": int((a != b).sum()),
            "index_add_runs_differ": int((atomic[0] != atomic[1]).sum()),
            "sums": G * DRAWS,
        })
        print(json.dumps(out[-1]), flush=True)
    return out


def index_add(out: torch.Tensor, group_index, rows: torch.Tensor) -> torch.Tensor:
    """One ``index_add_`` of the kept rows (atomics on the card)."""
    gi = np.asarray(group_index, np.int64).reshape(-1)
    kept = torch.from_numpy(np.flatnonzero(gi >= 0)).to(rows.device)
    return out.index_add_(0, torch.from_numpy(gi).to(out.device)[kept], rows[kept])


def end_to_end(card: torch.device) -> list:
    gen = torch.Generator(device=card).manual_seed(1)
    base = torch.randn(CHUNK_ROWS, DRAWS, device=card, generator=gen) - 1.0
    n_obs = 8 * CHUNK_ROWS
    out = []
    for G in (4, 1_000):
        gids = np.random.default_rng(G).integers(0, G, n_obs)
        for name, fn in (("add_group_sums", add_group_sums), ("index_add_", index_add)):
            group_module.add_group_sums = fn
            walls = []
            try:
                for _ in range(2):
                    t0 = time.perf_counter()
                    with on_device(card), warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        res = loo_group_streaming(
                            lambda idx: base[idx % CHUNK_ROWS], gids, n_obs, DRAWS,
                            chunk_size=CHUNK_ROWS, dtype=torch.float32)
                    torch.cuda.synchronize(card)
                    walls.append(time.perf_counter() - t0)
            finally:
                group_module.add_group_sums = add_group_sums
            out.append({"groups": G, "sums": name, "wall_s": walls,
                        "elpd_logo": float(res["elpd_logo"])})
            print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("group_sums_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    card = torch.device("cuda", torch.cuda.current_device())
    print(f"card: {card_of(card)}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    widths = bitwise_widths(card, np.random.default_rng(1))
    for row in widths:
        print(json.dumps(row), flush=True)
    entry = bitwise_entry_points(card)
    print(json.dumps(entry), flush=True)
    times = timings(card)
    walls = end_to_end(card)
    bad = (sum(row["differ"] for row in widths) + entry["streamed_differ_card"]
           + entry["streamed_differ_cpu"] + int(not entry["card_cpu_rel"] <= 1e-10))
    print(json.dumps({"bitwise_ok": bad == 0, "widths": widths, "entry_points": entry,
                      "times": times, "end_to_end": walls}))
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
