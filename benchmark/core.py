"""The harness's core: one run of one cell of ``BENCHMARK.json``.

It knows no cell, configuration, entry point or metric by name.  The cell's
entry in ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``traffic/<traffic>.json``, whose ``entry`` names the driver
``entries/<entry>.py``); ``workloads/<cell>.json`` holds the cell's check
sizes and the limits of its compared numbers; each metric the cell reports
is read by ``metrics/<metric>.py``.  A run:

1. checks that torch sees the cards the cell asks for, and prints the card's
   name, count and power limit;
2. builds the cell's inputs on the cards from ``--seed`` (the entry's
   ``prepare``, which first loads the program's kernel library where the
   cell's path launches it, timed apart) and calls the entry point once,
   which builds or loads every kernel and warms every shape the cell uses:
   the set-up, ``setup_s``, counts from the process's start to the end of
   that call; the line's ``setup`` says whether this run built the library
   (the first run in a fresh checkout compiles it with nvcc) and how long
   its load took;
3. ``--trace 0``: calls the entry point back to back for ``--seconds`` (a
   closed loop: one caller, each call ending in a synchronise of every
   card), the peak device memory reset before; ``--trace 1``: the
   workload's ``trace_calls`` calls under ``torch.profiler``;
4. compares the last call's outputs with the plain reference, computed
   after the window once the program's state is freed;
5. prints each compared number beside its limit on standard error, and
   last on standard output one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tracing
from .checks import judged

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pyloo_tpu", "bench_torch")


class Refused(Exception):
    """The run cannot give a result (no card, a bad name): exit non-zero."""


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise Refused(f"BENCHMARK.json has no {what} named {name!r}")


@dataclass
class Spec:
    """One cell as ``BENCHMARK.json`` and its files describe it."""

    cell: dict
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, bench_json: Path, name: str) -> "Spec":
        spec = json.loads(bench_json.read_text())
        cell = _named(spec["workloads"], name, "workload")
        config_entry = _named(spec["configs"], cell["config"], "configuration")
        config = json.loads((bench_json.parent / config_entry["file"]).read_text())
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(cell, config, traffic, workload, mine(spec["end_to_end"]),
                   mine(spec["per_layer"]))


@dataclass
class Run:
    """What an entry driver is given: the cell's files, the seed, the
    devices, and the sizes (the configuration's, or a CPU rehearsal's)."""

    spec: Spec
    seed: int
    devices: list
    config: dict
    on_card: bool
    library: dict | None = None

    def load_library(self) -> None:
        """Load the program's kernel library now, timed apart from the rest
        of the set-up; in a checkout with no library for the program's
        sources this builds it (nvcc)."""
        if not self.on_card:
            return
        built = not library_built()
        t = time.perf_counter()
        from pyloo_tpu_torch import _build

        _build.load()
        self.library = {"built": built, "load_s": time.perf_counter() - t}

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def sync(self) -> None:
        if self.on_card:
            for d in dict.fromkeys(self.devices):
                torch.cuda.synchronize(d)


@dataclass
class Window:
    """What the metric readers read."""

    case: object
    setup_s: float
    walls: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: tracing.Trace | None = None


def library_built() -> bool:
    """Whether the program's kernel library is loaded or built for its sources."""
    from pyloo_tpu_torch import _build

    return _build.is_built()


def card_line(chips: int) -> str:
    """The cards' names and power limits, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as err:
        out = [f"nvidia-smi failed: {err}"]
    return f"{chips} of {len(out)} card(s): " + "; ".join(out[:chips] or ["none listed"])


def resolve_devices(chips: int, device: str) -> list:
    """The run's devices: the first ``chips`` cards, or for a CPU rehearsal
    ``chips`` shards of the CPU.  Raises :class:`Refused` when torch sees
    fewer cards than the cell asks for."""
    if device == "cpu":
        return [torch.device("cpu")] * chips
    if not torch.cuda.is_available():
        raise Refused("torch finds no CUDA device: the benchmark measures on the card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, torch sees"
                      f" {torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


def rehearsal_config(config: dict, n_obs: int | None, draws: int | None) -> dict:
    """The configuration at a CPU rehearsal's size: every row count scaled
    to ``n_obs`` (keys starting ``n_obs``, in proportion) and ``draws``."""
    out = dict(config)
    if n_obs is not None:
        scale = n_obs / config["n_obs"]
        for key, value in config.items():
            if key.startswith("n_obs"):
                out[key] = max(8, int(value * scale))
    if draws is not None:
        out["draws"] = draws
    return out


def window(case, run: Run, seconds: float) -> tuple:
    """The closed loop: calls back to back until ``seconds`` have passed,
    each timed by the host's clock up to a synchronise.  (walls, the last
    result)."""
    walls, result = [], None
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        result = case.call()
        run.sync()
        walls.append(time.perf_counter() - t)
        if time.perf_counter() - start >= seconds:
            return walls, result


def peak_bytes(run: Run) -> int:
    if not run.on_card:
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(run.devices))


def reset_peak(run: Run) -> None:
    if run.on_card:
        for d in dict.fromkeys(run.devices):
            torch.cuda.reset_peak_memory_stats(d)


def read_metrics(metrics: list, ctx: Window) -> dict:
    """Each metric's reader, ``metrics/<name>.py``; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"_metric_{len(out)}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``pyloo_tpu_torch`` is not ``pyloo_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(args, t0: float, bench_json: Path, out=print, err=None) -> int:
    """One run of the cell ``args.workload``; returns the exit code."""
    err = err or (lambda line: print(line, file=sys.stderr, flush=True))
    try:
        spec = Spec.load(bench_json, args.workload)
        chips = int(spec.cell["chips"])
        devices = resolve_devices(chips, args.device)
    except Refused as why:
        err(f"benchmark: {why}")
        return 2
    on_card = args.device != "cpu"
    if on_card:
        if args.n_obs is not None or args.draws is not None:
            err("benchmark: on the card a cell runs at its full size")
            return 2
        err(card_line(chips))
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
        torch.backends.cudnn.allow_tf32 = False
    else:
        err("cpu: a rehearsal; no number of this run is a device metric")
    config = rehearsal_config(spec.config, args.n_obs, args.draws)
    run = Run(spec, args.seed, devices, config, on_card)

    entry = load_module(HERE / "entries" / f"{spec.traffic['entry']}.py", "_entry")
    had_library = library_built() if on_card else False
    case = entry.prepare(run)
    first = time.perf_counter()
    result = case.call()
    run.sync()
    now = time.perf_counter()
    ctx = Window(case, setup_s=now - t0)
    if on_card and run.library is None:  # a path that loads it, if at all, in its first call
        run.library = {"built": not had_library and library_built(), "load_s": None}
    err(f"set-up {ctx.setup_s:.3f} s, of it the first call {now - first:.3f} s;"
        f" the kernel library {run.library}")
    setup_peak = peak_bytes(run)
    reset_peak(run)
    if args.trace:
        calls = int(spec.workload["trace_calls"])
        result, ctx.trace = tracing.traced_calls(case.call, calls, run.sync,
                                                 [d.index for d in devices], on_card)
        ctx.peak_bytes = peak_bytes(run)
        metrics = read_metrics(spec.per_layer, ctx)
    else:
        ctx.walls, result = window(case, run, args.seconds)
        ctx.peak_bytes = peak_bytes(run)
        metrics = read_metrics(spec.end_to_end, ctx)
    attempted = len(ctx.walls) if not args.trace else ctx.trace.calls

    outputs = case.outputs(result)  # host copies: the program keeps no state between calls
    del result
    if on_card:
        torch.cuda.empty_cache()
    readings = case.compare(outputs, case.reference())
    correct, checks = judged(readings, spec.workload["limits"])

    found = loaded_forbidden()
    if found:
        err(f"benchmark: loaded {', '.join(found)} in the measured process")
        return 3
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": max(setup_peak, ctx.peak_bytes),
    }
    line = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.mean_busy_us() / 1e6
        device["window_s"] = ctx.trace.window_us / 1e6
        line["breakdown"] = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    line["setup"] = {"library_built": bool(run.library and run.library["built"]),
                     "library_load_s": run.library and run.library["load_s"]}
    line["checks"] = checks
    if ctx.walls:
        w = sorted(ctx.walls)
        err(f"walls: {len(w)} calls, min {w[0]:.4f} median {w[len(w) // 2]:.4f}"
            f" max {w[-1]:.4f} s; in order: {' '.join(f'{x:.3f}' for x in ctx.walls)}")
    for name, m in metrics.items():
        err(f"metric {name}: {m['value']!r} {m['unit']}")
    for name, c in checks.items():
        err(f"check {name}: {c['value']!r} limit {c['limit']!r}"
            f" {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    out(json.dumps(line))
    return 0 if correct else 1
