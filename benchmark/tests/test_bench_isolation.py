"""Nothing the benchmark runs imports JAX, the JAX package or the older
``bench_torch``, compared by whole top-level names (``pyloo_tpu_torch``
begins with ``pyloo_tpu`` and is the program); the references import
nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark import checks, core, run, control, measure, model, trace
from benchmark import reference, reference_torch
b = Path({root!r}) / "benchmark"
for group in ("entries", "metrics"):
    for i, p in enumerate(sorted((b / group).glob("*.py"))):
        core.load_module(p, f"_{{group}}_{{i}}")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import reference, reference_torch
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax_nor_the_jax_package():
    names = top_level_names(LOAD_ALL)
    assert "pyloo_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "pyloo_tpu", "bench_torch"}


def test_the_references_load_nothing_of_the_program():
    names = top_level_names(LOAD_REFERENCE)
    assert not names & {"pyloo_tpu_torch", "pyloo_tpu", "jax", "bench_torch"}


def test_a_run_refuses_a_loaded_jax_package(monkeypatch):
    from benchmark import core

    monkeypatch.setitem(sys.modules, "pyloo_tpu.fake", object())
    assert core.loaded_forbidden() == ["pyloo_tpu"]
    monkeypatch.delitem(sys.modules, "pyloo_tpu.fake")
    monkeypatch.setitem(sys.modules, "pyloo_tpu_torch_like", object())
    assert core.loaded_forbidden() == []
