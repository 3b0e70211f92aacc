"""pyloo_tpu_torch runs where neither JAX nor pandas exists.

The machine with the card has no JAX and no pandas, so the package must
import and run ``loo`` with both blocked, and must never import
``pyloo_tpu``.  A device of ``"cuda"`` without a CUDA device raises instead
of computing on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["pandas"] = None
sys.path.insert(0, {repo!r})
import torch
import pyloo_tpu_torch as pl

pl.rcParams["device.device"] = "cpu"
res = pl.loo(pl.load_example_data("centered_eight"))
assert round(res["elpd_loo"], 4) == -30.7807, res["elpd_loo"]
loaded = [m for m, mod in sys.modules.items() if mod is not None]
assert not any(m == "pyloo_tpu" or m.startswith(("pyloo_tpu.", "jax")) for m in loaded)

if not torch.cuda.is_available():
    pl.rcParams["device.device"] = "cuda"
    try:
        pl.loo(pl.load_example_data("centered_eight"))
    except RuntimeError as err:
        assert "no CUDA device" in str(err), err
    else:
        raise AssertionError("loo fell back to the CPU")
print("isolated ok")
"""


def test_runs_without_jax_or_pandas_and_never_falls_back():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=str(REPO))],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd=REPO.parent,
    )
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout


def test_no_source_imports_jax_or_pyloo_tpu():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|pyloo_tpu)\b", re.MULTILINE)
    offenders = [
        str(path.relative_to(REPO))
        for path in (REPO / "pyloo_tpu_torch").rglob("*.py")
        if pattern.search(path.read_text())
    ]
    assert offenders == []


def test_chip_smoke_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script runs in full there")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
