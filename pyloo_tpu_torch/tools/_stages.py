"""What the stage scripts share: cut copies of a kernel source, built in
parallel, timed with CUDA events on rows made from a seed."""

from __future__ import annotations

import re
import subprocess
from pathlib import Path


def insert_at(text: str, pattern: str, code: str, before: bool = False) -> str:
    """``text`` with ``{ code }`` on a line of its own after (or before) every
    line that matches ``pattern``."""
    out = []
    for line in text.splitlines():
        found = re.search(pattern, line)
        if found and before:
            out.append(f"  {{ {code} }}")
        out.append(line)
        if found and not before:
            out.append(f"  {{ {code} }}")
    return "\n".join(out) + "\n"


def build(sources: list[str], work: Path) -> list[Path]:
    """Compile every copy in parallel (one ``nvcc`` a copy, all started
    together); returns their shared libraries."""
    from pyloo_tpu_torch import _build

    libs, procs = [], []
    for i, text in enumerate(sources):
        src = work / f"copy{i}.cu"
        src.write_text(text)
        lib = work / f"libcopy{i}.so"
        cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", str(src), "-o", str(lib)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        libs.append(lib)
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{out}")
    return libs


def median_ms(fn, runs: int = 7) -> float:
    """Median time of ``fn()`` on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def rows(kind: str, b: int, s: int):
    """x = -log_lik rows on the card, from seed 0: ``normal`` rows are
    x = 1 - 0.8 z, ``concentrated`` rows x = 0.7 + 0.01 z."""
    import torch

    z = torch.randn(b, s, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    return 1.0 - 0.8 * z if kind == "normal" else 0.7 + 0.01 * z


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def add_shape_arguments(parser) -> None:
    parser.add_argument("--rows", type=int, default=131_072)
    parser.add_argument("--s", type=int, default=4_000)
    parser.add_argument("--k", type=int, default=191)
    parser.add_argument("--data", choices=("normal", "concentrated"), default="normal")
