"""Where the float64 cell's ingest time goes, on the card's host.

``loo()`` copies the cell's host array, ``(4, 1000, 262_144)`` float64
(8.4 GB), to the card from pageable memory: the CUDA driver moves it through
its staging buffers with one host thread.  This script makes that array
from the cell's model and, in rounds, times what the copy's rate could
depend on: one host thread's ``np.copyto`` of the array, the pageable copy
of the array and of a second one allocated with ``MADV_HUGEPAGE``, with the
page faults and CPU time of each, and the copy from pinned memory.  Then
the pageable copy in 64 MB pieces, and the pageable copy on one CPU.

Usage, from the root of the repository, on a machine with a card::

    python3 bench_torch/copy_probe.py
"""

from __future__ import annotations

import os
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repository's root onto the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import bench  # noqa: E402
from bench_torch import model as bench_model  # noqa: E402

PIECE = 8 << 20  # float64 values: 64 MB
ROUNDS = 10


def h2d(src, gb: float):
    """(GB/s, minor faults, user s, system s) of one copy of ``src`` to the card."""
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = torch.from_numpy(src).to("cuda") if isinstance(src, np.ndarray) else src.to("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    del x
    return (gb / wall, r1.ru_minflt - r0.ru_minflt, r1.ru_utime - r0.ru_utime,
            r1.ru_stime - r0.ru_stime)


def pieces(a: np.ndarray, dev: torch.Tensor) -> np.ndarray:
    """GB/s of each 64 MB piece of ``a`` copied to ``dev`` from pageable memory."""
    flat, d = a.reshape(-1), dev.reshape(-1)
    rates = []
    for j in range(0, flat.size, PIECE):
        n = min(PIECE, flat.size - j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        d[j:j + n].copy_(torch.from_numpy(flat[j:j + n]))
        torch.cuda.synchronize()
        rates.append(n * 8 / (time.perf_counter() - t) / 1e9)
    return np.array(rates)


def main() -> int:
    if not torch.cuda.is_available():
        print("copy_probe: torch finds no CUDA device; the probe runs on the card's host",
              file=sys.stderr)
        return 1
    from numpy._core import multiarray

    print(bench.card_line(torch.device("cuda")), flush=True)
    print(f"host kernel {os.uname().release}, {os.cpu_count()} CPUs, numpy {np.__version__}"
          f" (MADV_HUGEPAGE by default: {multiarray._get_madvise_hugepage()})", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model_obs, rows = bench.CELLS[bench.HOST_CELL]
    model = bench_model.logistic_model(model_obs, bench_model.CHAINS, bench_model.DRAWS,
                                       bench.SEED, "cuda")
    a = bench_model.host_log_lik_f64(model, rows)
    del model
    gb = a.nbytes / 1e9
    other = np.empty_like(a)
    np.copyto(other, a)
    saved = multiarray._get_madvise_hugepage()
    multiarray._set_madvise_hugepage(True)
    huge = np.empty_like(a)
    multiarray._set_madvise_hugepage(saved)
    np.copyto(huge, a)
    pinned = torch.empty(a.shape, dtype=torch.float64, pin_memory=True)
    pinned.copy_(torch.from_numpy(a))
    print(f"array {gb:.3f} GB; round: host np.copyto GB/s | pageable GB/s (minor faults,"
          " user s, system s) | pageable, MADV_HUGEPAGE | pinned GB/s", flush=True)
    for i in range(ROUNDS):
        t = time.perf_counter()
        np.copyto(other, a)
        host = gb / (time.perf_counter() - t)
        p, h, pin = h2d(a, gb), h2d(huge, gb), h2d(pinned, gb)
        print(f"  {i}: {host:.3f} | {p[0]:.3f} ({p[1]}, {p[2]:.3f}, {p[3]:.3f}) | {h[0]:.3f}"
              f" ({h[1]}, {h[2]:.3f}, {h[3]:.3f}) | {pin[0]:.3f}", flush=True)
    del pinned, huge, other
    dev = torch.empty(a.shape, dtype=torch.float64, device="cuda")
    for i in range(2):
        r = pieces(a, dev)
        print(f"  64 MB pieces, copy {i}: min {r.min():.3f}, p10 {np.percentile(r, 10):.3f},"
              f" median {np.median(r):.3f}, p90 {np.percentile(r, 90):.3f}, max {r.max():.3f}"
              f" GB/s; the six slowest at pieces {np.argsort(r)[:6].tolist()} of {r.size}",
              flush=True)
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[-1]})
    one = [h2d(a, gb)[0] for _ in range(4)]
    os.sched_setaffinity(0, set(cpus))
    print(f"  pageable on CPU {cpus[-1]} alone: {', '.join(f'{r:.3f}' for r in one)} GB/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
