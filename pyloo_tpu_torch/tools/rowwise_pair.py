"""Two versions of ``apply_rowwise`` under ``loo()``'s float32 scorer, on one card.

Loads ``parallel/sharding.py`` of this package and another version of that
file (``--other``, for instance ``git show REV:pyloo_tpu_torch/parallel/sharding.py``
written to a file, loaded as a module of this package's ``parallel`` so that
its relative imports resolve here) and
times ``apply_rowwise(lambda b: loo_scores_psis_fast(b, m_tail), matrix)``
with each on the same ``(rows, S)`` float32 matrix on the card, in the order
other, this, this, other after one warm-up call of each: a host clock around
a call that ends synchronised, and the peak device memory of each call.  The
outputs of the two versions are held bitwise equal.  On a machine with a
CUDA card, from the root of the repository::

    python3 -m pyloo_tpu_torch.tools.rowwise_pair --other OLD_sharding.py

Prints one line per call and, last, one JSON object with the times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

from ._stages import card, rows


def load_apply_rowwise(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"pyloo_tpu_torch.parallel.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.apply_rowwise


def main() -> int:
    import torch

    from pyloo_tpu_torch.ops import tail_length
    from pyloo_tpu_torch.ops.loo_kernels import loo_scores_psis_fast

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, help="another version of parallel/sharding.py")
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--s", type=int, default=4_000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    this = Path(__file__).resolve().parent.parent / "parallel" / "sharding.py"
    versions = {"other": load_apply_rowwise(Path(args.other), "_rowwise_other"),
                "this": load_apply_rowwise(this, "_rowwise_this")}
    matrix = -rows("normal", args.rows, args.s)  # log-likelihood rows
    m_tail = tail_length(args.s, 1.0)

    def call(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = versions[name](lambda b: loo_scores_psis_fast(b, m_tail), matrix)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() / 1e9

    warm = {name: call(name)[0] for name in versions}
    same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))  # NaN equal to NaN
               for a, b in zip(warm["other"], warm["this"], strict=True))
    del warm
    result = {"card": smi, "shape": [args.rows, args.s], "bitwise_equal": same, "calls": []}
    for name in ("other", "this", "this", "other"):
        _, wall, peak = call(name)
        result["calls"].append({"version": name, "wall_s": wall, "peak_gb": peak})
        print(f"  {name:>5}: {wall:.4f} s wall, peak device memory {peak:.2f} GB", flush=True)
    print(f"  outputs of the two versions bitwise equal: {same}", flush=True)
    print(json.dumps(result))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
