"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, the benchmark and
``pyloo_tpu_torch``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit); the last lines of standard error are the same checks.
With no CUDA device, fewer cards than the cell asks for, or JAX or the JAX
package loaded, it exits non-zero and prints no result.  ``--device cpu``
with ``--n-obs`` (and ``--draws``) rehearses a cell on the CPU at a small
size: no number of such a run is a device metric.
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up counts from here: the imports are part of it
ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # the checkout's root in place of this script's folder, whose module names
    # (trace, model, ...) would hide the standard library's and torch's
    sys.path[0] = ROOT_DIR

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(ROOT_DIR)
# every cache the program or torch may write stays inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--n-obs", type=int, help="rows of a CPU rehearsal")
    parser.add_argument("--draws", type=int, help="draws a chain of a CPU rehearsal")
    args = parser.parse_args(argv)
    if args.device == "cpu" and args.n_obs is None:
        parser.error("--device cpu rehearses a cell at the size --n-obs gives")
    return args


def main(argv=None, t0: float = T0) -> int:
    args = parse(argv)
    from benchmark import core

    return core.run_cell(args, t0, ROOT / "BENCHMARK.json")


if __name__ == "__main__":
    sys.exit(main())
