"""Readings that set a cell's limits: the program's and the control's.

    python3 benchmark/control.py --workload NAME --seeds 11 12 13 [--out FILE]

For each seed, in one process: the cell's inputs made as a run makes them,
one call of the entry point, the program's outputs compared with the plain
reference (the sound readings, whose largest over a dozen seeds or more is
a limit's lower reading), and the control, the reference computed one
precision below the traffic's, put in the program's place and compared the
same way (whose smallest is a limit's upper reading).  One JSON line a seed
on standard output, and in ``--out``; ``--device cpu --n-obs N`` rehearses
it on the CPU.  The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # this folder's module names would hide the standard library's


def largest_gaps(got, want, n: int = 10) -> list:
    """The ``n`` largest |got - want| over the rows both sides give finite,
    widest first: where a row-count limit's threshold lies against them."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both = np.isfinite(got) & np.isfinite(want)
    return np.sort(np.abs(got[both] - want[both]))[::-1][:n].tolist()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--n-obs", type=int)
    parser.add_argument("--draws", type=int)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import checks, core

    spec = core.Spec.load(ROOT / "BENCHMARK.json", args.workload)
    try:
        devices = core.resolve_devices(int(spec.cell["chips"]), args.device)
    except core.Refused as why:
        print(f"control: {why}", file=sys.stderr)
        return 2
    on_card = args.device != "cpu"
    if on_card:
        print(core.card_line(len(devices)), file=sys.stderr, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = core.rehearsal_config(spec.config, args.n_obs, args.draws)
    entry = core.load_module(core.HERE / "entries" / f"{spec.traffic['entry']}.py", "_entry")
    limits = spec.workload["limits"]
    failed_sound = 0
    for seed in args.seeds:
        run = core.Run(spec, seed, devices, config, on_card)
        case = entry.prepare(run)
        t = time.perf_counter()
        outputs = case.outputs(case.call())
        run.sync()
        call_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = case.reference()
        ref_s = time.perf_counter() - t
        t = time.perf_counter()
        ctrl = case.reference(control=True)
        ctrl_s = time.perf_counter() - t
        sound = case.compare(outputs, ref)
        control = case.compare(ctrl, ref)
        sound_ok, _ = checks.judged(sound, limits)
        control_ok, _ = checks.judged(control, limits)
        failed_sound += not sound_ok
        record = {"workload": args.workload, "seed": seed, "sound": sound,
                  "control": control, "sound_within_limits": sound_ok,
                  "control_within_limits": control_ok, "call_s": call_s,
                  "reference_s": ref_s, "control_s": ctrl_s}
        if "p_loo" in ref:  # every row's k on both sides
            record["largest_k_gaps"] = {"sound": largest_gaps(outputs["k"], ref["k"]),
                                        "control": largest_gaps(ctrl["k"], ref["k"])}
        line = json.dumps(record)
        print(line, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(line + "\n")
        del case, outputs, ref, ctrl
        if on_card:
            torch.cuda.empty_cache()
    return 1 if failed_sound else 0


if __name__ == "__main__":
    sys.exit(main())
