"""Float64 ``loo()`` of two versions of the package, with and without a deep-tail row.

Times ``loo(idata, pointwise=True)`` in float64 at ``--rows`` x 4,000 draws
on one card, with no mesh and over four shards of ``cuda:0``, on rows of
N(-1, 0.7) and on the same rows with row 5 replaced by a t(2) row whose tail
lies far below e^-60 (the float64 deep-tail guard's case).  Each version runs
in a process of its own, in the order other, this, this, other; a process
makes the rows on the card from one seed, makes a warm-up call of each
case, counts the synchronising CUDA calls of one call (torch's sync debug
mode, "warn"), then times two calls (a host clock around a call that ends
synchronised).  The last line is one JSON object with every process's
numbers and whether the two versions' results are equal bit for bit.

On a machine with a CUDA card, from the root of the repository, with another
version unpacked under ``build/`` (``git archive REV | tar -x -C build/other``)::

    python3 pyloo_tpu_torch/tools/guard_pair.py --other build/other
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

S, CHAINS = 4_000, 4
DEEP_ROW = 5


def _rows(n_rows: int, deep: bool):
    """(chains, draws, n_rows) float32 host log-likelihoods made on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    ll = torch.randn((S, n_rows), generator=gen, device="cuda") * 0.7 - 1.0
    if deep:  # t(2) = z / sqrt(chi2_2 / 2), chi2_2 = -2 log u
        z = torch.randn((S,), generator=gen, device="cuda", dtype=torch.float64)
        u = torch.rand((S,), generator=gen, device="cuda", dtype=torch.float64)
        ll[:, DEEP_ROW] = (z / torch.sqrt(-torch.log(u)) * 8.0 - 30.0).float()
    return ll.cpu().numpy().reshape(CHAINS, S // CHAINS, n_rows)


def child(root: str, n_rows: int) -> dict:
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import pyloo_tpu_torch as pl
    from pyloo_tpu_torch.parallel import Mesh, sharding

    assert os.path.abspath(pl.__file__).startswith(os.path.abspath(root))
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float64"
    shards = Mesh(["cuda:0"] * 4)
    real = sharding._visible_devices
    out = {"root": root, "cases": {}}
    for deep in (False, True):
        idata = pl.from_dict(log_likelihood={"y": _rows(n_rows, deep)})
        for mesh in (None, shards):
            sharding._visible_devices = (lambda: list(mesh.devices)) if mesh else (lambda: [])

            def call():
                torch.cuda.synchronize()
                t = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    res = pl.loo(idata, pointwise=True, reff=1.0)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t

            res, first = call()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    pl.loo(idata, pointwise=True, reff=1.0)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            walls = [call()[1] for _ in range(2)]
            digest = hashlib.sha256(np.ascontiguousarray(res.loo_i.values).tobytes())
            digest.update(np.ascontiguousarray(res.pareto_k.values).tobytes())
            key = f"{'deep' if deep else 'plain'}, {'mesh of 4' if mesh else 'no mesh'}"
            out["cases"][key] = {"first_s": first, "walls_s": walls, "syncs": syncs,
                                 "elpd_loo": res["elpd_loo"], "digest": digest.hexdigest()}
            print(f"  {root}: {key}: {', '.join(f'{w:.3f}' for w in walls)} s"
                  f" (first {first:.3f} s), {syncs} synchronising calls", flush=True)
        sharding._visible_devices = real
        del idata
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="root of another version (holds pyloo_tpu_torch/)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--rows", type=int, default=262_144)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print("CHILD " + json.dumps(child(args.child, args.rows)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for name, root in (("other", args.other), ("this", here), ("this", here),
                       ("other", args.other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                               "--rows", str(args.rows)], capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = next(x for x in proc.stdout.splitlines() if x.startswith("CHILD "))
        runs.append({"version": name, **json.loads(line[len("CHILD "):])})
    by = {name: next(r for r in runs if r["version"] == name) for name in ("other", "this")}
    same = {key: by["other"]["cases"][key]["digest"] == case["digest"]
            for key, case in by["this"]["cases"].items()}
    print(f"  results equal to the other version's bit for bit: {same}", flush=True)
    print(json.dumps({"card": smi, "rows": args.rows, "draws": S, "runs": runs,
                      "bitwise_equal": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
