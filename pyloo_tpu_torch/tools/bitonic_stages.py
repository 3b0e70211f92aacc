"""Where kernels C and D of pyloo_tpu_torch spend their time, stage by stage.

Builds copies of a bitonic top-k source (``csrc/topk_bitonic.cu`` or an
earlier version of it) and times kernel C (``reshape``) and kernel D
(``natural``) of each on the card with CUDA events (median of 7 runs after
a warm-up) at one shape.  Each source is built whole and cut right after

1. load: the row from device memory into the working storage (registers;
   shared memory in the block-per-row kernel);
2. + segment sort: the 36-stage bitonic network over every 256-wide segment;
3. + merge rounds: the max-merges of segment pairs, each with its 8-stage
   half-cleaner;
4. the whole kernel, with the write of the k values.

The cuts go at the source's ``// cut N`` markers; the block-per-row kernel,
which has none, is cut at its phase comments.  A cut copy writes one value
that depends on the work before the cut, so the compiler keeps that work.
Each whole copy is held bitwise to ``torch.topk`` on the same rows.
``--sass`` counts the instructions of each whole copy's segment loop by
opcode, from ``cuobjdump -sass`` (a loop pass sorts and merges one segment
for each group of lanes that holds one: two with 16 registers a lane).  The
copies are built with ``nvcc``, one process per copy, all started together,
under ``build/pyloo_tpu_torch/``.  On a machine with a CUDA card, from the root of
the repository::

    python3 -m pyloo_tpu_torch.tools.bitonic_stages
    python3 -m pyloo_tpu_torch.tools.bitonic_stages --source OLD.cu --data concentrated

``--data normal`` rows are x = 1 - 0.8 z; ``concentrated`` rows are
x = 0.7 + 0.01 z.  Prints one line per copy and, last, one JSON object with
the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ._stages import add_shape_arguments, build, card, insert_at, median_ms, rows

STAGES = ("load", "+ segment sort", "+ merge rounds", "+ write")

# One warp a row, the segment in registers: a cut inside the loop over
# segments folds the segment into the survivor with one max an element and
# goes on to the next segment; every cut writes one value a row only, the
# largest of the lane's registers, so that none of them is dead.
_FOLD = "_Pragma(\"unroll\") for (int q = 0; q < kRegs; ++q) top[q] = fmaxf(top[q], seg[q]); continue;"
_ONE_VALUE = ("float m = top[0]; _Pragma(\"unroll\") for (int q = 1; q < kRegs; ++q) m = fmaxf(m, top[q]);"
              " if (lane == 0) vals[row * static_cast<size_t>(k)] = m; continue;")
_CUTS = {
    1: [(r"^\s*// cut 1: load", _FOLD, False), (r"^\s*// cut 3: merge rounds", _ONE_VALUE, False)],
    2: [(r"^\s*// cut 2: segment sort", _FOLD, False),
        (r"^\s*// cut 3: merge rounds", _ONE_VALUE, False)],
    3: [(r"^\s*// cut 3: merge rounds", _ONE_VALUE, False)],
}
# The block-per-row kernel (one row in shared memory): cut before its phases
_BLOCK_ONE_VALUE = ("if (tid == 0) vals[blockIdx.x * static_cast<size_t>(k)] = row[0] + row[n - 1];"
                    " return;")
_BLOCK_CUTS = {
    1: [(r"^\s*// Phase 1: sort every segment", _BLOCK_ONE_VALUE, True)],
    2: [(r"^\s*// Phase 2: merge rounds", _BLOCK_ONE_VALUE, True)],
    3: [(r"^\s*float\* vr = vals \+", _BLOCK_ONE_VALUE, True)],
}


def cuts_of(text: str):
    """The table of cuts that fits this source, or None when it has no marks."""
    for table in (_CUTS, _BLOCK_CUTS):
        if all(re.search(pattern, text, re.MULTILINE)
               for marks in table.values() for pattern, _, _ in marks):
            return table
    return None


def cut_source(text: str, stop: int) -> str:
    """The source cut after stage ``stop`` (4: the source as it is)."""
    if stop >= 4:
        return text
    for pattern, code, before in cuts_of(text)[stop]:
        text = insert_at(text, pattern, code, before)
    return text


def sass_counts(lib: Path, kernel: str) -> dict:
    """Instructions of the kernels of ``lib`` whose name holds ``kernel``, by
    opcode, as ``cuobjdump -sass`` lists them: ``{name: {"total": n,
    "loop": n, "opcodes": {opcode: n}}}``.  Only the path the warps take
    together is counted (what precedes the first WARPSYNC: the compiler
    appends a copy of every shuffle for diverged warps after the code).
    ``loop`` and ``opcodes`` are of the innermost largest loop (the largest
    backward branch that lies inside another), the body a segment or a row
    runs through; of the whole path when there is no such loop."""
    text = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if kernel in found.group(1) else None
            if name:
                kernels[name] = []
            continue
        found = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if found and name:
            kernels[name].append((int(found.group(1), 16), found.group(2).strip()))
    out = {}
    for name, listing in kernels.items():
        end = next((i for i, (_, ins) in enumerate(listing) if "WARPSYNC" in ins), len(listing))
        path = listing[:end]
        loops = []
        for addr, ins in path:
            found = re.search(r"\bBRA (0x[0-9a-f]+)", ins)
            if found and int(found.group(1), 16) < addr:
                loops.append((int(found.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in loops if any(a <= lo and hi < b for a, b in loops)]
        lo, hi = max(inner, key=lambda r: r[1] - r[0]) if inner else (0, path[-1][0])
        body = [re.sub(r"^@!?U?P\d\s+", "", ins).split()[0].split(".")[0]
                for addr, ins in path if lo <= addr <= hi]
        opcodes = {op: body.count(op) for op in sorted(set(body), key=body.count, reverse=True)}
        out[name] = {"total": len(path), "loop": len(body), "opcodes": opcodes}
    return out


def entries(path: Path):
    """(kernel C, kernel D) as callables ``f(x, k, vals)``."""
    import torch

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = []
    for name in ("pyloo_topk_reshape_f32", "pyloo_topk_natural_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [i, p, i, i, i, i, p, p]
        fn.restype = i

        def call(x, k, vals, fn=fn):
            code = fn(x.device.index, x.data_ptr(), x.shape[0], x.shape[1], x.stride(0), k,
                      vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"launch failed with cudaError {code}")

        fns.append(call)
    return fns


def main() -> int:
    import torch

    from pyloo_tpu_torch._build import BUILD_DIR

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    default = Path(__file__).resolve().parent.parent / "csrc" / "topk_bitonic.cu"
    parser.add_argument("--source", action="append", help=f"a kernel source (default {default})")
    parser.add_argument("--sass", action="store_true",
                        help="count the instructions of each whole copy's segment loop, by opcode")
    add_shape_arguments(parser)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    todo = []  # (label, stage, source text)
    for source in args.source or [str(default)]:
        text = Path(source).read_text()
        stops = range(1, 5) if cuts_of(text) else [4]
        todo += [(source, stop, cut_source(text, stop)) for stop in stops]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    b, s, k = args.rows, args.s, args.k
    result = {"card": smi, "shape": [b, s, k], "data": args.data, "copies": []}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        libs = build([cut for _, _, cut in todo], Path(tmp))
        x = rows(args.data, b, s)
        want = torch.topk(x, k, dim=1).values
        vals = torch.empty((b, k), device="cuda")
        for (label, stop, _), path in zip(todo, libs):
            kern_c, kern_d = entries(path)
            got = {"source": label, "stage": STAGES[stop - 1],
                   "C_ms": median_ms(lambda: kern_c(x, k, vals)),
                   "D_ms": median_ms(lambda: kern_d(x, k, vals))}
            line = f"  {label} {STAGES[stop - 1]:>15}: C {got['C_ms']:.3f} ms, D {got['D_ms']:.3f} ms"
            if stop == 4:
                for name, kern in (("C", kern_c), ("D", kern_d)):
                    vals.fill_(float("nan"))
                    kern(x, k, vals)
                    got[f"{name}_bitwise"] = torch.equal(vals, want)
                line += (f"; bitwise to torch.topk: C {got['C_bitwise']},"
                         f" D {got['D_bitwise']}")
            result["copies"].append(got)
            print(line, flush=True)
            if stop == 4 and args.sass:
                got["sass"] = sass_counts(path, "topk_bitonic_kernel")
                for name, counts in got["sass"].items():
                    top = ", ".join(f"{op} {n}" for op, n in list(counts["opcodes"].items())[:8])
                    print(f"    {name[-24:]}: {counts['loop']} instructions in the segment loop"
                          f" ({top}); {counts['total']} on the whole path", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
