"""Where kernels A and B of pyloo_tpu_torch spend their time, stage by stage.

Builds copies of a prepass kernel source (``csrc/topk_prepass.cu`` or an
earlier version of it) and times them on the card with CUDA events (median
of 7 runs after a warm-up) at one shape.  A source with the ``// cut N``
markers is also built cut right after each stage:

1. load: the row from device memory, with max, min and the first-digit
   histogram;
2. + radix select: the k-th key's bin narrowed until its keys fit the
   candidate buffer, and the candidate pass (with kernel A's two row sums);
3. + compaction: the exact k-th key and the winners gathered;
4. + sort: the top k sorted and written (kernel B is complete here);
5. + sums: the scalar outputs (kernel A complete).

A cut copy writes one value that depends on the work before the cut, so the
compiler keeps that work.  Each whole copy is held to ``loo_prepass_plain``
and ``torch.topk`` on the same rows (vals bitwise, the sums' max |err|),
with its count of rows that overflowed the first digit.  ``--swap-row-exp``
adds a whole copy of each source whose two row sums take the other exp:
``expf`` where the source has ``ex2.approx`` (the special-function unit's),
and the reverse.  The copies are built with ``nvcc``, one
process per copy, all started together, under ``build/pyloo_tpu_torch/``.
On a machine with a CUDA card, from the root of the repository::

    python3 -m pyloo_tpu_torch.tools.prepass_stages
    python3 -m pyloo_tpu_torch.tools.prepass_stages --source OLD.cu --data concentrated

``--data normal`` rows are x = 1 - 0.8 z; ``concentrated`` rows are
x = 0.7 + 0.01 z, a posterior's spread of one observation's -log_lik, whose
draws share their first digit.  Prints one line per copy and, last, one
JSON object with the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

from ._stages import add_shape_arguments, build, card, insert_at, median_ms, rows

STAGES = ("load", "+ radix select", "+ compaction", "+ sort", "+ sums")

# (marker line, code inserted after it): a cut goes on to the warp's next row
_CUTS = {
    1: (r"^\s*// cut 1: load",
        "if (lane == 0) vals[r * k] = __uint_as_float(hist[lane]) + mx + mn; continue;"),
    2: (r"^\s*// cut 2: radix select",
        "if (lane == 0) vals[r * k] = __uint_as_float(cand[0]) + s_ll + s_lo; continue;"),
    3: (r"^\s*// cut 3: compaction",
        "if (lane == 0) vals[r * k] = __uint_as_float(win[P - 1]) + s_ll + s_lo; continue;"),
    4: (r"^\s*// cut 4: sort", "if (lane == 0) vals[r * k] += s_ll + s_lo; continue;"),
}
# the body of row_exp (one line or several; it holds no brace)
_ROW_EXP = re.compile(r"(float row_exp\(float z\) \{)([^}]*)(\})")
_EXPF = "\n  return expf(z);\n"
_EX2 = ('\n  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(z * 1.4426950408889634f));'
        "\n  return y;\n")


def has_cuts(text: str) -> bool:
    return all(re.search(pattern, text, re.MULTILINE) for pattern, _ in _CUTS.values())


def cut_source(text: str, stop: int) -> str:
    """The source cut after stage ``stop`` (5: the source as it is)."""
    if stop >= 5:
        return text
    return insert_at(text, *_CUTS[stop])


def copies(text: str, label: str, swap_row_exp: bool) -> list[tuple[str, int, str]]:
    """(label, stage, source) of every copy to build from one source."""
    out = [(label, stop, cut_source(text, stop)) for stop in (range(1, 6) if has_cuts(text) else [5])]
    found = _ROW_EXP.search(text)
    if swap_row_exp and found:
        other, name = (_EXPF, "expf") if "ex2.approx" in found.group(2) else (_EX2, "ex2")
        swapped = _ROW_EXP.sub(lambda m: m.group(1) + other + m.group(3), text, count=1)
        out.append((f"{label} row_exp={name}", 5, swapped))
    return out


def entries(path: Path, text: str):
    """(kernel A, kernel B) as callables ``f(x, k, outs, overflow)``.  Sources
    older than the overflow counter take no counter argument."""
    import torch

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    counter = "void* overflow, void* stream" in text
    lib.pyloo_loo_prepass_f32.argtypes = [i, p, i, i, i, i, p, p, p, p] + [p] * counter + [p]
    lib.pyloo_topk_desc_f32.argtypes = [i, p, i, i, i, i, p] + [p] * counter + [p]
    lib.pyloo_loo_prepass_f32.restype = lib.pyloo_topk_desc_f32.restype = i

    def call(fn, x, k, outs, overflow):
        stream = torch.cuda.current_stream().cuda_stream
        extra = [overflow.data_ptr()] if counter else []
        code = fn(x.device.index, x.data_ptr(), x.shape[0], x.shape[1], x.shape[1], k,
                  *[o.data_ptr() for o in outs], *extra, stream)
        if code != 0:
            raise RuntimeError(f"launch failed with cudaError {code}")

    return (lambda x, k, outs, ov: call(lib.pyloo_loo_prepass_f32, x, k, outs, ov),
            lambda x, k, outs, ov: call(lib.pyloo_topk_desc_f32, x, k, outs[:1], ov))


def main() -> int:
    import torch

    from pyloo_tpu_torch._build import BUILD_DIR
    from pyloo_tpu_torch.ops.topk import loo_prepass_plain

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    default = Path(__file__).resolve().parent.parent / "csrc" / "topk_prepass.cu"
    parser.add_argument("--source", action="append", help=f"a kernel source (default {default})")
    add_shape_arguments(parser)
    parser.add_argument("--swap-row-exp", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    todo = []
    for source in args.source or [str(default)]:
        text = Path(source).read_text()
        todo += [(label, stop, cut, text) for label, stop, cut in copies(text, source, args.swap_row_exp)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    b, s, k = args.rows, args.s, args.k
    result = {"card": smi, "shape": [b, s, k], "data": args.data, "copies": []}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        libs = build([cut for _, _, cut, _ in todo], Path(tmp))
        x = rows(args.data, b, s)
        want = loo_prepass_plain(x, k)
        want_b = torch.topk(x, k, dim=1).values
        outs = [torch.empty((b, k), device="cuda")] + list(torch.empty((3, b), device="cuda"))
        overflow = torch.zeros(1, dtype=torch.int32, device="cuda")
        for (label, stop, _, text), path in zip(todo, libs):
            kern_a, kern_b = entries(path, text)
            got = {"source": label, "stage": STAGES[stop - 1],
                   "A_ms": median_ms(lambda: kern_a(x, k, outs, overflow)),
                   "B_ms": median_ms(lambda: kern_b(x, k, outs, overflow))}
            line = f"  {label} {STAGES[stop - 1]:>15}: A {got['A_ms']:.3f} ms, B {got['B_ms']:.3f} ms"
            if stop == 5:
                overflow.zero_()
                kern_a(x, k, outs, overflow)
                counted = "void* overflow, void* stream" in text
                got["overflow_rows"] = int(overflow.item()) if counted else None
                got["vals_bitwise"] = torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])
                got["sums_max_abs_err"] = max(float((o - w).abs().max())
                                              for o, w in zip(outs[2:], want[2:]))
                kern_b(x, k, outs, overflow)
                got["B_bitwise"] = torch.equal(outs[0], want_b)
                line += (f"; A vals, C bitwise {got['vals_bitwise']}, sums max |err|"
                         f" {got['sums_max_abs_err']:.3g}; B bitwise {got['B_bitwise']};"
                         f" {got['overflow_rows']} of {b} rows overflowed the first digit"
                         f"{'' if counted else ' (not counted by this source)'}")
            result["copies"].append(got)
            print(line, flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
