"""Where moment matching's pareto_k on the card parts from the CPU's.

The fuzz's ``mm`` mode (``pyloo_tpu_torch.tools.fuzz_differential``) runs
each trial on the card and again on the CPU.  Their ``loo_i`` agree within
1e-10; their ``pareto_k`` part by up to ~1e-9.  This script runs the mode's
trials of a seed (both the host loop and the device-batched loop, as the
mode does) on both, and records every moment-matching transform's draws and
every Pareto fit's inputs (``compute_importance_weights`` in the host loop,
``psislw_batch`` in the batched one) and k.  Paired call by call, it
reports for each trial how many units in the last place (ulps) the card's
transformed draws and log ratios lie from the CPU's, how far each fit's k
moved, and the k that the CPU fits to the card's own inputs: where that
equals the card's k, the fit adds nothing of its own and the whole of the
difference comes from the inputs' last bits.

Usage, from the root of the repository, on a machine with a card::

    python3 -m pyloo_tpu_torch.tools.mm_drift_probe [trials] [seed]

``trials`` (default 40) is the fuzz's count, of which ``mm`` takes a fifth
(at least 4); ``seed`` defaults to 20260818.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import warnings

import numpy as np
import torch

from ..ops import moment_match as omm
from . import fuzz_differential as fz
from ._harness import card_of, on_device

# the module (the package's attribute of that name is the function)
lmm = importlib.import_module("pyloo_tpu_torch.loo_moment_match")
CPU = torch.device("cpu")


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float64 steps between ``a`` and ``b`` where
    both are finite (0 if nowhere)."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    both = np.isfinite(a) & np.isfinite(b)
    if not both.any():
        return 0

    def ordered(x):
        i = x.view(np.int64)
        return np.where(i < 0, np.int64(-(2**63)) - i, i)

    return int(np.max(np.abs(ordered(a[both]) - ordered(b[both]))))


@contextlib.contextmanager
def recording(log: list):
    """Record each transform's draws and each Pareto fit's inputs and k."""
    real_ciw, real_batch, real_tf = (lmm.compute_importance_weights, omm.psislw_batch,
                                     omm._transform)

    def ciw(lr, **kwargs):
        lw, k = real_ciw(lr, **kwargs)
        log.append(("fit", np.array(lr, np.float64), np.asarray(k, np.float64).ravel(),
                    lambda x: real_ciw(x, **kwargs)[1]))
        return lw, k

    def batch(lr, m):
        lw, k = real_batch(lr, m)
        log.append(("fit", lr.detach().cpu().numpy(), k.detach().cpu().numpy().ravel(),
                    lambda x: real_batch(torch.from_numpy(x), m)[1]))
        return lw, k

    def transform(u, w, kind):
        res = real_tf(u, w, kind)
        log.append(("draws", res[0].detach().cpu().numpy(), None, None))
        return res

    lmm.compute_importance_weights, omm.psislw_batch = ciw, batch
    lmm._transform = omm._transform = transform
    try:
        yield log
    finally:
        lmm.compute_importance_weights, omm.psislw_batch = real_ciw, real_batch
        lmm._transform = omm._transform = real_tf


def run(spec, device):
    log: list = []
    with on_device(device), recording(log), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fz.run_mm(spec, device)
    return out, log


def trial_report(spec, card: torch.device) -> dict:
    got, card_log = run(spec, card)
    want, cpu_log = run(spec, CPU)
    rep = {"trial": spec["trial"], "tag": spec["tag"],
           "k_diff": {key: float(np.max(np.abs(got[f"{key}.pareto_k"] - want[f"{key}.pareto_k"])))
                      for key in ("host", "device")},
           "loo_i_diff": float(np.max(np.abs(got["device.loo_i"] - want["device.loo_i"]))),
           "calls": [len(card_log), len(cpu_log)]}
    if [e[0] for e in card_log] != [e[0] for e in cpu_log]:
        rep["paired"] = False  # the greedy loops took different steps
        return rep
    draw_ulps = lr_ulps = 0
    lr_abs = fit_k = refit = 0.0
    with on_device(CPU):
        for (kind, x_card, k_card, refit_fn), (_, x_cpu, k_cpu, _) in zip(card_log, cpu_log):
            if kind == "draws":
                draw_ulps = max(draw_ulps, ulps(x_card, x_cpu))
                continue
            lr_ulps = max(lr_ulps, ulps(x_card, x_cpu))
            fin = np.isfinite(x_card) & np.isfinite(x_cpu)
            lr_abs = max(lr_abs, float(np.max(np.abs(x_card[fin] - x_cpu[fin]), initial=0.0)))
            fin_k = np.isfinite(k_card) & np.isfinite(k_cpu)
            fit_k = max(fit_k, float(np.max(np.abs(k_card - k_cpu)[fin_k], initial=0.0)))
            k_again = np.asarray(refit_fn(x_card.copy()), np.float64).ravel()
            fin_k = np.isfinite(k_again) & np.isfinite(k_card)
            refit = max(refit, float(np.max(np.abs(k_again - k_card)[fin_k], initial=0.0)))
    rep.update(paired=True, draw_ulps=draw_ulps, log_ratio_ulps=lr_ulps, log_ratio_abs=lr_abs,
               fit_k_diff=fit_k, cpu_fit_of_card_inputs_vs_card_k=refit)
    return rep


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    trials = int(argv[0]) if argv else 40
    seed = int(argv[1]) if len(argv) > 1 else 20260818
    if not torch.cuda.is_available():
        print("mm_drift_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    card = torch.device("cuda", torch.cuda.current_device())
    print(f"card: {card_of(card)}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    rng = np.random.default_rng(seed)
    reports = []
    for trial in range(fz.trials_of("mm", trials)):
        reports.append(trial_report(fz.draw_mm(rng, trial), card))
        print(json.dumps(reports[-1]), flush=True)
    print(json.dumps({"seed": seed, "trials": reports}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
