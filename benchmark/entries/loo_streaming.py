"""``loo_streaming`` over the logistic model made on the cards.

The log-likelihood is made chunk by chunk on the card by the model's
generator, at the default chunking, ``pointwise=True``; over a mesh of the
run's cards when the traffic asks for one, each card holding its own copy of
the model.  The reference makes every chunk (every shard) again with the
indices the program was given and scores every row in float64 with the
plain torch PSIS; the control scores them one precision below the traffic's.

Compared: ``loo_i_gap`` (every row, relative to 1 + |loo_i|) and ``k_gap``
(every row, absolute; in float32 its 99.99th percentile, ``k_gap_q9999``)
over the rows both sides give finite,
``nonfinite_mismatches`` (rows one side gives finite and the other not), and ``elpd_gap``, ``p_loo_gap``, ``se_gap``
(relative): the selection, the fit, and the accumulation over every chunk.
"""

from __future__ import annotations

import numpy as np
import torch

import pyloo_tpu_torch as pl
from pyloo_tpu_torch.parallel import Mesh

from benchmark import checks, reference, reference_torch
from benchmark.model import LogisticModel

BLOCK = 131072  # rows the reference makes and scores at a time


class Case:
    def __init__(self, run):
        cfg, traffic = run.config, run.traffic
        self.dtype = getattr(torch, traffic["dtype"])
        if self.dtype == torch.float32:
            run.load_library()  # the float32 path launches kernel A
        devices = run.devices if traffic["mesh"] else run.devices[:1]
        self.devices = devices
        self.model = LogisticModel(cfg, cfg["n_obs"], run.seed, devices)
        self.fn = self.model.log_lik_fn()
        self.n_obs, self.n_draws = cfg["n_obs"], self.model.n_draws
        self.mesh = Mesh(devices) if traffic["mesh"] else None
        self.reff = float(traffic["reff"])
        self.tail = reference.tail_length(self.n_draws, self.reff)
        pl.rcParams["device.device"] = devices[0].type
        pl.rcParams["device.precision"] = traffic["dtype"]
        # what the metrics read
        f, n, s = self.model.n_features, self.n_obs, self.n_draws
        self.rows_per_call = n
        self.generator_calls_per_chunk = len(devices)  # one call a shard
        # the log-likelihood written once and read once, xw read once; the matmul
        self.call_bytes = 2 * self.dtype.itemsize * n * s + 4 * n * f
        self.call_flops = 2 * n * s * f
        # kernel A reads every row once and writes the tail's values and three sums a row
        self.kernel_a_bytes_per_call = 4 * n * (s + self.tail + 1 + 3)

    def call(self):
        return pl.loo_streaming(self.fn, self.n_obs, self.n_draws, reff=self.reff,
                                dtype=self.dtype, pointwise=True, mesh=self.mesh)

    outputs = staticmethod(checks.loo_outputs)

    def reference(self, control: bool = False) -> dict:
        """Every row made again and scored: in float64, or for the control
        one precision below."""
        dtype = checks.CONTROL_DTYPE[self.dtype] if control else torch.float64
        loo_i = np.empty(self.n_obs)
        k = np.empty(self.n_obs)
        totals = reference_torch.Totals()
        for lo in range(0, self.n_obs, BLOCK):
            hi = min(lo + BLOCK, self.n_obs)
            ll = self.fn(torch.arange(lo, hi, device=self.devices[0]))
            e, kk, lp = reference_torch.score_rows(ll, self.tail, dtype)
            del ll
            totals.add(e, lp)
            loo_i[lo:hi] = e.cpu().numpy()
            k[lo:hi] = kk.cpu().numpy()
        return {"loo_i": loo_i, "k": k, **totals.result()}

    def compare(self, out: dict, ref: dict) -> dict:
        return checks.compare_loo(out, ref, float32_fit=self.dtype == torch.float32)


def prepare(run) -> Case:
    return Case(run)
