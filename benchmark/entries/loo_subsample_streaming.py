"""``loo_subsample_streaming`` over the logistic model made on the card.

Each call streams the LPD approximation of every observation chunk by
chunk (the traffic's dtype), draws the subsample from ``--seed`` (the
traffic's ``estimator`` and ``observations``), scores the sampled rows
exactly in float64 and forms the estimate, ``pointwise=True`` so that the
sampled rows' ``loo_i`` come back.  The reference makes every row again
from the model, in blocks of its own, and takes each row's LPD in
float64, draws the subsample with numpy from the same seed, makes the
sampled rows again as the program asked for them and scores them in
float64 with the plain torch PSIS, and forms the difference estimate with
its subsampling SE (Magnusson et al. 2020, arXiv:2001.09660).  The control
takes the LPD one precision below the traffic's, and the exact rows in
float32.

Compared: ``lpd_gap`` (every row, relative to 1 + |lpd|); ``loo_i_gap``
and ``k_gap`` of the reference's sampled rows, over the rows both sides
give finite; ``nonfinite_mismatches``, the rows one side gives finite and
the other not (a row the program did not sample reads NaN); ``elpd_gap`` and
``subsampling_se_gap`` (relative).
"""

from __future__ import annotations

import math

import numpy as np
import torch

import pyloo_tpu_torch as pl

from benchmark import reference, reference_torch
from benchmark.checks import CONTROL_DTYPE, rel_gap, row_gaps
from benchmark.model import LogisticModel

BLOCK = 131072  # rows the reference makes at a time


class Case:
    def __init__(self, run):
        cfg, traffic = run.config, run.traffic
        self.seed = run.seed
        self.dtype = getattr(torch, traffic["dtype"])
        self.device = run.devices[0]
        self.model = LogisticModel(cfg, cfg["n_obs"], run.seed, [self.device])
        self.fn = self.model.log_lik_fn()
        self.n_obs, self.n_draws = cfg["n_obs"], self.model.n_draws
        self.observations = int(traffic["observations"])
        self.estimator = traffic["estimator"]
        self.reff = 1.0
        self.tail = reference.tail_length(self.n_draws, self.reff)
        pl.rcParams["device.device"] = self.device.type
        pl.rcParams["device.precision"] = traffic["dtype"]
        f, n, s, m = self.model.n_features, self.n_obs, self.n_draws, self.observations
        self.rows_per_call = n
        self.generator_calls_per_chunk = 1
        # every row's log-likelihood written once and read once, xw read once, and
        # the sampled rows made, cast to float64 and read; the matmuls
        self.call_bytes = (2 * self.dtype.itemsize * n * s + 4 * n * f
                           + m * s * (2 * self.dtype.itemsize + 2 * 8))
        self.call_flops = 2 * (n + m) * s * f

    def call(self):
        return pl.loo_subsample_streaming(
            self.fn, self.n_obs, self.n_draws, observations=self.observations,
            estimator=self.estimator, dtype=self.dtype, seed=self.seed, pointwise=True)

    @staticmethod
    def outputs(result) -> dict:
        idx = np.asarray(result.estimates.indices.idx, np.int64)
        return {"lpd": np.asarray(result.estimates.stream["elpd_loo_approximation"], np.float64),
                "idx": idx,
                "loo_i": np.asarray(result["loo_i"].values, np.float64)[idx],
                "k": np.asarray(result["pareto_k"], np.float64),
                "elpd_loo": float(result["elpd_loo"]),
                "subsampling_se": float(result["subsampling_SE"])}

    def reference(self, control: bool = False) -> dict:
        lpd_dtype = CONTROL_DTYPE[self.dtype] if control else torch.float64
        exact_dtype = torch.float32 if control else torch.float64
        lpd = np.empty(self.n_obs)
        for lo in range(0, self.n_obs, BLOCK):
            hi = min(lo + BLOCK, self.n_obs)
            ll = self.fn(torch.arange(lo, hi, device=self.device))
            lpd[lo:hi] = reference_torch.lpd(ll.to(lpd_dtype)).double().cpu().numpy()
            del ll
        rng = np.random.default_rng(self.seed)
        idx = np.sort(rng.choice(self.n_obs, size=self.observations, replace=False))
        rows = self.fn(torch.as_tensor(idx, dtype=torch.int64, device=self.device))
        e, k, _ = reference_torch.score_rows(rows, self.tail, exact_dtype)
        e, k = e.cpu().numpy(), k.cpu().numpy()
        # the difference estimator under simple random sampling without replacement
        n, m = self.n_obs, len(idx)
        diff = e - lpd[idx]
        elpd = math.fsum(lpd) + n * diff.mean()
        var = n * n * (1.0 - m / n) * diff.var(ddof=1) / m
        return {"lpd": lpd, "idx": idx, "loo_i": e, "k": k, "elpd_loo": elpd,
                "subsampling_se": math.sqrt(var)}

    @staticmethod
    def compare(out: dict, ref: dict) -> dict:
        """The program's sampled rows read at the reference's; a row it did
        not sample reads NaN, a mismatch."""
        pos = np.clip(np.searchsorted(out["idx"], ref["idx"]), 0, len(out["idx"]) - 1)
        hit = out["idx"][pos] == ref["idx"]
        loo_i = np.where(hit, out["loo_i"][pos], np.nan)
        k = np.where(hit, out["k"][pos], np.nan)
        lpd_gap, lpd_off = row_gaps(out["lpd"], ref["lpd"])
        loo_i_gap, loo_i_off = row_gaps(loo_i, ref["loo_i"])
        k_gap, k_off = row_gaps(k, ref["k"], relative=False)
        return {"lpd_gap": lpd_gap, "loo_i_gap": loo_i_gap, "k_gap": k_gap,
                "nonfinite_mismatches": lpd_off + loo_i_off + k_off,
                "elpd_gap": rel_gap(out["elpd_loo"], ref["elpd_loo"]),
                "subsampling_se_gap": rel_gap(out["subsampling_se"], ref["subsampling_se"])}


def prepare(run) -> Case:
    return Case(run)
