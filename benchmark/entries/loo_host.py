"""``loo()`` on a host array of draws at the traffic's precision.

Set-up makes the model on the card and, from it, the first ``n_obs_host``
observations' log-likelihood as one host ``(chains, draws, n_obs_host)``
float64 array in an InferenceData with the posterior's draws; each call is
``loo(idata, pointwise=True)`` with reff computed from the posterior.  The
reference computes reff with the numpy split-chain ESS and scores every row
of the same host array with the plain torch PSIS, in float64; the control
does both one precision below.

Compared: ``loo_i_gap`` (every row, relative to 1 + |loo_i|) and ``k_gap``
(every row, absolute) over the rows both sides give finite,
``nonfinite_mismatches`` (rows one side gives finite and the other not), ``elpd_gap``, ``p_loo_gap``, ``se_gap`` (relative):
ingest, reff, the selection, fit and deep-tail guard, and the assembly.
"""

from __future__ import annotations

import numpy as np
import torch

import pyloo_tpu_torch as pl

from benchmark import checks, reference, reference_torch
from benchmark.model import LogisticModel
BLOCK = 8192


class Case:
    def __init__(self, run):
        cfg, traffic = run.config, run.traffic
        self.dtype = getattr(torch, traffic["dtype"])
        self.device = run.devices[0]
        model = LogisticModel(cfg, cfg["n_obs"], run.seed, [self.device])
        self.n_obs = cfg["n_obs_host"]
        self.n_draws = model.n_draws
        self.ll = model.host_log_lik_f64(self.n_obs)
        self.posterior = model.posterior()
        del model
        self.idata = pl.inference_data_from_numpy({
            "posterior": {"beta": (self.posterior["beta"], ("chain", "draw", "beta_dim_0"), {})},
            "log_likelihood": {"y": (self.ll, ("chain", "draw", "obs"), {})},
        })
        pl.rcParams["device.device"] = self.device.type
        pl.rcParams["device.precision"] = traffic["dtype"]
        self.rows_per_call = self.n_obs

    def call(self):
        return pl.loo(self.idata, pointwise=True)

    outputs = staticmethod(checks.loo_outputs)

    def reference(self, control: bool = False) -> dict:
        """reff and every row from the host array, in float64 or, for the
        control, one precision below."""
        dtype = checks.CONTROL_DTYPE[self.dtype] if control else torch.float64
        reff = reference.relative_eff(self.posterior, np.float32 if control else np.float64)
        tail = reference.tail_length(self.n_draws, reff)
        loo_i = np.empty(self.n_obs)
        k = np.empty(self.n_obs)
        totals = reference_torch.Totals()
        flat = self.ll.reshape(self.n_draws, self.n_obs)  # sample = chain * draws + draw
        for lo in range(0, self.n_obs, BLOCK):
            hi = min(lo + BLOCK, self.n_obs)
            # (S, rows) slices copied as they lie, turned to rows on the card
            rows = torch.from_numpy(np.ascontiguousarray(flat[:, lo:hi])).to(self.device).T.contiguous()
            e, kk, lp = reference_torch.score_rows(rows, tail, dtype)
            totals.add(e, lp)
            loo_i[lo:hi] = e.cpu().numpy()
            k[lo:hi] = kk.cpu().numpy()
        return {"loo_i": loo_i, "k": k, **totals.result()}

    compare = staticmethod(checks.compare_loo)


def prepare(run) -> Case:
    return Case(run)
