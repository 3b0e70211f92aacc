"""``loo(..., moment_match=True, split=True)`` of a Poisson GLMM.

Set-up makes the model (``benchmark/model_glmm.py``) on the card: its data,
the traffic's ``fits`` sets of Laplace draws, and from each an
InferenceData whose log-likelihood ``(chains, draws, N)`` and flat
unconstrained draws ``(chains, draws, P)`` lie on the host, as a fit leaves
them, with the program's model of the GLMM's torch functions and a wrapper
a fit.  Each call is ``loo(idata, pointwise=True, moment_match=True,
wrapper=wrapper, split=True)`` on the next fit, at the default float64,
``cov``, ``max_iters`` and ``k_threshold``, reff computed from the
posterior: PSIS-LOO of every row, then moment matching of every row whose
k exceeds the threshold, on the program's device-batched path.  How many
rows a fit flags, and how many passes and splits they take, varies from
fit to fit, so a timed call is a round of ``loo()`` calls, one on each fit
in turn: every window times whole rounds of the same work, however fast
the program goes, and a run's rate is that of several fits.  Under a
profiler a call is one ``loo()`` call, on the first fit, so that the
per-layer metrics read one ``loo()`` call and a traced run takes no longer
than a timed one.  The reference (``benchmark/reference_mm.py``) runs the
last ``loo()`` call's workflow again in plain torch a flagged row at a
time, in float64; the control one precision below.

Compared: ``loo_i_gap`` (every row, relative to 1 + |loo_i|), ``k_gap``
(every row, absolute), ``nonfinite_mismatches``, ``accepted_mismatches``
(rows whose count of accepted transforms differs, or that one side matched
and the other not), ``elpd_gap``, ``p_loo_gap``, ``se_gap`` (relative).
The program has to report each row's accepted transforms (the result's
``moment_match_accepted``): a program that does not cannot be checked, and
its first call fails.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

import pyloo_tpu_torch as pl

from benchmark import checks, mm_work, reference_mm
from benchmark.model_glmm import GLMM


class Case:
    def __init__(self, run):
        cfg, traffic = run.config, run.traffic
        self.dtype = getattr(torch, traffic["dtype"])
        self.device = run.devices[0]
        pl.rcParams["device.device"] = self.device.type
        pl.rcParams["device.precision"] = traffic["dtype"]
        self.glmm = GLMM(cfg, cfg["n_obs"], run.seed, self.device, fits=int(traffic["fits"]))
        model = pl.models.Model("glmm_poisson", self.glmm.data(), self.glmm.param_shapes(),
                                self.glmm.logp, self.glmm.log_lik,
                                obs_keys=("x", "y", "patient"))
        self.flats = [flat.cpu().numpy() for flat in self.glmm.fits]
        idatas = [pl.models.idata_from_flat_draws(model, flat) for flat in self.flats]
        self.fits = [(idata, pl.JAXModelWrapper(model, idata)) for idata in idatas]
        self.last = 0  # the fit of the last loo() call
        self.split = bool(traffic["split"])  # cov, max_iters, k_threshold: the defaults
        # what the metrics read: the rows of a timed call's round of fits
        self.rows_per_call = self.glmm.n_obs * len(self.fits)
        self.work = mm_work.Work(self.glmm.n_draws, self.glmm.n_params, self.glmm.n_obs)

    def call(self):
        """``loo()`` on each fit in turn, or under a profiler on the first;
        the last call's result."""
        result = None
        for self.last in range(1 if torch.autograd._profiler_enabled() else len(self.fits)):
            idata, wrapper = self.fits[self.last]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # k warnings and max_iters notes, every call
                result = pl.loo(idata, pointwise=True, moment_match=True, wrapper=wrapper,
                                split=self.split)
            if getattr(result, "moment_match_accepted", None) is None:
                raise RuntimeError("the program does not report each row's accepted transforms"
                                   " (moment_match_accepted): this cell cannot check it")
        return result

    @staticmethod
    def outputs(result) -> dict:
        return {**checks.loo_outputs(result),
                "accepted": np.asarray(result.moment_match_accepted, np.int64)}

    def reference(self, control: bool = False) -> dict:
        """The last call's workflow again, a flagged row at a time: in float64
        or, for the control, one precision below."""
        dtype = checks.CONTROL_DTYPE[self.dtype] if control else torch.float64
        g = self.glmm
        return reference_mm.loo_moment_match(
            {"x": g.x, "y": g.y, "patient": g.patient}, self.flats[self.last], g.tau,
            g.prior_sd, dtype)

    @staticmethod
    def compare(out: dict, ref: dict) -> dict:
        readings = checks.compare_loo(out, ref)
        got, want = out["accepted"], ref["accepted"]
        readings["accepted_mismatches"] = (
            int(np.count_nonzero(got != want)) if got.shape == want.shape
            else max(got.size, want.size))
        return readings


def prepare(run) -> Case:
    return Case(run)
