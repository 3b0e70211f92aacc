"""``loo_nonfactor_streaming`` over a Gaussian process made on the card.

Set-up makes the model (``benchmark/model_gp.py``) on the card; each call
is ``loo_nonfactor_streaming(y, 0, cov_fn, S, chains=4, form="cov",
model_type="normal", reff=1.0, pointwise=True)`` at the default chunking,
the generator making each chunk's covariances on the card.  The reference
(``benchmark/reference_nonfactor.py``) makes every block of covariances
again with the same generator, inverts each from its Cholesky factor and
scores the conditional log-densities with the plain torch PSIS, in float64;
the control does all of it one precision below.

Compared: ``loo_i_gap`` (every row, relative to 1 + |loo_i|) and ``k_gap``
(every row, absolute) over the rows both sides give finite,
``nonfinite_mismatches`` (rows one side gives finite and the other not),
``elpd_gap``, ``p_loo_gap``, ``se_gap`` (relative): the factorisations,
the conditional densities, the float64 PSIS and the assembly.
"""

from __future__ import annotations

import torch

import pyloo_tpu_torch as pl

from benchmark import checks, factor_work, reference, reference_nonfactor
from benchmark.model_gp import GPModel

# draws the reference factorises and inverts at a time: at N = 2,048 a block
# of 64 (2.1 GB a matrix stack) takes ~11 s a call's draws against ~15 s
# for 8, in the run's time after its window
REFERENCE_BLOCK = 64


class Case:
    def __init__(self, run):
        self.entry = pl.loo_nonfactor_streaming  # a program without it fails here, at once
        cfg, traffic = run.config, run.traffic
        self.dtype = getattr(torch, traffic["dtype"])
        self.device = run.devices[0]
        self.model = GPModel(cfg, cfg["n_obs"], run.seed, self.device)
        self.fn = self.model.cov_fn()
        self.n_obs, self.n_draws = cfg["n_obs"], self.model.n_draws
        self.mu = torch.zeros((), dtype=torch.float64, device=self.device)  # the GP's mean
        self.reff = float(traffic["reff"])
        self.form, self.model_type = traffic["form"], traffic["model_type"]
        self.tail = reference.tail_length(self.n_draws, self.reff)
        pl.rcParams["device.device"] = self.device.type
        pl.rcParams["device.precision"] = traffic["dtype"]
        # what the metrics read
        self.rows_per_call = self.n_obs
        self.generator_calls_per_chunk = 1
        self.factor_flops = factor_work.factor_flops(self.n_obs, self.n_draws)
        self.least_seconds = factor_work.least_seconds(self.n_obs, self.n_draws)

    def call(self):
        return self.entry(self.model.y, self.mu, self.fn, self.n_draws,
                          chains=self.model.chains, form=self.form,
                          model_type=self.model_type,
                          reff=self.reff, pointwise=True)

    outputs = staticmethod(checks.loo_outputs)

    def reference(self, control: bool = False) -> dict:
        """Every draw's covariance made again, inverted from its Cholesky
        factor and scored: in float64, or for the control one precision
        below."""
        dtype = checks.CONTROL_DTYPE[self.dtype] if control else torch.float64
        return reference_nonfactor.loo(self.model.y, self.mu, self.fn, self.n_draws, self.tail,
                                       dtype, block=REFERENCE_BLOCK)

    compare = staticmethod(checks.compare_loo)


def prepare(run) -> Case:
    return Case(run)
