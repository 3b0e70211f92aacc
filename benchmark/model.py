"""The logistic model of the ``logit32_*`` configurations, made from a seed.

A logistic regression with ``n_features`` features: ``beta = beta_scale
N(0, 1)`` over ``chains`` x ``draws`` draws, ``xw = x_scale N(0, 1)`` and
``y ~ Bernoulli(y_prob)``, drawn independently of ``xw``.  Everything is
made on the device by one ``torch.Generator``, in the order ``beta``,
``xw``, ``y``, in a few large calls, so a seed gives the same model wherever
that generator's device type is the same.  Over several devices the model
is made on the first and copied to the others, one copy a device.

The log-likelihood of observation ``i`` under draw ``s`` is
``y_i eta - log(1 + exp(eta))`` with ``eta = xw_i . beta_s``; the draws are
stacked ``sample = chain * draws + draw``, as ``loo()`` stacks them.  The
generator's work is recorded as the ``benchmark.generator`` range under
``torch.profiler``.  A copy of ``bench_torch/model.py`` with its
configuration read from the configuration's file.
"""

from __future__ import annotations

import numpy as np
import torch

GENERATOR_RANGE = "benchmark.generator"


class LogisticModel:
    """``xw`` (n_obs, F), ``yw`` (n_obs,) of 0.0 / 1.0 and ``beta``
    (chains, draws, F), float32, on each of ``devices``."""

    def __init__(self, config: dict, n_obs: int, seed: int, devices):
        devices = [torch.device(d) for d in devices]
        first = devices[0]
        gen = torch.Generator(device=first).manual_seed(seed)
        f = config["n_features"]
        beta = config["beta_scale"] * torch.randn(config["chains"], config["draws"], f,
                                                  device=first, generator=gen)
        xw = config["x_scale"] * torch.randn(n_obs, f, device=first, generator=gen)
        yw = (torch.rand(n_obs, device=first, generator=gen) < config["y_prob"]).float()
        self.n_obs, self.n_features = n_obs, f
        self.chains, self.draws = config["chains"], config["draws"]
        self.n_draws = self.chains * self.draws
        self.beta = beta
        self.copies = {}
        for d in devices:
            if d not in self.copies:
                self.copies[d] = (xw.to(d), yw.to(d), beta.reshape(self.n_draws, f).to(d))

    def log_lik_fn(self):
        """``log_lik_fn(idx)``: the (rows, S) float32 log-likelihood of the
        observations ``idx``, made on ``idx.device`` from that device's copy."""
        copies = self.copies

        def fn(idx):
            with torch.profiler.record_function(GENERATOR_RANGE):
                xw, yw, beta_s = copies[idx.device]
                eta = xw[idx] @ beta_s.T  # full float32: the run turns TF32 off
                return yw[idx, None] * eta - torch.logaddexp(eta, eta.new_zeros(()))

        return fn

    def host_log_lik_f64(self, n_rows: int) -> np.ndarray:
        """The first ``n_rows`` observations' log-likelihood as a host
        ``(chains, draws, n_rows)`` float64 array, computed in float64 on the
        first device one chain at a time and copied into one array."""
        xw, yw, _ = next(iter(self.copies.values()))
        x = xw[:n_rows].double()
        y = yw[:n_rows].double()
        zero = x.new_zeros(())
        out = np.empty((self.chains, self.draws, n_rows), np.float64)
        for c in range(self.chains):
            eta = self.beta[c].double() @ x.T  # (draws, n_rows)
            torch.from_numpy(out[c]).copy_(y * eta - torch.logaddexp(eta, zero))
            del eta
        return out

    def posterior(self) -> dict:
        """The posterior's draws on the host: ``{"beta": (chains, draws, F)}``."""
        return {"beta": self.beta.cpu().numpy()}
