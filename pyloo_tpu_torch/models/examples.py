"""Example models: eight schools, roaches (Poisson), wells (logistic).

Counterpart of ``pyloo_tpu/models/examples.py`` in torch (reference fixtures
``pyloo/tests/models.py:14-61`` eight schools, ``:426-461`` roaches,
``:495-530`` wells).  The tables roaches.csv / wells.csv are the classic
Gelman & Hill (2007) regression examples, bundled in
``pyloo_tpu_torch/data``.  ``gammaln`` is ``torch.lgamma`` and
``logaddexp(0, eta)`` is ``torch.logaddexp`` against zeros (``softplus``
goes linear above its threshold and departs from it by about 2e-9).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data import load_example_data
from .wrapper import Model

__all__ = [
    "eight_schools_centered",
    "eight_schools_noncentered",
    "roaches_model",
    "wells_model",
    "EIGHT_SCHOOLS_Y",
    "EIGHT_SCHOOLS_SIGMA",
]

EIGHT_SCHOOLS_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
EIGHT_SCHOOLS_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _normal_logpdf(x, mu, sigma):
    return -_HALF_LOG_2PI - _log(sigma) - 0.5 * ((x - mu) / sigma) ** 2


def _half_cauchy5_log_tau(log_tau):
    """log half-Cauchy(5) density of tau = exp(log_tau), plus the Jacobian
    log|d tau / d log_tau| = log_tau."""
    tau = torch.exp(log_tau)
    return math.log(2.0) - torch.log(math.pi * 5.0 * (1 + (tau / 5.0) ** 2)) + log_tau


def eight_schools_centered(data=None) -> Model:
    """Centered parameterization: theta_j ~ N(mu, tau) (funnel geometry).

    ``theta`` tracks the number of observations, so the model carries a
    ``builder`` and can be refit on data subsets (k-fold CV, reloo).
    """
    if data is None:
        data = {"y": EIGHT_SCHOOLS_Y, "sigma": EIGHT_SCHOOLS_SIGMA}
    n = len(data["y"])

    def logp(params, data):
        mu, log_tau, theta = params["mu"], params["log_tau"], params["theta"]
        lp = _normal_logpdf(mu, 0.0, 5.0)
        lp = lp + _half_cauchy5_log_tau(log_tau)
        lp = lp + torch.sum(_normal_logpdf(theta, mu, torch.exp(log_tau)))
        lp = lp + torch.sum(_normal_logpdf(data["y"], theta, data["sigma"]))
        return lp

    def log_lik(params, data):
        return _normal_logpdf(data["y"], params["theta"], data["sigma"])

    def constrain(params):
        return {
            "mu": params["mu"],
            "theta": params["theta"],
            "tau": torch.exp(params["log_tau"]),
        }

    return Model(
        name="eight_schools_centered",
        data=data,
        param_shapes={"mu": (), "log_tau": (), "theta": (n,)},
        logp=logp,
        log_lik=log_lik,
        constrain=constrain,
        obs_keys=("y", "sigma"),
        builder=eight_schools_centered,
    )


def eight_schools_noncentered(data=None) -> Model:
    """Non-centered parameterization: theta = mu + tau * theta_tilde."""
    if data is None:
        data = {"y": EIGHT_SCHOOLS_Y, "sigma": EIGHT_SCHOOLS_SIGMA}
    n = len(data["y"])

    def theta_of(params):
        return params["mu"] + torch.exp(params["log_tau"]) * params["theta_t"]

    def logp(params, data):
        mu, log_tau, theta_t = params["mu"], params["log_tau"], params["theta_t"]
        lp = _normal_logpdf(mu, 0.0, 5.0)
        lp = lp + _half_cauchy5_log_tau(log_tau)
        lp = lp + torch.sum(_normal_logpdf(theta_t, 0.0, 1.0))
        lp = lp + torch.sum(_normal_logpdf(data["y"], theta_of(params), data["sigma"]))
        return lp

    def log_lik(params, data):
        return _normal_logpdf(data["y"], theta_of(params), data["sigma"])

    def constrain(params):
        return {
            "mu": params["mu"],
            "theta": theta_of(params),
            "tau": torch.exp(params["log_tau"]),
        }

    return Model(
        name="eight_schools_noncentered",
        data=data,
        param_shapes={"mu": (), "log_tau": (), "theta_t": (n,)},
        logp=logp,
        log_lik=log_lik,
        constrain=constrain,
        obs_keys=("y", "sigma"),
        builder=eight_schools_noncentered,
    )


def roaches_model() -> Model:
    """Poisson regression on the pest-control roaches data (262 obs).

    y ~ Poisson(exp(X @ beta + intercept + log(exposure))), sqrt-transformed
    pre-treatment roach count; matches the reference fixture
    (``pyloo/tests/models.py:426-461``).
    """
    df = load_example_data("roaches")
    X = np.column_stack([np.sqrt(df["roach1"]), df["treatment"], df["senior"]])
    y = df["y"].astype(np.float64)
    offset = np.log(df["exposure2"])

    def log_lik(params, data):
        eta = data["X"] @ params["beta"] + params["intercept"] + data["offset"]
        return data["y"] * eta - torch.exp(eta) - torch.lgamma(data["y"] + 1.0)

    def logp(params, data):
        beta, intercept = params["beta"], params["intercept"]
        eta = data["X"] @ beta + intercept + data["offset"]
        lp = torch.sum(_normal_logpdf(beta, 0.0, 2.5))
        lp = lp + _normal_logpdf(intercept, 0.0, 5.0)
        lp = lp + torch.sum(data["y"] * eta - torch.exp(eta) - torch.lgamma(data["y"] + 1.0))
        return lp

    return Model(
        name="roaches",
        data={"X": X, "y": y, "offset": offset},
        param_shapes={"beta": (3,), "intercept": ()},
        logp=logp,
        log_lik=log_lik,
        obs_keys=("X", "y", "offset"),
    )


def wells_model() -> Model:
    """Logistic regression on the arsenic wells data (3020 obs).

    switch ~ Bernoulli(logit = X @ beta), X = [1, dist/100, arsenic];
    matches the reference fixture (``pyloo/tests/models.py:495-530``).
    """
    df = load_example_data("wells")
    X = np.column_stack([np.ones(len(df["switch"])), df["dist"] / 100.0, df["arsenic"]])
    y = df["switch"].astype(np.float64)

    def bernoulli_logit(y, eta):
        return y * eta - torch.logaddexp(torch.zeros_like(eta), eta)

    def logp(params, data):
        beta = params["beta"]
        eta = data["X"] @ beta
        lp = torch.sum(_normal_logpdf(beta, 0.0, 1.0))
        lp = lp + torch.sum(bernoulli_logit(data["y"], eta))
        return lp

    def log_lik(params, data):
        return bernoulli_logit(data["y"], data["X"] @ params["beta"])

    return Model(
        name="wells",
        data={"X": X, "y": y},
        param_shapes={"beta": (3,)},
        logp=logp,
        log_lik=log_lik,
        obs_keys=("X", "y"),
    )
