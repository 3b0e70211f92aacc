"""The Poisson GLMM of the ``glmm_poisson_*`` configurations, made from a seed.

brms's ``loo_moment_match`` example, ``count ~ zAge + zBase * Trt + (1 |
patient)`` with a Poisson family and a log link, at the shape of Thall &
Vail's epilepsy data (each patient seen ``visits`` times).  The data law:
``zAge`` and ``zBase`` standard normal a patient, ``Trt`` Bernoulli(0.5) a
patient, patient intercepts ``a_j ~ N(0, tau)``, and an observation-level
``N(0, obs_sd)`` term that the fitted model lacks (the misfit that makes
PSIS flag rows), ``count ~ Poisson(exp(b0 + b1 zAge + b2 zBase + b3 Trt +
b4 zBase Trt + a_j + e))``.  The data are one table, as a study's are: made
by a ``torch.Generator`` seeded with the configuration's ``data_seed``, in the
order zAge, zBase, Trt, a, e, the counts.  The draws, as a fit's are, come
from the run's seed, by a second generator: ``fits`` sets of them, one after
another.  Everything is made in float64 on the device, so a seed gives the
same model wherever the generators' device type is the same.

The fitted model's unconstrained vector is ``q = (b, a)``: the 5 fixed
effects, then the ``J`` patient intercepts, with ``tau`` fixed at the
truth's and the priors ``b0 ~ N(0, prior_intercept_sd)``, ``b1..4 ~ N(0,
prior_coef_sd)``.  Its posterior is log-concave, and the draws are its
Laplace approximation: the mode by Newton's method, then ``mode + L^-T z``
with ``L`` the Cholesky factor of the negative Hessian at the mode (so the
draws' covariance is the inverse Hessian), ``chains`` x ``draws`` of them
a set.

:meth:`GLMM.log_lik` and :meth:`GLMM.logp` are the model's pointwise
log-likelihood and log joint density as torch functions of named parameters
and data that ``torch.func`` can transform; the cell's entry builds the
program's model of them.  This file is the workload's own code: it imports
torch only.
"""

from __future__ import annotations

import math

import torch

N_FIXED = 5  # intercept, zAge, zBase, Trt, zBase:Trt


class GLMM:
    """The data (``x`` (N, 4), ``y`` (N,) counts as float64, ``patient``
    (N,) int64), the mode and the draws of the configuration, on
    ``device``: ``fits`` sets, each (chains, draws, P), the first of them
    ``flat``."""

    def __init__(self, config: dict, n_obs: int, seed: int, device, fits: int = 1):
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(int(config["data_seed"]))
        f64 = dict(dtype=torch.float64, device=device)
        self.visits = int(config["visits"])
        self.n_patients = n_obs // self.visits
        self.n_obs = self.n_patients * self.visits
        self.chains, self.draws = int(config["chains"]), int(config["draws"])
        self.n_draws = self.chains * self.draws
        self.n_params = N_FIXED + self.n_patients
        self.tau = float(config["tau"])
        self.prior_sd = torch.tensor([config["prior_intercept_sd"]]
                                     + [config["prior_coef_sd"]] * (N_FIXED - 1), **f64)
        j = self.n_patients
        z_age = torch.randn(j, generator=gen, **f64)
        z_base = torch.randn(j, generator=gen, **f64)
        trt = (torch.rand(j, generator=gen, **f64) < 0.5).to(torch.float64)
        a_true = self.tau * torch.randn(j, generator=gen, **f64)
        e = config["obs_sd"] * torch.randn(self.n_obs, generator=gen, **f64)
        self.patient = torch.arange(j, device=device).repeat_interleave(self.visits)
        per_patient = torch.stack([z_age, z_base, trt, z_base * trt], dim=1)
        self.x = per_patient[self.patient]  # (N, 4)
        b_true = torch.tensor(config["b"], **f64)
        eta = b_true[0] + self.x @ b_true[1:] + a_true[self.patient] + e
        self.y = torch.poisson(torch.exp(eta), generator=gen)
        self.mode, self.chol = self._laplace(int(config["newton_steps"]))
        gen = torch.Generator(device=device).manual_seed(seed)
        self.fits = []
        for _ in range(fits):
            z = torch.randn(self.n_draws, self.n_params, generator=gen, **f64)
            # mode + L^-T z: covariance (L L^T)^-1, the inverse of the negative Hessian
            flat = self.mode + torch.linalg.solve_triangular(self.chol.T, z.T, upper=True).T
            self.fits.append(flat.reshape(self.chains, self.draws, self.n_params))
        self.flat = self.fits[0]

    # the model, as the program evaluates it -------------------------------

    def data(self) -> dict:
        """The observation-indexed data on the host: ``x``, ``y``, ``patient``."""
        return {"x": self.x.cpu().numpy(), "y": self.y.cpu().numpy(),
                "patient": self.patient.cpu().numpy()}

    def param_shapes(self) -> dict:
        return {"b": (N_FIXED,), "a": (self.n_patients,)}

    @staticmethod
    def log_lik(params: dict, data: dict) -> torch.Tensor:
        """Each observation's Poisson log-likelihood under ``params``."""
        b = params["b"]
        eta = b[0] + data["x"] @ b[1:] + params["a"][data["patient"]]
        return data["y"] * eta - torch.exp(eta) - torch.lgamma(data["y"] + 1.0)

    def logp(self, params: dict, data: dict) -> torch.Tensor:
        """The log joint density of ``params`` (constants of the priors left out)."""
        b, a = params["b"], params["a"]
        prior = (-0.5 * torch.sum((b / self.prior_sd.to(b.device)) ** 2)
                 - 0.5 * torch.sum(a * a) / (self.tau * self.tau))
        return prior + torch.sum(self.log_lik(params, data))

    # the Laplace approximation ---------------------------------------------

    def design(self) -> torch.Tensor:
        """The (N, P) design of the flat vector: intercept, x, patient indicators."""
        ones = torch.ones(self.n_obs, 1, dtype=torch.float64, device=self.x.device)
        z = torch.nn.functional.one_hot(self.patient, self.n_patients).to(torch.float64)
        return torch.cat([ones, self.x, z], dim=1)

    def precision_prior(self) -> torch.Tensor:
        tau = torch.full((self.n_patients,), 1.0 / (self.tau * self.tau),
                         dtype=torch.float64, device=self.x.device)
        return torch.cat([1.0 / self.prior_sd ** 2, tau])

    def log_post(self, q: torch.Tensor, design: torch.Tensor) -> float:
        eta = design @ q
        return float(torch.sum(self.y * eta - torch.exp(eta))
                     - 0.5 * torch.sum(self.precision_prior() * q * q))

    def _laplace(self, steps: int) -> tuple:
        """(mode, L): Newton's method from ``b0 = log mean(y)``, halving a step
        until the log posterior rises, for at most ``steps`` steps, and the
        lower Cholesky factor of the negative Hessian at the mode."""
        design, prec = self.design(), self.precision_prior()
        q = torch.zeros(self.n_params, dtype=torch.float64, device=design.device)
        q[0] = math.log(float(self.y.mean()))
        value = self.log_post(q, design)
        for _ in range(steps):
            mu = torch.exp(design @ q)
            grad = design.T @ (self.y - mu) - prec * q
            chol = torch.linalg.cholesky(design.T @ (mu[:, None] * design) + torch.diag(prec))
            step = torch.cholesky_solve(grad[:, None], chol)[:, 0]
            t = 1.0
            while (trial := self.log_post(q + t * step, design)) < value and t > 1e-8:
                t *= 0.5
            if trial < value:  # no step raises it: the mode to rounding
                break
            q, value = q + t * step, trial
            if float(step.abs().max()) * t < 1e-12:
                break
        mu = torch.exp(design @ q)
        chol = torch.linalg.cholesky(design.T @ (mu[:, None] * design) + torch.diag(prec))
        return q, chol
