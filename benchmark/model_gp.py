"""The Gaussian process of the ``gp_expquad_*`` configurations, made from a seed.

The Stan User's Guide's Gaussian process with a normal outcome and the
latent function marginalised out (chapter "Gaussian Processes"):
``y ~ multi_normal_cholesky(0, cholesky(K))`` with
``K = gp_exp_quad_cov(x, alpha, rho) + sigma^2 I`` and
``gp_exp_quad_cov(x, alpha, rho)[i, j] = alpha^2 exp(-(x_i - x_j)^2 / (2 rho^2))``.
The inputs are ``x ~ U(x_low, x_high)``; ``y`` is drawn once from the
process at the truth; each draw's ``(alpha, rho, sigma)`` is the truth
times ``exp(jitter N(0, 1))`` (no fitted posterior).  Everything is made in
float64 on the device by one ``torch.Generator``, in the order ``x``, the
normal variates of ``y``, the draws, so a seed gives the same model
wherever that generator's device type is the same.

``cov_fn()`` is the generator of the draws' covariances: ``fn(idx)`` makes
``K`` of the draws ``idx`` (stacked ``chain * draws + draw``) on
``idx.device``, recorded as the ``benchmark.generator`` range under
``torch.profiler``.
"""

from __future__ import annotations

import torch

from benchmark.model import GENERATOR_RANGE


class GPModel:
    """``x``, ``y`` (n_obs,), the draws' ``theta`` (S, 3) of ``(alpha, rho,
    sigma)`` and the squared distances ``d2`` (n_obs, n_obs), float64, on
    ``device``."""

    def __init__(self, config: dict, n_obs: int, seed: int, device):
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        f64 = dict(dtype=torch.float64, device=device)
        self.chains, self.draws = config["chains"], config["draws"]
        self.n_obs, self.n_draws = n_obs, self.chains * self.draws
        lo, hi = config["x_low"], config["x_high"]
        x = lo + (hi - lo) * torch.rand(n_obs, generator=gen, **f64)
        z = torch.randn(n_obs, generator=gen, **f64)
        truth = torch.tensor([config["alpha"], config["rho"], config["sigma"]], **f64)
        self.theta = truth * torch.exp(config["jitter"] * torch.randn(self.n_draws, 3,
                                                                      generator=gen, **f64))
        self.d2 = (x[:, None] - x[None, :]) ** 2
        self.x = x
        self.y = torch.linalg.cholesky(self.cov(*self.terms(truth[None]))[0]) @ z
        self.draw_terms = self.terms(self.theta)

    @staticmethod
    def terms(theta: torch.Tensor) -> tuple:
        """``(alpha^2, -1 / (2 rho^2), sigma^2)`` of the rows of ``theta`` (B, 3)."""
        a, rho, s = theta.unbind(1)
        return a * a, -0.5 / (rho * rho), s * s

    def cov(self, scale, coef, nugget) -> torch.Tensor:
        """``K`` (B, n_obs, n_obs) of the draws' ``terms``."""
        k = scale[:, None, None] * torch.exp(self.d2 * coef[:, None, None])
        k.diagonal(dim1=1, dim2=2).add_(nugget[:, None])
        return k

    def cov_fn(self):
        """``fn(idx)``: the covariances of the draws ``idx``, made on
        ``idx.device``."""
        terms = self.draw_terms

        def fn(idx):
            with torch.profiler.record_function(GENERATOR_RANGE):
                return self.cov(*(t.to(idx.device)[idx] for t in terms))

        return fn
