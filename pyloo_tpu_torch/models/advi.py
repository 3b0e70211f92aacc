"""Automatic differentiation variational inference (mean-field / full-rank).

Counterpart of ``pyloo_tpu/models/advi.py``: a Gaussian q over the model's
flat unconstrained vector, fitted by Adam on the ELBO under the
reparameterisation trick (``mc_samples`` draws a step, the model's log
density vmapped over them), then sampled; ``compute_log_p`` /
``compute_log_q`` / ``compute_log_weights`` feed
:func:`pyloo_tpu_torch.loo_approximate_posterior`.

Adam is ``optax.adam``'s update (b1 0.9, b2 0.999, eps 1e-8, eps_root 0),
written out on the parameters' tensors.  The full-rank factor is packed in
``np.tril_indices`` order, so a fit moves between the packages as numpy.
Every step stays on the device: the ELBO trace is written into a device
tensor and read once, at the end.  The noise of each step and of the final
draws comes from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Literal

import numpy as np
import torch

from .._common import compute_device
from ..containers import DataArray, Dataset, InferenceData
from .wrapper import Model, draw_groups, map_draws

__all__ = ["ADVI", "ADVIResult", "compute_log_weights"]

_LOG_2PI = math.log(2 * math.pi)


@dataclass
class ADVIResult:
    """Variational fit artifacts.

    ``mean`` and either ``log_sigma`` (mean-field) or ``L`` (full-rank
    Cholesky factor) parameterize the Gaussian q; ``elbo_trace`` records
    optimization progress (the negative ELBO of each step).
    """

    method: str
    mean: np.ndarray
    log_sigma: np.ndarray | None
    L: np.ndarray | None
    elbo_trace: np.ndarray
    model: Model
    idata: InferenceData | None = None
    warnings: list = field(default_factory=list)


class _Gaussian:
    """The variational family over ``D`` dimensions: its parameters as a
    dict of tensors, the scale they give, draws and log density."""

    def __init__(self, D: int, fullrank: bool, device):
        self.D, self.fullrank = D, fullrank
        rows, cols = np.tril_indices(D)
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)

    def init(self, dtype, device) -> dict:
        D = self.D
        if self.fullrank:
            return {"mean": torch.zeros(D, dtype=dtype, device=device),
                    "tril": torch.zeros(D * (D + 1) // 2, dtype=dtype, device=device)}
        return {"mean": torch.zeros(D, dtype=dtype, device=device),
                "log_sigma": torch.full((D,), -1.0, dtype=dtype, device=device)}

    def unpack(self, params):
        """``(mean, scale)``: the scale is the Cholesky factor L (full-rank,
        a softplus-positive diagonal) or the standard deviations."""
        mean = params["mean"]
        if self.fullrank:
            tril = params["tril"]
            L = torch.zeros((self.D, self.D), dtype=tril.dtype, device=tril.device)
            L = L.index_put((self.rows, self.cols), tril)
            diag = torch.diagonal(L)
            diag = torch.logaddexp(diag, torch.zeros_like(diag)) + 1e-8
            return mean, torch.diagonal_scatter(L, diag)
        return mean, torch.exp(params["log_sigma"])

    def sample(self, params, eps):
        mean, scale = self.unpack(params)
        if self.fullrank:
            return mean + eps @ scale.T
        return mean + eps * scale

    def log_q(self, params, z):
        mean, scale = self.unpack(params)
        D = self.D
        if self.fullrank:
            diff = z - mean
            sol = torch.linalg.solve_triangular(scale, diff.T, upper=False).T
            logdet = torch.sum(torch.log(torch.diagonal(scale)))
            return -0.5 * torch.sum(sol**2, dim=-1) - logdet - 0.5 * D * _LOG_2PI
        return torch.sum(
            -0.5 * ((z - mean) / scale) ** 2 - torch.log(scale) - 0.5 * _LOG_2PI,
            dim=-1,
        )

    def entropy(self, params):
        _, scale = self.unpack(params)
        log_scale = torch.log(torch.diagonal(scale)) if self.fullrank else torch.log(scale)
        return torch.sum(log_scale) + 0.5 * self.D * (1 + _LOG_2PI)


def _adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``optax.adam``'s update as a function ``(params, grads) -> params``
    over dicts of tensors, with its moments in a closure."""
    state = {"mu": None, "nu": None, "count": 0}

    def update(params, grads):
        if state["mu"] is None:
            state["mu"] = {k: torch.zeros_like(v) for k, v in params.items()}
            state["nu"] = {k: torch.zeros_like(v) for k, v in params.items()}
        state["count"] += 1
        count = state["count"]
        out = {}
        for k, g in grads.items():
            mu = (1 - b1) * g + b1 * state["mu"][k]
            nu = (1 - b2) * g**2 + b2 * state["nu"][k]
            state["mu"][k], state["nu"][k] = mu, nu
            mu_hat = mu / (1 - b1**count)
            nu_hat = nu / (1 - b2**count)
            out[k] = params[k] + (mu_hat / (torch.sqrt(nu_hat) + eps)) * -learning_rate
        return out

    return update


class ADVI:
    """Mean-field or full-rank Gaussian variational approximation."""

    def __init__(self, model: Model, method: Literal["meanfield", "fullrank"] = "meanfield"):
        if method not in ("meanfield", "fullrank"):
            raise ValueError("method must be 'meanfield' or 'fullrank'")
        self.model = model
        self.method = method
        self.result: ADVIResult | None = None

    def fit(
        self,
        n: int = 10_000,
        learning_rate: float = 1e-2,
        mc_samples: int = 8,
        seed: int = 0,
        draws: int = 1000,
        chains: int = 1,
        compute_log_likelihood: bool = True,
    ) -> ADVIResult:
        """Maximize the ELBO and sample the fitted q.

        Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA
        device this raises.  ``seed`` seeds the ``torch.Generator`` on that
        device that makes every step's noise and the final draws.
        """
        device = compute_device()
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        D = self.model.flat_dim

        def noise(rows: int):
            return torch.randn((rows, D), generator=generator, dtype=torch.float64,
                               device=device)

        return self._fit(lambda i: noise(mc_samples), lambda: noise(draws * chains), n,
                         learning_rate, draws, chains, compute_log_likelihood, device)

    def _fit(self, step_noise: Callable, final_noise: Callable, n: int, learning_rate: float,
             draws: int, chains: int, compute_log_likelihood: bool, device) -> ADVIResult:
        """The fit, its noise given: ``step_noise(i)`` is step ``i``'s
        ``(mc_samples, D)`` standard normals, ``final_noise()`` the
        ``(draws * chains, D)`` ones of the draws."""
        model = self.model
        D = model.flat_dim
        family = _Gaussian(D, self.method == "fullrank", device)
        data = model.tensor_data(device)
        logp = torch.func.vmap(lambda q: model.logp(model.unravel(q), data))

        def neg_elbo(params, eps):
            z = family.sample(params, eps)
            return -(torch.mean(logp(z)) + family.entropy(params))

        value_and_grad = torch.func.grad_and_value(neg_elbo)
        params = family.init(torch.float64, device)
        adam = _adam(learning_rate)
        trace = torch.empty(n, dtype=torch.float64, device=device)
        for it in range(n):
            grads, loss = value_and_grad(params, step_noise(it))
            params = adam(params, grads)
            trace[it] = loss
        trace = trace.cpu().numpy()

        mean, scale = (v.detach() for v in family.unpack(params))
        record: list = []
        if not np.all(np.isfinite(trace[-10:])):
            record.append("ELBO not finite at the end of optimization")

        flat = family.sample(params, final_noise()).reshape(chains, draws, D)
        idata = self._assemble_idata(flat, compute_log_likelihood)
        scale = scale.cpu().numpy()
        self.result = ADVIResult(
            method=self.method,
            mean=mean.cpu().numpy(),
            log_sigma=None if family.fullrank else np.log(scale),
            L=scale if family.fullrank else None,
            elbo_trace=trace,
            model=model,
            idata=idata,
            warnings=record,
        )
        self._params = params
        self._family = family
        return self.result

    def _assemble_idata(self, flat: torch.Tensor, compute_log_likelihood: bool):
        """The draws ``flat`` (C, T, D) on the device as an InferenceData:
        constrained posterior, the flat draws and the pointwise
        log-likelihood, evaluated there."""
        C, T, D = flat.shape
        posterior, log_lik = draw_groups(self.model, flat.reshape(C * T, D), C, T,
                                         compute_log_likelihood)
        groups = {
            "posterior": posterior,
            "sample_stats": Dataset(
                {"_flat_draws": DataArray(flat.cpu().numpy(), ("chain", "draw", "flat_param"))}
            ),
        }
        if log_lik is not None:
            groups["log_likelihood"] = log_lik
        return InferenceData(**groups)

    # -- densities for loo_approximate_posterior ----------------------------
    def _flat_draws(self) -> torch.Tensor:
        result = self._require_fit()
        flat = result.idata.sample_stats._flat_draws.values.reshape(-1, self.model.flat_dim)
        return torch.as_tensor(flat, device=compute_device())

    def compute_log_p(self) -> np.ndarray:
        """True log joint at the variational draws."""
        return map_draws(self.model.logp_flat, self._flat_draws(), self.model.n_obs).cpu().numpy()

    def compute_log_q(self) -> np.ndarray:
        """Variational log density at the variational draws."""
        return self._family.log_q(self._params, self._flat_draws()).cpu().numpy()

    def _require_fit(self) -> ADVIResult:
        if self.result is None:
            raise RuntimeError("Call fit() before computing densities")
        return self.result


def compute_log_weights(approx, scale: bool = False) -> np.ndarray:
    """log_p - log_q at the approximation's draws (optionally normalized).

    Mirrors reference ``wrapper/pymc/utils.py:175-216``.
    """
    log_p = approx.compute_log_p() if hasattr(approx, "compute_log_p") else approx.compute_logp()
    log_q = approx.compute_log_q() if hasattr(approx, "compute_log_q") else approx.compute_logq()
    lw = log_p - log_q
    if scale:
        m = lw.max()
        lw = lw - (m + np.log(np.sum(np.exp(lw - m))))
    return lw
