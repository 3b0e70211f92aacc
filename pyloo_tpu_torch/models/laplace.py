"""Laplace approximation of the posterior (MAP + Gaussian curvature).

Counterpart of ``pyloo_tpu/models/laplace.py``: the MAP in unconstrained
space by scipy's BFGS on the host, each evaluation of the log density and
its gradient a ``torch.func.grad_and_value`` call on the device (one host
read of its value and gradient, as scipy needs them); the Hessian there by
``torch.func.hessian``; diagonal jitter escalated until the negative Hessian
is positive definite; draws from the resulting normal by numpy's
``multivariate_normal(method="cholesky")`` and ``compute_logq`` by
``scipy.stats.multivariate_normal.logpdf``, so the same seed gives the same
draws and log q as ``pyloo_tpu``.  scipy is imported where it is used.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .._common import compute_device
from ..containers import DataArray, Dataset, InferenceData
from .wrapper import Model, draw_groups, map_draws, observed_data

__all__ = ["Laplace", "LaplaceVIResult"]


@dataclass
class LaplaceVIResult:
    """Laplace fit artifacts: posterior idata, MAP mean, covariance, warnings."""

    idata: InferenceData
    mu: np.ndarray
    H_inv: np.ndarray
    model: Model
    warnings: list = field(default_factory=list)


class Laplace:
    """Laplace (quadratic) approximation for a functional model."""

    def __init__(self, model: Model):
        self.model = model
        self.result: LaplaceVIResult | None = None

    # -- fitting ------------------------------------------------------------
    def fit(
        self,
        draws: int = 1000,
        chains: int = 4,
        seed: int = 0,
        compute_log_likelihood: bool = True,
        optimizer_method: str = "BFGS",
        jitter_start: float = 1e-8,
        jitter_max: float = 1e2,
    ) -> LaplaceVIResult:
        """MAP-fit the model and sample from the Gaussian approximation.

        The model is evaluated on ``rcParams["device.device"]``; with
        ``"cuda"`` and no CUDA device this raises.
        """
        from scipy import optimize

        model = self.model
        record: list = []
        device = compute_device()
        data = model.tensor_data(device)

        def logp(q):
            return model.logp(model.unravel(q), data)

        grad_and_value = torch.func.grad_and_value(logp)

        def neg_logp_and_grad(q):
            grad, value = grad_and_value(torch.as_tensor(q, dtype=torch.float64, device=device))
            both = torch.cat([value[None], grad]).cpu().numpy()
            return -float(both[0]), -both[1:]

        x0 = np.zeros(model.flat_dim)
        opt = optimize.minimize(neg_logp_and_grad, x0, jac=True, method=optimizer_method)
        if not opt.success:
            msg = f"MAP optimization did not fully converge: {opt.message}"
            warnings.warn(msg, UserWarning, stacklevel=2)
            record.append(msg)
        mu = np.asarray(opt.x, dtype=np.float64)

        H = torch.func.hessian(logp)(torch.as_tensor(mu, device=device)).cpu().numpy()
        H_neg = -H  # precision of the Gaussian approximation
        H_reg, reg_msg = _regularize_matrix(H_neg, jitter_start, jitter_max)
        if reg_msg:
            record.append(reg_msg)
        H_inv = np.linalg.inv(H_reg)
        H_inv = (H_inv + H_inv.T) / 2

        rng = np.random.default_rng(seed)
        total = draws * chains
        flat_draws = rng.multivariate_normal(
            mu, H_inv, size=total, method="cholesky"
        ).reshape(chains, draws, model.flat_dim)

        idata = self._assemble_idata(flat_draws, compute_log_likelihood)
        self.result = LaplaceVIResult(
            idata=idata, mu=mu, H_inv=H_inv, model=model, warnings=record
        )
        return self.result

    def _assemble_idata(self, flat_draws: np.ndarray, compute_log_likelihood: bool):
        """The draws (C, T, D) as an InferenceData: constrained posterior,
        the flat draws, the observed data and the pointwise log-likelihood,
        evaluated on the device."""
        C, T, D = flat_draws.shape
        rows = torch.as_tensor(flat_draws.reshape(C * T, D), device=compute_device())
        posterior, log_lik = draw_groups(self.model, rows, C, T, compute_log_likelihood)
        groups = {
            "posterior": posterior,
            "sample_stats": Dataset(
                {"_flat_draws": DataArray(flat_draws, ("chain", "draw", "flat_param"))}
            ),
            "observed_data": observed_data(self.model),
        }
        if log_lik is not None:
            groups["log_likelihood"] = log_lik
        return InferenceData(**groups)

    # -- densities ----------------------------------------------------------
    def compute_logp(self, idata: InferenceData | None = None) -> np.ndarray:
        """True (unnormalized) posterior log density at the drawn samples,
        evaluated on the device."""
        result = self._require_fit(idata)
        flat = result.idata.sample_stats._flat_draws.values.reshape(-1, self.model.flat_dim)
        rows = torch.as_tensor(flat, device=compute_device())
        return map_draws(self.model.logp_flat, rows, self.model.n_obs).cpu().numpy()

    def compute_logq(self, idata: InferenceData | None = None) -> np.ndarray:
        """Gaussian approximation log density at the drawn samples."""
        from scipy import stats

        result = self._require_fit(idata)
        flat = result.idata.sample_stats._flat_draws.values.reshape(-1, self.model.flat_dim)
        try:
            return stats.multivariate_normal.logpdf(flat, mean=result.mu, cov=result.H_inv)
        except np.linalg.LinAlgError:
            warnings.warn(
                "Covariance is numerically singular; evaluating logq with"
                " allow_singular=True.",
                UserWarning,
                stacklevel=2,
            )
            return stats.multivariate_normal.logpdf(
                flat, mean=result.mu, cov=result.H_inv, allow_singular=True
            )

    def _require_fit(self, idata):
        if self.result is None:
            raise RuntimeError("Call fit() before computing densities")
        return self.result


def _regularize_matrix(matrix: np.ndarray, jitter_start: float, jitter_max: float):
    """Escalate diagonal jitter until all eigenvalues are positive.

    Mirrors reference ``laplace.py:451-506``.
    """
    eigvals = np.linalg.eigvalsh(matrix)
    if np.all(eigvals > 0):
        return matrix, None
    jitter = jitter_start
    while jitter <= jitter_max:
        candidate = matrix + jitter * np.eye(matrix.shape[0])
        if np.all(np.linalg.eigvalsh(candidate) > 0):
            msg = (
                f"Hessian regularized with diagonal jitter {jitter:.1e} (min"
                f" eigenvalue was {eigvals.min():.2e})"
            )
            warnings.warn(msg, UserWarning, stacklevel=3)
            return candidate, msg
        jitter *= 10
    raise np.linalg.LinAlgError(
        "Could not regularize the negative Hessian to positive definiteness"
        f" (min eigenvalue {eigvals.min():.2e})"
    )
