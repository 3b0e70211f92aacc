"""Shared plumbing of the top-level estimators."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .ops.ess import relative_eff
from .rcparams import rcParams

__all__ = [
    "compute_device",
    "resolve_scale",
    "clean_log_likelihood",
    "compute_reff",
    "good_k_threshold",
]


def compute_device() -> torch.device:
    """The device of ``rcParams["device.device"]``; raises if it is absent.

    With ``"cuda"`` and no CUDA device this raises rather than computing on
    the CPU: set ``rcParams["device.device"] = "cpu"`` to do that.
    """
    name = rcParams["device.device"]
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rcParams['device.device'] is 'cuda' but torch finds no CUDA device;"
            " set rcParams['device.device'] = 'cpu' to compute on the CPU"
        )
    return torch.device(name)


def resolve_scale(scale):
    """Map scale name -> (name, multiplier): log=1, negative_log=-1, deviance=-2."""
    scale = rcParams["stats.ic_scale"] if scale is None else scale.lower()
    if scale == "deviance":
        return scale, -2
    if scale == "log":
        return scale, 1
    if scale == "negative_log":
        return scale, -1
    raise TypeError('Valid scale values are "deviance", "log", "negative_log"')


def _any_rowblock(matrix: torch.Tensor, predicate) -> bool:
    """Whether ``predicate`` holds anywhere, read one block of rows at a time
    so that the mask never spans the whole matrix."""
    rows = max(1, (1 << 28) // max(matrix.shape[1], 1))
    return bool(torch.stack([predicate(block).any() for block in matrix.split(rows)]).any())


def clean_log_likelihood(
    matrix: torch.Tensor, context="LOO", clean_inf: bool = False
) -> torch.Tensor:
    """Replace NaN (and, with ``clean_inf``, +-inf) log-lik values of the
    ``(n_obs, S)`` matrix with +-1e10, warning.

    Mirrors reference behaviour at ``pyloo/loo.py:218-227`` and
    ``pyloo/waic.py:110-132``.  ``pyloo_tpu`` scans the host payload; here
    the scan runs on the device matrix.  The matrix may share memory with the
    caller's array, so a matrix with such values is replaced, not written to.
    """
    if _any_rowblock(matrix, torch.isnan):
        warnings.warn(
            f"NaN values detected in log-likelihood. These will be ignored in"
            f" the {context} calculation.",
            UserWarning,
            stacklevel=3,
        )
        matrix = torch.where(torch.isnan(matrix), -1e10, matrix)
    if clean_inf and _any_rowblock(matrix, torch.isinf):
        warnings.warn(
            f"Infinite values detected in log-likelihood. These will be"
            f" ignored in the {context} calculation.",
            UserWarning,
            stacklevel=3,
        )
        matrix = torch.where(
            torch.isinf(matrix), torch.where(matrix > 0, 1e10, -1e10), matrix
        )
    return matrix


def compute_reff(inference_data, reff, n_samples):
    """Relative MCMC efficiency from the posterior group (mean-method ESS).

    Mirrors reference ``pyloo/loo.py:204-216``: 1.0 for single-chain data,
    otherwise mean ESS across all parameter elements divided by S.
    """
    if reff is not None:
        return reff
    if not hasattr(inference_data, "posterior"):
        raise TypeError("Must be able to extract a posterior group from data.")
    posterior = inference_data.posterior
    first = next(iter(posterior.data_vars.values()))
    n_chains = first.sizes.get("chain", 1)
    if n_chains == 1:
        return 1.0
    return relative_eff(
        {name: var.values for name, var in posterior.data_vars.items()}, n_samples
    )


def good_k_threshold(n_samples):
    """min(1 - 1/log10(S), 0.7) — reference ``pyloo/loo.py:249``."""
    return min(1 - 1 / np.log10(n_samples), 0.7)
