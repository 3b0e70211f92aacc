"""Moment-matching support: parameter conversion and model re-evaluation.

Counterpart of ``pyloo_tpu/helpers.py`` (reference ``pyloo/helpers.py:29-492``).
Where the reference evaluates a compiled PyTensor logp once per draw in a
Python double loop, the functional-model path here is one vmapped call over
the whole (S, P) draw matrix on the computation device; inputs and results
are numpy arrays on the host.
"""

from __future__ import annotations

from typing import TypedDict

import numpy as np
import torch

from ._common import compute_device
from .containers import DataArray
from .models.wrapper import JAXModelWrapper, map_draws
from .ops.ess import ess_mean
from .profiling import count

__all__ = [
    "ParameterConverter",
    "ShiftResult",
    "ShiftAndScaleResult",
    "ShiftAndCovResult",
    "UpdateQuantitiesResult",
    "log_prob_upars",
    "log_lik_i_upars",
    "extract_log_likelihood_for_observation",
    "compute_updated_r_eff",
    "_initialize_array",
]


class ShiftResult(TypedDict):
    upars: np.ndarray
    shift: np.ndarray


class ShiftAndScaleResult(TypedDict):
    upars: np.ndarray
    shift: np.ndarray
    scaling: np.ndarray


class ShiftAndCovResult(TypedDict):
    upars: np.ndarray
    shift: np.ndarray
    mapping: np.ndarray


class UpdateQuantitiesResult(TypedDict):
    lwi: np.ndarray
    lwfi: np.ndarray
    ki: float
    kfi: float
    log_liki: np.ndarray


class ParameterConverter:
    """Flatten named posterior draws to an (S, P) matrix and back.

    For :class:`JAXModelWrapper` the model's ``ravel``/``unravel`` define the
    layout, so conversions are exact inverses (reference ``helpers.py:84-235``
    tracks shapes/dims/coords of a PyMC posterior instead).
    """

    def __init__(self, wrapper: JAXModelWrapper):
        self.wrapper = wrapper
        self.model = wrapper.model
        self.param_names = list(self.model.param_shapes)

    @property
    def flat_dim(self) -> int:
        return self.model.flat_dim

    def dict_to_matrix(self, params: dict) -> np.ndarray:
        """dict of (S, *shape) arrays -> (S, P) matrix."""
        pieces = []
        for name in self.param_names:
            values = np.asarray(params[name])
            pieces.append(values.reshape(values.shape[0], -1))
        return np.concatenate(pieces, axis=1)

    def matrix_to_dict(self, matrix: np.ndarray) -> dict:
        """(S, P) matrix -> dict of (S, *shape) arrays."""
        out = {}
        pos = 0
        for name in self.param_names:
            shape = self.model.param_shapes[name]
            size = int(np.prod(shape, dtype=int))
            out[name] = np.asarray(matrix[:, pos : pos + size]).reshape(
                (matrix.shape[0],) + tuple(shape)
            )
            pos += size
        return out


def _draws_on_device(wrapper, upars) -> torch.Tensor:
    if isinstance(upars, dict):
        upars = ParameterConverter(wrapper).dict_to_matrix(upars)
    return torch.tensor(np.asarray(upars), dtype=torch.float64, device=compute_device())


def log_prob_upars(wrapper: JAXModelWrapper, upars) -> np.ndarray:
    """Unconstrained log joint density per draw: one vmapped call."""
    model = wrapper.model
    draws = _draws_on_device(wrapper, upars)
    count("host_reads", "moment_match.log_prob_upars")
    return map_draws(model.logp_flat, draws, model.n_obs).cpu().numpy()


def log_lik_i_upars(wrapper: JAXModelWrapper, upars, pointwise: bool = True):
    """Pointwise log likelihood at unconstrained draws: (S, n_obs)."""
    model = wrapper.model
    draws = _draws_on_device(wrapper, upars)
    count("host_reads", "moment_match.log_lik_i_upars")
    ll = map_draws(model.log_lik_flat, draws, model.n_obs).cpu().numpy()
    if pointwise:
        return ll
    return ll.sum(axis=1)


def extract_log_likelihood_for_observation(log_lik_result, i: int) -> np.ndarray:
    """Column i of a pointwise log-likelihood result, flattened to (S,)."""
    if isinstance(log_lik_result, DataArray):
        values = log_lik_result.values
    else:
        values = np.asarray(log_lik_result)
    if values.ndim == 1:
        return values
    if values.ndim == 2:
        return values[:, i]
    # (chain, draw, obs)
    flat_idx = np.unravel_index(i, values.shape[2:]) if values.ndim > 3 else (i,)
    return values[(slice(None), slice(None)) + tuple(flat_idx)].reshape(-1)


def _wrapper_model_fns(model):
    """The batched loop's model callables for a wrapper's :class:`Model`.

    ``log_prob_fn``: ``(n, S, P) -> (n, S)`` log joint density, vmapped in
    draw chunks within the evaluation budget of
    :func:`pyloo_tpu_torch.models.wrapper.map_draws`.

    ``log_lik_col_fn``: ``((n, S, P), obs_idx) -> (n, S)``, each lane's
    observation's log likelihood at its draws.  A model with static
    parameter shapes (no ``builder``) is evaluated on the observation's own
    rows of ``obs_keys`` with the same function, so a call holds ``n x S``
    values and not ``n x S x n_obs`` (10 GB at 64 x 4,000 x 5,000): its
    ``log_lik`` is pointwise, entry i reading row i of the observation
    arrays, as held-out scoring already assumes (``log_likelihood_i``).  A
    model with a ``builder`` (parameters that track the observations) is
    evaluated on its full vector, a lane at a time, and indexed.
    """
    obs_keys = model.obs_keys

    def log_prob_fn(u):
        n, S, P = u.shape
        return map_draws(model.logp_flat, u.reshape(n * S, P), model.n_obs).reshape(n, S)

    def log_lik_col_fn(u, obs_idx):
        data = model.tensor_data(u.device, u.dtype)
        if model.builder is not None:
            return torch.stack([
                torch.index_select(
                    map_draws(model.log_lik_flat, u[j], model.n_obs), 1, obs_idx[j : j + 1]
                )[:, 0]
                for j in range(u.shape[0])
            ])
        static = {k: v for k, v in data.items() if k not in obs_keys}
        rows = {k: data[k][obs_idx][:, None] for k in obs_keys}  # (n, 1, ...)

        def one(q, own):
            return model.log_lik(model.unravel(q), {**static, **own})[0]

        return torch.func.vmap(torch.func.vmap(one, in_dims=(0, None)), in_dims=(0, 0))(
            u, rows
        )

    return log_prob_fn, log_lik_col_fn


def _n_chains(wrapper) -> int:
    """Chains of the wrapper's posterior (1 when it has none)."""
    posterior = getattr(wrapper.idata, "posterior", None)
    if posterior is None:
        return 1
    first = next(iter(posterior.data_vars.values()))
    return first.sizes.get("chain", 1)


def compute_updated_r_eff(
    wrapper: JAXModelWrapper,
    i: int,
    log_liki_half: np.ndarray,
    S_half: int,
    r_eff_i: float,
) -> float:
    """Relative efficiency after a split transform: min over the two halves.

    Each half is arranged back into its chain structure when the original
    chain count divides it (reference ``helpers.py:345-424``).
    """
    log_liki_half = np.asarray(log_liki_half).ravel()
    n_chains = _n_chains(wrapper)

    def half_reff(half_values: np.ndarray) -> float:
        n = len(half_values)
        if n == 0:
            return r_eff_i
        if n_chains > 1 and n % n_chains == 0:
            arranged = half_values.reshape(n_chains, n // n_chains)
        else:
            arranged = half_values.reshape(1, n)
        if arranged.shape[1] < 8:
            return r_eff_i
        e = ess_mean(arranged)
        return float(np.asarray(e) / n)

    r1 = half_reff(log_liki_half[:S_half])
    r2 = half_reff(log_liki_half[S_half:])
    out = min(r1, r2)
    return out if np.isfinite(out) and out > 0 else r_eff_i


def _initialize_array(arr, default_fn, dim):
    """Use ``arr`` when its shape matches, else build the identity default."""
    if arr is not None:
        arr = np.asarray(arr)
        expected = default_fn(dim)
        if arr.shape == expected.shape:
            return arr
    return default_fn(dim)
