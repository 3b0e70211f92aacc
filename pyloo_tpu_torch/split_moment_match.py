"""Split moment matching: half-forward / half-inverse transformed draws.

Counterpart of ``pyloo_tpu/split_moment_match.py`` (reference
``pyloo/split_moment_match.py:22-263``): the first S/2 draws get the
accumulated affine transform, the last S/2 its inverse; the proposal becomes
the deterministic two-component mixture; both the LOO and the
full-posterior weights are re-smoothed.

The transform algebra and the mixture denominator are the device functions
:func:`pyloo_tpu_torch.ops.moment_match.split_transform_halves` and
:func:`pyloo_tpu_torch.ops.moment_match.split_mixture_log_weights`; the
map's inverse and determinant are computed on the device too.  With a
:class:`~pyloo_tpu_torch.models.JAXModelWrapper` the halves are evaluated
there by the batched loop's model callables, and only the observation's
log-likelihood and the weights come back; the five callables are evaluated
on host copies of the halves.  :func:`split_lanes` is the transform of a
block of the batched loop's lanes, all on the device.
"""

from __future__ import annotations

from typing import Callable, Literal

import numpy as np
import torch

from ._common import compute_device
from .base import ISMethod, compute_importance_weights
from .helpers import _initialize_array, _wrapper_model_fns, compute_updated_r_eff
from .models.wrapper import JAXModelWrapper
from .ops.guard import per_row
from .ops.moment_match import split_mixture_log_weights, split_transform_halves
from .ops.psis import psislw_batch
from .profiling import count

__all__ = ["loo_moment_match_split", "split_lanes"]


def _read(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host, counted as a ``moment_match.split`` read."""
    count("host_reads", "moment_match.split")
    return t.cpu().numpy()


def _split_ratios(upars, shift, scaling, mapping, obs_idx, log_prob_fn, log_lik_col_fn, *,
                  use_cov: bool):
    """(log-lik, raw mixture log-weights), each (lanes, S), and whether each
    lane's map is invertible (lanes,), of the split transform of lanes with
    maps ``shift`` (lanes, P), ``scaling`` (lanes, P), ``mapping`` (lanes,
    P, P) of the draws ``upars`` (S, P); the lanes' observations
    ``obs_idx``, evaluated by the batched loop's model callables
    (:func:`pyloo_tpu_torch.helpers._wrapper_model_fns`).  A lane whose map
    is singular is transformed by the identity in its place, and its
    values are not to be used."""
    ok = torch.ones(mapping.shape[:-2], dtype=torch.bool, device=mapping.device)
    mapping_inv = mapping
    if use_cov:
        mapping_inv, info = torch.linalg.inv_ex(mapping)
        ok = info == 0
        eye = torch.eye(mapping.shape[-1], dtype=mapping.dtype, device=mapping.device)
        mapping = torch.where(ok[:, None, None], mapping, eye)
        mapping_inv = torch.where(ok[:, None, None], mapping_inv, eye)
    fwd, inv = split_transform_halves(upars, shift, scaling, mapping, mapping_inv,
                                      use_cov=use_cov)
    ll = log_lik_col_fn(fwd, obs_idx)
    # inverse-map Jacobian: log|d inv / d u| = -sum log scaling - log|det M|
    log_jac = torch.sum(torch.log(scaling), dim=-1) + torch.linalg.slogdet(mapping)[1]
    lr = split_mixture_log_weights(ll, log_prob_fn(fwd), log_prob_fn(inv) - log_jac[:, None])
    return ll, lr, ok


def split_lanes(upars, shift, scaling, mapping, obs_idx, row_tails, tail_max: int,
                log_prob_fn, log_lik_col_fn, *, use_cov: bool):
    """(log-lik, smoothed log-weights), each (lanes, S), and whether each
    lane's map is invertible (lanes,), of the split transform of a block of
    moment matching's lanes, on their device: each lane's mixture weights
    Pareto-smoothed with its own tail length ``row_tails`` (at most
    ``tail_max``), each lane deciding its own deep-tail guard.  The values
    of a lane whose map is singular are not to be used."""
    ll, lr, ok = _split_ratios(upars, shift, scaling, mapping, obs_idx, log_prob_fn,
                               log_lik_col_fn, use_cov=use_cov)
    with per_row():
        lw, _ = psislw_batch(lr, tail_max, row_tails)
    return ll, lw, ok


def _callable_fns(model, i, log_prob_fn, log_lik_fn, kwargs):
    """The user callables as the batched loop's model callables of one lane:
    each evaluates a host copy of the lane's draws."""
    if log_prob_fn is None or log_lik_fn is None:
        raise ValueError(
            "When not using JAXModelWrapper, you must provide the following"
            " functions: log_prob_upars_fn and log_lik_i_upars_fn"
        )
    device = compute_device()

    def lane(values):
        return torch.tensor(np.asarray(values, dtype=np.float64).ravel(), device=device)[None]

    def lp(u):
        return lane(log_prob_fn(model, upars=_read(u[0]), **kwargs))

    def ll(u, _obs_idx):
        return lane(log_lik_fn(model, upars=_read(u[0]), i=i, **kwargs))

    return lp, ll


def loo_moment_match_split(
    model,
    upars: np.ndarray,
    cov: bool,
    total_shift: np.ndarray,
    total_scaling: np.ndarray,
    total_mapping: np.ndarray,
    i: int,
    r_eff_i: float,
    log_prob_upars_fn: Callable | None = None,
    log_lik_i_upars_fn: Callable | None = None,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    verbose: bool = False,
    **kwargs,
):
    """Split-transform importance weights for observation ``i``.

    Returns a dict with ``lwi`` / ``lwfi`` / ``log_liki`` / ``r_eff_i``.
    The transforms and the mixture weights are computed on
    ``rcParams["device.device"]``.
    """
    upars = np.asarray(upars)
    S, dim = upars.shape
    S_half = S // 2

    total_shift = _initialize_array(total_shift, np.zeros, dim)
    total_scaling = _initialize_array(total_scaling, np.ones, dim)
    total_mapping = _initialize_array(total_mapping, np.eye, dim)

    device = compute_device()

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=device)

    if isinstance(model, JAXModelWrapper):
        fns = _wrapper_model_fns(model.model)
    else:
        fns = _callable_fns(model, i, log_prob_upars_fn, log_lik_i_upars_fn, kwargs)
    ll_half, lwi_half, ok = _split_ratios(
        dev(upars), dev(total_shift)[None], dev(total_scaling)[None], dev(total_mapping)[None],
        torch.tensor([i], device=device), *fns, use_cov=bool(cov),
    )
    if not _read(ok)[0]:
        raise torch.linalg.LinAlgError("the accumulated map is singular")
    log_liki_half = _read(ll_half[0])
    lwi_half = lwi_half[0]

    lwi_half, _ = compute_importance_weights(lwi_half, method=method, reff=r_eff_i)
    lwi_half = np.asarray(lwi_half)

    # full-posterior ("f") weights: add the log-lik back, guard non-finites
    lr = lwi_half + log_liki_half
    lr[np.isnan(lr) | (np.isinf(lr) & (lr > 0))] = -np.inf
    lwfi_half, _ = compute_importance_weights(lr, method=method, reff=r_eff_i)

    if isinstance(model, JAXModelWrapper):
        r_eff_i = compute_updated_r_eff(model, i, log_liki_half, S_half, r_eff_i)

    return {
        "lwi": lwi_half,
        "lwfi": np.asarray(lwfi_half),
        "log_liki": log_liki_half,
        "r_eff_i": r_eff_i,
    }
