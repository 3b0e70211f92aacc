"""Implicitly-adaptive importance sampling via moment matching.

Counterpart of ``pyloo_tpu/loo_moment_match.py`` (reference
``pyloo/loo_moment_match.py:34-1157``
(Paananen, Piironen, Bürkner, Vehtari 2021, "Implicitly adaptive importance
sampling", Stat. Comput. 31).  For every observation whose Pareto k exceeds
the threshold, posterior draws are affinely transformed (weighted-mean shift,
+marginal-scale, +covariance via Cholesky) and kept greedily whenever the
transform lowers k; an optional split transform (half forward, half inverse,
multiple-importance-sampling weights) protects the elpd estimate.

Two model interfaces, as in the reference:
* a :class:`pyloo_tpu_torch.models.JAXModelWrapper` — log-prob/log-lik
  re-evaluations are vmapped calls over the whole draw matrix on the
  device, and by default every bad observation's greedy loop runs at once
  there (:func:`pyloo_tpu_torch.ops.moment_match.batched_moment_match`);
* five user callables (``post_draws``, ``log_lik_i``, ``unconstrain_pars``,
  ``log_prob_upars_fn``, ``log_lik_i_upars_fn``) with the reference
  signatures, through the host loop.

With ``rcParams["device.auto_shard"]`` and more than one CUDA device, the
lanes (the bad observations) are split over every device of
:func:`pyloo_tpu_torch.parallel.obs_mesh`, as ``pyloo_tpu`` shards them,
padded to a multiple of the mesh size with lanes that replay the first
observation at k = -inf, which never run.  ``pyloo_tpu`` runs a batch for
each PSIS tail length; the port runs every lane in one batch, each with its
own tail length (equal to rounding).
"""

from __future__ import annotations

import inspect
import logging
import warnings
from copy import deepcopy
from typing import Callable, Literal

import numpy as np
import torch

from ._common import compute_device
from .base import ISMethod, compute_importance_weights
from .containers import DataArray
from .elpd import ELPDData
from .helpers import (
    ParameterConverter,
    ShiftAndCovResult,
    ShiftAndScaleResult,
    ShiftResult,
    UpdateQuantitiesResult,
    _n_chains,
    _wrapper_model_fns,
    log_prob_upars,
)
from .models.wrapper import JAXModelWrapper
from .ops import psislw_batch, tail_length
from .ops.ess import ess_mean
from .ops.moment_match import KINDS, _Lanes, _transform, run_lanes
from .parallel.sharding import default_mesh, device_scope
from .profiling import count, span
from .rcparams import rcParams
from .split_moment_match import loo_moment_match_split, split_lanes
from .utils import _logsumexp

_log = logging.getLogger(__name__)

__all__ = ["loo_moment_match", "loo_moment_match_split"]


def loo_moment_match(
    model,
    loo_data: ELPDData,
    post_draws: Callable | None = None,
    log_lik_i: Callable | None = None,
    unconstrain_pars: Callable | None = None,
    log_prob_upars_fn: Callable | None = None,
    log_lik_i_upars_fn: Callable | None = None,
    max_iters: int = 30,
    k_threshold: float | None = None,
    split: bool = False,
    cov: bool = True,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    verbose: bool = False,
    device_batched: bool | None = None,
    **kwargs,
) -> ELPDData:
    """Improve PSIS-LOO for high-k observations by moment matching.

    Parameters
    ----------
    model : JAXModelWrapper or custom object
        With a wrapper, draws/log-prob/log-lik come from the wrapper; with a
        custom object the five callables must be supplied.
    loo_data : ELPDData
        Pointwise LOO result to improve (must contain ``pareto_k``).
    max_iters : int
        Greedy transformation iterations per observation.
    k_threshold : float, optional
        Defaults to ``min(1 - 1/log10(S), 0.7)``.
    split : bool
        Apply the split transform (half forward / half inverse) after
        matching, protecting against transform overshoot.
    cov : bool
        Include the full-covariance (Cholesky) transform.
    device_batched : bool, optional
        Run the greedy loop for ALL bad observations at once on the device
        (:mod:`pyloo_tpu_torch.ops.moment_match`, each with its own PSIS
        tail length) instead of a host loop with per-transform device
        round-trips.  Default: automatically enabled on the wrapper + PSIS +
        non-verbose path; the five-callable interface always uses the host
        loop (the callbacks are arbitrary Python).

    Returns
    -------
    ELPDData
        Copy with updated ``loo_i``, ``pareto_k``, and totals.  On the
        device-batched path its ``moment_match_passes`` attribute (not a
        row) counts the passes the batched loop ran.  Its
        ``moment_match_accepted`` attribute, on both paths, is each
        observation's count of accepted transforms (a flat int64 array; -1
        where the observation's k did not call for matching).

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.
    """
    with span("pyloo.moment_match"):
        compute_device()
        _log.setLevel(logging.INFO if verbose else logging.WARNING)
        loo_data = deepcopy(loo_data)

        if hasattr(loo_data, "loo_i") and not hasattr(loo_data, "p_loo_i"):
            loo_data.p_loo_i = DataArray(
                np.zeros_like(loo_data.loo_i.values),
                loo_data.loo_i.dims,
                dict(loo_data.loo_i.coords),
            )

        is_wrapper = isinstance(model, JAXModelWrapper)
        if device_batched and not is_wrapper:
            raise ValueError(
                "device_batched=True requires a JAXModelWrapper model; the"
                " five-callable interface runs on the host loop."
            )
        converter = None
        if is_wrapper:
            converter = ParameterConverter(model)
            upars = model.get_unconstrained_parameters()
            S = upars.shape[0]
            count("mm_evals", "original", S)
            orig_log_prob = log_prob_upars(model, upars)
        else:
            required = {
                "post_draws": post_draws,
                "log_lik_i": log_lik_i,
                "unconstrain_pars": unconstrain_pars,
                "log_prob_upars_fn": log_prob_upars_fn,
                "log_lik_i_upars_fn": log_lik_i_upars_fn,
            }
            missing = [name for name, fn in required.items() if fn is None]
            if missing:
                raise ValueError(
                    "When not using JAXModelWrapper, you must provide all the"
                    f" following functions: {', '.join(required)}. Missing:"
                    f" {', '.join(missing)}"
                )
            _validate_custom_function(post_draws, ["model"], "post_draws")
            _validate_custom_function(log_lik_i, ["model", "i"], "log_lik_i")
            _validate_custom_function(
                unconstrain_pars, ["model", "pars"], "unconstrain_pars"
            )
            _validate_custom_function(
                log_prob_upars_fn, ["model", "upars"], "log_prob_upars_fn"
            )
            _validate_custom_function(
                log_lik_i_upars_fn, ["model", "upars", "i"], "log_lik_i_upars_fn"
            )
            try:
                pars = post_draws(model, **kwargs)
                upars = unconstrain_pars(model, pars=pars, **kwargs)
                upars = _validate_output(upars, "upars", expected_ndim=2)
            except Exception as e:
                raise ValueError(
                    f"Error getting unconstrained parameters: {e}. Make sure your "
                    "post_draws and unconstrain_pars functions are implemented"
                    " correctly."
                ) from e
            S = upars.shape[0]
            try:
                orig_log_prob = log_prob_upars_fn(model, upars=upars, **kwargs)
                orig_log_prob = _validate_output(
                    orig_log_prob, "orig_log_prob", expected_ndim=1
                )
            except Exception as e:
                raise ValueError(
                    f"Error computing log probabilities: {e}. Make sure your "
                    "log_prob_upars_fn function is implemented correctly."
                ) from e

        if k_threshold is None:
            k_threshold = min(1 - 1 / np.log10(S), 0.7)

        if hasattr(loo_data, "pareto_k"):
            ks = np.asarray(
                loo_data.pareto_k.values
                if hasattr(loo_data.pareto_k, "values")
                else loo_data.pareto_k
            )
        else:
            raise ValueError(
                "Moment matching requires pointwise LOO results with Pareto k values. "
                "Please recompute LOO with pointwise=True before using"
                " moment_match=True."
            )

        bad_obs = np.where(ks > k_threshold)[0]
        _log.info(f"Found {len(bad_obs)} observations with Pareto k > {k_threshold}")
        kfs = np.zeros_like(ks, dtype=float)
        original_ks = ks.copy()
        # each observation's accepted transforms; -1 where it was not matched
        loo_data.moment_match_accepted = np.full(ks.size, -1, dtype=np.int64)

        try:
            method_enum = method if isinstance(method, ISMethod) else ISMethod(
                str(method).lower()
            )
        except ValueError:
            method_enum = None
        if device_batched is None:
            device_batched = (
                is_wrapper and method_enum == ISMethod.PSIS and not verbose
            )
        if device_batched and method_enum == ISMethod.PSIS and len(bad_obs) > 0:
            _moment_match_wrapper_batched(
                model, loo_data, upars, orig_log_prob, bad_obs, kfs, ks,
                k_threshold=k_threshold, max_iters=max_iters, split=split,
                cov=cov, verbose=verbose,
            )
            summary(loo_data, original_ks, k_threshold, verbose=verbose)
            return loo_data

        for i in bad_obs:
            uparsi = upars.copy()
            ki = ks[i]
            kfi = 0.0

            log_liki, r_eff_i = _initial_log_lik(
                model, i, is_wrapper, upars, log_lik_i, verbose, **kwargs
            )
            lwi, initial_k = compute_importance_weights(
                -log_liki, method=method, reff=r_eff_i
            )
            lwi = np.asarray(lwi)

            total_shift = np.zeros(upars.shape[1])
            total_scaling = np.ones(upars.shape[1])
            total_mapping = np.eye(upars.shape[1])
            iterind = 1

            while iterind <= max_iters and ki > k_threshold:
                if iterind == max_iters:
                    warnings.warn(
                        "Maximum number of moment matching iterations reached. "
                        "Increasing max_iters may improve accuracy.",
                        stacklevel=2,
                    )
                improved = False

                transform_fns = [("shift", shift), ("scale", shift_and_scale)]
                if cov:
                    transform_fns.append(("cov", shift_and_cov))

                # each transform is computed from the *current* (possibly just
                # accepted) draws, matching the reference's greedy sequencing
                for kind, make_trans in transform_fns:
                    trans = make_trans(uparsi, lwi)
                    try:
                        quantities = update_quantities_i(
                            model,
                            trans["upars"],
                            i,
                            orig_log_prob,
                            r_eff_i,
                            converter if is_wrapper else None,
                            None if is_wrapper else log_prob_upars_fn,
                            None if is_wrapper else log_lik_i_upars_fn,
                            method,
                            verbose=verbose,
                            **kwargs,
                        )
                    except Exception as e:
                        warnings.warn(
                            f"Error during {kind} shift for observation {i}: {e}. "
                            "Skipping this transformation.",
                            stacklevel=2,
                        )
                        continue
                    if quantities["ki"] < ki:
                        _log.info(
                            f"Observation {i}: {kind} transform improved Pareto k from"
                            f" {ki:.4f} to {quantities['ki']:.4f}"
                        )
                        uparsi = trans["upars"]
                        total_shift = total_shift + trans["shift"]
                        if "scaling" in trans:
                            total_scaling = total_scaling * trans["scaling"]
                        if "mapping" in trans:
                            total_mapping = trans["mapping"] @ total_mapping
                        lwi = np.asarray(quantities["lwi"])
                        ki = quantities["ki"]
                        kfi = quantities["kfi"]
                        log_liki = quantities["log_liki"]
                        iterind += 1
                        improved = True

                if not improved:
                    _log.info(
                        f"Observation {i}: No further improvement after"
                        f" {iterind - 1} iterations. Final Pareto k = {ki:.4f}"
                    )
                    break

            if max_iters == 1:
                warnings.warn(
                    "Maximum number of moment matching iterations reached with"
                    " max_iters=1. Increasing max_iters may improve accuracy.",
                    stacklevel=2,
                )

            loo_data.moment_match_accepted[i] = iterind - 1
            if split and iterind > 1:
                try:
                    split_result = loo_moment_match_split(
                        model,
                        upars,
                        cov,
                        total_shift,
                        total_scaling,
                        total_mapping,
                        i,
                        r_eff_i,
                        log_prob_upars_fn=None if is_wrapper else log_prob_upars_fn,
                        log_lik_i_upars_fn=None if is_wrapper else log_lik_i_upars_fn,
                        method=method,
                        verbose=verbose,
                        **kwargs,
                    )
                    log_liki = split_result["log_liki"]
                    lwi = np.asarray(split_result["lwi"])
                    r_eff_i = split_result["r_eff_i"]
                except Exception as e:
                    warnings.warn(
                        f"Split transformation failed for observation {i}: {e}. "
                        "Using the last successful transformation instead.",
                        stacklevel=2,
                    )

            new_elpd_i = float(_logsumexp(np.asarray(log_liki) + lwi))
            update_loo_data_i(
                loo_data, int(i), new_elpd_i, float(ki), float(kfi), kfs,
                log_liki=np.asarray(log_liki), verbose=verbose,
            )

        summary(loo_data, original_ks, k_threshold, verbose=verbose)
        return loo_data


# Device memory for one copy of a block of lanes' draws, (lanes, S, P): the
# greedy loop holds a few such copies, so a call with many flagged rows runs
# them in blocks, each within this budget (64 lanes at S = 4,000, P = 517).
_LANE_BLOCK_BYTES = 1 << 30


def _moment_match_wrapper_batched(
    model, loo_data, upars, orig_log_prob, bad_obs, kfs, ks, *,
    k_threshold, max_iters, split, cov, verbose,
):
    """Device-resident moment matching for every bad observation at once.

    The bad observations run as lanes of one batched greedy loop, each with
    its own integer PSIS tail length
    (:func:`pyloo_tpu_torch.ops.moment_match.run_lanes`), in blocks of lanes
    within ``_LANE_BLOCK_BYTES``: transforms as batched (lanes, S, P) linear
    algebra, PSIS re-fits through the batched smoother, and the greedy
    control flow as an ``active`` mask over the lanes.  The split transform
    of a block's lanes runs on the device too
    (:func:`pyloo_tpu_torch.split_moment_match.split_lanes`), and the block's
    results come back in one read each.  The host loop above remains the
    path for custom callables / SIS / TIS.

    Under a profiler: the spans ``pyloo.moment_match.lanes`` (the bad
    observations' log-lik, r_eff and tail lengths), ``.pass`` (one a pass of
    a block's loop), ``.split`` (one a block, carrying its first lane ``i``)
    and ``.update``; the counters ``mm_lanes``, ``mm_passes``,
    ``mm_lane_passes``, ``mm_accepted`` (by ``shift``, ``scale``,
    ``cov``), ``mm_cov_failures`` (lanes whose covariance map fell back to
    the identity), ``mm_split_lanes``, ``mm_evals`` (draws whose log density
    was evaluated) and ``host_reads`` under ``moment_match.*``.
    """
    device = compute_device()
    upars = np.asarray(upars, dtype=np.float64)
    S, P = upars.shape
    upars_dev = torch.tensor(upars, device=device)
    log_prob_fn, log_lik_col_fn = _wrapper_model_fns(model.model)

    with span("pyloo.moment_match.lanes"):
        # each bad observation's log-lik at the original draws, on its own rows
        bad = [int(i) for i in bad_obs]
        count("mm_lanes", "batched", len(bad))
        ll_bad = log_lik_col_fn(
            upars_dev.expand(len(bad), S, P), torch.as_tensor(bad, device=device)
        )  # (n_bad, S)
        count("host_reads", "moment_match.lanes")
        ll_bad_host = ll_bad.cpu().numpy()

        # r_eff per bad observation, exactly as the host loop computes it
        n_chains = _n_chains(model)
        r_effs = {}
        for j, i in enumerate(bad):
            if n_chains == 1:
                r_effs[i] = 1.0
            else:
                col = ll_bad_host[j]
                r_effs[i] = float(np.asarray(ess_mean(col.reshape(n_chains, -1))) / S)

        # each lane's own PSIS tail budget: lanes of every budget share a batch
        tails = [tail_length(S, r_effs[i]) for i in bad]

    orig_lp = torch.tensor(np.asarray(orig_log_prob), dtype=torch.float64)
    # the lanes are split over the mesh: every lane's greedy loop is
    # independent, so different observations run on different devices
    mesh = default_mesh(device) if rcParams["device.auto_shard"] else None
    devices = mesh.devices if mesh is not None else (device,)
    on = {str(d): (upars_dev.to(d), orig_lp.to(d)) for d in devices}
    tail_max = max(tails)
    block = max(len(devices), _LANE_BLOCK_BYTES // (S * P * upars_dev.element_size()))
    passes = 0
    for start in range(0, len(bad), block):
        rows = list(range(start, min(start + block, len(bad))))
        n_b = len(rows)
        # the block's device state ends with the call: the peak is one block's
        block_passes, out = _match_block(
            rows, bad, tails, tail_max, ll_bad, ks, devices, on, log_prob_fn, log_lik_col_fn,
            k_threshold=k_threshold, max_iters=max_iters, split=split, cov=cov)
        passes += block_passes
        idxs = [bad[j] for j in rows]
        for kind, n_kind in zip(KINDS, out["accepted_by_kind"].sum(axis=0).tolist()):
            count("mm_accepted", kind, n_kind)
        count("mm_cov_failures", "batched", int(out["cov_failed"].sum()))
        if split:
            count("mm_split_lanes", "batched", int(np.sum(out["n_accepted"] > 0)))
        _log.info(
            f"Batched moment matching covered {n_b} observations,"
            f" {int(np.sum(out['n_accepted'] > 0))} improved"
        )

        for j, i in enumerate(idxs):
            loo_data.moment_match_accepted[i] = int(out["n_accepted"][j])
            if bool(out["reached_max"][j]):
                warnings.warn(
                    "Maximum number of moment matching iterations reached. "
                    "Increasing max_iters may improve accuracy.",
                    stacklevel=2,
                )
            if max_iters == 1:
                warnings.warn(
                    "Maximum number of moment matching iterations reached with"
                    " max_iters=1. Increasing max_iters may improve accuracy.",
                    stacklevel=2,
                )
            if split and bool(out["split_failed"][j]):
                warnings.warn(
                    f"Split transformation failed for observation {i}: the accumulated"
                    " map is singular. Using the last successful transformation instead.",
                    stacklevel=2,
                )
            with span("pyloo.moment_match.update"):
                log_liki = out["log_liki"][j]
                new_elpd_i = float(_logsumexp(log_liki + out["lwi"][j]))
                update_loo_data_i(
                    loo_data, int(i), new_elpd_i, float(out["ki"][j]), float(out["kfi"][j]),
                    kfs, log_liki=log_liki, verbose=verbose,
                )
    loo_data.moment_match_passes = passes


def _match_block(rows, bad, tails, tail_max, ll_bad, ks, devices, on, log_prob_fn,
                 log_lik_col_fn, *, k_threshold, max_iters, split, cov):
    """The greedy loop, and the split, of the lanes ``rows`` (positions in
    ``bad``) over the devices: (passes, the lanes' results on the host)."""
    n_b = len(rows)
    S, device = ll_bad.shape[1], ll_bad.device
    # padding lanes replay the block's first observation but start with
    # k at -inf, so their loop condition is false from the start
    rows_p = rows + [rows[0]] * ((-n_b) % len(devices))
    idxs = [bad[j] for j in rows_p]
    row_tails = torch.as_tensor([tails[j] for j in rows_p], device=device)
    log_liki0 = ll_bad[rows_p]
    lwi0, _ki_recomputed = psislw_batch(-log_liki0, tail_max, row_tails)
    # host-loop parity: the greedy baseline k is the STORED pareto_k
    # from loo_data (reference loo_moment_match.py:389 ``ki = ks[i]``),
    # not the value recomputed from the initial weights
    ki0_np = np.asarray(ks, dtype=np.float64).flat[idxs].copy()
    ki0_np[n_b:] = -np.inf
    ki0 = torch.as_tensor(ki0_np, device=device)
    obs_idx = torch.as_tensor(idxs, device=device)
    per = len(rows_p) // len(devices)
    lanes = []
    for j, d in enumerate(devices):
        lane = slice(j * per, (j + 1) * per)
        upars_d, orig_lp_d = on[str(d)]
        with device_scope(d):
            lanes.append(_Lanes(
                upars_d, obs_idx[lane].to(d), orig_lp_d, log_liki0[lane].to(d),
                lwi0[lane].to(d), ki0[lane].to(d), float(k_threshold),
                log_prob_fn=log_prob_fn, log_lik_col_fn=log_lik_col_fn,
                tail_max=tail_max, max_iters=max_iters, use_cov=cov,
                row_tails=row_tails[lane].to(d),
            ))
    passes = run_lanes(lanes)
    parts = [lane.result() for lane in lanes]
    if split:
        with span("pyloo.moment_match.split", i=idxs[0]):
            count("mm_evals", "split", 2 * S * len(rows_p))
            for part, lane, d in zip(parts, lanes, devices):
                with device_scope(d):
                    _split_part(part, lane, on[str(d)][0], cov, tail_max,
                                log_prob_fn, log_lik_col_fn)
    keys = ("ki", "kfi", "lwi", "log_liki", "n_accepted", "reached_max",
            "accepted_by_kind", "cov_failed") + (("split_failed",) if split else ())
    count("host_reads", "moment_match.result", len(parts) * len(keys))
    out = {k: torch.cat([p[k].cpu() for p in parts])[:n_b].numpy() for k in keys}
    return passes, out


def _split_part(part: dict, lanes: _Lanes, upars, cov: bool, tail_max: int, log_prob_fn,
                log_lik_col_fn) -> None:
    """Put the split transform's ``log_liki`` and ``lwi`` of the lanes that
    accepted a transform into ``part`` (a :meth:`_Lanes.result`), on its
    device, and ``split_failed``: the lanes whose accumulated map is
    singular, which keep their last transform's, as a lane that accepted
    none keeps its own (the host loop drops such an observation's split
    with a warning)."""
    ll, lw, ok = split_lanes(upars, part["total_shift"], part["total_scaling"],
                             part["total_mapping"], lanes.obs_idx, lanes.row_tails,
                             tail_max, log_prob_fn, log_lik_col_fn, use_cov=cov)
    matched = part["n_accepted"] > 0
    part["split_failed"] = matched & ~ok
    take = (matched & ok)[:, None]
    part["log_liki"] = torch.where(take, ll, part["log_liki"])
    part["lwi"] = torch.where(take, lw, part["lwi"])


def _log_lik_column(wrapper, upars, i: int) -> np.ndarray:
    """Observation i's log-lik at each draw, by the batched loop's column
    function (:func:`_wrapper_model_fns`), so both paths evaluate it alike."""
    device = compute_device()
    draws = torch.tensor(np.asarray(upars), dtype=torch.float64, device=device)[None]
    _, log_lik_col_fn = _wrapper_model_fns(wrapper.model)
    return log_lik_col_fn(draws, torch.tensor([i], device=device))[0].cpu().numpy()


def _initial_log_lik(model, i, is_wrapper, upars, log_lik_i, verbose, **kwargs):
    """Original-draw log-lik for observation i and its relative efficiency."""
    if is_wrapper:
        log_liki = _log_lik_column(model, upars, int(i))
        n_chains = _n_chains(model)
        if n_chains == 1:
            r_eff_i = 1.0
        else:
            arranged = log_liki.reshape(n_chains, -1)
            r_eff_i = float(np.asarray(ess_mean(arranged)) / len(log_liki))
        return log_liki, r_eff_i

    try:
        log_liki = log_lik_i(model, i, **kwargs)
        log_liki = _validate_output(
            log_liki, f"log_lik for observation {i}", expected_ndim=1
        )
    except Exception as e:
        raise ValueError(
            f"Error computing log likelihood for observation {i}: {e}. "
            "Make sure your log_lik_i function returns the log likelihood "
            "for the specified observation as a 1D array."
        ) from e
    matrix = np.asarray(log_liki)
    if matrix.ndim > 1 and matrix.shape[1] > 1:
        r_eff_i = float(np.asarray(ess_mean(matrix.T)) / matrix.size)
    else:
        r_eff_i = 1.0
    return log_liki, r_eff_i


def update_quantities_i(
    model,
    upars: np.ndarray,
    i: int,
    orig_log_prob: np.ndarray,
    r_eff_i: float,
    converter: ParameterConverter | None = None,
    log_prob_upars_fn: Callable | None = None,
    log_lik_i_upars_fn: Callable | None = None,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    verbose: bool = False,
    **kwargs,
) -> UpdateQuantitiesResult:
    """Re-evaluate weights/diagnostics/log-lik at transformed draws.

    Importance ratios: ``lr = -log_lik_new + log_prob_new - orig_log_prob``
    (leave-one-out) and ``log_prob_new - orig_log_prob`` (full posterior),
    each re-smoothed with the chosen IS method.
    """
    if isinstance(model, JAXModelWrapper):
        log_prob_new = log_prob_upars(model, upars)
        log_liki_new = _log_lik_column(model, upars, int(i))
    else:
        if None in (log_prob_upars_fn, log_lik_i_upars_fn):
            raise ValueError(
                "log_prob_upars_fn and log_lik_i_upars_fn must be provided when"
                " not using JAXModelWrapper"
            )
        try:
            log_prob_new = log_prob_upars_fn(model, upars=upars, **kwargs)
            log_prob_new = _validate_output(
                log_prob_new, "log_prob_new", expected_ndim=1
            )
        except Exception as e:
            raise ValueError(
                f"Error computing log probability: {e}. Make sure your"
                " log_prob_upars_fn function returns a 1D array of log"
                " probabilities."
            ) from e
        try:
            log_liki_new = log_lik_i_upars_fn(model, upars=upars, i=i, **kwargs)
            log_liki_new = _validate_output(
                log_liki_new, f"log_liki_new for obs {i}", expected_ndim=1
            )
        except Exception as e:
            raise ValueError(
                f"Error computing log likelihood for observation {i}: {e}. Make"
                " sure your log_lik_i_upars_fn function returns a 1D array of"
                " log likelihoods."
            ) from e

    log_liki_new = np.asarray(log_liki_new, dtype=np.float64)
    log_prob_new = np.asarray(log_prob_new, dtype=np.float64)
    orig_log_prob = np.asarray(orig_log_prob, dtype=np.float64)

    lr = -log_liki_new + log_prob_new - orig_log_prob
    lr[np.isnan(lr)] = -np.inf
    lwi_new, ki_new = compute_importance_weights(lr, method=method, reff=r_eff_i)

    full_lr = log_prob_new - orig_log_prob
    full_lr[np.isnan(full_lr)] = -np.inf
    lwfi_new, kfi_new = compute_importance_weights(
        full_lr, method=method, reff=r_eff_i
    )

    return {
        "lwi": np.asarray(lwi_new),
        "lwfi": np.asarray(lwfi_new),
        "ki": float(ki_new),
        "kfi": float(kfi_new),
        "log_liki": log_liki_new,
    }


def _lane_transform(upars, lwi, kind: int):
    """One moment-matching transform of one draw matrix, through the batched
    loop's :func:`pyloo_tpu_torch.ops.moment_match._transform` on the device,
    so that the host loop and the batched loop transform alike."""
    device = compute_device()
    u = torch.tensor(np.asarray(upars), dtype=torch.float64, device=device)[None]
    w = torch.tensor(np.asarray(lwi), dtype=torch.float64, device=device)[None]
    new, shift_amt, scaling, mapping, ok = _transform(u, w, kind)
    return (new[0].cpu().numpy(), shift_amt[0].cpu().numpy(), scaling[0].cpu().numpy(),
            mapping[0].cpu().numpy(), bool(ok[0]))


def shift(upars: np.ndarray, lwi: np.ndarray) -> ShiftResult:
    """Translate draws so the plain mean lands on the weighted mean."""
    new, shift_amt, _, _, _ = _lane_transform(upars, lwi, 0)
    return {"upars": new, "shift": shift_amt}


def shift_and_scale(upars: np.ndarray, lwi: np.ndarray) -> ShiftAndScaleResult:
    """Shift plus marginal-variance matching (S/(S-1)-corrected 2nd moment)."""
    new, shift_amt, scaling, _, _ = _lane_transform(upars, lwi, 1)
    return {"upars": new, "shift": shift_amt, "scaling": scaling}


def shift_and_cov(upars: np.ndarray, lwi: np.ndarray) -> ShiftAndCovResult:
    """Shift plus full covariance matching via the Cholesky map L_w @ L^-1.

    With lower-triangular factors cov = L L^T and wcov = L_w L_w^T, the map
    M = L_w L^-1 satisfies M cov M^T = wcov exactly.  (R loo's ``chol`` is
    upper-triangular; the reference translated its transpose pattern onto
    NumPy's lower factor, ``loo_moment_match.py:899-901``, producing a map
    that does not actually reproduce the weighted covariance.)  Where a
    factorisation fails the mapping is the identity, with a warning.
    """
    new, shift_amt, _, mapping, ok = _lane_transform(upars, lwi, 2)
    if not ok:
        warnings.warn(
            "Cholesky decomposition failed during covariance matching: Matrix is not"
            " positive definite. Using identity mapping instead.",
            stacklevel=2,
        )
    return {"upars": new, "shift": shift_amt, "mapping": mapping}


def update_loo_data_i(
    loo_data: ELPDData,
    i: int,
    new_elpd_i: float,
    ki: float,
    kfi: float,
    kfs: np.ndarray,
    wrapper=None,
    log_liki: np.ndarray | None = None,
    verbose: bool = False,
) -> None:
    """Write observation i's improved elpd/k back and re-derive the totals."""
    if log_liki is None:
        raise ValueError("log_liki must be provided")
    lpd_i = _logsumexp(log_liki) - np.log(len(log_liki))
    p_loo_i = lpd_i - new_elpd_i

    if hasattr(loo_data, "loo_i"):
        old_elpd_i = loo_data.loo_i.values.flat[i]
        loo_data.loo_i.values.flat[i] = new_elpd_i
        loo_data.p_loo_i.values.flat[i] = p_loo_i
        loo_data["elpd_loo"] = float(np.sum(loo_data.loo_i.values))
        loo_data["p_loo"] = float(np.sum(loo_data.p_loo_i.values))
        n_data_points = loo_data.n_data_points
        loo_data["se"] = float(
            (n_data_points * np.var(loo_data.loo_i.values)) ** 0.5
        )
        loo_data["p_loo_se"] = float(
            (n_data_points * np.var(loo_data.p_loo_i.values)) ** 0.5
        )
        _log.info(
            f"Observation {i}: ELPD changed from {old_elpd_i:.4f} to"
            f" {new_elpd_i:.4f} (diff: {new_elpd_i - old_elpd_i:.4f})"
        )
    else:
        loo_data["elpd_loo"] = new_elpd_i
        loo_data["p_loo"] = p_loo_i

    if "looic" in loo_data:
        loo_data["looic"] = -2 * loo_data["elpd_loo"]
        if "se" in loo_data:
            loo_data["looic_se"] = 2 * loo_data["se"]

    if hasattr(loo_data, "pareto_k"):
        k_arr = (
            loo_data.pareto_k.values
            if hasattr(loo_data.pareto_k, "values")
            else loo_data.pareto_k
        )
        old_k = k_arr.flat[i]
        k_arr.flat[i] = ki
        _log.info(
            f"Observation {i}: Pareto k changed from {old_k:.4f} to {ki:.4f}"
            f" (improvement: {old_k - ki:.4f})"
        )
    kfs.flat[i] = kfi


def summary(loo_data, original_ks, k_threshold, verbose=False):
    """Log how many observations improved / remain problematic."""
    if not hasattr(loo_data, "pareto_k"):
        return
    new_ks = (
        loo_data.pareto_k.values
        if hasattr(loo_data.pareto_k, "values")
        else loo_data.pareto_k
    )
    was_bad = original_ks > k_threshold
    still_bad = np.asarray(new_ks) > k_threshold
    improved = int(np.sum(was_bad & ~still_bad))
    remaining = int(np.sum(still_bad))
    _log.info(
        f"Moment matching: {improved} of {int(np.sum(was_bad))} problematic"
        f" observations improved below the threshold; {remaining} remain above."
    )


def _validate_custom_function(func, required_args, name):
    """Check a user callable exposes the reference-contract arguments."""
    try:
        signature = inspect.signature(func)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a callable function")
    params = set(signature.parameters)
    has_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        for p in signature.parameters.values()
    )
    missing = [a for a in required_args if a not in params]
    if missing and not has_var_kw:
        raise ValueError(
            f"Function {name} is missing required arguments: {', '.join(missing)}"
        )


def _validate_output(value, name, expected_ndim):
    """Coerce model-callback output to a float ndarray of the expected rank."""
    if isinstance(value, DataArray):
        value = value.values
    value = np.asarray(value, dtype=np.float64)
    if value.ndim > expected_ndim:
        value = value.reshape(value.shape[0], -1) if expected_ndim == 2 else value.ravel()
    if value.ndim != expected_ndim:
        raise ValueError(
            f"{name} must be a {expected_ndim}-D array, got shape {value.shape}"
        )
    if value.size == 0:
        raise ValueError(f"{name} is empty")
    return value
