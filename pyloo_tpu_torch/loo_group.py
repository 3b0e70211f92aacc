"""Leave-one-group-out cross-validation (LOGO-CV).

Counterpart of ``pyloo_tpu/loo_group.py`` (reference
``pyloo/loo_group.py:19-379``).  The group sums are made on the device in
the order of a sequential ``index_add_`` (:func:`add_group_sums`); the
per-group IS step runs the LOO scorers over the ``(n_groups, S)`` matrix.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ._common import clean_log_likelihood, compute_reff, good_k_threshold, resolve_scale
from .base import ISMethod, _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops import tail_length
from .ops.loo_kernels import loo_scores_psis, loo_scores_sis, loo_scores_tis
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_group"]


_SLAB = 1 << 25  # values of ``rows`` gathered at once (256 MB of float64)


def add_group_sums(out: torch.Tensor, group_index, rows: torch.Tensor) -> torch.Tensor:
    """Add each row of ``rows`` into ``out[group_index[row]]`` in row order.

    The sums are those of a sequential ``index_add_`` (the CPU's, and
    ``pyloo_tpu``'s there): ``((out[g] + r_a) + r_b) + ...`` for the rows
    ``a < b < ...`` of group g.  On the card ``index_add_`` over repeated
    indices adds with atomics in no fixed order, and ``index_put_`` with
    ``accumulate`` in an order of its own, so a group sum would round
    otherwise than on the CPU, and draws whose sums tie would come apart and
    move the PSIS tail they straddle; there the sums are
    :func:`ordered_group_sums`.  ``group_index`` is a host integer array; a
    row whose index is negative is left out.
    """
    gi = np.asarray(group_index, dtype=np.int64).reshape(-1)
    if rows.device.type != "cpu":
        return ordered_group_sums(out, gi, rows)
    kept = np.flatnonzero(gi >= 0)
    if len(kept) < len(gi):
        rows = rows[torch.from_numpy(kept)]
    return out.index_add_(0, torch.from_numpy(gi[kept]), rows)


def ordered_group_sums(out: torch.Tensor, gi: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
    """:func:`add_group_sums` on any device, through ``cumsum``.

    The rows are gathered group by group into blocks ``(1 + rounds, groups,
    S)`` led by the groups' sums so far, and ``cumsum`` over the first axis,
    which runs as one sequential loop a column (on the card as on the CPU),
    gives the sums in row order: one block for each distinct group size
    (groups largest first, so that each round of a block holds a row of
    each of its groups), cut into slabs of at most ``_SLAB`` values (or one
    row a group, where a row is wider).  The sorts are made on the rows'
    device; one copy of the group sizes comes to the host.
    """
    index = torch.from_numpy(gi).to(rows.device)
    by_group = torch.argsort(index, stable=True)[int(np.count_nonzero(gi < 0)):]
    sizes = torch.bincount(index[by_group], minlength=out.shape[0])
    largest = torch.argsort(sizes, descending=True, stable=True)
    starts = (torch.cumsum(sizes, 0) - sizes)[largest]  # each group's first row in by_group
    sizes = sizes[largest].cpu().numpy()
    width = rows.shape[1]
    done = 0  # rounds added: every group's first ``done`` rows
    # the distinct sizes, smallest first: rounds [done, size) hold the first k groups
    for k in np.flatnonzero(np.diff(sizes, append=0) < 0)[::-1] + 1:
        size = int(sizes[k - 1])
        for g0 in range(0, k, max(1, _SLAB // width)):
            g = slice(g0, min(k, g0 + max(1, _SLAB // width)))
            n = g.stop - g.start
            step = max(1, _SLAB // (n * width))
            for a in range(done, size, step):
                b = min(a + step, size)
                rounds = torch.arange(a, b, device=starts.device)
                block = rows.index_select(0, by_group[(starts[None, g] + rounds[:, None]).ravel()])
                block = torch.cat([out.index_select(0, largest[g])[None],
                                   block.view(b - a, n, width)])
                if n * width == 1:  # one column: cumsum would take a parallel scan
                    block = torch.cat([block, torch.zeros_like(block)], dim=2)
                out.index_copy_(0, largest[g], block.cumsum(0)[-1, :, :width])
        done = size
    return out


def loo_group(
    data,
    group_ids: np.ndarray,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method="psis",
) -> ELPDData:
    """LOGO-CV: leave out whole groups of observations at once.

    ``group_ids`` assigns every observation to a group; within-group
    log-likelihoods are summed before importance weighting, so the weights
    target the leave-one-group-out posterior.

    Returns an ELPDData with ``elpd_logo``/``p_logo``/``logoic`` rows (and
    per-group ``logo_i``/diagnostics when pointwise).
    """
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = int(np.prod(shape[:-1]))
    scale, scale_value = resolve_scale(scale)

    group_ids = np.asarray(group_ids)
    if len(group_ids) != n_data_points:
        raise ValueError(
            f"Length of group_ids ({len(group_ids)}) must match the number of "
            f"observations in log_likelihood ({n_data_points})."
        )
    unique_groups, group_index = np.unique(group_ids, return_inverse=True)
    n_groups = len(unique_groups)

    reff = compute_reff(inference_data, reff, n_samples)
    matrix, _, _ = as_sample_matrix(log_likelihood)  # (N, S)
    matrix = clean_log_likelihood(matrix, context="LOGO")

    try:
        method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
    if method != ISMethod.PSIS:
        warnings.warn(
            f"Using {method.value.upper()} for LOGO computation. Note that PSIS is the "
            "recommended method as it is typically more efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )

    group_ll = add_group_sums(matrix.new_zeros((n_groups, n_samples)), group_index, matrix)
    del matrix

    return _logo_result(
        group_ll, unique_groups, n_samples, reff, scale, scale_value,
        method, pointwise,
    )


def _logo_result(
    group_ll, unique_groups, n_samples, reff, scale, scale_value,
    method, pointwise,
):
    """IS weighting and result assembly over the ``(n_groups, S)`` tensor of
    group sums.  PSIS takes the exact scorer whatever the precision."""
    n_groups = group_ll.shape[0]
    if method == ISMethod.PSIS:
        m_tail = tail_length(n_samples, reff)
        scores = apply_rowwise(lambda b: loo_scores_psis(b, m_tail), group_ll)
    elif method == ISMethod.SIS:
        scores = apply_rowwise(loo_scores_sis, group_ll)
    else:
        scores = apply_rowwise(loo_scores_tis, group_ll)
    elpd_g, diagnostics, lppd_g = map(_host, scores)

    warn_mg = False
    good_k = good_k_threshold(n_samples)
    if method == ISMethod.PSIS:
        if np.any(diagnostics > good_k):
            n_high_k = int(np.sum(diagnostics > good_k))
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater than "
                f"{good_k:.2f} for {n_high_k} groups. This indicates that "
                "importance sampling may be unreliable because the marginal posterior "
                "and LOGO posterior are very different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(np.min(diagnostics))
        if min_ess < n_samples * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    logo_lppd_i = DataArray(
        scale_value * elpd_g, ("group",), {"group": unique_groups}, "logo_i"
    )
    logo_lppd = float(logo_lppd_i.values.sum())
    logo_lppd_se = float((n_groups * np.var(logo_lppd_i.values)) ** 0.5)
    lppd = float(np.sum(lppd_g))
    p_logo = lppd - logo_lppd / scale_value
    p_logo_se = float(np.sqrt(np.sum(np.var(logo_lppd_i.values))))
    logoic = -2 * logo_lppd
    logoic_se = 2 * logo_lppd_se

    rows: list[tuple[str, Any]] = [
        ("elpd_logo", logo_lppd),
        ("se", logo_lppd_se),
        ("p_logo", p_logo),
        ("p_logo_se", p_logo_se),
        ("n_samples", n_samples),
        ("n_groups", n_groups),
        ("warning", warn_mg),
    ]
    if pointwise:
        rows.append(("logo_i", logo_lppd_i))
    rows += [("scale", scale), ("logoic", logoic), ("logoic_se", logoic_se)]
    if pointwise:
        if method == ISMethod.PSIS:
            rows += [("pareto_k", diagnostics), ("good_k", good_k)]
        else:
            rows += [("ess", diagnostics)]
    elif method == ISMethod.PSIS:
        rows += [("good_k", good_k)]

    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
