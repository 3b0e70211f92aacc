"""Model comparison: ranking, pairwise elpd differences, model weights.

Counterpart of ``pyloo_tpu/compare.py`` (reference ``pyloo/compare.py:23-596``)
without pandas: :func:`loo_compare` returns a :class:`CompareTable` and
:func:`loo_model_weights` a :class:`ModelWeights`, each with a
``to_pandas()`` that imports pandas when it is called.  Weights: stacking
(scipy's SLSQP on the host below ``_DEVICE_SOLVER_MIN_OBS`` observations, as
the reference optimises; the EM solver of :mod:`pyloo_tpu_torch.ops.stacking`
on the device at or above it), Bayesian-bootstrap pseudo-BMA (numpy's
``RandomState.dirichlet`` on the host, so one seed gives the draws of
``pyloo_tpu``) and plain pseudo-BMA.
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np

from .elpd import ELPDData
from .loo import loo
from .waic import waic

__all__ = ["loo_compare", "loo_model_weights", "CompareTable", "ModelWeights"]

# above this many observations the stacking solve moves to the device
_DEVICE_SOLVER_MIN_OBS = 100_000

_METHODS = ("stacking", "bb-pseudo-bma", "pseudo-bma")


class CompareTable:
    """The comparison table of :func:`loo_compare`, ranked best to worst.

    Ordered columns of numpy arrays (``rank``, ``elpd_<ic>``, ``p_<ic>``,
    ``elpd_diff``, ``weight``, ``se``, ``dse``, ``warning``, ``scale``), one
    row a model; ``index`` holds the model names.  ``table["weight"]`` is a
    column; ``to_pandas()`` gives ``pyloo_tpu``'s ``DataFrame``.
    """

    def __init__(self, columns: dict, index):
        self._columns = dict(columns)
        self.index = list(index)

    @property
    def columns(self):
        return list(self._columns)

    def __getitem__(self, column):
        return self._columns[column]

    def __contains__(self, column):
        return column in self._columns

    def __len__(self):
        return len(self.index)

    def to_pandas(self):
        """The same table as a ``pandas.DataFrame`` (imports pandas)."""
        import pandas as pd

        return pd.DataFrame(self._columns, index=self.index)

    def __str__(self):
        cells = [[""] + self.columns]
        for i, name in enumerate(self.index):
            cells.append([str(name)] + [_cell(v[i]) for v in self._columns.values()])
        widths = [max(len(row[j]) for row in cells) for j in range(len(cells[0]))]
        return "\n".join(
            "  ".join(c.ljust(w) if j == 0 else c.rjust(w) for j, (c, w) in enumerate(zip(row, widths)))
            for row in cells
        )

    __repr__ = __str__


class ModelWeights:
    """Model weights by name, in the caller's insertion order.

    ``weights["a"]`` looks one up; ``index`` and ``values`` are the names and
    the float64 weights; ``to_pandas()`` gives ``pyloo_tpu``'s
    ``pandas.Series`` named ``weight``.
    """

    name = "weight"

    def __init__(self, values, index):
        self.values = np.asarray(values, dtype=np.float64)
        self.index = list(index)

    def __getitem__(self, name):
        return self.values[self.index.index(name)]

    def items(self):
        return zip(self.index, self.values)

    def to_pandas(self):
        """The weights as a ``pandas.Series`` (imports pandas)."""
        import pandas as pd

        return pd.Series(self.values, index=self.index, name=self.name)

    def __str__(self):
        width = max(len(str(n)) for n in self.index)
        return "\n".join(f"{str(n).ljust(width)}  {v:.6f}" for n, v in self.items())

    __repr__ = __str__


def _cell(value):
    if isinstance(value, (float, np.floating)):
        return f"{value:.6g}"
    return str(value)


def _check_args(compare_dict, ic, method, scale):
    if not isinstance(compare_dict, dict):
        raise TypeError("compare_dict must be a dictionary")
    if len(compare_dict) < 2:
        raise ValueError("You must specify at least two models for comparison")
    scale = "log" if scale is None else scale.lower()
    if scale not in ["log", "negative_log", "deviance"]:
        raise ValueError("Scale must be 'log', 'negative_log' or 'deviance'")
    method = method.lower()
    if method not in _METHODS:
        raise ValueError("Method must be 'stacking', 'BB-pseudo-BMA' or 'pseudo-BMA'")
    if ic not in ["loo", "waic", "kfold"]:
        raise ValueError("ic must be 'loo', 'waic', or 'kfold'")
    return method, scale


def _weights(elpds, ic, method, b_samples, alpha, seed, scale):
    """``(weights by name, bootstrap SEs by name or None)``."""
    if method == "stacking":
        return _stacking_weights(elpds, ic, scale), None
    if method == "bb-pseudo-bma":
        return _bb_pseudo_bma_weights(elpds, ic, b_samples, alpha, seed, scale)
    return _pseudo_bma_weights(elpds, ic, scale), None


def loo_compare(
    compare_dict,
    ic: str = "loo",
    method: Literal["stacking", "bb-pseudo-bma", "pseudo-bma"] = "stacking",
    b_samples: int = 1000,
    alpha: float = 1,
    seed=None,
    scale: str | None = None,
    var_name: str | None = None,
    observations=None,
    estimator=None,
    K: int | None = None,
    folds=None,
    stratify=None,
    random_seed: int | None = None,
) -> CompareTable:
    """Compare models by ELPD (LOO, subsampled LOO or WAIC; precomputed LFO
    and LOGO results).

    ``compare_dict`` maps model names to InferenceData-convertibles or to
    pointwise :class:`ELPDData` results.  Returns a :class:`CompareTable`
    ordered best to worst with columns rank / elpd / p_<ic> / elpd_diff /
    weight / se / dse / warning / scale.  With ``observations`` (a subsample
    size or indices) raw entries are scored by
    :func:`pyloo_tpu_torch.loo_subsample` with ``estimator``.  With
    ``ic="kfold"`` raw entries are model wrappers scored by
    :func:`pyloo_tpu_torch.loo_kfold` with ``K`` (default 10), ``folds``,
    ``stratify`` and ``random_seed``.

    Examples
    --------
    .. code-block:: python

        import pyloo_tpu_torch as pl

        table = pl.loo_compare({"a": idata_a, "b": idata_b})
        table["weight"]          # stacking weights on the simplex
    """
    method, scale = _check_args(compare_dict, ic, method, scale)
    elpds, scale, ic = _calculate_ics(
        compare_dict, scale=scale, ic=ic, var_name=var_name, observations=observations,
        estimator=estimator, K=K, folds=folds, stratify=stratify, random_seed=random_seed,
    )

    ascending = scale != "log"
    model_names = list(elpds.keys())
    elpd_values = np.array([elpds[name][f"elpd_{ic}"] for name in model_names])
    order = np.argsort(elpd_values) if ascending else np.argsort(-elpd_values)
    ordered_names = [model_names[i] for i in order]

    best_model = ordered_names[0]
    diffs, ses, dses = [], [], []
    for name in ordered_names:
        if name == best_model:
            diff = 0
            dse = 0
        else:
            diff = elpds[name][f"elpd_{ic}"] - elpds[best_model][f"elpd_{ic}"]
            if scale == "negative_log":
                diff *= -1
            elif scale == "deviance":
                diff *= -2
            ic_i = f"{ic}_i"
            pointwise_diff = _pointwise(elpds[name], ic_i) - _pointwise(elpds[best_model], ic_i)
            dse = np.sqrt(len(pointwise_diff) * np.var(pointwise_diff))
        diffs.append(diff)
        ses.append(elpds[name]["se"])
        dses.append(dse)

    weights, computed_ses = _weights(elpds, ic, method, b_samples, alpha, seed, scale)
    if computed_ses is not None:
        ses = [computed_ses[name] for name in ordered_names]

    n = len(ordered_names)
    columns = {
        "rank": np.arange(n),
        f"elpd_{ic}": np.array([elpds[name][f"elpd_{ic}"] for name in ordered_names], float),
        # LFO results carry no effective-parameter estimate
        f"p_{ic}": np.array([elpds[name].get(f"p_{ic}", np.nan) for name in ordered_names],
                            float),
        "elpd_diff": np.array(diffs, float),
        "weight": np.array([weights[name] for name in ordered_names], float),
        "se": np.array(ses, float),
        "dse": np.array(dses, float),
        "warning": np.array([bool(elpds[name]["warning"]) for name in ordered_names]),
        "scale": np.array([scale] * n, dtype=object),
    }
    return CompareTable(columns, ordered_names)


def loo_model_weights(
    compare_dict,
    ic: str = "loo",
    method: Literal["stacking", "bb-pseudo-bma", "pseudo-bma"] = "stacking",
    b_samples: int = 1000,
    alpha: float = 1,
    seed=None,
    scale: str | None = None,
    var_name: str | None = None,
) -> ModelWeights:
    """Model-averaging weights alone, without the comparison table.

    R ``loo::loo_model_weights`` parity.  Accepts the ``compare_dict`` of
    :func:`loo_compare`; returns the simplex weights as a
    :class:`ModelWeights` in the caller's insertion order (not ranked).
    """
    method, scale = _check_args(compare_dict, ic, method, scale)
    elpds, scale, ic = _calculate_ics(compare_dict, scale=scale, ic=ic, var_name=var_name)
    weights, _ = _weights(elpds, ic, method, b_samples, alpha, seed, scale)
    names = list(elpds.keys())
    return ModelWeights([weights[n] for n in names], names)


def _pointwise(result, ic_i):
    return np.asarray(getattr(result[ic_i], "values", result[ic_i]), dtype=np.float64).ravel()


def _ic_matrix(elpds, ic_i):
    """Pointwise elpds as ``(n_obs, n_models)``; checks that the lengths match.

    (Reference-compatible name, ``pyloo/compare.py:267-282``.)"""
    columns = []
    rows = None
    for name in elpds:
        values = _pointwise(elpds[name], ic_i)
        if rows is None:
            rows = len(values)
        elif len(values) != rows:
            raise ValueError("The number of observations should be the same across all models")
        columns.append(values)
    return rows, len(columns), np.stack(columns, axis=1)


def _calculate_ics(
    compare_dict,
    scale=None,
    ic=None,
    var_name=None,
    observations=None,
    estimator=None,
    K=None,
    folds=None,
    stratify=None,
    random_seed=None,
):
    """Resolve precomputed ELPDData entries and compute the rest.

    ``pyloo_tpu`` deep-copies ``compare_dict`` first; nothing here writes to
    an entry, so the entries are shared, not copied (a raw entry may hold a
    matrix of many gigabytes).
    """
    precomputed = {name: e for name, e in compare_dict.items() if isinstance(e, ELPDData)}
    precomputed_ic = None
    precomputed_scale = None

    if precomputed:
        arbitrary = list(precomputed.values())[-1]
        precomputed_ic = arbitrary.index[0].split("_")[1]
        precomputed_scale = arbitrary["scale"]
        missing_pointwise = f"{precomputed_ic}_i" not in arbitrary

        others = list(precomputed.values())[:-1]
        if any(e.index[0].split("_")[1] != precomputed_ic for e in others):
            raise ValueError("All information criteria to be compared must be the same")
        if any(e["scale"] != precomputed_scale for e in others):
            raise ValueError("All information criteria to be compared must use the same scale")
        if missing_pointwise or any(f"{precomputed_ic}_i" not in e for e in others):
            raise ValueError("Not all provided ELPDData have been calculated with pointwise=True")
        if ic is not None and ic.lower() != precomputed_ic.lower():
            warnings.warn(
                "Provided ic argument is incompatible with precomputed elpd data. "
                f"Using ic from precomputed elpddata: {precomputed_ic}",
                stacklevel=3,
            )
            ic = precomputed_ic
        if scale is not None and scale.lower() != precomputed_scale:
            warnings.warn(
                "Provided scale argument is incompatible with precomputed elpd data. "
                f"Using scale from precomputed elpddata: {precomputed_scale}",
                stacklevel=3,
            )
            scale = precomputed_scale

    ic = (precomputed_ic or "loo") if ic is None else ic.lower()
    scale = (precomputed_scale or "log") if scale is None else scale.lower()

    out = dict(compare_dict)
    raw = [name for name, d in out.items() if not isinstance(d, ELPDData)]
    if ic not in ("loo", "waic", "kfold") and raw:
        raise ValueError(
            f"ic='{ic}' cannot be computed from raw data inside loo_compare; "
            "precompute every entry (e.g. loo_lfo/loo_group with "
            "pointwise=True) and pass the ELPDData results"
        )
    for name in raw:
        try:
            if ic == "waic":
                out[name] = waic(out[name], pointwise=True, var_name=var_name, scale=scale)
            elif ic == "kfold":
                from .loo_kfold import loo_kfold

                out[name] = loo_kfold(
                    out[name], K=K if K is not None else 10, folds=folds, pointwise=True,
                    var_name=var_name, scale=scale, stratify=stratify,
                    random_seed=random_seed, save_fits=False,
                )
            elif observations is not None:
                from .loo_subsample import loo_subsample

                out[name] = loo_subsample(
                    out[name], observations=observations, estimator=estimator,
                    pointwise=True, var_name=var_name, scale=scale,
                )
            else:
                out[name] = loo(out[name], pointwise=True, var_name=var_name, scale=scale)
        except Exception as e:
            raise e.__class__(f"Encountered error trying to compute {ic} from model {name}.") from e
    return out, scale, ic


def _to_log_scale(values, scale):
    if scale == "deviance":
        return values / -2
    if scale == "negative_log":
        return values * -1
    return values


def _stacking_weights(elpds, ic, scale, solver="auto"):
    """Stacking of predictive distributions (Yao et al. 2018).

    ``solver="auto"`` takes scipy's SLSQP (the reference's optimiser) below
    ``_DEVICE_SOLVER_MIN_OBS`` observations and the EM solver on the device
    (:func:`pyloo_tpu_torch.ops.stacking.stacking_weights_em`) at or above.
    """
    model_names = list(elpds.keys())
    n_models = len(model_names)
    rows, _, pointwise = _ic_matrix(elpds, f"{ic}_i")
    pointwise = _to_log_scale(pointwise, scale)

    if solver == "device" or (solver == "auto" and rows >= _DEVICE_SOLVER_MIN_OBS):
        from .ops.stacking import stacking_weights_em

        weights = stacking_weights_em(pointwise).cpu().numpy()
        return dict(zip(model_names, weights))

    from scipy import optimize

    max_elpd = np.max(pointwise, axis=1, keepdims=True)
    exp_elpds = np.exp(pointwise - max_elpd)

    def full_simplex(free):
        w = np.concatenate((free, [max(1.0 - np.sum(free), 0.0)]))
        w = np.maximum(w, 0)
        return w / np.sum(w)

    def objective(free):
        return -np.sum(np.log(exp_elpds @ full_simplex(free)))

    def gradient(free):
        denom = exp_elpds @ full_simplex(free)
        return -np.array(
            [np.sum((exp_elpds[:, k] - exp_elpds[:, -1]) / denom) for k in range(n_models - 1)]
        )

    result = optimize.minimize(
        objective,
        np.full(n_models - 1, 1.0 / n_models),
        jac=gradient,
        bounds=[(0.0, 1.0)] * (n_models - 1),
        constraints=[
            {"type": "ineq", "fun": lambda x: 1.0 - np.sum(x)},
            {"type": "ineq", "fun": np.sum},
        ],
        method="SLSQP",
        options={"ftol": 1e-12, "maxiter": 2000},
    )
    return dict(zip(model_names, full_simplex(result.x)))


def _bb_pseudo_bma_weights(elpds, ic, b_samples, alpha, seed, scale):
    """Bayesian-bootstrap pseudo-BMA: Dirichlet reweighting on the host.

    Holds the ``(b_samples, n_obs)`` float64 Dirichlet draws at once, as
    ``pyloo_tpu`` does (8 GB at 1,000 draws of 1,000,000 observations).
    """
    model_names = list(elpds.keys())
    rows, _, pointwise = _ic_matrix(elpds, f"{ic}_i")
    pointwise = _to_log_scale(pointwise * rows, scale)

    rng = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    b_weighting = rng.dirichlet([alpha] * rows, size=b_samples)  # (b, rows)
    z_bs = b_weighting @ pointwise  # (b, cols) bootstrap elpd totals
    rel = z_bs - z_bs.max(axis=1, keepdims=True)
    w = np.exp(rel)
    w /= w.sum(axis=1, keepdims=True)
    mean_weights = w.mean(axis=0)
    ses = dict(zip(model_names, z_bs.std(axis=0)))
    return dict(zip(model_names, mean_weights)), ses


def _pseudo_bma_weights(elpds, ic, scale):
    """Akaike-type weights: softmax of total elpds."""
    model_names = list(elpds.keys())
    totals = np.array([elpds[name][f"elpd_{ic}"] for name in model_names])
    totals = _to_log_scale(totals, scale)
    rel = totals - totals.max()
    w = np.exp(rel)
    return dict(zip(model_names, w / w.sum()))
