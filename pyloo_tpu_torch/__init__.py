"""pyloo_tpu_torch: PSIS leave-one-out cross-validation in PyTorch, for CUDA.

The PyTorch port of ``pyloo_tpu``.  It covers ``loo()`` on a log-likelihood
matrix (PSIS, SIS, TIS, mixture), ``loo_streaming()`` over a log-likelihood
made on the device chunk by chunk, and the importance-weights path: the
weights themselves (``psislw``, ``psislw_compact``, ``sislw``, ``tislw``,
``compute_importance_weights``) and what reads them (``e_loo``,
``loo_predictive_metric``, ``loo_i``, ``loo_group``, ``waic``, ``elpd``,
``mcse_loo``, ``psis_ess_values``, ``loo_pit`` and the Pareto-k accessors),
scoring and model comparison (``loo_score``, ``crps``, ``scrps``,
``loo_lfo``, ``loo_compare``, ``loo_model_weights``), subsampled LOO
(``loo_subsample``, ``update_subsample``) and LOO for approximate
posteriors (``loo_approximate_posterior``, ``importance_resample``), every
``*_streaming`` form, and log-likelihood matrices on disk (``NpyLogLik``,
``loo_from_file``, ``waic_from_file``), in float64 (the default, reference-exact) or float32 (``loo()`` and
``loo_streaming()`` through a hand-written CUDA prepass kernel); and the
workflows that refit or re-weight a model (``Model``, ``JAXModelWrapper``,
``loo(moment_match=True)`` / ``loo_moment_match``, ``loo_kfold``,
``reloo``), whose models are torch functions sampled by HMC, NUTS or ChEES
on the device or fitted by ``Laplace`` and ``ADVI``
(:mod:`pyloo_tpu_torch.models`), or a live PyMC model through
``PyMCWrapper``; LOO for non-factorised normal and Student-t models
(``loo_nonfactor``); ingestion of netCDF files, CmdStan CSV output, NumPyro
and cmdstanpy fits and foreign arviz-style objects (``from_netcdf``,
``save_netcdf``, ``from_cmdstan``, ``from_cmdstanpy``, ``from_numpyro``,
``convert_foreign``); the diagnostic plots (``plot_loo``, ``plot_khat``,
``plot_compare``, ``plot_influence``, ``plot_loo_difference``,
``plot_loo_pit`` and their ``*_plot`` names; matplotlib is imported when a
plot is drawn); ``warmup`` for a cold process, and :mod:`pyloo_tpu_torch.profiling`.
The device is ``rcParams["device.device"]`` (``"cuda"`` by default; set
``"cpu"`` to compute on the CPU).

.. code-block:: python

    import pyloo_tpu_torch as pl

    idata = pl.load_example_data("centered_eight")
    print(pl.loo(idata, pointwise=True))
"""

import types as _types

from .base import ISMethod, compute_importance_weights
from . import compare as _compare_module
from .compare import CompareTable, ModelWeights, loo_compare, loo_model_weights


class _CallableCompareModule(_types.ModuleType):
    """Module type of ``pyloo_tpu_torch.compare``: calling the module calls
    ``loo_compare``, so ``pl.compare({...})`` works and the submodule path
    ``pyloo_tpu_torch.compare.loo_compare`` stays importable."""

    def __call__(self, *args, **kwargs):
        return self.loo_compare(*args, **kwargs)


_compare_module.__class__ = _CallableCompareModule
compare = _compare_module
from .containers import DataArray, Dataset, InferenceData
from .convert import inference_data_from_numpy
from .data import load_example_data
from .diagnostics import (
    loo_pit,
    mcse_loo,
    pareto_k_ids,
    pareto_k_table,
    pareto_k_values,
    psis_ess_values,
    relative_eff,
)
from .e_loo import ExpectationResult, compute_pareto_k, e_loo, k_hat
from .elpd import ELPDData
from .generic_elpd import elpd
from .helpers import (
    ParameterConverter,
    ShiftAndCovResult,
    ShiftAndScaleResult,
    ShiftResult,
    UpdateQuantitiesResult,
    compute_updated_r_eff,
    extract_log_likelihood_for_observation,
    log_lik_i_upars,
    log_prob_upars,
)
from .loo import loo
from .loo_group import loo_group
from .loo_i import loo_i
from .loo_kfold import (
    _kfold_split_grouped,
    _kfold_split_random,
    _kfold_split_stratified,
    loo_kfold,
)
from .loo_moment_match import loo_moment_match
from .io import NpyLogLik, loo_from_file, waic_from_file
from .loo_approximate_posterior import importance_resample, loo_approximate_posterior
from .loo_lfo import loo_lfo
from .loo_score import LooScoreResult, crps, loo_score, scrps
from .loo_predictive_metric import MetricResult, loo_predictive_metric
from .loo_subsample import loo_subsample, update_subsample
from .loo_nonfactor import loo_nonfactor
from .models import ADVI, JAXModelWrapper, Laplace, Model, PyMCWrapper
from .ingest import (
    convert_foreign,
    from_cmdstan,
    from_cmdstanpy,
    from_netcdf,
    from_numpyro,
    save_netcdf,
)
from .plots import (
    compare_plot,
    influence_plot,
    loo_difference_plot,
    loo_pit_plot,
    loo_plot,
    plot_compare,
    plot_khat,
    plot_influence,
    plot_loo,
    plot_loo_difference,
    plot_loo_pit,
)
from .psis import CompactWeights, psislw, psislw_compact
from .rcparams import rcParams
from .reloo import reloo
from .sis import sislw
from .split_moment_match import loo_moment_match_split
from .streaming import (
    clear_streaming_cache,
    e_loo_streaming,
    loo_approximate_posterior_streaming,
    loo_compare_streaming,
    loo_group_streaming,
    loo_predictive_metric_streaming,
    loo_score_streaming,
    loo_streaming,
    loo_subsample_streaming,
    waic_streaming,
)
from .tis import tislw
from .utils import from_dict, get_log_likelihood, to_inference_data
from .waic import waic
from .warmup import warmup

__all__ = [
    "ISMethod",
    "compute_importance_weights",
    "loo",
    "loo_streaming",
    "clear_streaming_cache",
    "waic_streaming",
    "loo_score_streaming",
    "loo_compare_streaming",
    "e_loo_streaming",
    "loo_predictive_metric_streaming",
    "loo_group_streaming",
    "loo_subsample_streaming",
    "loo_approximate_posterior_streaming",
    "NpyLogLik",
    "loo_from_file",
    "waic_from_file",
    "loo_subsample",
    "update_subsample",
    "loo_approximate_posterior",
    "importance_resample",
    "loo_compare",
    "loo_model_weights",
    "compare",
    "CompareTable",
    "ModelWeights",
    "loo_score",
    "crps",
    "scrps",
    "LooScoreResult",
    "loo_lfo",
    "loo_i",
    "loo_group",
    "waic",
    "elpd",
    "psislw",
    "psislw_compact",
    "CompactWeights",
    "sislw",
    "tislw",
    "e_loo",
    "ExpectationResult",
    "compute_pareto_k",
    "k_hat",
    "loo_predictive_metric",
    "MetricResult",
    "loo_pit",
    "mcse_loo",
    "pareto_k_ids",
    "pareto_k_table",
    "pareto_k_values",
    "psis_ess_values",
    "relative_eff",
    "rcParams",
    "load_example_data",
    "from_dict",
    "get_log_likelihood",
    "to_inference_data",
    "inference_data_from_numpy",
    "InferenceData",
    "Dataset",
    "DataArray",
    "ELPDData",
    "loo_kfold",
    "_kfold_split_random",
    "_kfold_split_stratified",
    "_kfold_split_grouped",
    "reloo",
    "JAXModelWrapper",
    "Model",
    "ADVI",
    "Laplace",
    "loo_nonfactor",
    "loo_moment_match",
    "loo_moment_match_split",
    "ParameterConverter",
    "ShiftAndCovResult",
    "ShiftAndScaleResult",
    "ShiftResult",
    "UpdateQuantitiesResult",
    "log_lik_i_upars",
    "log_prob_upars",
    "compute_updated_r_eff",
    "extract_log_likelihood_for_observation",
    "PyMCWrapper",
    "convert_foreign",
    "from_cmdstan",
    "from_cmdstanpy",
    "from_netcdf",
    "from_numpyro",
    "save_netcdf",
    "plot_loo",
    "plot_khat",
    "plot_compare",
    "plot_influence",
    "plot_loo_difference",
    "plot_loo_pit",
    "loo_plot",
    "compare_plot",
    "influence_plot",
    "loo_difference_plot",
    "loo_pit_plot",
    "warmup",
]
