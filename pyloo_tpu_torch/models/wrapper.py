"""Functional model description and posterior fitting.

Counterpart of ``pyloo_tpu/models/wrapper.py``: a model is a pair of pure
functions (unconstrained log joint, pointwise log likelihood) over a flat
parameter vector, plus metadata to name, reshape and constrain draws.
Everything downstream (HMC, the refit workflows, moment matching) composes
from these functions with ``torch.func.grad`` / ``torch.func.vmap``.

The model's functions are torch functions that ``torch.func`` can transform:
no in-place operation on their inputs, no ``.item()``, no Python branch on a
tensor.  They receive their parameters as tensors and ``data`` as a dict of
tensors on the computation device (floating arrays in the draws' dtype).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

from .._common import compute_device
from ..containers import DataArray, Dataset, InferenceData
from .chees import sample_chees
from .hmc import sample_hmc
from .nuts import sample_nuts

__all__ = ["Model", "fit", "idata_from_flat_draws", "JAXModelWrapper", "map_draws"]

# Device memory that one vmapped model evaluation may hold in temporaries:
# a chunk of draws evaluates rows x width values (width: the observations a
# draw touches), with about _EVAL_TEMPORARIES temporaries of that size.
_EVAL_BUDGET_BYTES = 1 << 30
_EVAL_TEMPORARIES = 4

_SAMPLERS = {"hmc": sample_hmc, "nuts": sample_nuts, "chees": sample_chees}


def as_tensors(data: dict, device, dtype) -> dict:
    """``data`` as tensors on ``device``: floating values in ``dtype``, the
    others (integer indices, masks) in their own dtype."""
    out = {}
    for key, value in data.items():
        t = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
        out[key] = t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
    return out


def map_draws(fn, draws: torch.Tensor, width: int):
    """``fn`` over the leading axis of ``draws`` through ``torch.func.vmap``,
    in chunks of draws within ``_EVAL_BUDGET_BYTES`` (``width``: the values
    one draw's evaluation holds, its observations)."""
    per_draw = max(1, width) * draws.element_size() * _EVAL_TEMPORARIES
    chunk = max(1, min(draws.shape[0], _EVAL_BUDGET_BYTES // per_draw))
    return torch.func.vmap(fn, chunk_size=chunk)(draws)


@dataclass(frozen=True)
class Model:
    """A Bayesian model as pure torch functions of a flat unconstrained vector.

    Attributes
    ----------
    name : str
    data : dict
        Arrays the likelihood depends on (numpy, on the host); the
        observation-indexed entries are listed in ``obs_keys`` so workflows
        (k-fold, reloo) can subset them.
    param_shapes : dict[str, tuple]
        Layout of the flat unconstrained vector, in insertion order.
    logp : callable ``(params_dict, data) -> scalar tensor``
        Unnormalized log joint in unconstrained space (including Jacobian
        terms for any transformed parameter).
    log_lik : callable ``(params_dict, data) -> (n_obs,) tensor``
        Pointwise log likelihood in unconstrained space.
    constrain : callable ``(params_dict) -> dict``, optional
        Maps unconstrained draws to named constrained posterior variables.
    obs_keys : tuple of str
        Keys of ``data`` indexed by observation (subsettable).
    builder : callable ``(data) -> Model``, optional
        Rebuilds the model for new data; required when parameter shapes
        track the number of observations (per-observation random effects).

    ``logp``, ``log_lik`` and ``constrain`` must be transformable by
    ``torch.func`` (``grad``, ``vmap``): no in-place operation on their
    inputs, no ``.item()``, no Python branch on a tensor value.  ``data``
    reaches them as a dict of tensors on the draws' device, floating arrays
    in the draws' dtype.
    """

    name: str
    data: dict
    param_shapes: dict
    logp: Callable
    log_lik: Callable
    constrain: Callable | None = None
    obs_keys: tuple = ()
    builder: Callable | None = None
    # data as tensors, by (device, dtype): converted once, not per evaluation
    _tensors: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def flat_dim(self) -> int:
        return int(sum(np.prod(s, dtype=int) for s in self.param_shapes.values()))

    @property
    def n_obs(self) -> int:
        return int(np.shape(self.data[self.obs_keys[0]])[0])

    def tensor_data(self, device, dtype=torch.float64) -> dict:
        """``data`` as tensors on ``device`` (cached per device and dtype)."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            self._tensors[key] = as_tensors(self.data, device, dtype)
        return self._tensors[key]

    def unravel(self, q):
        """Flat vector -> dict of named unconstrained parameters."""
        out = {}
        i = 0
        for name, shape in self.param_shapes.items():
            size = int(np.prod(shape, dtype=int))
            out[name] = q[i : i + size].reshape(shape)
            i += size
        return out

    def ravel(self, params: dict):
        return torch.cat(
            [torch.as_tensor(params[name]).reshape(-1) for name in self.param_shapes]
        )

    def _data_for(self, q, data):
        if data is None:
            return self.tensor_data(q.device, q.dtype)
        return as_tensors(data, q.device, q.dtype)

    def logp_flat(self, q, data=None):
        return self.logp(self.unravel(q), self._data_for(q, data))

    def log_lik_flat(self, q, data=None):
        return self.log_lik(self.unravel(q), self._data_for(q, data))

    def with_data(self, **updates) -> "Model":
        new_data = dict(self.data)
        new_data.update(updates)
        if self.builder is not None:
            return self.builder(new_data)
        return replace(self, data=new_data)

    def subset_observations(self, keep_idx) -> "Model":
        """Model restricted to the observations in ``keep_idx``."""
        keep_idx = np.asarray(keep_idx)
        updates = {k: np.asarray(self.data[k])[keep_idx] for k in self.obs_keys}
        return self.with_data(**updates)


def fit(
    model: Model,
    *,
    draws: int = 1000,
    tune: int = 1000,
    chains: int | None = None,
    seed: int = 0,
    compute_log_likelihood: bool = True,
    init: np.ndarray | None = None,
    algorithm: str = "hmc",
    **hmc_kwargs,
) -> InferenceData:
    """Sample the model's posterior and assemble results.

    ``algorithm="hmc"`` (the default) uses static-trajectory adaptive HMC
    (:mod:`pyloo_tpu_torch.models.hmc`); ``algorithm="nuts"`` the iterative
    multinomial No-U-Turn sampler (:mod:`pyloo_tpu_torch.models.nuts`);
    ``algorithm="chees"`` ChEES-adapted trajectory lengths
    (:mod:`pyloo_tpu_torch.models.chees`), one step count shared by all
    chains.  Each runs on ``rcParams["device.device"]``.

    ``chains`` defaults per algorithm: 4 for HMC and NUTS, 16 for ChEES,
    whose trajectory-length gradient is a cross-chain expectation and is
    noisy at few chains.

    Returns an :class:`InferenceData` with ``posterior`` (constrained,
    named), ``log_likelihood`` and ``observed_data`` groups.
    """
    if algorithm not in _SAMPLERS:
        raise ValueError(
            f"Unknown algorithm {algorithm!r}; use 'hmc', 'nuts' or 'chees'"
        )
    if chains is None:
        chains = 16 if algorithm == "chees" else 4
    device = compute_device()
    data = model.tensor_data(device)

    def logp_q(q):
        return model.logp(model.unravel(q), data)

    q0 = np.zeros(model.flat_dim) if init is None else init
    draws_flat, accept = _SAMPLERS[algorithm](
        logp_q,
        q0,
        num_warmup=tune,
        num_samples=draws,
        num_chains=chains,
        seed=seed,
        **hmc_kwargs,
    )  # (C, T, D)
    return idata_from_flat_draws(
        model,
        draws_flat,
        accept=accept,
        compute_log_likelihood=compute_log_likelihood,
    )


def idata_from_flat_draws(
    model: Model,
    draws_flat,
    *,
    accept: float = 1.0,
    compute_log_likelihood: bool = True,
) -> InferenceData:
    """Assemble an :class:`InferenceData` from flat unconstrained draws.

    ``draws_flat`` is ``(chains, draws, flat_dim)`` in the model's flat
    parameter order.  The constrained values and the pointwise log
    likelihood are evaluated on ``rcParams["device.device"]``.
    """
    draws_flat = np.asarray(draws_flat, dtype=np.float64)
    C, T, D = draws_flat.shape
    flat = torch.tensor(draws_flat, device=compute_device()).reshape(C * T, D)
    posterior, log_lik = draw_groups(model, flat, C, T, compute_log_likelihood)
    groups = {
        "posterior": posterior,
        "sample_stats": Dataset(
            {
                "accept_rate": DataArray(np.full((C, T), accept), ("chain", "draw")),
                # raw flat unconstrained draws: powers refit workflows
                # (log_likelihood_i, moment matching) without inversion
                "_flat_draws": DataArray(draws_flat, ("chain", "draw", "flat_param")),
            }
        ),
        "observed_data": observed_data(model),
    }
    if log_lik is not None:
        groups["log_likelihood"] = log_lik
    return InferenceData(**groups)


def draw_groups(model: Model, flat: torch.Tensor, C: int, T: int,
                compute_log_likelihood: bool = True):
    """``(posterior, log_likelihood)`` Datasets of the draws ``flat``
    (C * T, D) on the device: the constrained values by name, and the
    pointwise log-likelihood (``None`` unless ``compute_log_likelihood``),
    both evaluated there."""
    upars = torch.func.vmap(model.unravel)(flat)
    constrained = (
        torch.func.vmap(model.constrain)(upars) if model.constrain is not None else upars
    )
    posterior = {}
    # by name, in the order pyloo_tpu's vmapped dict comes back in
    for name in sorted(constrained):
        values = constrained[name].cpu().numpy()
        values = values.reshape((C, T) + values.shape[1:])
        posterior[name] = DataArray(
            values,
            ("chain", "draw") + tuple(f"{name}_dim_{i}" for i in range(values.ndim - 2)),
            name=name,
        )
    if not compute_log_likelihood:
        return Dataset(posterior), None
    ll = map_draws(model.log_lik_flat, flat, model.n_obs).cpu().numpy()
    return Dataset(posterior), Dataset(
        {"obs": DataArray(ll.reshape(C, T, -1), ("chain", "draw", "obs_id"), name="obs")}
    )


def observed_data(model: Model) -> Dataset:
    """The model's observation-indexed data as the ``observed_data`` group."""
    return Dataset(
        {
            k: DataArray(
                np.asarray(v),
                tuple(f"{k}_dim_{i}" for i in range(np.asarray(v).ndim)),
                name=k,
            )
            for k, v in model.data.items()
            if k in model.obs_keys
        }
    )


class JAXModelWrapper:
    """Standardized access to a fitted functional model.

    The name is ``pyloo_tpu``'s, kept so code moves between the packages;
    the model is a :class:`Model` of torch functions.  Capability-equivalent
    to the reference ``PyMCWrapper`` (``pyloo/wrapper/pymc/pymc.py:32-807``):
    data selection and mutation, posterior refitting, per-observation
    log-likelihood on held-out data, and the unconstrained draws.
    """

    def __init__(self, model: Model, idata: InferenceData | None = None, *,
                 sample_kwargs: dict | None = None):
        if not isinstance(model, Model):
            raise TypeError(
                "JAXModelWrapper requires a pyloo_tpu_torch Model (pure torch functions"
                " that torch.func can transform), got"
                f" {type(model).__module__}.{type(model).__name__}. PyTensor/PyMC graphs"
                " cannot run here — port the model's logp to a torch function (see"
                " pyloo_tpu_torch.models.examples for templates)."
            )
        self.model = model
        self.idata = idata
        self.sample_kwargs = dict(sample_kwargs or {})
        self._original_data = {
            k: np.asarray(model.data[k]).copy() for k in model.data
        }
        for v in self._original_data.values():
            v.setflags(write=False)

    # -- introspection ------------------------------------------------------
    @property
    def observed_data(self):
        return {k: np.asarray(self.model.data[k]) for k in self.model.obs_keys}

    @property
    def n_obs(self):
        return self.model.n_obs

    def get_observed_name(self):
        return "y" if "y" in self.model.obs_keys else self.model.obs_keys[0]

    def get_variable_names(self):
        """Names of the model's (unconstrained) parameters."""
        return list(self.model.param_shapes)

    def get_shapes(self):
        """Unconstrained parameter shapes by name."""
        return dict(self.model.param_shapes)

    def get_observed_data(self):
        """The primary observed-response array (first obs key named 'y' if
        present, else the first obs key)."""
        return np.asarray(self.model.data[self.get_observed_name()])

    # -- data mutation ------------------------------------------------------
    def select_observations(self, indices):
        """Split data into (selected, remaining) per-observation subsets."""
        n = self.n_obs
        idx = np.arange(n)[indices] if isinstance(indices, slice) else np.atleast_1d(
            np.asarray(indices)
        )
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"observation indices out of range [0, {n})")
        mask = np.zeros(n, dtype=bool)
        mask[idx] = True
        selected = {k: np.asarray(self.model.data[k])[mask] for k in self.model.obs_keys}
        remaining = {k: np.asarray(self.model.data[k])[~mask] for k in self.model.obs_keys}
        return selected, remaining

    def set_data(self, new_data: dict):
        self.model = self.model.with_data(**new_data)

    def reset_data(self):
        self.model = self.model.with_data(
            **{k: v.copy() for k, v in self._original_data.items()}
        )

    # -- refitting ----------------------------------------------------------
    def sample_posterior(self, **kwargs) -> InferenceData:
        """Refit the model's posterior on its current data.

        A ``sampler`` entry in ``sample_kwargs`` (or ``kwargs``) supplies a
        custom sample function ``sampler(model, **opts) -> InferenceData``
        and is inherited by refit workflows (k-fold folds, reloo), which
        propagate ``sample_kwargs`` to the per-fold wrappers.
        """
        opts = dict(self.sample_kwargs)
        opts.update(kwargs)
        sampler = opts.pop("sampler", None)
        if sampler is not None:
            return sampler(self.model, **opts)
        return fit(self.model, **opts)

    def log_likelihood_i(self, holdout_data, idata: InferenceData):
        """Log-lik of held-out observation(s) under a refitted posterior.

        ``holdout_data`` maps obs_keys to the held-out slices; an integer /
        index array selects the corresponding rows of the wrapper's
        *original* data.  Returns an array (chain, draw, n_holdout),
        evaluated on ``rcParams["device.device"]``.
        """
        if not isinstance(holdout_data, dict):
            idx = np.atleast_1d(np.asarray(holdout_data))
            holdout_data = {
                k: self._original_data[k][idx] for k in self.model.obs_keys
            }
        model_i = self.model.with_data(**holdout_data)
        draws = self._flat_draws(idata)
        if model_i.flat_dim != draws.shape[-1]:
            raise ValueError(
                f"model for held-out data has {model_i.flat_dim} unconstrained"
                f" parameters but the posterior draws have {draws.shape[-1]};"
                " per-observation parameters cannot be scored on held-out"
                " observations — marginalize them in log_lik or use a"
                " fixed-dimension model"
            )
        C, T, D = draws.shape
        flat = torch.tensor(np.asarray(draws), dtype=torch.float64, device=compute_device())
        ll = map_draws(model_i.log_lik_flat, flat.reshape(C * T, D), model_i.n_obs)
        return ll.cpu().numpy().reshape(C, T, -1)

    @staticmethod
    def _flat_draws(idata):
        """(chain, draw, flat_dim) unconstrained draws stored by :func:`fit`."""
        ss = getattr(idata, "sample_stats", None)
        if ss is not None and "_flat_draws" in ss:
            return ss._flat_draws.values
        raise ValueError(
            "InferenceData does not carry flat unconstrained draws; produce "
            "it with pyloo_tpu_torch.models.fit / JAXModelWrapper.sample_posterior"
        )

    # -- transforms ---------------------------------------------------------
    def get_unconstrained_parameters(self):
        """Posterior draws as a (chain*draw, flat_dim) unconstrained matrix."""
        v = self._flat_draws(self.idata)
        return v.reshape(-1, v.shape[-1])

    def get_constrained_parameters(self):
        """Posterior draws as named constrained arrays (chain, draw, ...)."""
        return {
            name: var.values
            for name, var in self.idata.posterior.data_vars.items()
        }
