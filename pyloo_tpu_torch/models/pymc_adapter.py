"""Live-PyMC-model adapter: compile a ``pm.Model`` into a :class:`Model`.

Counterpart of ``pyloo_tpu/models/pymc_adapter.py``.  A fitted ``pm.Model``'s
log joint, pointwise log-likelihood and constrained <-> unconstrained
transforms are compiled through PyTensor's PyTorch backend into torch
functions; the resulting :class:`pyloo_tpu_torch.models.Model` powers
``reloo`` / ``loo_kfold`` / ``loo_moment_match`` with this package's
samplers doing the refits on the device, in place of ``pm.sample`` round
trips (reference ``pyloo/wrapper/pymc/pymc.py:383-457``).

Leave-out semantics are functional rather than data-surgical: the adapted
model carries the retained-observation index vector as its data, and the
leave-out log joint is ``full_logp - sum(log_lik over removed)``, which for
factorised likelihoods is exactly the refit target.

The PyTensor-touching code is isolated in :func:`_build_bridge_from_pymc`;
everything downstream consumes the plain :class:`PyTensorJaxBridge`
contract (the name is ``pyloo_tpu``'s, kept so imports move between the
packages; its functions are torch functions), so the adapter logic is
testable without PyMC installed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .._common import compute_device
from .wrapper import JAXModelWrapper, Model, map_draws

__all__ = [
    "PyMCWrapper",
    "PyTensorJaxBridge",
    "from_pymc",
    "from_bridge",
    "is_pymc_model",
    "unconstrain_posterior",
]


def is_pymc_model(obj: Any) -> bool:
    """Duck-typed check for a live ``pm.Model`` (PyMC is optional here)."""
    mod = type(obj).__module__ or ""
    return (
        mod.split(".")[0] == "pymc"
        and hasattr(obj, "basic_RVs")
        and hasattr(obj, "value_vars")
    )


@dataclass(frozen=True)
class PyTensorJaxBridge:
    """A PyMC model as torch functions: the adapter's testable contract.

    The functions must be transformable by ``torch.func`` (``grad``,
    ``vmap``): no in-place operation on their inputs, no ``.item()``, no
    Python branch on a tensor.

    Attributes
    ----------
    name : str
    param_shapes : dict[str, tuple]
        Unconstrained value-variable layout (PyMC's ``*_log__``-style names).
    logp : callable ``(params_dict) -> scalar tensor``
        Full-data log joint in unconstrained space, Jacobian included
        (PyMC ``model.logp(jacobian=True)``).
    log_lik : callable ``(params_dict) -> (n_obs,) tensor``
        Pointwise log-likelihood of every observation, raveled across
        observed RVs in ``observed`` order.
    observed : dict[str, np.ndarray]
        Observed-data arrays by RV name (reporting / fold bookkeeping).
    constrain : callable ``(params_dict) -> dict`` or None
        Unconstrained draws -> named constrained posterior variables.
    forward : callable ``(constrained_dict) -> params_dict`` or None
        Constrained posterior values -> unconstrained value variables
        (PyMC ``rvs_to_transforms[rv].forward``; reference capability
        ``pymc.py:459-556``).
    """

    name: str
    param_shapes: dict
    logp: Callable
    log_lik: Callable
    observed: dict
    constrain: Callable | None = None
    forward: Callable | None = None
    # constrained (free-RV) names the forward transform consumes; defaults
    # to the value-var names (no transforms)
    free_names: tuple = ()

    def constrained_names(self) -> tuple:
        return self.free_names or tuple(self.param_shapes)

    @property
    def n_obs(self) -> int:
        return int(sum(np.asarray(v).size for v in self.observed.values()))


def from_bridge(bridge: PyTensorJaxBridge) -> Model:
    """Build a refit-capable :class:`Model` over a compiled bridge.

    The model's observation axis is the retained-index vector
    ``__obs_idx__`` (plus the observed arrays, subset in lockstep for
    reporting): ``subset_observations`` / k-fold splits shrink the index
    set, and the log joint subtracts the removed observations' pointwise
    log-likelihood from the full-data log joint.
    """
    n_obs = bridge.n_obs
    if n_obs < 1:
        raise ValueError(
            f"PyMC model {bridge.name!r} has no observed values; LOO refit"
            " workflows need at least one observation"
        )

    data = {"__obs_idx__": np.arange(n_obs)}
    for k, v in bridge.observed.items():
        data[k] = np.asarray(v).reshape(-1)
    obs_keys = ("__obs_idx__",) + tuple(bridge.observed)

    def log_lik(params, d):
        return bridge.log_lik(params)[d["__obs_idx__"]]

    def logp(params, d):
        full = bridge.logp(params)
        idx = d["__obs_idx__"]
        ll = bridge.log_lik(params)
        kept = torch.zeros((n_obs,), dtype=ll.dtype, device=ll.device).index_fill(0, idx, 1.0)
        return full - torch.sum(torch.where(kept > 0, 0.0, ll))

    return Model(
        bridge.name,
        data,
        dict(bridge.param_shapes),
        logp,
        log_lik,
        constrain=bridge.constrain,
        obs_keys=obs_keys,
    )


def unconstrain_posterior(bridge: PyTensorJaxBridge, posterior: dict):
    """Constrained posterior draws -> ``(chains, draws, flat_dim)`` matrix.

    ``posterior`` maps constrained variable names to ``(chain, draw, ...)``
    arrays (a fitted PyMC idata's posterior group).  The bridge's forward
    transforms run vmapped over the draws on ``rcParams["device.device"]``;
    the flat order follows ``bridge.param_shapes`` (the :class:`Model`'s
    ``ravel`` order).  Returns a float64 numpy array.
    """
    if bridge.forward is None:
        raise ValueError(
            "bridge carries no forward transform; re-adapt the PyMC model"
            " with transforms enabled"
        )
    names = list(bridge.param_shapes)

    def one(constrained):
        upars = bridge.forward(constrained)
        return torch.cat([torch.as_tensor(upars[k]).reshape(-1) for k in names])

    device = compute_device()
    batched = {
        k: torch.as_tensor(np.asarray(v, dtype=np.float64), device=device)
        for k, v in posterior.items()
    }
    flat = torch.func.vmap(torch.func.vmap(one))(batched)
    return flat.cpu().numpy()


# -- the PyTensor-touching half (requires pymc at call time) -----------------


def _torch_graph(inputs, outputs):
    """PyTensor graph -> torch function, through PyTensor's PyTorch backend.

    The counterpart of ``pymc.sampling.jax.get_jaxified_graph`` (which
    imports JAX): shared variables become constants, the graph is rewritten
    by the ``PYTORCH`` mode's optimizer and turned into a Python function
    of torch tensors by ``pytorch_funcify``.
    """
    import pytensor.tensor as pt
    from pytensor.compile import mode
    from pytensor.compile.sharedvalue import SharedVariable
    from pytensor.graph.basic import graph_inputs
    from pytensor.graph.fg import FunctionGraph
    from pytensor.graph.replace import clone_replace
    from pytensor.link.pytorch.dispatch import pytorch_funcify

    shared = [v for v in graph_inputs(outputs) if isinstance(v, SharedVariable)]
    replace = {v: pt.constant(v.get_value(borrow=True), name=v.name) for v in shared}
    graph = clone_replace(list(outputs), replace=replace) if replace else list(outputs)
    fgraph = FunctionGraph(inputs=inputs, outputs=graph, clone=True)
    mode.PYTORCH.optimizer.rewrite(fgraph)
    return pytorch_funcify(fgraph)


def _build_bridge_from_pymc(pm_model) -> PyTensorJaxBridge:
    """Compile a live ``pm.Model`` into a :class:`PyTensorJaxBridge`.

    The same graphs as ``pyloo_tpu``'s (``logp(jacobian=True)``, the
    observed RVs' elementwise logp, the constrained views, the forward
    transforms), compiled through PyTensor's PyTorch backend
    (:func:`_torch_graph`) instead of its JAX backend.
    """
    try:
        import pymc  # noqa: F401
        import pytensor.link.pytorch.dispatch  # noqa: F401
    except Exception as err:
        raise ImportError(
            "adapting a live PyMC model requires pymc (with PyTensor's PyTorch"
            " backend): pip install pymc"
        ) from err

    value_vars = list(pm_model.value_vars)
    names = [v.name for v in value_vars]
    ip = pm_model.initial_point()
    param_shapes = {n: tuple(np.shape(ip[n])) for n in names}

    # full log joint (jacobian included) over the value variables
    logp_fn = _torch_graph(value_vars, [pm_model.logp(jacobian=True, sum=True)])

    # pointwise log-likelihood: one elemwise graph per observed RV
    observed_rvs = list(pm_model.observed_RVs)
    ll_graphs = pm_model.logp(vars=observed_rvs, jacobian=False, sum=False)
    if not isinstance(ll_graphs, (list, tuple)):
        ll_graphs = [ll_graphs]
    ll_fn = _torch_graph(value_vars, list(ll_graphs))

    observed = {}
    for rv in observed_rvs:
        val = pm_model.rvs_to_values.get(rv)
        arr = getattr(val, "data", None)
        if arr is None and hasattr(val, "get_value"):
            arr = val.get_value()
        observed[rv.name] = np.asarray(arr)

    # constrained views of the free RVs (for posterior naming) and the
    # forward (constrained -> unconstrained) transforms for idata ingestion
    free_rvs = list(pm_model.free_RVs)
    constrained_graphs = pm_model.replace_rvs_by_values(free_rvs)
    constrain_fn = _torch_graph(value_vars, constrained_graphs)
    free_names = [rv.name for rv in free_rvs]

    fwd_graphs = []
    fwd_inputs = []
    for rv in free_rvs:
        vv = pm_model.rvs_to_values[rv]
        tr = pm_model.rvs_to_transforms.get(rv)
        rv_input = vv.type(name=f"{rv.name}_constrained")
        fwd_inputs.append(rv_input)
        if tr is None:
            fwd_graphs.append(rv_input)
        else:
            fwd_graphs.append(tr.forward(rv_input, *rv.owner.inputs))
    fwd_fn = _torch_graph(fwd_inputs, fwd_graphs)

    def as_args(params):
        return [params[n] for n in names]

    def logp(params):
        return logp_fn(*as_args(params))[0]

    def log_lik(params):
        parts = ll_fn(*as_args(params))
        return torch.cat([torch.as_tensor(p).reshape(-1) for p in parts])

    def constrain(params):
        outs = constrain_fn(*as_args(params))
        return dict(zip(free_names, outs))

    def forward(constrained):
        outs = fwd_fn(*[constrained[n] for n in free_names])
        return dict(zip(names, outs))

    return PyTensorJaxBridge(
        name=getattr(pm_model, "name", "") or "pymc_model",
        param_shapes=param_shapes,
        logp=logp,
        log_lik=log_lik,
        observed=observed,
        constrain=constrain,
        forward=forward,
        free_names=tuple(free_names),
    )


def from_pymc(pm_model) -> tuple[Model, PyTensorJaxBridge]:
    """Adapt a live ``pm.Model``; returns ``(model, bridge)``."""
    bridge = _build_bridge_from_pymc(pm_model)
    return from_bridge(bridge), bridge


class PyMCWrapper(JAXModelWrapper):
    """Wrapper accepting a live ``pm.Model`` or a native :class:`Model`.

    The drop-in counterpart of the reference ``PyMCWrapper``
    (``pyloo/wrapper/pymc/pymc.py:32-807``): given a fitted PyMC model and
    its ``InferenceData``, the model compiles through PyTensor's PyTorch
    backend into this package's functional form, the constrained posterior
    is forward-transformed into the flat unconstrained draws the refit
    workflows consume, and refits (``reloo``, ``loo_kfold``,
    ``loo_moment_match``) run with this package's samplers on the device.

    ``bridge`` holds the compiled :class:`PyTensorJaxBridge` (None when
    constructed from a native :class:`Model`).
    """

    def __init__(self, model, idata=None, *, sample_kwargs: dict | None = None):
        bridge = None
        if is_pymc_model(model):
            model, bridge = from_pymc(model)
            if idata is not None:
                idata = ingest_pymc_idata(bridge, model, idata)
        super().__init__(model, idata, sample_kwargs=sample_kwargs)
        self.bridge = bridge


def ingest_pymc_idata(bridge: PyTensorJaxBridge, model: Model, idata):
    """Fitted-PyMC ``InferenceData`` -> native container with flat draws.

    Converts a foreign (arviz) container, forward-transforms the
    constrained posterior into the ``(chain, draw, flat_dim)``
    unconstrained matrix the refit workflows consume
    (``sample_stats._flat_draws``, see :func:`pyloo_tpu_torch.models.fit`),
    and fills in ``log_likelihood`` / ``observed_data`` groups when the
    trace lacks them (the reference forces
    ``idata_kwargs.log_likelihood=True`` for the same reason,
    ``pymc.py:383-457``).  The log-likelihood is evaluated on
    ``rcParams["device.device"]``.
    """
    from ..containers import DataArray, Dataset, InferenceData
    from ..ingest import convert_foreign

    if not isinstance(idata, InferenceData):
        idata = convert_foreign(idata)
    if "posterior" not in idata.groups():
        raise ValueError("idata has no posterior group")

    wanted = set(bridge.constrained_names())
    posterior = {
        name: np.asarray(var.values)
        for name, var in idata.posterior.data_vars.items()
        if name in wanted
    }
    missing = wanted - set(posterior)
    if missing:
        raise ValueError(
            f"posterior group lacks free variables {sorted(missing)} of the"
            " PyMC model; was this idata sampled from a different model?"
        )
    flat = unconstrain_posterior(bridge, posterior)

    groups = {g: getattr(idata, g) for g in idata.groups()}
    ss_vars = (
        dict(groups["sample_stats"].data_vars)
        if "sample_stats" in groups
        else {}
    )
    ss_vars["_flat_draws"] = DataArray(
        flat, ("chain", "draw", "flat_param"), name="_flat_draws"
    )
    groups["sample_stats"] = Dataset(ss_vars)

    if "log_likelihood" not in groups:
        C, T, D = flat.shape
        q = torch.as_tensor(flat, device=compute_device()).reshape(C * T, D)
        ll = map_draws(model.log_lik_flat, q, model.n_obs).cpu().numpy()
        groups["log_likelihood"] = Dataset(
            {
                "obs": DataArray(
                    ll.reshape(C, T, -1), ("chain", "draw", "obs_id"), name="obs"
                )
            }
        )
    if "observed_data" not in groups:
        groups["observed_data"] = Dataset(
            {
                k: DataArray(np.asarray(v).reshape(-1), (f"{k}_dim_0",), name=k)
                for k, v in bridge.observed.items()
            }
        )
    return InferenceData(**groups)
