"""Ingestion: netCDF files, foreign InferenceData, CmdStan and NumPyro output.

Counterpart of ``pyloo_tpu/ingest.py`` (numpy only; ``h5py`` is imported
inside the netCDF functions):

- :func:`from_netcdf` / :func:`save_netcdf` read and write the netCDF4
  (HDF5) group layout arviz uses, through h5py dimension scales.  The layout
  is the one ``pyloo_tpu`` writes, so a file saved by either package reads
  back in the other, and in arviz / xarray.
- :func:`convert_foreign` converts any object that walks like an
  ``arviz.InferenceData`` (group attributes holding xarray Datasets), using
  only the attribute protocol.
- :func:`from_cmdstan` parses CmdStan's CSV output files;
  :func:`from_cmdstanpy` reads a fitted ``CmdStanMCMC`` by duck typing.
- :func:`from_numpyro` reads a fitted ``numpyro.infer.MCMC`` by duck typing.
  numpyro is never imported here (it would import JAX): without
  ``log_likelihood=`` the result has no ``log_likelihood`` group and a
  warning says so, as ``pyloo_tpu`` does when numpyro is not importable.

Everything routes through :func:`pyloo_tpu_torch.utils.to_inference_data`,
so ``pl.loo("posterior.nc")``, ``pl.loo("output_*.csv")`` and
``pl.loo(pymc_idata)`` work directly.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Any, Mapping

import numpy as np

from .containers import DataArray, Dataset, InferenceData

__all__ = [
    "from_netcdf",
    "save_netcdf",
    "convert_foreign",
    "looks_like_foreign_idata",
    "from_numpyro",
    "from_cmdstan",
    "from_cmdstanpy",
]

_log = logging.getLogger(__name__)

# netCDF marks a dimension that has no coordinate variable with this NAME
# prefix on its (placeholder) dimension-scale dataset.
_PHONY_PREFIX = "This is a netCDF dimension but not a netCDF variable."


# --------------------------------------------------------------------------
# netCDF (HDF5) files
# --------------------------------------------------------------------------


def _decode_strings(values: np.ndarray) -> np.ndarray:
    """bytes → str elementwise (netCDF stores strings as vlen/fixed bytes)."""
    if values.dtype.kind in ("S", "O"):
        flat = [
            v.decode("utf-8", "replace") if isinstance(v, bytes) else v
            for v in values.ravel()
        ]
        return np.asarray(flat, dtype=object).reshape(values.shape)
    return values


def _attr_str(attrs, key, default=None):
    val = attrs.get(key, default)
    if isinstance(val, bytes):
        return val.decode("utf-8", "replace")
    return val


def _read_h5_group(group, h5py) -> Dataset:
    """One HDF5 group → Dataset, resolving dimension scales to dims/coords."""
    scales: dict[str, np.ndarray | None] = {}
    data_items = {}
    for name, item in group.items():
        if not isinstance(item, h5py.Dataset):
            continue
        if _attr_str(item.attrs, "CLASS") == "DIMENSION_SCALE":
            nm = _attr_str(item.attrs, "NAME", "")
            phony = str(nm).startswith(_PHONY_PREFIX)
            scales[name] = None if phony else _decode_strings(np.asarray(item[()]))
        else:
            data_items[name] = item

    variables: dict[str, DataArray] = {}
    for name, item in data_items.items():
        values = np.asarray(item[()])
        if _attr_str(item.attrs, "dtype") == "bool":  # h5netcdf convention
            values = values.astype(bool)
        dims: list[str] = []
        for axis in range(values.ndim):
            dim_name = None
            try:  # the standard netCDF-4 path: DIMENSION_LIST references
                dim_objs = item.dims[axis]
                if len(dim_objs) > 0:
                    dim_name = dim_objs[0].name.rsplit("/", 1)[-1]
            except (KeyError, RuntimeError):  # pragma: no cover - corrupt refs
                dim_name = None
            if dim_name is None:
                # h5netcdf invalid_netcdf / zarr-style fallback attribute
                ad = item.attrs.get("_ARRAY_DIMENSIONS")
                if ad is not None and len(ad) == values.ndim:
                    dim_name = _attr_str({"d": ad[axis]}, "d")
            if dim_name is None:
                dim_name = f"{name}_dim_{axis}"
            dims.append(str(dim_name))
        coords = {
            d: scales[d]
            for d in dims
            if scales.get(d) is not None and len(scales[d]) == values.shape[dims.index(d)]
        }
        variables[name] = DataArray(values, tuple(dims), coords, name)
    attrs = {k: _attr_str(group.attrs, k) for k in group.attrs}
    return Dataset(variables, attrs=attrs)


def from_netcdf(path: str | os.PathLike) -> InferenceData:
    """Load an :class:`InferenceData` from a netCDF4/HDF5 file.

    Reads the group layout ``arviz.InferenceData.to_netcdf`` writes (one HDF5
    group per idata group; variable dimensions resolved through netCDF-4
    dimension scales, with the ``_ARRAY_DIMENSIONS`` attribute as a fallback
    for h5netcdf ``invalid_netcdf`` files).  Reference capability:
    ``pyloo/utils.py:21-79`` via ``arviz.convert_to_inference_data(filename)``.
    """
    import h5py

    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        handle = h5py.File(path, "r")
    except OSError as err:
        raise ValueError(
            f"{path!r} is not a netCDF4/HDF5 file. Classic netCDF3 files are "
            "not supported - re-save with arviz/xarray (netCDF4 engine) or "
            "load the arrays yourself and use pyloo_tpu_torch.from_dict."
        ) from err
    with handle as f:
        groups = {}
        for name, item in f.items():
            if isinstance(item, h5py.Group):
                groups[name] = _read_h5_group(item, h5py)
        if not groups:
            # A flat file (no groups): treat root datasets as the posterior.
            root = _read_h5_group(f, h5py)
            if not len(root):
                raise ValueError(f"no netCDF groups or variables found in {path!r}")
            groups["posterior"] = root
    return InferenceData(**groups)


def save_netcdf(idata: InferenceData, path: str | os.PathLike) -> str:
    """Write an :class:`InferenceData` to a netCDF4-compatible HDF5 file.

    Produces standard netCDF-4 structure (dimension-scale datasets with
    ``CLASS``/``NAME``/``DIMENSION_LIST``/``REFERENCE_LIST`` attributes via
    h5py's dimension-scale API) so the file round-trips through
    ``arviz.from_netcdf`` / ``xarray.open_dataset`` as well as
    :func:`from_netcdf`.
    """
    import h5py

    path = os.fspath(path)
    str_dtype = h5py.string_dtype(encoding="utf-8")
    with h5py.File(path, "w") as f:
        # Root attribute marking the file as netCDF-4 flavoured HDF5.
        f.attrs["_NCProperties"] = np.bytes_(
            "version=2,pyloo_tpu_torch=1,hdf5=via-h5py"
        )
        for group_name in idata.groups():
            ds = getattr(idata, group_name)
            g = f.create_group(group_name)
            for k, v in ds.attrs.items():
                try:
                    g.attrs[k] = v
                except TypeError:
                    g.attrs[k] = str(v)

            # Dimension sizes and coordinate values across the group.
            dim_sizes: dict[str, int] = {}
            dim_coords: dict[str, np.ndarray] = {}
            for var in ds.values():
                for d, size in zip(var.dims, var.shape):
                    prev = dim_sizes.setdefault(d, size)
                    if prev != size:
                        raise ValueError(
                            f"dimension {d!r} has conflicting sizes "
                            f"{prev} and {size} in group {group_name!r}"
                        )
                    if d in var.coords and d not in dim_coords:
                        dim_coords[d] = np.asarray(var.coords[d])

            scales = {}
            for d, size in dim_sizes.items():
                if d in dim_coords:
                    cv = dim_coords[d]
                    if cv.dtype.kind in ("U", "O", "S"):
                        cv = np.asarray(
                            [str(x) for x in cv.ravel()], dtype=object
                        ).reshape(cv.shape)
                        scale = g.create_dataset(d, data=cv, dtype=str_dtype)
                    else:
                        scale = g.create_dataset(d, data=cv)
                    scale.make_scale(d)
                else:
                    scale = g.create_dataset(d, data=np.zeros(size, dtype="f4"))
                    scale.make_scale(f"{_PHONY_PREFIX} {size:10d}")
                scales[d] = scale

            for name, var in ds.items():
                if name in scales:  # coordinate variable == its scale
                    continue
                values = np.asarray(var.values)
                kwargs = {}
                if values.dtype == bool:
                    values = values.astype(np.int8)
                    kwargs["data"] = values
                    dset = g.create_dataset(name, **kwargs)
                    dset.attrs["dtype"] = "bool"  # h5netcdf convention
                elif values.dtype.kind in ("U", "O"):
                    flat = np.asarray(
                        [str(x) for x in values.ravel()], dtype=object
                    ).reshape(values.shape)
                    dset = g.create_dataset(name, data=flat, dtype=str_dtype)
                else:
                    dset = g.create_dataset(name, data=values)
                for axis, d in enumerate(var.dims):
                    dset.dims[axis].attach_scale(scales[d])
    return path


# --------------------------------------------------------------------------
# Duck-typed foreign InferenceData (arviz / PyMC / anything xarray-backed)
# --------------------------------------------------------------------------

_FOREIGN_GROUPS = (
    "posterior",
    "posterior_predictive",
    "log_likelihood",
    "sample_stats",
    "prior",
    "prior_predictive",
    "observed_data",
    "constant_data",
    "predictions",
    "predictions_constant_data",
    "log_prior",
)


def _foreign_group_names(obj) -> list[str]:
    groups = getattr(obj, "groups", None)
    if callable(groups):
        try:
            names = list(groups())
        except TypeError:
            names = []
        if names and all(isinstance(n, str) for n in names):
            return names
    return [g for g in _FOREIGN_GROUPS if hasattr(obj, g)]


def looks_like_foreign_idata(obj: Any) -> bool:
    """True when ``obj`` walks like an ``arviz.InferenceData`` we can convert.

    Requires at least one known group attribute whose value exposes the
    xarray ``Dataset`` protocol (``data_vars`` plus per-variable ``dims`` /
    ``values``).  Our own :class:`InferenceData` is excluded - callers check
    ``isinstance`` first.
    """
    if isinstance(obj, InferenceData):
        return False
    for name in _foreign_group_names(obj):
        ds = getattr(obj, name, None)
        if ds is None:
            continue
        data_vars = getattr(ds, "data_vars", None)
        if data_vars is None:
            return False
        try:
            var_names = list(data_vars)
        except TypeError:
            return False
        if not var_names:
            continue
        var = ds[var_names[0]]
        return hasattr(var, "dims") and hasattr(var, "values")
    return False


def _convert_foreign_dataset(ds) -> Dataset:
    coords_obj = getattr(ds, "coords", None)
    out: dict[str, DataArray] = {}
    for name in list(ds.data_vars):
        var = ds[name]
        dims = tuple(str(d) for d in var.dims)
        values = np.asarray(var.values)
        coords: dict[str, np.ndarray] = {}
        if coords_obj is not None:
            for d in dims:
                try:
                    present = d in coords_obj
                except TypeError:
                    present = False
                if present:
                    cv = coords_obj[d]
                    coords[d] = np.asarray(getattr(cv, "values", cv))
        out[str(name)] = DataArray(values, dims, coords, str(name))
    attrs = dict(getattr(ds, "attrs", {}) or {})
    return Dataset(out, attrs=attrs)


def convert_foreign(obj: Any) -> InferenceData:
    """Convert a duck-typed arviz-style InferenceData to the native container.

    Walks every group attribute (``posterior``, ``log_likelihood``,
    ``sample_stats``, ...) through the xarray attribute protocol only -
    ``data_vars``, per-variable ``dims``/``values``, and dataset ``coords``.
    This is the data-level adapter for fitted PyMC / NumPyro / CmdStan
    results that already live in an arviz container (reference capability:
    ``pyloo/utils.py:21-79``).
    """
    groups: dict[str, Dataset] = {}
    for name in _foreign_group_names(obj):
        ds = getattr(obj, name, None)
        if ds is None or not hasattr(ds, "data_vars"):
            continue
        try:
            converted = _convert_foreign_dataset(ds)
        except Exception as err:  # pragma: no cover - malformed foreign group
            warnings.warn(
                f"skipping group {name!r} during conversion: {err}",
                UserWarning,
                stacklevel=2,
            )
            continue
        if len(converted):
            groups[name] = converted
    if not groups:
        raise ValueError(
            "object exposes no convertible InferenceData groups "
            f"(type {type(obj).__name__})"
        )
    return InferenceData(**groups)


# --------------------------------------------------------------------------
# NumPyro
# --------------------------------------------------------------------------

# numpyro extra-field name → arviz sample_stats name (sign handled below)
_NUMPYRO_STAT_RENAMES = {
    "potential_energy": "lp",
    "energy": "energy",
    "diverging": "diverging",
    "accept_prob": "acceptance_rate",
    "mean_accept_prob": "mean_acceptance_rate",
    "num_steps": "n_steps",
    "adapt_state.step_size": "step_size",
}


def from_numpyro(
    mcmc,
    *,
    log_likelihood: Mapping[str, Any] | None = None,
    coords: Mapping[str, Any] | None = None,
    dims: Mapping[str, Any] | None = None,
) -> InferenceData:
    """Build :class:`InferenceData` from a fitted ``numpyro.infer.MCMC``.

    Duck-typed: posterior draws come from
    ``mcmc.get_samples(group_by_chain=True)`` and sampler statistics from
    ``mcmc.get_extra_fields(group_by_chain=True)``, renamed to the arviz
    conventions (``lp = -potential_energy``), as in ``pyloo_tpu``.  Pass the
    pointwise log-likelihood as ``log_likelihood=`` (a dict of
    ``(chain, draw, *obs)`` arrays).  Without it the result has no
    ``log_likelihood`` group and a warning says so: this package never
    imports numpyro, which would import JAX, so it cannot compute one with
    ``numpyro.infer.log_likelihood`` as ``pyloo_tpu`` does when numpyro is
    importable.
    """
    samples = mcmc.get_samples(group_by_chain=True)
    posterior = {str(k): np.asarray(v) for k, v in samples.items()}
    if not posterior:
        raise ValueError("mcmc.get_samples() returned no posterior draws")

    sample_stats: dict[str, np.ndarray] = {}
    get_extra = getattr(mcmc, "get_extra_fields", None)
    if callable(get_extra):
        try:
            extra = get_extra(group_by_chain=True)
        except Exception:  # pragma: no cover - exotic kernels
            extra = {}
        for key, value in (extra or {}).items():
            name = _NUMPYRO_STAT_RENAMES.get(str(key))
            if name is None:
                continue
            value = np.asarray(value)
            if name == "lp":
                value = -value
            sample_stats[name] = value

    if log_likelihood is not None:
        ll_group = {str(k): np.asarray(v) for k, v in log_likelihood.items()}
    else:
        warnings.warn(
            "numpyro is not importable; the returned InferenceData has no "
            "log_likelihood group. Pass log_likelihood={name: array} to "
            "from_numpyro to attach one.",
            UserWarning,
            stacklevel=2,
        )
        ll_group = None

    from .utils import from_dict

    return from_dict(
        posterior=posterior,
        sample_stats=sample_stats or None,
        log_likelihood=ll_group,
        coords=dict(coords or {}),
        dims=dict(dims or {}),
    )


# --------------------------------------------------------------------------
# CmdStan (Stan CSV output files / cmdstanpy fits)
# --------------------------------------------------------------------------

# Stan CSV sampler-diagnostic column → arviz sample_stats name
_CMDSTAN_STAT_RENAMES = {
    "lp__": "lp",
    "accept_stat__": "acceptance_rate",
    "stepsize__": "step_size",
    "treedepth__": "tree_depth",
    "n_leapfrog__": "n_steps",
    "divergent__": "diverging",
    "energy__": "energy",
}


def _parse_stan_csv(path):
    """Parse one Stan CSV file → (columns, (n_rows, n_cols) f64 data, config).

    Comment lines (``# key = value`` headers, the adaptation block, timing
    footers) may appear anywhere; ``config`` collects the key/value ones.
    """
    import io

    config: dict[str, str] = {}
    columns: list[str] | None = None
    body: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                text = line[1:].strip()
                if "=" in text:
                    key, _, value = text.partition("=")
                    value = value.strip()
                    # "num_samples = 1000 (Default)" → "1000"
                    config[key.strip()] = value.split()[0] if value else ""
                continue
            if columns is None:
                columns = [c.strip() for c in line.split(",")]
            else:
                body.append(line)
    if columns is None:
        raise ValueError(f"{path}: no header row found (not a Stan CSV?)")
    if not body:
        raise ValueError(f"{path}: no draws found")
    data = np.loadtxt(
        io.StringIO("\n".join(body)), delimiter=",", ndmin=2, dtype=np.float64
    )
    if data.shape[1] != len(columns):
        raise ValueError(
            f"{path}: {data.shape[1]} data columns but {len(columns)} header names"
        )
    # with save_warmup=1 CmdStan writes num_warmup warmup rows before the
    # num_samples kept rows (the adaptation comment block between them is
    # skipped above) — drop them
    if config.get("save_warmup") in ("1", "true", "True"):
        n_warm = int(config.get("num_warmup", 0) or 0)
        if 0 < n_warm < data.shape[0]:
            data = data[n_warm:]
    return columns, data, config


def _group_stan_columns(columns):
    """Group flattened Stan CSV columns by variable.

    Stan writes ``theta.2.3`` (1-based, one column per element); variable
    names cannot contain dots, so any all-numeric dotted suffix is an index.
    Returns ``(stats, variables)``: column position of each ``__`` diagnostic,
    and ``{base: [(zero_based_index_tuple, column_position), ...]}``.
    """
    stats: dict[str, int] = {}
    variables: dict[str, list[tuple[tuple[int, ...], int]]] = {}
    for pos, col in enumerate(columns):
        if col.endswith("__"):
            stats[col] = pos
            continue
        parts = col.split(".")
        if len(parts) > 1 and all(p.isdigit() for p in parts[1:]):
            base = parts[0]
            idx = tuple(int(p) - 1 for p in parts[1:])
        else:
            base, idx = col, ()
        variables.setdefault(base, []).append((idx, pos))
    return stats, variables


def _assemble_stan_variables(variables, data):
    """(chain, draw, col) data + column groups → {name: (chain, draw, *shape)}.

    Elements are scattered by their explicit indices, so the result is
    correct whatever element order the CSV used (CmdStan writes column-major;
    this does not rely on it).
    """
    out: dict[str, np.ndarray] = {}
    lead = data.shape[:-1]
    for base, entries in variables.items():
        if len(entries) == 1 and entries[0][0] == ():
            out[base] = data[..., entries[0][1]]
            continue
        rank = len(entries[0][0])
        if any(len(idx) != rank for idx, _ in entries):
            raise ValueError(f"inconsistent index rank for variable {base!r}")
        shape = tuple(
            max(idx[d] for idx, _ in entries) + 1 for d in range(rank)
        )
        arr = np.full(lead + shape, np.nan, dtype=data.dtype)
        for idx, pos in entries:
            arr[(Ellipsis,) + idx] = data[..., pos]
        out[base] = arr
    return out


def _stan_groups_to_idata(columns, data, log_likelihood, coords, dims):
    """Shared tail of from_cmdstan / from_cmdstanpy: split and build."""
    from .utils import from_dict

    stats, variables = _group_stan_columns(columns)
    ll_names = (
        [log_likelihood]
        if isinstance(log_likelihood, str)
        else list(log_likelihood or [])
    )
    posterior = _assemble_stan_variables(variables, data)
    ll_group = {k: posterior.pop(k) for k in ll_names if k in posterior}
    if ll_names and not ll_group:
        warnings.warn(
            f"no {ll_names!r} variable found in the Stan CSV columns; the "
            "returned InferenceData has no log_likelihood group",
            UserWarning,
            stacklevel=3,
        )
    sample_stats: dict[str, np.ndarray] = {}
    for raw_name, pos in stats.items():
        name = _CMDSTAN_STAT_RENAMES.get(raw_name, raw_name.rstrip("_"))
        values = data[..., pos]
        if name == "diverging":
            values = values.astype(bool)
        elif name in ("tree_depth", "n_steps"):
            values = values.astype(np.int64)
        sample_stats[name] = values
    return from_dict(
        posterior=posterior or None,
        log_likelihood=ll_group or None,
        sample_stats=sample_stats or None,
        coords=dict(coords or {}),
        dims=dict(dims or {}),
    )


def from_cmdstan(
    posterior,
    *,
    log_likelihood: str | list[str] = "log_lik",
    coords: Mapping[str, Any] | None = None,
    dims: Mapping[str, Any] | None = None,
) -> InferenceData:
    """Build :class:`InferenceData` from CmdStan CSV output files.

    ``posterior`` is one path, a glob pattern (``"output_*.csv"``), or a list
    of paths — one file per chain.  Flattened array columns (``theta.2.3``)
    are reassembled into ``(chain, draw, *shape)`` arrays by their explicit
    1-based indices; ``__`` diagnostics become ``sample_stats`` under the
    arviz names; the ``log_likelihood`` variable (a ``generated quantities``
    vector by Stan convention, default ``log_lik``) becomes the
    ``log_likelihood`` group; warmup rows are dropped when ``save_warmup=1``.

    Pure NumPy — no cmdstanpy/arviz needed.  Reference capability: arviz
    ``from_cmdstan`` feeding ``pyloo/utils.py:21-79``.
    """
    import glob as _glob

    if isinstance(posterior, (str, os.PathLike)):
        text = os.fspath(posterior)
        if any(ch in text for ch in "*?["):
            paths = sorted(_glob.glob(text))
            if not paths:
                raise FileNotFoundError(f"no files match {text!r}")
        else:
            paths = [text]
    else:
        paths = [os.fspath(p) for p in posterior]
    if not paths:
        raise ValueError("from_cmdstan needs at least one CSV path")

    columns = None
    chains = []
    for path in paths:
        cols, data, _config = _parse_stan_csv(path)
        if columns is None:
            columns = cols
        elif cols != columns:
            raise ValueError(
                f"{path}: column names differ from {paths[0]} — these files "
                "are not chains of one run"
            )
        chains.append(data)
    n_keep = min(c.shape[0] for c in chains)
    if any(c.shape[0] != n_keep for c in chains):
        warnings.warn(
            "chains have unequal draw counts; truncating all to "
            f"{n_keep} draws",
            UserWarning,
            stacklevel=2,
        )
        chains = [c[:n_keep] for c in chains]
    data = np.stack(chains, axis=0)  # (chain, draw, col)
    return _stan_groups_to_idata(columns, data, log_likelihood, coords, dims)


def from_cmdstanpy(
    fit,
    *,
    log_likelihood: str | list[str] = "log_lik",
    coords: Mapping[str, Any] | None = None,
    dims: Mapping[str, Any] | None = None,
) -> InferenceData:
    """Build :class:`InferenceData` from a fitted ``cmdstanpy.CmdStanMCMC``.

    Duck-typed: only ``fit.column_names`` and ``fit.draws(concat_chains=False)``
    (the ``(draw, chain, column)`` array) are touched, so any object exposing
    those works — cmdstanpy itself is not imported.  Column handling is
    shared with :func:`from_cmdstan`.
    """
    columns = [str(c) for c in fit.column_names]
    draws = np.asarray(fit.draws(concat_chains=False), dtype=np.float64)
    if draws.ndim != 3 or draws.shape[2] != len(columns):
        raise ValueError(
            f"fit.draws(concat_chains=False) has shape {draws.shape}; "
            f"expected (draw, chain, {len(columns)})"
        )
    data = np.moveaxis(draws, 1, 0)  # (chain, draw, col)
    return _stan_groups_to_idata(columns, data, log_likelihood, coords, dims)
