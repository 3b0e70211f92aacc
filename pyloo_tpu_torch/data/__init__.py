"""Bundled example datasets.

``load_example_data`` plays the role of ``arviz.load_arviz_data`` for the
eight-schools posteriors the reference relies on (``centered_eight``,
``non_centered_eight``) and loads the regression tables of the example
models (``roaches``, ``wells``: Gelman & Hill 2007).  The files are bundled
in this directory.
"""

from __future__ import annotations

import os

import numpy as np

from ..containers import DataArray, Dataset, InferenceData

__all__ = ["load_example_data"]

_DATA_DIR = os.path.dirname(os.path.abspath(__file__))

_SCHOOLS = np.array(
    [
        "Choate",
        "Deerfield",
        "Phillips Andover",
        "Phillips Exeter",
        "Hotchkiss",
        "Lawrenceville",
        "St. Paul's",
        "Mt. Hermon",
    ]
)


def _load_npz_idata(path: str) -> InferenceData:
    with np.load(path) as payload:
        groups: dict[str, dict[str, np.ndarray]] = {}
        for key in payload.files:
            group, var = key.split("/", 1)
            groups.setdefault(group, {})[var] = payload[key]

    school_coord = {"school": _SCHOOLS}

    def dims_for(group, var, values):
        if group == "observed_data":
            return ("school",), school_coord
        if var == "obs":
            return ("chain", "draw", "school"), school_coord
        if values.ndim == 2:
            return ("chain", "draw"), {}
        if var == "theta":
            return ("chain", "draw", "school"), school_coord
        return (
            ("chain", "draw")
            + tuple(f"{var}_dim_{i}" for i in range(values.ndim - 2)),
            {},
        )

    out = {}
    for group, variables in groups.items():
        ds = {}
        for var, values in variables.items():
            dims, coords = dims_for(group, var, values)
            ds[var] = DataArray(values, dims, coords, var)
        out[group] = Dataset(ds)
    return InferenceData(**out)


def read_csv_columns(path: str) -> dict:
    """A numeric CSV with a header row as ``{column: float64 array}``.

    The header's names may be quoted (``"y","roach1",...``); the quotes are
    stripped.  Plain numpy: the package does not use pandas.
    """
    with open(path) as fh:
        names = [name.strip().strip('"') for name in fh.readline().strip().split(",")]
    table = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)
    return {name: np.ascontiguousarray(table[:, j]) for j, name in enumerate(names)}


def load_example_data(name: str):
    """Load a bundled dataset by name.

    ``centered_eight`` / ``non_centered_eight`` return :class:`InferenceData`;
    ``roaches`` / ``wells`` return their table as a dict of numpy columns
    (float64), in the file's column order, where ``pyloo_tpu`` returns a
    pandas DataFrame.
    """
    name = name.lower()
    if name in ("centered_eight", "non_centered_eight"):
        return _load_npz_idata(os.path.join(_DATA_DIR, f"{name}.npz"))
    if name in ("roaches", "wells"):
        return read_csv_columns(os.path.join(_DATA_DIR, f"{name}.csv"))
    raise ValueError(
        f"Unknown example dataset {name!r}; available: centered_eight, "
        "non_centered_eight, roaches, wells"
    )
