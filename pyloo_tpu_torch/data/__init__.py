"""Bundled example datasets.

``load_example_data`` plays the role of ``arviz.load_arviz_data`` for the
eight-schools posteriors the reference relies on (``centered_eight``,
``non_centered_eight``).  It reads the ``.npz`` files bundled with
``pyloo_tpu`` by path, from the sibling package's directory, without
importing it.
"""

from __future__ import annotations

import os

import numpy as np

from ..containers import DataArray, Dataset, InferenceData

__all__ = ["load_example_data"]

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pyloo_tpu",
    "data",
)

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


def load_example_data(name: str):
    """Load a bundled dataset by name as :class:`InferenceData`.

    ``centered_eight`` / ``non_centered_eight``.  The regression tables that
    ``pyloo_tpu`` returns as pandas DataFrames (``roaches``, ``wells``) raise
    :class:`NotImplementedError`: this package does not use pandas.
    """
    name = name.lower()
    if name in ("centered_eight", "non_centered_eight"):
        return _load_npz_idata(os.path.join(_DATA_DIR, f"{name}.npz"))
    if name in ("roaches", "wells"):
        raise NotImplementedError(
            f"{name!r} is a pandas DataFrame in pyloo_tpu; pyloo_tpu_torch does"
            " not use pandas and does not load it"
        )
    raise ValueError(
        f"Unknown example dataset {name!r}; available: centered_eight, "
        "non_centered_eight"
    )
