"""Build an :class:`InferenceData` from plain numpy arrays.

The state that feeds ``loo()`` is an ``InferenceData``.  This converter takes
it in a form that any package can produce without importing this one, so the
same arrays can go through ``pyloo_tpu`` and ``pyloo_tpu_torch``.
"""

from __future__ import annotations

import numpy as np

from .containers import DataArray, Dataset, InferenceData

__all__ = ["inference_data_from_numpy"]


def inference_data_from_numpy(groups) -> InferenceData:
    """``{group: {var: (values, dims, coords)}}`` -> :class:`InferenceData`.

    ``values`` is an array whose axes ``dims`` names; ``coords`` maps a dim
    name to its labels (dims without an entry are indexed by position).
    """
    return InferenceData(
        **{
            group: Dataset(
                {
                    var: DataArray(np.asarray(values), dims, coords, var)
                    for var, (values, dims, coords) in variables.items()
                }
            )
            for group, variables in groups.items()
        }
    )
