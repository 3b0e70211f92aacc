"""pyloo_tpu_torch: PSIS leave-one-out cross-validation in PyTorch, for CUDA.

The PyTorch port of ``pyloo_tpu``.  It covers ``loo()`` on a log-likelihood
matrix (PSIS, SIS, TIS, mixture) and ``loo_streaming()`` over a
log-likelihood made on the device chunk by chunk, in float64 (the default,
reference-exact) or float32 (through a hand-written CUDA prepass kernel).
The device is ``rcParams["device.device"]`` (``"cuda"`` by default; set
``"cpu"`` to compute on the CPU).

.. code-block:: python

    import pyloo_tpu_torch as pl

    idata = pl.load_example_data("centered_eight")
    print(pl.loo(idata, pointwise=True))
"""

from .containers import DataArray, Dataset, InferenceData
from .convert import inference_data_from_numpy
from .data import load_example_data
from .elpd import ELPDData
from .loo import loo
from .rcparams import rcParams
from .streaming import clear_streaming_cache, loo_streaming
from .utils import from_dict

__all__ = [
    "loo",
    "loo_streaming",
    "clear_streaming_cache",
    "rcParams",
    "load_example_data",
    "from_dict",
    "inference_data_from_numpy",
    "InferenceData",
    "Dataset",
    "DataArray",
    "ELPDData",
]
