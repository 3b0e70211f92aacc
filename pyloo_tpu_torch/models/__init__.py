"""Model bridge: pure-function models, samplers, variational fits, wrappers.

Counterpart of ``pyloo_tpu/models``: models as pure torch log-density
functions, adaptive HMC, multinomial NUTS and ChEES-HMC samplers (chains as
the batch axis of one state), variational fits (Laplace, ADVI), the wrapper
protocol that powers refit-based workflows (reloo, k-fold CV, moment
matching), the example models, and the adapter of a live PyMC model
(:mod:`pyloo_tpu_torch.models.pymc_adapter`).
"""

from .advi import ADVI, ADVIResult, compute_log_weights
from .examples import (
    eight_schools_centered,
    eight_schools_noncentered,
    roaches_model,
    wells_model,
)
from .hmc import sample_hmc
from .laplace import Laplace, LaplaceVIResult
from .nuts import sample_nuts
from .pymc_adapter import PyMCWrapper, PyTensorJaxBridge, from_pymc
from .wrapper import JAXModelWrapper, Model, fit, idata_from_flat_draws

__all__ = [
    "sample_hmc",
    "sample_nuts",
    "ADVI",
    "ADVIResult",
    "Laplace",
    "LaplaceVIResult",
    "compute_log_weights",
    "eight_schools_centered",
    "eight_schools_noncentered",
    "roaches_model",
    "wells_model",
    "JAXModelWrapper",
    "PyMCWrapper",
    "PyTensorJaxBridge",
    "from_pymc",
    "Model",
    "fit",
    "idata_from_flat_draws",
]
