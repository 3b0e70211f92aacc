"""Model bridge: pure-function models, an HMC sampler, wrappers, examples.

Counterpart of ``pyloo_tpu/models``: models as pure torch log-density
functions, an adaptive HMC sampler (chains as the batch axis of one state),
the wrapper protocol that powers refit-based workflows (reloo, k-fold CV,
moment matching) and the example models.  NUTS, ChEES, ADVI, Laplace and the
PyMC adapter are not ported yet (ROADMAP.md, Queue 1 item 7).
"""

from .examples import (
    eight_schools_centered,
    eight_schools_noncentered,
    roaches_model,
    wells_model,
)
from .hmc import sample_hmc
from .wrapper import JAXModelWrapper, Model, fit, idata_from_flat_draws

__all__ = [
    "sample_hmc",
    "eight_schools_centered",
    "eight_schools_noncentered",
    "roaches_model",
    "wells_model",
    "JAXModelWrapper",
    "Model",
    "fit",
    "idata_from_flat_draws",
]
