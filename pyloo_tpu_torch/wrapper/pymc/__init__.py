"""Drop-in import path: ``from pyloo_tpu_torch.wrapper.pymc import PyMCWrapper``.

Mirrors ``pyloo_tpu/wrapper/pymc/__init__.py``; see
:mod:`pyloo_tpu_torch.models.pymc_adapter` for the live-PyMC bridge and
:mod:`pyloo_tpu_torch.models.laplace` for the Laplace approximation.
"""

from ...models import Laplace, PyMCWrapper
from ...models.pymc_adapter import PyTensorJaxBridge, from_pymc

__all__ = ["PyMCWrapper", "Laplace", "PyTensorJaxBridge", "from_pymc"]
