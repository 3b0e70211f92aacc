"""Drop-in import path: ``from pyloo_tpu_torch.wrapper import PyMCWrapper``.

Mirrors ``pyloo_tpu/wrapper/__init__.py`` (and the reference package layout,
``pyloo/wrapper/__init__.py``).  The implementations live in
:mod:`pyloo_tpu_torch.models`.
"""

from ..models import Laplace, PyMCWrapper

__all__ = ["PyMCWrapper", "Laplace"]
