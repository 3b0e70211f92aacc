"""Validated global configuration store.

The keys of ``pyloo_tpu.rcparams`` (the reference's three, compute
precision, and two JAX-side keys kept so that a configuration written for
``pyloo_tpu`` loads unchanged), plus ``device.device``: where the numeric
work runs.
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Any, Callable


def _bool_validator(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    raise ValueError(f"Value must be True or False, not {value}")


def _choice_validator(*choices: str) -> Callable[[Any], str]:
    valid = set(choices)

    def _validate(value: Any) -> str:
        if isinstance(value, str) and value.lower() in valid:
            return value.lower()
        raise ValueError(f"Value must be one of {valid}, not {value}")

    return _validate


_DEFAULTS: dict[str, tuple[Any, Callable[[Any], Any]]] = {
    # -- parity with the reference configuration surface --------------------
    "stats.ic_pointwise": (False, _bool_validator),
    "stats.ic_scale": ("log", _choice_validator("deviance", "log", "negative_log")),
    "plot.backend": ("matplotlib", _choice_validator("matplotlib")),
    # -- device ---------------------------------------------------------------
    # float64 matches the reference NumPy numerics; float32 is the throughput
    # path through the CUDA prepass kernel.
    "device.precision": ("float64", _choice_validator("float32", "float64")),
    # where tensors live and kernels run.  "cuda" with no CUDA device makes
    # every entry point raise: nothing moves to the CPU on its own.
    "device.device": ("cuda", _choice_validator("cuda", "cpu")),
    # loo_nonfactor's draws and moment matching's lanes over every CUDA
    # device of obs_mesh() (row-parallel scorers shard whenever a mesh exists)
    "device.auto_shard": (True, _bool_validator),
    # validated but without effect here: pyloo_tpu's XLA compilation cache
    # has no counterpart in this package
    "device.compilation_cache": ("auto", _choice_validator("auto", "on", "off")),
}


class RcParams(MutableMapping):
    """Dict-like store whose keys are fixed and whose values are validated."""

    validate = {key: validator for key, (_, validator) in _DEFAULTS.items()}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self._store: dict[str, Any] = {
            key: default for key, (default, _) in _DEFAULTS.items()
        }
        self.update(*args, **kwargs)

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in self.validate:
            raise KeyError(
                f"{key} is not a valid rc parameter (see rcParams.keys() for "
                "a list of valid parameters)"
            )
        try:
            self._store[key] = self.validate[key](value)
        except ValueError as err:
            raise ValueError(f"Key {key}: {err}") from err

    def __getitem__(self, key: str) -> Any:
        return self._store[key]

    def __delitem__(self, key: str) -> None:
        raise TypeError("RcParams keys cannot be deleted")

    def clear(self) -> None:
        raise TypeError("RcParams keys cannot be deleted")

    def pop(self, key: str, default: Any = None) -> Any:
        raise TypeError(
            "RcParams keys cannot be deleted. Use .get(key) or RcParams[key] "
            "to check values"
        )

    def popitem(self):
        raise TypeError(
            "RcParams keys cannot be deleted. Use .get(key) or RcParams[key] "
            "to check values"
        )

    def setdefault(self, key: str, default: Any = None):
        raise TypeError(
            "Defaults in RcParams are handled on object initialization."
        )

    def __iter__(self):
        yield from sorted(self._store)

    def __len__(self) -> int:
        return len(self._store)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._store})"

    def __str__(self) -> str:
        return "\n".join(f"{k:<22}: {v}" for k, v in sorted(self._store.items()))

    def copy(self) -> dict[str, Any]:
        return dict(self._store)


rcParams = RcParams()
