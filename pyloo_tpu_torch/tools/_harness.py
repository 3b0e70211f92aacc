"""What the two verification tools share: the device they run on (and
``rcParams`` set to it, in float64), the card's description, and the
comparisons of float32 results with NaN in them."""

from __future__ import annotations

import contextlib
import subprocess
import sys

import torch


class NoCard(SystemExit):
    """Asked for ``cuda`` where torch finds no CUDA device: exit code 2."""

    def __init__(self, tool: str):
        print(f"{tool}: torch finds no CUDA device; pass --device cpu to run on the CPU"
              " (its records then say platform cpu)", file=sys.stderr)
        super().__init__(2)


def resolve_device(name: str, tool: str) -> torch.device:
    """``cuda`` (the card, the default) or ``cpu``; a ``cuda`` that torch
    cannot see raises :class:`NoCard`, never falls back."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCard(tool)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{tool}: unknown device {name!r} (cuda or cpu)")
    return device


@contextlib.contextmanager
def on_device(device):
    """``rcParams["device.device"]`` set to ``device``'s type (``cuda``: the
    current card) and ``rcParams["device.precision"]`` to float64 for the
    block, whatever the caller left there: the scripts ported run JAX with
    x64, and each tool says where it asks for float32."""
    from .. import rcParams

    saved = {key: rcParams[key] for key in ("device.device", "device.precision")}
    rcParams["device.device"] = torch.device(device).type
    rcParams["device.precision"] = "float64"
    try:
        yield torch.device(device)
    finally:
        for key, value in saved.items():
            rcParams[key] = value


def platform_of(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def card_of(device: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them (torch's
    name where ``nvidia-smi`` is missing); None on the CPU."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index}"], capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal value for value (-0.0 equals +0.0), a NaN matching a NaN of
    either sign."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def finite_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` where both are finite (0.0 if nowhere)."""
    both = torch.isfinite(got) & torch.isfinite(want)
    if not bool(both.any()):
        return 0.0
    return float(torch.where(both, (got.double() - want.double()).abs(), 0.0).max())
