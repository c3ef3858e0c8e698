"""Runtime utilities: device selection, phase timing."""

from .device import resolve_device
from .prof import PhaseTimer

__all__ = ["resolve_device", "PhaseTimer"]
