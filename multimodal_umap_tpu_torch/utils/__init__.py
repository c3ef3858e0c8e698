"""Runtime utilities: device selection, phase timing, checkpointing,
loss logging."""

from . import checkpoint, logging
from .device import resolve_device
from .prof import PhaseTimer

__all__ = ["checkpoint", "logging", "resolve_device", "PhaseTimer"]
