"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. The default is CUDA;
without a GPU that raises, unless the caller asked for the CPU. Nothing
drops to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device`` (None -> "cuda"); raises when it
    names CUDA and no GPU is present. "cuda" without an index becomes the
    current card's ``cuda:i``, the device its tensors report, so that a
    tensor already there compares equal to it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
