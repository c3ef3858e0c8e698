"""Structured per-epoch loss logging.

Copy of ``multimodal_umap_tpu/utils/logging.py``: per-phase loss
histories are written as JSONL under the configured ``log_dir``.
"""

from __future__ import annotations

import json
import os
import time


def write_loss_log(log_dir: str | None, phase: str, losses) -> str | None:
    """Writes one JSONL file of per-epoch losses; returns its path."""
    if log_dir is None:
        return None
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{phase}_{int(time.time())}.jsonl")
    with open(path, "w") as f:
        for epoch, value in enumerate(losses):
            f.write(json.dumps({"epoch": epoch, "loss": float(value)}) + "\n")
    return path
