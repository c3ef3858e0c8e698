"""Cross-modal alignment of fitted embeddings: the cosine of each pair."""

from __future__ import annotations

import torch


def pair_cosines(e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """(N,) float64 cosine between row i of ``e0`` and row i of ``e1``."""
    a, b = e0.double(), e1.double()
    return (a * b).sum(1) / (torch.linalg.vector_norm(a, dim=1)
                             * torch.linalg.vector_norm(b, dim=1)
                             ).clamp_min(1e-300)
