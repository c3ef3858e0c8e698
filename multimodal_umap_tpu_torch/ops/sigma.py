"""Per-point bandwidth (sigma) solver.

Solves, per row i, for sigma_i such that

    sum_j exp(-(d_ij - rho_i) / sigma_i) = log2(k)

by Newton's method with the analytic derivative
f'(s) = sum_j e_j (d_j - rho) / s^2. The quirks of
``multimodal_umap_tpu/ops/sigma.py`` are kept: the start value is 1.0,
the +1e-6 regularizer is added to the derivative, sigma is clamped
>= 1e-6, 20 iterations.
"""

from __future__ import annotations

import math

import torch


def solve_sigmas(dists: torch.Tensor, rhos: torch.Tensor,
                 num_iters: int = 20) -> torch.Tensor:
    """(N,) fuzzy-set bandwidths for (N, k) neighbor distances and (N,)
    nearest-neighbor distances, clamped >= 1e-6."""
    dists = dists.float()
    target = math.log2(dists.shape[1])
    shifted = (dists - rhos.float()[:, None]).clamp_min(0.0)
    sigmas = torch.ones(dists.shape[0], dtype=torch.float32,
                        device=dists.device)
    for _ in range(num_iters):
        e = torch.exp(-shifted / sigmas[:, None])
        f = e.sum(1) - target
        df = (e * shifted).sum(1) / (sigmas * sigmas)
        sigmas = (sigmas - f / (df + 1e-6)).clamp_min(1e-6)
    return sigmas
