"""Gather-only building blocks for the layout engine's gradients.

Counterpart of ``multimodal_umap_tpu/ops/scatter_free.py``:
``permutation_gather`` is ``table[pi]`` for a permutation ``pi`` whose
backward is the reindex ``ct[pi_inv]`` -- each output row receives
exactly one cotangent row, so no scatter-add is needed.
"""

from __future__ import annotations

import torch


class _PermutationGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pi, pi_inv):
        ctx.save_for_backward(pi_inv)
        return table[pi]

    @staticmethod
    def backward(ctx, ct):
        (pi_inv,) = ctx.saved_tensors
        return ct[pi_inv], None, None


def permutation_gather(table: torch.Tensor, pi: torch.Tensor,
                       pi_inv: torch.Tensor) -> torch.Tensor:
    """``table[pi]`` whose gradient is ``ct[pi_inv]`` -- a gather, never
    a scatter. ``pi`` must be a permutation with inverse ``pi_inv``."""
    return _PermutationGather.apply(table, pi, pi_inv)


def inverse_permutation(pi: torch.Tensor) -> torch.Tensor:
    """pi_inv with pi_inv[pi] = arange(n)."""
    pi_inv = torch.empty_like(pi)
    pi_inv[pi] = torch.arange(pi.shape[0], dtype=pi.dtype, device=pi.device)
    return pi_inv


def random_permutation_pair(n: int, generator: torch.Generator,
                            device: torch.device | str = "cpu"):
    """(pi, pi_inv), int64, for a uniform random permutation of [0, n)
    drawn from ``generator`` (which must live on ``device``)."""
    pi = torch.randperm(n, generator=generator, device=device)
    return pi, inverse_permutation(pi)
