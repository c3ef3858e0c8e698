"""Gather-only building blocks for the layout engine's gradients.

Counterpart of ``multimodal_umap_tpu/ops/scatter_free.py``:
``permutation_gather`` is ``table[pi]`` for a permutation ``pi`` whose
backward is the reindex ``ct[pi_inv]`` -- each output row receives
exactly one cotangent row, so no scatter-add is needed.
:func:`dynamic_roll` and :func:`dynamic_slice` take their offset as a
0-d device tensor (JAX traces its roll offsets; here a captured CUDA
graph reads them from a buffer refilled each epoch); a roll's backward
is a gather too, a slice's writes distinct rows into zeros.
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


def inverse_permutation(pi: torch.Tensor, out=None) -> torch.Tensor:
    """pi_inv with pi_inv[pi] = arange(n), written into ``out`` if given."""
    pi_inv = torch.empty_like(pi) if out is None else out
    pi_inv[pi] = torch.arange(pi.shape[0], dtype=pi.dtype, device=pi.device)
    return pi_inv


def random_permutation_pair(n: int, generator: torch.Generator,
                            device: torch.device | str, out=None):
    """(pi, pi_inv), int64, for a uniform random permutation of [0, n)
    drawn from ``generator`` (which must live on ``device``); ``out``, a
    pair of (n,) int64 buffers, receives them in place."""
    pi, pi_inv = ((torch.empty(n, dtype=torch.int64, device=device), None)
                  if out is None else out)
    torch.randperm(n, generator=generator, out=pi)
    return pi, inverse_permutation(pi, out=pi_inv)


def _roll_index(n: int, off: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=off.device) + off) % n


class _DynamicRoll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, off):
        ctx.save_for_backward(off)
        return x.index_select(0, _roll_index(x.shape[0], off))

    @staticmethod
    def backward(ctx, ct):
        (off,) = ctx.saved_tensors
        return ct.index_select(0, _roll_index(ct.shape[0], -off)), None


def dynamic_roll(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, -off, 0)`` (row i is ``x[(i + off) % n]``) for a
    0-d int64 ``off`` on ``x``'s device: a gather whose backward is the
    inverse roll, also a gather -- no scatter."""
    return _DynamicRoll.apply(x, off)


class _DynamicSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, start, length):
        idx = (start + torch.arange(length, device=start.device)) % x.shape[0]
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return (ct.new_zeros((ctx.rows, *ct.shape[1:])).index_copy_(0, idx, ct),
                None, None)


def dynamic_slice(x: torch.Tensor, start: torch.Tensor,
                  length: int) -> torch.Tensor:
    """``x[start:start + length]`` for a 0-d int64 ``start`` on ``x``'s
    device, wrapping past the last row (``torch.roll(x, -start, 0)[:length]``,
    ``length`` at most ``x``'s rows): a gather, whose backward writes the
    cotangent into zeros (an ``index_copy_`` of distinct rows: no
    accumulation), as a slice's backward does."""
    return _DynamicSlice.apply(x, start, length)
