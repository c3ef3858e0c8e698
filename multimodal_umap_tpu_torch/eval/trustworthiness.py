"""Trustworthiness of an embedding (Venna & Kaski), vectorized.

T(k) = 1 - 2/(n k (2n - 3k - 1)) * sum_i sum_{j in U_k(i)} (r(i,j) - k)

where U_k(i) are the k nearest neighbors of i in the EMBEDDING that are
not among its k nearest neighbors in the ORIGINAL space, and r(i, j) is
j's neighbor rank of i in the original space. 1.0 = no intrusions.
Counterpart of ``multimodal_umap_tpu/eval/trustworthiness.py``.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn
from ..utils.device import resolve_device


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _trust_from_ranks(orig_ranks: torch.Tensor, emb_nbrs: torch.Tensor,
                      k: int) -> float:
    n = orig_ranks.shape[0]
    ranks_of_emb = orig_ranks.gather(1, emb_nbrs.long())
    penalty = (ranks_of_emb - (k - 1)).clamp_min(0)
    # f32 sum: an int32 total wraps on large-n garbage embeddings.
    total = penalty.float().sum()
    denom = n * k * (2 * n - 3 * k - 1)
    return float(1.0 - 2.0 * total / denom)


def trustworthiness(originals, embedding, k: int = 10,
                    device: torch.device | str | None = None) -> float:
    """Fraction-of-trust score in [0, 1] (1 = no neighbor intrusions).
    ``device`` defaults to the embedding's device (CUDA for arrays)."""
    device = resolve_device(embedding.device if device is None and isinstance(
        embedding, torch.Tensor) else device)
    x = _as_f32(originals, device)
    e = _as_f32(embedding, device)
    n = x.shape[0]
    if not 0 < k < n / 2:
        raise ValueError(f"k={k} must be in (0, n/2) for n={n}")
    sq = (x * x).sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d.fill_diagonal_(float("inf"))
    order = torch.argsort(d, dim=1)
    orig_ranks = torch.argsort(order, dim=1)
    _, emb_nbrs = knn(e, e, k, exclude_self=True)
    return _trust_from_ranks(orig_ranks, emb_nbrs, k)


def _trust_rows(x_s, x, e_s, e, rows, k) -> torch.Tensor:
    """Summed intrusion penalties of the sampled anchor rows ``rows``."""
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)[None, :]
    self_mask = cols == rows[:, None]
    d_o = ((x_s * x_s).sum(1)[:, None] + (x * x).sum(1)[None, :]
           - 2.0 * (x_s @ x.T)).masked_fill(self_mask, float("inf"))
    orig_ranks = torch.argsort(torch.argsort(d_o, dim=1), dim=1)
    d_e = ((e_s * e_s).sum(1)[:, None] + (e * e).sum(1)[None, :]
           - 2.0 * (e_s @ e.T)).masked_fill(self_mask, float("inf"))
    _, emb_nbrs = torch.topk(d_e, k, dim=1, largest=False)
    penalty = (orig_ranks.gather(1, emb_nbrs) - (k - 1)).clamp_min(0)
    return penalty.float().sum()


def trustworthiness_sampled(originals, embedding, k: int = 10,
                            sample_rows: int = 4096, seed: int = 0,
                            row_block: int | None = None,
                            device: torch.device | str | None = None
                            ) -> float:
    """Unbiased row-sampled estimate of :func:`trustworthiness`: S anchor
    rows drawn without replacement (``torch.Generator`` seeded by
    ``seed``), their (S, n) panels taken in blocks of ~2^26 entries."""
    device = resolve_device(embedding.device if device is None and isinstance(
        embedding, torch.Tensor) else device)
    x = _as_f32(originals, device)
    e = _as_f32(embedding, device)
    n = x.shape[0]
    if not 0 < k < n / 2:
        raise ValueError(f"k={k} must be in (0, n/2) for n={n}")
    if sample_rows >= n:
        return trustworthiness(x, e, k)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randperm(n, generator=gen)[:sample_rows].to(x.device)
    block = row_block or max(64, (1 << 26) // max(n, 1))
    total = x.new_zeros(())
    for lo in range(0, sample_rows, block):
        blk = rows[lo:lo + block]
        total = total + _trust_rows(x[blk], x, e[blk], e, blk, k)
    mean_penalty = float(total) / sample_rows
    denom = k * (2 * n - 3 * k - 1)
    return float(1.0 - 2.0 * mean_penalty / denom)
