"""Training, embedding and reconstruction wrappers, and the evaluation
metrics: cross-modal cosine similarity and kNN retrieval.

Counterpart of ``multimodal_umap_tpu/eval/validation.py``. As in the
reference, both metrics *re-embed* their inputs with a full transform
optimization (``knn_test`` once per modality pair), so embeddings are
stochastic and parity is statistical.

Under a mesh (``train(..., mesh=)``) every rank calls these with the same
arguments; ``transform`` returns whole results on every rank, so the
metrics are the single-device values on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..models.mixture import MultimodalUMAP
from ..ops.knn import knn


def train(data: dict, cfg: Config, device: torch.device | str | None = None,
          verbose: bool = False, mesh=None) -> MultimodalUMAP:
    """Trains a multimodal UMAP model on a data dict, with the storage
    dtype (``feature_dtype``) and the snapshot options of ``cfg``
    (``progress_path``, ``resume``, ``graph_cache_path``); ``mesh`` (a
    ``parallel.Mesh``) shards it over the ranks."""
    tensors = [data[key] for key in data]
    model = MultimodalUMAP(
        k_neighbors=cfg.k_neighbors, out_dim=cfg.out_dim,
        min_dist=cfg.min_dist, num_encoders=len(tensors), seed=cfg.seed,
        spectral_method=cfg.spectral_method, knn_engine=cfg.knn_engine,
        device=device, feature_dtype=cfg.feature_dtype, mesh=mesh,
    )
    model.fit(tensors, epochs=cfg.train_epochs, num_rep=cfg.num_rep,
              lr=cfg.lr, alpha=cfg.alpha, batch_size=cfg.batch_size,
              progress_path=cfg.progress_path, resume=cfg.resume,
              verbose=verbose, graph_cache_path=cfg.graph_cache_path)
    return model


def embed(model: MultimodalUMAP, data: list, src: list[int], cfg: Config,
          verbose: bool = False) -> list[torch.Tensor]:
    """Out-of-sample embedding wrapper."""
    return model.transform(data, epochs=cfg.test_epochs, data_indices=src,
                           num_rep=cfg.num_rep, lr=cfg.lr, alpha=cfg.alpha,
                           batch_size=cfg.batch_size, verbose=verbose)


def recon(model: MultimodalUMAP, embeds: list, dst: list[int], cfg: Config,
          verbose: bool = False) -> list[torch.Tensor]:
    """Reconstruction wrapper: latent embeddings back to the features of
    modalities ``dst``."""
    return model.inverse_transform(
        embeds, epochs=cfg.test_epochs, data_indices=dst,
        num_rep=cfg.num_rep, lr=cfg.lr, alpha=cfg.alpha,
        batch_size=cfg.batch_size, verbose=verbose)


def embed_and_recon(model: MultimodalUMAP, data: list, src: list[int],
                    dst: list[int], cfg: Config, verbose: bool = False
                    ) -> list[torch.Tensor]:
    """Cross-modal translation: embed ``data`` of modalities ``src``,
    then reconstruct it as modalities ``dst``."""
    return recon(model, embed(model, data, src, cfg, verbose), dst, cfg,
                 verbose)


def _mean_pairwise_cosine(normed: list[torch.Tensor]) -> torch.Tensor:
    """Mean over samples of the mean over modality pairs of row-wise
    cosine similarity of L2-normalized rows."""
    m = len(normed)
    sims = [(normed[i] * normed[j]).sum(1)
            for i in range(m) for j in range(i + 1, m)]
    return torch.stack(sims, dim=1).mean(1).mean()


def similarity_test(data: dict, cfg: Config, model: MultimodalUMAP,
                    return_values: bool = False, quiet: bool = False
                    ) -> float | None:
    """Average cross-modal cosine similarity after re-embedding."""
    tensors = [data[key] for key in data]
    embeds = embed(model, tensors, list(range(len(tensors))), cfg)
    normed = [e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
              for e in embeds]
    result = float(_mean_pairwise_cosine(normed))
    if not quiet:
        print(f"Average cross-modal cosine similarity: {result:.4f}")
    return result if return_values else None


def bidirectional_recall(src: torch.Tensor, dst: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Fraction of rows whose paired row lands in the cross-modal top-k,
    averaged over both directions (one kNN per direction)."""
    n = src.shape[0]
    _, fwd = knn(src, dst, k)
    _, bwd = knn(dst, src, k)
    ids = torch.arange(n, dtype=torch.int32, device=fwd.device)[:, None]
    hit_fwd = (fwd == ids).any(1).float().mean()
    hit_bwd = (bwd == ids).any(1).float().mean()
    return (hit_fwd + hit_bwd) / 2.0


def knn_test(data: dict, cfg: Config, k: int = 5,
             model: MultimodalUMAP | None = None,
             return_values: bool = False, quiet: bool = False
             ) -> float | None:
    """Bidirectional kNN retrieval accuracy @k, averaged over modality
    pairs; each pair is re-embedded independently."""
    tensors = [data[key] for key in data]
    accs = []
    for i in range(len(tensors)):
        for j in range(i + 1, len(tensors)):
            embeds = embed(model, [tensors[i], tensors[j]], [i, j], cfg)
            accs.append(float(bidirectional_recall(embeds[0], embeds[1], k)))
    result = float(np.mean(accs))
    if not quiet:
        print(f"Average {k}-NN accuracy: {result:.4f}")
    return result if return_values else None
