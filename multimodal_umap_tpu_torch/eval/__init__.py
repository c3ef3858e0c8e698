"""Evaluation: train / embed / recon wrappers, cross-modal cosine, kNN
retrieval, trustworthiness."""

from .trustworthiness import trustworthiness, trustworthiness_sampled
from .validation import (
    bidirectional_recall,
    embed,
    embed_and_recon,
    knn_test,
    recon,
    similarity_test,
    train,
)

__all__ = [
    "train",
    "embed",
    "recon",
    "embed_and_recon",
    "bidirectional_recall",
    "knn_test",
    "similarity_test",
    "trustworthiness",
    "trustworthiness_sampled",
]
