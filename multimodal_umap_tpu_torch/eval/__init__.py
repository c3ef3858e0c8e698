"""Evaluation: cross-modal cosine, kNN retrieval, trustworthiness."""

from .trustworthiness import trustworthiness, trustworthiness_sampled
from .validation import (
    bidirectional_recall,
    embed,
    knn_test,
    similarity_test,
    train,
)

__all__ = [
    "train",
    "embed",
    "bidirectional_recall",
    "knn_test",
    "similarity_test",
    "trustworthiness",
    "trustworthiness_sampled",
]
