"""Per-modality encoder: exact kNN graph + fuzzy weights + spectral init.

Counterpart of ``multimodal_umap_tpu/models/encoder.py`` (single
device):

  * ``fit_graph`` -- self-graph of the training features, symmetrized by
    the fuzzy-union t-conorm, spectral initialization;
  * ``transform_graph`` -- query-vs-train graph in feature space, fuzzy
    weights with fresh per-query sigma/rho, initialized by the
    affinity-weighted average of the stored train embeddings;
  * ``invert_graph`` -- query-vs-train graph in latent space with
    output-curve weights, initialized by the affinity-weighted average of
    the training data rows (the JAX package's fixed invert semantics).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.graph import (
    DenseSymGraph,
    EdgeGraph,
    _reverse_edge_weights,
    curve_weights,
    embed_query,
    fuzzy_weights,
    symmetrize,
    symmetrize_dense,
)
from ..ops.knn import knn, resolve_engine
from ..ops.spectral import spectral_embedding


@dataclasses.dataclass
class ModalityEncoder:
    """Graph state for one modality.

    Attributes:
        k_neighbors: neighbors per point.
        out_dim: latent dimensionality.
        id: modality index.
        sigmas, rhos: (N,) fit-time bandwidths / nearest distances.
        spectral_method: ops/spectral.py initializer selection.
        knn_engine: ops/knn.py engine (None = device default).
    """

    k_neighbors: int
    out_dim: int
    id: int = 0
    sigmas: torch.Tensor | None = None
    rhos: torch.Tensor | None = None
    spectral_method: str = "auto"
    knn_engine: str | None = None

    def fit_graph(self, features: torch.Tensor
                  ) -> tuple[EdgeGraph, DenseSymGraph, torch.Tensor]:
        """The symmetric fuzzy graph (edge list for spectral, dense view
        for the layout engine; both from one reverse-edge lookup) and its
        spectral embedding."""
        engine = resolve_engine(self.knn_engine, features.device)
        dists, nbrs = knn(features, features, self.k_neighbors,
                          exclude_self=True, engine=engine)
        weights, rhos, sigmas = fuzzy_weights(dists)
        rev = _reverse_edge_weights(nbrs, weights)
        graph = symmetrize(nbrs, weights, rev)
        dense = symmetrize_dense(nbrs, weights, rev)
        self.sigmas = sigmas
        self.rhos = rhos
        embed = spectral_embedding(graph, self.out_dim,
                                   method=self.spectral_method)
        return graph, dense, embed

    def transform_graph(self, query: torch.Tensor,
                        train_features: torch.Tensor,
                        train_embeds: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Query-to-train (nbrs, weights) + weighted-average init."""
        engine = resolve_engine(self.knn_engine, query.device)
        dists, nbrs = knn(query, train_features, self.k_neighbors,
                          engine=engine)
        weights, _, _ = fuzzy_weights(dists)
        return nbrs, weights, embed_query(nbrs, weights, train_embeds)

    def invert_graph(self, query_embeds: torch.Tensor,
                     train_embeds: torch.Tensor, train_data: torch.Tensor,
                     a: float, b: float
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Latent-space (nbrs, weights) + data-space initialization."""
        engine = resolve_engine(self.knn_engine, query_embeds.device)
        dists, nbrs = knn(query_embeds, train_embeds, self.k_neighbors,
                          engine=engine)
        weights = curve_weights(dists, a, b)
        return nbrs, weights, embed_query(nbrs, weights, train_data)
