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

Each step runs under a ``utils.prof`` span of the caller's phase:
``knn`` (the search, the ring's and the fit's all-gather included),
``sigma`` (the fuzzy weights or the output-curve weights), ``union``
(the reverse-edge lookup and both symmetrized views), ``spectral``.

Under a mesh (``mesh=``, more than one rank) every mode takes this
rank's row shards of its tables and returns this rank's rows: the kNN
rides the ring (ops/knn_stream.py), so no rank holds a feature table,
and the init's reference rows are fetched by ring too
(``layout._ring_rows``). The fit graph's (N, k) kNN results are
all-gathered and symmetrized whole on every rank (the reverse-edge
lookup needs every row), and the spectral init runs on the
destination-sharded graph.
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
from ..parallel.collectives import all_gather_tensor
from ..utils import prof


def _ring_ok(mesh, num_refs: int) -> bool:
    """The ring path needs more than one rank and the reference rows
    divisible by the mesh size (queries are padded; a reference table is
    not -- an indivisible one stays whole on every rank)."""
    return mesh is not None and mesh.size > 1 and num_refs % mesh.size == 0


def _ring_knn(q_shard, r_shard, k, mesh, *, exclude_self, engine):
    """Ring kNN of this rank's (padded) query rows; the caller pads the
    queries to a mesh multiple and slices the padded rows off."""
    from ..ops.knn_stream import knn_ring_shards

    return knn_ring_shards(q_shard, r_shard, k, mesh,
                           exclude_self=exclude_self,
                           bf16=engine in ("bf16", "stream"))


def _ring_embed_query(nbrs, weights, ref_shard, mesh) -> torch.Tensor:
    """``embed_query`` with the reference rows fetched by ring."""
    from .layout import _ring_rows

    rows = _ring_rows(ref_shard, nbrs, mesh)  # (Q, k, D)
    slots = torch.arange(nbrs.numel(), device=nbrs.device).view(nbrs.shape)
    return embed_query(slots, weights, rows.reshape(-1, rows.shape[-1]))


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

    def fit_graph(self, features: torch.Tensor, mesh=None
                  ) -> tuple[EdgeGraph, DenseSymGraph, torch.Tensor]:
        """The symmetric fuzzy graph (edge list for spectral, dense view
        for the layout engine; both from one reverse-edge lookup) and its
        spectral embedding. Under a mesh ``features`` are this rank's
        rows and the results are whole on every rank."""
        ring = mesh is not None and mesh.size > 1
        dists, nbrs = self._knn(features, features, mesh, exclude_self=True,
                                gather=True)
        with prof.span("sigma"):
            weights, rhos, sigmas = fuzzy_weights(dists)
        with prof.span("union"):
            rev = _reverse_edge_weights(nbrs, weights)
            graph = symmetrize(nbrs, weights, rev)
            dense = symmetrize_dense(nbrs, weights, rev)
        self.sigmas = sigmas
        self.rhos = rhos
        with prof.span("spectral"):
            embed = spectral_embedding(graph, self.out_dim,
                                       method=self.spectral_method,
                                       mesh=mesh if ring else None)
        return graph, dense, embed

    def _knn(self, query: torch.Tensor, refs: torch.Tensor, mesh, *,
             exclude_self: bool = False, gather: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dists, nbrs) of the query rows, under the ``knn`` span: on
        the ring under a mesh of more than one rank (``gather``: then
        all-gathered whole), else :func:`knn`."""
        engine = resolve_engine(self.knn_engine, query.device)
        with prof.span("knn"):
            if mesh is None or mesh.size <= 1:
                return knn(query, refs, self.k_neighbors,
                           exclude_self=exclude_self, engine=engine)
            dists, nbrs = _ring_knn(query, refs, self.k_neighbors, mesh,
                                    exclude_self=exclude_self, engine=engine)
            if gather:
                dists = all_gather_tensor(dists, mesh)
                nbrs = all_gather_tensor(nbrs, mesh)
            return dists, nbrs

    def transform_graph(self, query: torch.Tensor,
                        train_features: torch.Tensor,
                        train_embeds: torch.Tensor, mesh=None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Query-to-train (nbrs, weights) + weighted-average init. Under
        a mesh every table is this rank's rows (queries padded to a mesh
        multiple)."""
        dists, nbrs = self._knn(query, train_features, mesh)
        with prof.span("sigma"):
            weights, _, _ = fuzzy_weights(dists)
        if mesh is not None and mesh.size > 1:
            return nbrs, weights, _ring_embed_query(nbrs, weights,
                                                    train_embeds, mesh)
        return nbrs, weights, embed_query(nbrs, weights, train_embeds)

    def invert_graph(self, query_embeds: torch.Tensor,
                     train_embeds: torch.Tensor, train_data: torch.Tensor,
                     a: float, b: float, mesh=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Latent-space (nbrs, weights) + data-space initialization. Under
        a mesh every table is this rank's rows."""
        dists, nbrs = self._knn(query_embeds, train_embeds, mesh)
        with prof.span("sigma"):
            weights = curve_weights(dists, a, b)
        if mesh is not None and mesh.size > 1:
            return nbrs, weights, _ring_embed_query(nbrs, weights,
                                                    train_data, mesh)
        return nbrs, weights, embed_query(nbrs, weights, train_data)
