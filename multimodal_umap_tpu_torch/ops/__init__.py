"""Compute ops: exact kNN (tile kernel), fuzzy graphs, spectral init,
losses."""

from . import losses
from .graph import (
    DenseSymGraph,
    EdgeGraph,
    curve_weights,
    embed_query,
    fuzzy_weights,
    symmetrize,
    symmetrize_dense,
    to_dense,
)
from .knn import knn, resolve_engine
# The submodule ``knn_tile`` (kernel wrapper, launch counter) stays
# reachable as ``ops.knn_tile``: its wrapper function is not re-exported.
from .knn_tile import knn_tile_plain, knn_tiled
from .sigma import solve_sigmas
from .spectral import spectral_embedding

__all__ = [
    "losses",
    "DenseSymGraph",
    "EdgeGraph",
    "curve_weights",
    "embed_query",
    "fuzzy_weights",
    "symmetrize",
    "symmetrize_dense",
    "to_dense",
    "knn",
    "resolve_engine",
    "knn_tile_plain",
    "knn_tiled",
    "solve_sigmas",
    "spectral_embedding",
]
