"""Fuzzy simplicial-set construction on fixed-shape (N, k) arrays.

Counterpart of ``multimodal_umap_tpu/ops/graph.py``. Neighbor ids are
(N, k) int32 and weights (N, k) f32. The symmetrized fit graph is the
fuzzy-union t-conorm ``A + A^T - A o A^T``, realized as a fixed 2*N*k
edge list: a forward copy of every directed kNN edge plus a transposed
copy that is masked out when the reverse edge already exists in the
kNN lists.
"""

from __future__ import annotations

import dataclasses

import torch

from .sigma import solve_sigmas


@dataclasses.dataclass
class EdgeGraph:
    """Fixed-shape edge-list view of a (num_rows x num_cols) affinity;
    ``valid`` masks duplicate slots (weight-0 absent entries)."""

    rows: torch.Tensor  # (E,) int32
    cols: torch.Tensor  # (E,) int32
    weights: torch.Tensor  # (E,) f32
    valid: torch.Tensor  # (E,) bool
    num_rows: int
    num_cols: int

    @property
    def num_edges(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class DenseSymGraph:
    """Dense (N, k) view of the symmetric fuzzy graph for the layout
    engine: forward slots carry the union weight; ``bwd_valid`` marks
    the transposed copies that are distinct entries."""

    nbrs: torch.Tensor  # (N, k) int32
    weights: torch.Tensor  # (N, k) f32
    bwd_valid: torch.Tensor  # (N, k) bool
    num_rows: int


def fuzzy_weights(dists: torch.Tensor, num_iters: int = 20):
    """Fuzzy membership w = exp(-(d - rho)/sigma) with rho the row's
    nearest distance and sigma the Newton-solved bandwidth.

    Returns (weights (Q, k), rhos (Q,), sigmas (Q,))."""
    rhos = dists.min(1).values
    sigmas = solve_sigmas(dists, rhos, num_iters=num_iters)
    weights = torch.exp(-(dists - rhos[:, None]) / sigmas[:, None])
    return weights, rhos, sigmas


def curve_weights(dists: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Output-space curve weights 1/(1 + a d^(2b)) (invert mode)."""
    return 1.0 / (1.0 + a * torch.pow(dists.clamp_min(1e-12), 2.0 * b))


# Rows per block of the reverse-edge lookup (multimodal_umap_tpu/ops/
# graph.py:92): the (rows, k, k) transients are ~rows*k*k*(8+4+1+4)
# bytes, ~250 MB at 65,536 rows and k=15, whatever N is.
_REV_BLOCK = 65536


def _reverse_edge_block(nb: torch.Tensor, weights: torch.Tensor,
                        row0: int, row1: int):
    """Rows [row0, row1) of :func:`_reverse_edge_weights` (``nb`` the
    whole (N, k) int64 neighbour table)."""
    nb_r = nb[row0:row1]
    nbrs_of_nbrs = nb[nb_r]  # (rows, k, k)
    row_ids = torch.arange(row0, row1, device=nb.device)[:, None, None]
    match = nbrs_of_nbrs == row_ids
    w_rev = torch.where(match, weights[nb_r], 0.0).sum(2)
    return w_rev, match.any(2)


def _reverse_edge_weights(nbrs: torch.Tensor, weights: torch.Tensor,
                          rev_block: int | None = None):
    """For edge (i, j = nbrs[i, m]) the weight w[j, l] with
    nbrs[j, l] == i, and whether it exists: ((N, k), (N, k) bool).
    Blocks of ``rev_block`` rows (default :data:`_REV_BLOCK`) keep the
    (rows, k, k) transients constant in N; each row's result is the
    unblocked one bit for bit (at most one slot matches)."""
    rev_block = _REV_BLOCK if rev_block is None else rev_block
    nb = nbrs.long()
    n = nb.shape[0]
    w_rev, exists = zip(*(
        _reverse_edge_block(nb, weights, s, min(s + rev_block, n))
        for s in range(0, n, rev_block)))
    return torch.cat(w_rev), torch.cat(exists)


def symmetrize(nbrs: torch.Tensor, weights: torch.Tensor,
               rev: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> EdgeGraph:
    """Fuzzy-union symmetrization A + A^T - A o A^T as a fixed 2*N*k
    edge list exactly covering the symmetric matrix's nonzeros. ``rev``:
    :func:`_reverse_edge_weights` of (nbrs, weights) when the caller has
    it already."""
    n, k = nbrs.shape
    w_rev, exists_rev = rev or _reverse_edge_weights(nbrs, weights)
    sym_w = (weights + w_rev - weights * w_rev).reshape(-1).float()
    rows = torch.arange(n, dtype=torch.int32,
                        device=nbrs.device).repeat_interleave(k)
    cols = nbrs.reshape(-1).to(torch.int32)
    # Transposed copies cover entries (j, i); drop them when j already
    # lists i (that entry is covered by j's own forward slot).
    fwd_valid = torch.ones(n * k, dtype=torch.bool, device=nbrs.device)
    return EdgeGraph(
        rows=torch.cat([rows, cols]),
        cols=torch.cat([cols, rows]),
        weights=torch.cat([sym_w, sym_w]),
        valid=torch.cat([fwd_valid, ~exists_rev.reshape(-1)]),
        num_rows=n,
        num_cols=n,
    )


def symmetrize_dense(nbrs: torch.Tensor, weights: torch.Tensor,
                     rev: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> DenseSymGraph:
    """Dense-layout fuzzy-union symmetrization (same math as
    :func:`symmetrize`, same ``rev``)."""
    w_rev, exists_rev = rev or _reverse_edge_weights(nbrs, weights)
    return DenseSymGraph(
        nbrs=nbrs.to(torch.int32),
        weights=(weights + w_rev - weights * w_rev).float(),
        bwd_valid=~exists_rev,
        num_rows=nbrs.shape[0],
    )


def embed_query(nbrs: torch.Tensor, weights: torch.Tensor,
                ref: torch.Tensor) -> torch.Tensor:
    """Affinity-weighted average of reference rows: (Q, k) affinities
    row-normalized (sums clamped >= 1e-6) times ``ref[nbrs]``. A
    bf16-stored ``ref`` is gathered as it is and up-cast per gathered
    row (the JAX package's type promotion); the result is f32."""
    row_sums = weights.sum(1).clamp_min(1e-6)
    norm_w = weights / row_sums[:, None]
    return torch.einsum("qk,qkd->qd", norm_w, ref[nbrs.long()].float())


def to_dense(graph: EdgeGraph) -> torch.Tensor:
    """Materializes the affinity matrix (tests / small-N spectral only)."""
    w = torch.where(graph.valid, graph.weights, 0.0)
    dense = torch.zeros(graph.num_rows * graph.num_cols, dtype=torch.float32,
                        device=w.device)
    flat = graph.rows.long() * graph.num_cols + graph.cols.long()
    return dense.index_add_(0, flat, w).view(graph.num_rows, graph.num_cols)
