"""Spectral initialization: smallest eigenvectors of the normalized
Laplacian of the symmetric fuzzy graph.

Counterpart of ``multimodal_umap_tpu/ops/spectral.py``. The operator is
L = I - D^{-1/2} A D^{-1/2} + 1e-6 I with degrees clamped >= 1e-6, and
the trivial first eigenvector is dropped. The Laplacian is never
materialized (except on the small-n dense path): its matvec is an
``index_add_`` over the fixed edge list.

Methods: ``chebyshev`` (Chebyshev-filtered subspace iteration + one
Rayleigh-Ritz per round, stopped on the worst residual), ``dense``
(``eigh`` of the materialized Laplacian, small n only) and ``auto``
(dense below the small-n guardrail, else chebyshev). ``lobpcg`` is not
ported yet.

The filter's start block is seeded (``torch.Generator`` seed 42); the
JAX package's PRNGKey(42) block cannot be reproduced, so results agree
as subspaces (principal angles), not element-wise.
"""

from __future__ import annotations

import torch

from .graph import EdgeGraph, to_dense

_EPS_SHIFT = 1e-6
_START_SEED = 42


def _degrees(graph: EdgeGraph) -> torch.Tensor:
    w = torch.where(graph.valid, graph.weights, 0.0)
    deg = torch.zeros(graph.num_rows, dtype=torch.float32, device=w.device)
    return deg.index_add_(0, graph.rows.long(), w).clamp_min(1e-6)


def _adjacency_apply(graph: EdgeGraph, w: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """A @ y by index_add_ over the edge list (``w`` zeroed where
    invalid)."""
    out = torch.zeros((graph.num_rows, y.shape[1]), dtype=y.dtype,
                      device=y.device)
    return out.index_add_(0, graph.rows.long(),
                          y[graph.cols.long()] * w[:, None])


class _Laplacian:
    """L @ x for L = (1 + eps) I - D^-1/2 A D^-1/2."""

    def __init__(self, graph: EdgeGraph):
        self.graph = graph
        self.w = torch.where(graph.valid, graph.weights, 0.0)
        self.d_inv_sqrt = _degrees(graph) ** -0.5

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ax = _adjacency_apply(self.graph, self.w, self.d_inv_sqrt[:, None] * x)
        return (1.0 + _EPS_SHIFT) * x - self.d_inv_sqrt[:, None] * ax


def _cheb_rayleigh_ritz(lap: _Laplacian, x: torch.Tensor):
    """Orthonormal Ritz block (ascending) + its Ritz values."""
    b = x.T @ lap(x)
    b = (b + b.T) / 2.0
    theta, v = torch.linalg.eigh(b)  # ascending
    return x @ v, theta


def _cheb_residual(lap: _Laplacian, x, theta, out_dim: int) -> torch.Tensor:
    """Worst ||L v_j - theta_j v_j|| over the returned columns."""
    keep = x[:, : out_dim + 1]
    r = lap(keep) - keep * theta[None, : out_dim + 1]
    return torch.sqrt((r * r).sum(0)).max()


def _cheb_filter_round(lap: _Laplacian, x, theta, degree: int):
    """One Chebyshev filter application + QR + Rayleigh-Ritz, damping
    [lo, hi] with lo the block's largest Ritz value. Both recurrence
    terms are rescaled by the same factor (the recurrence is linear) so
    the amplified components never overflow f32."""
    hi = 2.0 + 2.0 * _EPS_SHIFT
    lo = theta[-1].clamp(0.05 * hi, 0.95 * hi)
    half_w = (hi - lo) / 2.0
    center = (lo + hi) / 2.0
    y_prev = x
    y = (lap(x) - center * x) / half_w
    for _ in range(degree - 1):
        y_next = 2.0 * (lap(y) - center * y) / half_w - y_prev
        y_prev, y = y, y_next
        scale = 1.0 / y.abs().max().clamp_min(1.0)
        y = y * scale
        y_prev = y_prev * scale
    x, _ = torch.linalg.qr(y)
    return _cheb_rayleigh_ritz(lap, x)


def _cheb_init(lap: _Laplacian, n: int, out_dim: int, guard: int):
    """Seeded orthonormal start block (trivial eigenvector first) + its
    Ritz values."""
    m = out_dim + 1 + guard
    dev = lap.w.device
    gen = torch.Generator(device=dev).manual_seed(_START_SEED)
    x = torch.randn(n, m, generator=gen, device=dev)
    trivial = 1.0 / lap.d_inv_sqrt
    x[:, 0] = trivial / torch.linalg.norm(trivial)
    x, _ = torch.linalg.qr(x)
    return _cheb_rayleigh_ritz(lap, x)


def _spectral_chebyshev(graph: EdgeGraph, out_dim: int, degree: int = 24,
                        max_rounds: int = 8, guard: int = 8,
                        tol: float = 2e-3) -> torch.Tensor:
    """Chebyshev-filtered subspace iteration: rounds repeat until the
    worst residual of the returned columns is <= ``tol``, at most
    ``max_rounds`` (one host read of the residual per round)."""
    lap = _Laplacian(graph)
    x, theta = _cheb_init(lap, graph.num_rows, out_dim, guard)
    for _ in range(max_rounds):
        x, theta = _cheb_filter_round(lap, x, theta, degree)
        if float(_cheb_residual(lap, x, theta, out_dim)) <= tol:
            break
    return x[:, 1 : out_dim + 1]


def _spectral_dense(graph: EdgeGraph, out_dim: int) -> torch.Tensor:
    adj = to_dense(graph)
    d_inv_sqrt = adj.sum(1).clamp_min(1e-6) ** -0.5
    n = graph.num_rows
    lap = (torch.eye(n, dtype=torch.float32, device=adj.device)
           * (1.0 + _EPS_SHIFT)
           - d_inv_sqrt[:, None] * adj * d_inv_sqrt[None, :])
    _, vecs = torch.linalg.eigh(lap)  # ascending
    return vecs[:, 1 : out_dim + 1]


def spectral_embedding(graph: EdgeGraph, out_dim: int,
                       method: str = "auto") -> torch.Tensor:
    """(N, out_dim) f32 smallest non-trivial Laplacian eigenvectors of
    the symmetric fuzzy graph.

    ``method``: "dense", "chebyshev", or "auto" (dense below the
    small-n guardrail, where the filter block would not fit, else
    chebyshev)."""
    small_n = graph.num_rows < 4 * (out_dim + 1) + 4
    if method == "auto" or (method == "chebyshev" and small_n):
        method = "dense" if small_n else "chebyshev"
    if method == "dense":
        return _spectral_dense(graph, out_dim)
    if method == "chebyshev":
        return _spectral_chebyshev(graph, out_dim)
    if method == "lobpcg":
        raise ValueError("spectral method 'lobpcg' is not ported to "
                         "PyTorch yet; use 'auto', 'chebyshev' or 'dense'")
    raise ValueError(f"unknown spectral method: {method}")
