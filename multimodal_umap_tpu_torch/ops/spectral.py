"""Spectral initialization: smallest eigenvectors of the normalized
Laplacian of the symmetric fuzzy graph.

Counterpart of ``multimodal_umap_tpu/ops/spectral.py``. The operator is
L = I - D^{-1/2} A D^{-1/2} + 1e-6 I with degrees clamped >= 1e-6, and
the trivial first eigenvector is dropped. The Laplacian is never
materialized (except on the small-n dense path): its matvec is an
``index_add_`` over the fixed edge list.

Methods: ``chebyshev`` (Chebyshev-filtered subspace iteration + one
Rayleigh-Ritz per round, stopped on the worst residual), ``lobpcg``
(LOBPCG on the shifted operator c*I - L, a port of
``jax.experimental.sparse.linalg.lobpcg_standard``), ``dense`` (``eigh``
of the materialized Laplacian, small n only) and ``auto`` (dense below
the small-n guardrail, else chebyshev).

The start blocks are seeded (``torch.Generator`` seed 42); the JAX
package's PRNGKey(42) blocks cannot be reproduced, so results agree as
subspaces (principal angles), not element-wise. ``lobpcg`` takes its
start block as an input (``x0``), so a test can hand it JAX's.

Under a mesh (``spectral_embedding(..., mesh=)``) the Chebyshev filter
runs on a :class:`DestShardedGraph`: each rank keeps the edges whose
destination row it owns, so an apply is a local ``index_add_`` over its
rows plus ONE all-gather of the (N, m) block; QR and Rayleigh-Ritz run
on the gathered block, the same arithmetic on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.collectives import all_gather_tensor
from .graph import EdgeGraph, to_dense

_EPS_SHIFT = 1e-6
_LOBPCG_SHIFT = 2.0 + 2.0 * _EPS_SHIFT
_START_SEED = 42


@dataclasses.dataclass
class DestShardedGraph:
    """This rank's edges of a symmetric EdgeGraph: those whose
    destination row it owns, in their original order (multimodal_umap_tpu/
    ops/spectral.py:35: there (P, E_pad) arrays sharded on P, padded with
    weight-0 edges; here each rank holds only its own). ``rows`` are
    local destination ids, ``cols`` global source ids, ``weights`` 0
    where the edge was invalid."""

    rows: torch.Tensor  # (E_r,) int64
    cols: torch.Tensor  # (E_r,) int64
    weights: torch.Tensor  # (E_r,) f32
    num_rows: int  # global N
    mesh: object

    @property
    def num_edges(self) -> int:
        return int(self.rows.shape[0])

    @property
    def local_rows(self) -> int:
        return self.num_rows // self.mesh.size


def dest_shard_graph(graph: EdgeGraph, mesh) -> DestShardedGraph:
    """Buckets a symmetric EdgeGraph (whole on every rank) by destination
    shard and keeps this rank's bucket. Requires ``num_rows`` divisible
    by the mesh size (the ring kNN's precondition)."""
    n, p = graph.num_rows, mesh.size
    if n % p:
        raise ValueError(f"num_rows={n} not divisible by mesh size {p}")
    lo = mesh.rank * (n // p)
    rows = graph.rows.long()
    keep = torch.nonzero((rows >= lo) & (rows < lo + n // p)).squeeze(1)
    w = torch.where(graph.valid, graph.weights, 0.0)
    return DestShardedGraph(rows=rows[keep] - lo, cols=graph.cols.long()[keep],
                            weights=w[keep], num_rows=n, mesh=mesh)


def _degrees(graph: EdgeGraph) -> torch.Tensor:
    w = torch.where(graph.valid, graph.weights, 0.0)
    deg = torch.zeros(graph.num_rows, dtype=torch.float32, device=w.device)
    return deg.index_add_(0, graph.rows.long(), w).clamp_min(1e-6)


# Edges per block of the Laplacian matvec (multimodal_umap_tpu/ops/
# spectral.py:124): the (edges, B) gather transient is edges*B*4 bytes,
# ~1.1 GB at 4M edges and B = 73, whatever N is.
_EDGE_BLOCK = 4 * 1024 * 1024


def _adjacency_apply(graph: EdgeGraph, w: torch.Tensor, y: torch.Tensor,
                     edge_block: int | None = None) -> torch.Tensor:
    """A @ y by index_add_ over the edge list (``w`` zeroed where
    invalid), ``edge_block`` edges at a time (default
    :data:`_EDGE_BLOCK`), each block added into one output. A block's
    (edges, B) gather is scaled in place: one edge-block-sized
    transient."""
    edge_block = _EDGE_BLOCK if edge_block is None else edge_block
    out_rows = (graph.local_rows if isinstance(graph, DestShardedGraph)
                else graph.num_rows)
    out = torch.zeros((out_rows, y.shape[1]), dtype=y.dtype, device=y.device)
    for e0 in range(0, graph.num_edges, edge_block):
        _add_edges(out, graph.rows[e0:e0 + edge_block],
                   graph.cols[e0:e0 + edge_block], w[e0:e0 + edge_block], y)
    return out


def _add_edges(out: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               w: torch.Tensor, y: torch.Tensor) -> None:
    """out[rows] += w * y[cols], one block of edges."""
    out.index_add_(0, rows.long(), y[cols.long()].mul_(w[:, None]))


class _Laplacian:
    """L @ x for L = (1 + eps) I - D^-1/2 A D^-1/2."""

    def __init__(self, graph: EdgeGraph):
        self.graph = graph
        self.w = torch.where(graph.valid, graph.weights, 0.0)
        self.d_inv_sqrt = _degrees(graph) ** -0.5

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ax = _adjacency_apply(self.graph, self.w, self.d_inv_sqrt[:, None] * x)
        return (1.0 + _EPS_SHIFT) * x - self.d_inv_sqrt[:, None] * ax


class _MeshLaplacian(_Laplacian):
    """:class:`_Laplacian` of a :class:`DestShardedGraph`: (N, B) in,
    (N, B) out on every rank; each apply computes this rank's rows and
    all-gathers them (its one collective)."""

    def __init__(self, graph: DestShardedGraph):
        self.graph = graph
        self.w = graph.weights
        self.lo = graph.mesh.rank * graph.local_rows
        deg = torch.zeros(graph.local_rows, dtype=torch.float32,
                          device=self.w.device)
        deg.index_add_(0, graph.rows, self.w)
        self.d_inv_sqrt = all_gather_tensor(deg.clamp_min(1e-6),
                                            graph.mesh) ** -0.5

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        hi = self.lo + self.graph.local_rows
        ax = _adjacency_apply(self.graph, self.w, self.d_inv_sqrt[:, None] * x)
        lx = ((1.0 + _EPS_SHIFT) * x[self.lo:hi]
              - self.d_inv_sqrt[self.lo:hi, None] * ax)
        return all_gather_tensor(lx, self.graph.mesh)


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
    ``max_rounds`` (one host read of the residual per round). A
    :class:`DestShardedGraph` takes the mesh's apply."""
    lap = (_MeshLaplacian(graph) if isinstance(graph, DestShardedGraph)
           else _Laplacian(graph))
    x, theta = _cheb_init(lap, graph.num_rows, out_dim, guard)
    for _ in range(max_rounds):
        x, theta = _cheb_filter_round(lap, x, theta, degree)
        if float(_cheb_residual(lap, x, theta, out_dim)) <= tol:
            break
    return x[:, 1 : out_dim + 1]


def _col_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _eigh_descending(a: torch.Tensor):
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _svqb(x: torch.Tensor) -> torch.Tensor:
    """Truncated orthonormal basis of ``x`` by SVQB (columns of a
    numerically rank-deficient ``x`` come back zero)."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(x: torch.Tensor) -> torch.Tensor:
    return _svqb(_svqb(x))


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The part of ``u`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``, orthonormalized; suspicious columns zeroed."""
    for _ in range(2):
        u = _orthonormalize(u - basis @ (basis.T @ u))
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99)


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` columns orthonormal to the orthonormal (n, k) ``x``, from a
    block Householder reflector (deterministic)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower])
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype,
                                   device=x.device)])
    w = y @ (vt.T * ((2.0 * (1.0 + s)) ** -0.5)[None, :])
    h = -2.0 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(matvec, x: torch.Tensor, m: int = 100,
                    tol: float | None = None):
    """The ``k`` largest eigenpairs of the symmetric operator ``matvec``
    ((n, B) -> (n, B)) by LOBPCG, started from the (n, k) block ``x``.

    A port of ``jax.experimental.sparse.linalg.lobpcg_standard``: an
    orthonormal X, P, R basis kept throughout (SVQB), P from the
    Rayleigh-Ritz coefficients, at most ``m`` iterations, stopping early
    once every residual ``|A v - theta v|`` is below ``tol * 10 * n *
    (theta + |A v|)`` (``tol`` default: the dtype's epsilon). The
    convergence count is read on the host once per iteration.

    Returns (theta (k,) descending, vectors (n, k), iterations run).
    """
    n, k = x.shape
    if k == 0 or 5 * k >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim, got "
                         f"{k * 5}, {n}")
    if tol is None:
        tol = torch.finfo(x.dtype).eps
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = matvec(x)
    theta = (x * ax).sum(0, keepdim=True)
    r = ax - theta * x
    it = 0
    while it < m:
        r = _project_out(torch.cat([x, p], 1), r)
        xpr = torch.cat([x, p, r], 1)
        theta, q = _eigh_descending(xpr.T @ matvec(xpr))
        b = q[:, :k]
        b = b / _col_norms(b)
        x = xpr @ b
        x = x / _col_norms(x)
        q_p, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ q_p)
        norm_p = _col_norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = matvec(x)
        r = ax - theta[None, :k] * x
        reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
        converged = int((torch.linalg.vector_norm(r, dim=0)
                         < tol * reltol).sum())
        theta = theta[None, :k]
        it += 1
        if converged >= k:
            break
    return theta[0], x, it


def lobpcg_problem(graph: EdgeGraph, out_dim: int,
                   x0: torch.Tensor | None = None):
    """The operator and start block of :func:`_spectral_lobpcg`: the
    matvec of c*I - L (c = 2 + 2 eps, so L's smallest eigenpairs are the
    largest) and ``x0`` (n, out_dim + 1) -- default a seeded normal
    block -- with column 0 set to the normalized trivial eigenvector
    d^{1/2}."""
    lap = _Laplacian(graph)
    n, dev = graph.num_rows, lap.w.device
    if x0 is None:
        gen = torch.Generator(device=dev).manual_seed(_START_SEED)
        x0 = torch.randn(n, out_dim + 1, generator=gen, device=dev)
    else:
        x0 = x0.to(device=dev, dtype=torch.float32).clone()
    trivial = 1.0 / lap.d_inv_sqrt
    x0[:, 0] = trivial / torch.linalg.norm(trivial)
    return (lambda x: _LOBPCG_SHIFT * x - lap(x)), x0


def _spectral_lobpcg(graph: EdgeGraph, out_dim: int, max_iters: int = 64,
                     x0: torch.Tensor | None = None) -> torch.Tensor:
    """LOBPCG on :func:`lobpcg_problem`, at most ``max_iters``
    iterations; the trivial column is dropped."""
    matvec, x0 = lobpcg_problem(graph, out_dim, x0)
    _, vecs, _ = lobpcg_standard(matvec, x0, m=max_iters)
    return vecs[:, 1:]


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
                       method: str = "auto", mesh=None) -> torch.Tensor:
    """(N, out_dim) f32 smallest non-trivial Laplacian eigenvectors of
    the symmetric fuzzy graph.

    ``method``: "dense", "chebyshev", "lobpcg" (at most 64 iterations;
    needs 5 * (out_dim + 1) < N), or "auto" (dense below the small-n
    guardrail, where the filter block would not fit, else chebyshev).
    ``mesh`` (more than one rank, N divisible): the Chebyshev filter runs
    on :func:`dest_shard_graph`'s bucket; every rank returns the whole
    block."""
    small_n = graph.num_rows < 4 * (out_dim + 1) + 4
    if method == "auto" or (method == "chebyshev" and small_n):
        method = "dense" if small_n else "chebyshev"
    if method == "dense":
        return _spectral_dense(graph, out_dim)
    if method == "chebyshev":
        if (mesh is not None and mesh.size > 1
                and graph.num_rows % mesh.size == 0):
            graph = dest_shard_graph(graph, mesh)
        return _spectral_chebyshev(graph, out_dim)
    if method == "lobpcg":
        return _spectral_lobpcg(graph, out_dim)
    raise ValueError(f"unknown spectral method: {method}")
