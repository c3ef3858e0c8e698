"""The symmetric graph's normalized Laplacian: its null space and its
smallest eigenvalues.

L = I - D^-1/2 A D^-1/2 has, on a graph of C connected components, the null
space spanned by d^1/2 restricted to each component. A spectral
initialisation of the smallest non-trivial eigenvectors therefore holds, as
its first min(C - 1, out_dim) columns, vectors of that space, and as the
rest eigenvectors whose Rayleigh quotients are the next smallest
eigenvalues. L is block-diagonal over the components, so its spectrum is
that of each component's dense block (``eigvalsh`` in float64).
"""

from __future__ import annotations

import torch


def components(n: int, rows: torch.Tensor, cols: torch.Tensor
               ) -> torch.Tensor:
    """(n,) int64 component of each node (its least node id), by min-label
    propagation over the edges in both directions with pointer jumping."""
    labels = torch.arange(n, device=rows.device)
    while True:
        new = labels.clone()
        new.scatter_reduce_(0, rows, labels[cols], "amin")
        new.scatter_reduce_(0, cols, labels[rows], "amin")
        new = new[new]
        if torch.equal(new, labels):
            return labels
        labels = new


def _graph(ids: torch.Tensor, sym: torch.Tensor, back: torch.Tensor,
           sym_t: torch.Tensor | None):
    """(rows, cols, weights, degrees, component of each node) of the graph
    whose entries are (i, ids[i, m]) with weight ``sym`` and (ids[i, m], i)
    with weight ``sym_t`` (default ``sym``), the transposed entry left out
    where ``back`` says the pair is listed both ways (its own row lists
    it). Components are numbered 0..C-1; degrees are clamped at 1e-6."""
    n, k = ids.shape
    own = torch.arange(n, device=ids.device).repeat_interleave(k)
    nbr = ids.reshape(-1).long()
    w = sym.reshape(-1).double()
    w_t = w if sym_t is None else sym_t.reshape(-1).double()
    w_t = torch.where(back.reshape(-1), 0.0, w_t)
    rows, cols = torch.cat([own, nbr]), torch.cat([nbr, own])
    weights = torch.cat([w, w_t])
    deg = torch.zeros(n, dtype=torch.float64, device=ids.device)
    deg.index_add_(0, rows, weights)
    _, comp = torch.unique(components(n, own, nbr), return_inverse=True)
    return rows, cols, weights, deg.clamp_min(1e-6), comp


def null_basis(ids: torch.Tensor, sym: torch.Tensor, back: torch.Tensor,
               sym_t: torch.Tensor | None = None) -> torch.Tensor:
    """(N, C) float64 orthonormal basis of the null space of the graph of
    :func:`_graph`."""
    n = ids.shape[0]
    _, _, _, deg, comp = _graph(ids, sym, back, sym_t)
    basis = torch.zeros((n, int(comp.max()) + 1), dtype=torch.float64,
                        device=ids.device)
    basis[torch.arange(n, device=ids.device), comp] = deg.sqrt()
    return basis / torch.linalg.vector_norm(basis, dim=0)


def outside_share(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(m,) share of each column's norm outside span(basis)."""
    x = x.double()
    rest = x - basis @ (basis.T @ x)
    return (torch.linalg.vector_norm(rest, dim=0)
            / torch.linalg.vector_norm(x, dim=0).clamp_min(1e-300))


# The largest connected component whose Laplacian is taken dense: 16,384
# rows are 2 GiB in float64. The benchmark's graphs split into one
# component a cluster (about 1,000-1,500 rows).
MAX_BLOCK = 16_384


def laplacian_blocks(ids: torch.Tensor, sym: torch.Tensor,
                     back: torch.Tensor, sym_t: torch.Tensor | None = None):
    """The normalized Laplacian L = I - D^-1/2 A D^-1/2 of the graph of
    :func:`_graph`, one dense float64 block a connected component (L is
    block-diagonal over them), yielded as (node ids, block); a component
    over :data:`MAX_BLOCK` rows raises ValueError."""
    rows, cols, weights, deg, comp = _graph(ids, sym, back, sym_t)
    n = ids.shape[0]
    order = torch.argsort(comp, stable=True)
    counts = torch.bincount(comp)
    if int(counts.max()) > MAX_BLOCK:
        raise ValueError(f"a component of {int(counts.max())} rows")
    starts = torch.cumsum(counts, 0) - counts
    local = torch.empty(n, dtype=torch.long, device=ids.device)
    local[order] = torch.arange(n, device=ids.device) - starts[comp[order]]
    e_order = torch.argsort(comp[rows], stable=True)
    e_counts = torch.bincount(comp[rows], minlength=counts.numel()).tolist()
    inv_sqrt = deg.rsqrt()
    scaled = weights * inv_sqrt[rows] * inv_sqrt[cols]
    e0 = 0
    for c, (s, m) in enumerate(zip(starts.tolist(), counts.tolist())):
        sel = e_order[e0:e0 + e_counts[c]]
        e0 += e_counts[c]
        block = torch.zeros((m, m), dtype=torch.float64, device=ids.device)
        block.index_put_((local[rows[sel]], local[cols[sel]]), -scaled[sel],
                         accumulate=True)
        block = (block + block.T) / 2.0
        block.diagonal().add_(1.0)
        yield order[s:s + m], block


def smallest_spectrum(blocks, m: int, vectors: bool = False):
    """The m smallest eigenvalues of the block-diagonal Laplacian, ascending
    (float64), and with ``vectors`` their (N, m) eigenvectors too. Each
    block's smallest is exactly 0, so with m blocks or more and no vectors
    the answer is m zeros."""
    blocks = list(blocks)
    if not vectors and len(blocks) >= m:
        dev = blocks[0][1].device
        return torch.zeros(m, dtype=torch.float64, device=dev), None
    vals, vecs = [], []
    for nodes, block in blocks:
        if vectors:
            w, v = torch.linalg.eigh(block)
            vals.append(w[:m])
            vecs.append((nodes, v[:, :m]))
        else:
            vals.append(torch.linalg.eigvalsh(block)[:m])
    flat = torch.cat(vals)
    top = torch.argsort(flat, stable=True)[:m]
    if not vectors:
        return flat[top], None
    n = int(sum(nodes.numel() for nodes, _ in vecs))
    out = torch.zeros((n, m), dtype=torch.float64, device=flat.device)
    owner = torch.cat([torch.full((w.numel(),), c, device=flat.device)
                       for c, w in enumerate(vals)])
    within = torch.cat([torch.arange(w.numel(), device=flat.device)
                        for w in vals])
    for j, t in enumerate(top.tolist()):
        nodes, v = vecs[int(owner[t])]
        out[nodes, j] = v[:, int(within[t])]
    return flat[top], out


def rayleigh_quotients(blocks, x: torch.Tensor) -> torch.Tensor:
    """(m,) x_j^T L x_j / x_j^T x_j of each column of x (N, m)."""
    x = x.double()
    num = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for nodes, block in blocks:
        xc = x[nodes]
        num += ((block @ xc) * xc).sum(0)
    return num / (x * x).sum(0).clamp_min(1e-300)
