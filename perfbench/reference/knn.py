"""Exact k nearest neighbours in float64.

Each block of query rows gets a float64 distance panel in the expansion form
|q|^2 + |r|^2 - 2 q.r against every row, its ``k + margin`` smallest entries
as candidates, and those candidates' distances again in the direct form
sqrt(sum((q - r)^2)), sorted. The expansion form's float64 rounding (about
1e-11 of a squared distance here) is far below the gap between a row's k-th
and (k + margin)-th neighbour, so the result is exact to float64.
"""

from __future__ import annotations

import torch

MARGIN = 16


def direct_distances(table64: torch.Tensor, rows: torch.Tensor,
                     ids: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """(len(rows), m) float64 distances of ``table64[rows]`` to
    ``table64[ids]`` in the direct form, ``chunk`` rows at a time."""
    out = []
    for s in range(0, rows.shape[0], chunk):
        q = table64[rows[s:s + chunk]]
        diff = table64[ids[s:s + chunk]] - q[:, None, :]
        out.append(diff.square_().sum(2).sqrt_())
    return torch.cat(out)


def exact_knn(table: torch.Tensor, k: int, block: int = 2048):
    """((N, k) float64 ascending distances, (N, k) int64 ids) of every row
    of ``table`` against the others (a row is never its own neighbour)."""
    x = table.double()
    n = x.shape[0]
    sq = (x * x).sum(1)
    cand = min(k + MARGIN, n - 1)
    dists, ids = [], []
    for s in range(0, n, block):
        q = x[s:s + block]
        panel = torch.addmm(sq[None, :], q, x.T, alpha=-2.0)
        panel += sq[s:s + block, None]
        local = torch.arange(q.shape[0], device=x.device)
        panel[local, local + s] = float("inf")
        _, c = torch.topk(panel, cand, dim=1, largest=False)
        del panel
        d = direct_distances(x, local + s, c)
        d, order = torch.sort(d, dim=1)
        dists.append(d[:, :k])
        ids.append(c.gather(1, order)[:, :k])
    return torch.cat(dists), torch.cat(ids)
