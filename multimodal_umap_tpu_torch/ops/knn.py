"""Exact k-nearest-neighbor search.

Counterpart of ``multimodal_umap_tpu/ops/knn.py``. Distance panels
``|q|^2 + |r|^2 - 2 q r^T`` for a block of query rows against all
references, then a per-row selection; ids are int32, distances are
Euclidean (not squared), ascending.

Engines (``engine=`` argument, or the ``MMUMAP_KNN_ENGINE`` variable,
else the device default):

* ``bf16`` (CUDA default) -- the hand-written tile kernel
  (ops/knn_tile.py, csrc/knn_tile.cu) in bf16 mode: bf16 tensor-core
  panels, per-tile top-k in the kernel, exact merge, candidates
  (per tile max(k+8, :func:`_candidate_width`), global max(4k, 64))
  re-scored exactly in f32;
* ``stream`` -- the same kernel path with the streamed engine's
  candidate width (:func:`_candidate_width`);
* ``pallas`` -- the tile kernel in f32 mode (full f32 products);
* ``approx`` -- the tile kernel in f32 mode too. The JAX engine is a
  ``precision="highest"`` panel with ``lax.approx_max_k`` (the TPU's
  PartialReduce), which has no counterpart on the card; its selection
  is exact here (on the CPU ``approx_max_k`` returns ``top_k``'s result),
  so the 0.99 recall target is met;
* ``xla`` (CPU default) -- exact f32 row-blocked panels with
  ``torch.matmul`` + ``torch.topk``; explicit only on CUDA. Past
  :data:`_XLA_PANEL_BYTES` of one row block's panel the columns are
  streamed too (the JAX package's threshold), still in f32.

bf16-stored inputs take the kernel's bf16 mode under every engine. On
the CPU the kernel engines run the kernel's plain version.
"""

from __future__ import annotations

import os

import torch

from . import knn_tile as tiled
from .knn_tile import _candidate_width, knn_tiled, merge_topk

_ENGINES = frozenset({"bf16", "xla", "pallas", "approx", "stream"})
# Above this many bytes of one row block's f32 panel (row_block x N) the
# xla engine streams column blocks (knn_tile.COL_BLOCK) with f32 panels
# (multimodal_umap_tpu/ops/knn.py:296-316).
_XLA_PANEL_BYTES = 4 * 1024**3


def resolve_engine(engine: str | None = None,
                   device: torch.device | str | None = None) -> str:
    """Engine resolution: explicit argument > MMUMAP_KNN_ENGINE >
    device default (bf16 on CUDA -- the default device -- xla on the
    CPU). Unknown names raise."""
    dev = torch.device("cuda" if device is None else device)
    resolved = engine or os.environ.get("MMUMAP_KNN_ENGINE", "") or (
        "bf16" if dev.type == "cuda" else "xla"
    )
    if resolved not in _ENGINES:
        raise ValueError(
            f"unknown kNN engine {resolved!r}; expected one of "
            f"{sorted(_ENGINES)}")
    return resolved


def _exact_rescore_sq(q: torch.Tensor, references: torch.Tensor,
                      ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Exact f32 squared distances of each query to its candidate rows,
    in the direct ``sum((q - r)^2)`` form (no cancellation). The
    (rows, cand, D) gather is the transient, bounded by ``chunk`` rows;
    bf16-stored rows are up-cast per chunk, so "exact" is w.r.t. the
    stored values. The gathered chunk is reused in place for the
    difference and its square ((r - q)^2 == (q - r)^2 exactly)."""
    out = []
    for s in range(0, q.shape[0], chunk):
        # (c, cand, D): the gather is a copy, so it is free to overwrite.
        diff = references[ids[s:s + chunk].long()].float()
        diff.sub_(q[s:s + chunk].float()[:, None, :])
        out.append(diff.square_().sum(2))
    return torch.cat(out)


def _knn_block(q_block: torch.Tensor, references: torch.Tensor,
               r_sq: torch.Tensor, row_offset: int, k: int,
               exclude_self: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One row block against ``references``: f32 panel + top-k. Query
    row i's self column is ``row_offset + i`` where it lies in
    [0, N)."""
    q_sq = (q_block * q_block).sum(1, keepdim=True)
    panel = (q_sq + r_sq[None, :] - 2.0 * (q_block @ references.T)).clamp_min(0.0)
    if exclude_self:
        rows = torch.arange(q_block.shape[0], device=panel.device)
        cols = rows + row_offset
        ok = (cols >= 0) & (cols < references.shape[0])
        panel[rows[ok], cols[ok]] = float("inf")
    d, ids = torch.topk(panel, k, dim=1, largest=False)
    return d.clamp_min(0.0).sqrt(), ids.to(torch.int32)


def _knn_block_streamed(q_block: torch.Tensor, references: torch.Tensor,
                        r_sq: torch.Tensor, row_offset: int, k: int,
                        exclude_self: bool, col_block: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_knn_block` over ``col_block`` columns at a time, each
    chunk's top-k merged into the running best (knn_stream._panel_merge
    with f32 panels): the panel transient is row_block x col_block."""
    best_d = best_i = None
    for c0 in range(0, references.shape[0], col_block):
        c1 = min(c0 + col_block, references.shape[0])
        d, i = _knn_block(q_block, references[c0:c1], r_sq[c0:c1],
                          row_offset - c0, min(k, c1 - c0), exclude_self)
        i += c0
        best_d, best_i = merge_topk(best_d, best_i, d, i, k)
    return best_d, best_i


def knn(
    queries: torch.Tensor,
    references: torch.Tensor,
    k: int,
    *,
    exclude_self: bool = False,
    row_block: int = 8192,
    engine: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``queries`` (Q, D) against ``references`` (N, D).

    ``exclude_self`` masks query i vs reference i (fit mode, where the
    queries are the references). Returns ((Q, k) ascending Euclidean
    distances, (Q, k) int32 reference ids).

    If either input is stored bfloat16 the call takes the kernel's bf16
    mode whatever the engine (the JAX package's bf16-stored rule): the
    tables go to the kernel without an f32 copy and the re-score is exact
    w.r.t. the stored values. Reference columns are taken
    ``knn_tile.COL_BLOCK`` at a time: per kernel launch, and per streamed
    panel of the ``xla`` engine past :data:`_XLA_PANEL_BYTES`.
    """
    engine = resolve_engine(engine, queries.device)
    bf16_stored = torch.bfloat16 in (queries.dtype, references.dtype)
    if bf16_stored or engine in ("bf16", "stream", "pallas", "approx"):
        cand = None
        if engine == "stream":
            cand = _candidate_width(
                k, references.shape[0] - (1 if exclude_self else 0))
        return knn_tiled(queries, references, k, exclude_self=exclude_self,
                         bf16=bf16_stored or engine in ("bf16", "stream"),
                         row_block=row_block, cand=cand)

    q = queries.float()
    r = references.float()
    num_q, num_r = q.shape[0], r.shape[0]
    if k > num_r - (1 if exclude_self else 0):
        raise ValueError(f"k={k} exceeds available references ({num_r})")
    r_sq = (r * r).sum(1)
    stream = 4 * row_block * num_r > _XLA_PANEL_BYTES
    d_parts, i_parts = [], []
    for s in range(0, num_q, row_block):
        if stream:
            d, i = _knn_block_streamed(q[s:s + row_block], r, r_sq, s, k,
                                       exclude_self, tiled.COL_BLOCK)
        else:
            d, i = _knn_block(q[s:s + row_block], r, r_sq, s, k,
                              exclude_self)
        d_parts.append(d)
        i_parts.append(i)
    return torch.cat(d_parts), torch.cat(i_parts)
