"""Ring-sharded exact kNN over the mesh.

Counterpart of ``knn_ring`` and ``pad_rows_to_multiple`` in
``multimodal_umap_tpu/ops/knn_stream.py`` (its single-device
``knn_streamed`` is ``knn_tile.knn_tiled``'s column chunks here).
Queries and references both shard on rows; no rank ever holds the
reference table. At each of the P ring steps a rank meets its query
shard with the reference shard it holds -- through the tile kernel
(:func:`.knn_tile.knn_tiled`, which computes the same function as JAX's
``_panel_sq`` + ``hier_topk_smallest`` panel: the squared-distance
panel with exact per-tile selection) -- merges the step's top-k into its
running best with global column ids, and passes the shard to rank + 1
(:func:`..parallel.collectives.ring_pass`). After P steps every query
row has met every reference row.

bf16 mode keeps a widened candidate set per step (the port's bf16
engine's: 32 a tile at k=15, max(4k, 64) merged; JAX's ring:
``_candidate_width``) and re-scores it exactly against the resident
shard (inside ``knn_tiled``), so returned distances are exact f32; f32
mode keeps the top-k directly. bf16-stored shards ride the ring as
their bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import ring_pass
from ..parallel.mesh import ShardingPlan
from .knn_tile import knn_tiled, merge_topk


def knn_ring_shards(
    q_shard: torch.Tensor,
    r_shard: torch.Tensor,
    k: int,
    mesh,
    *,
    exclude_self: bool = False,
    bf16: bool | None = None,
    num_valid_cols: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring on this rank's shards: ``q_shard`` (Q/P, D) and
    ``r_shard`` (N/P, D), both on the mesh's device, every rank's the
    same size. Returns this rank's ((Q/P, k) ascending Euclidean
    distances, (Q/P, k) int32 global reference ids).

    Global columns >= ``num_valid_cols`` (padding) are never returned;
    ``exclude_self`` (fit: queries are the references) drops column
    ``rank * Q/P + i`` for local query row i. ``bf16`` (default: on for
    CUDA shards or a bf16-stored table) ranks in the kernel's bf16 mode
    and re-scores exactly."""
    p, me = mesh.size, mesh.rank
    q_rows, r_rows = q_shard.shape[0], r_shard.shape[0]
    n_valid = r_rows * p if num_valid_cols is None else int(num_valid_cols)
    if exclude_self and q_rows != r_rows:
        raise ValueError("exclude_self requires queries == references")
    excl = 1 if exclude_self else 0
    if k > n_valid - excl:
        raise ValueError(f"k={k} exceeds available references ({n_valid})")
    stored_bf16 = torch.bfloat16 in (q_shard.dtype, r_shard.dtype)
    if bf16 is None:
        bf16 = q_shard.device.type == "cuda"
    bf16 = bool(bf16) or stored_bf16
    best_d = best_i = None
    cur = r_shard
    for step in range(p):
        # After `step` passes this rank holds the shard that started at
        # rank (me - step) mod p.
        col_offset = ((me - step) % p) * r_rows
        valid = min(r_rows, max(0, n_valid - col_offset))
        self_here = exclude_self and col_offset == me * q_rows
        avail = valid - (1 if self_here else 0)
        if avail > 0:
            k_step = min(k, avail)
            d, i = knn_tiled(
                q_shard, cur if valid == r_rows else cur[:valid], k_step,
                exclude_self=self_here, bf16=bf16,
                row_offset=me * q_rows - col_offset)
            best_d, best_i = merge_topk(best_d, best_i, d, i + col_offset, k)
        if step < p - 1:
            cur = ring_pass(cur, mesh)
    return best_d, best_i


def knn_ring(
    queries,
    references,
    k: int,
    mesh,
    *,
    exclude_self: bool = False,
    bf16: bool | None = None,
    num_valid_cols: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the reference table ring-sharded over the mesh.

    Every rank passes the same whole ``queries`` (Q, D) and
    ``references`` (N, D) (host arrays or tensors); each moves only its
    rows to its device (bf16 storage kept, anything else as f32) and
    gets back its rows of the result (:func:`knn_ring_shards`). Q and N
    must divide the mesh size: pad at the caller
    (:func:`pad_rows_to_multiple`) and pass the true reference count as
    ``num_valid_cols``; padded query rows return garbage the caller
    slices off."""
    p = mesh.size
    num_q, num_r = queries.shape[0], references.shape[0]
    if num_q % p or num_r % p:
        raise ValueError(
            f"knn_ring needs row counts divisible by mesh size {p}; "
            f"got Q={num_q}, N={num_r} (pad at the caller)")
    plan = ShardingPlan(mesh)

    def stored(x):
        x = plan.shard(x)
        return x if x.dtype == torch.bfloat16 else x.float()

    q = stored(queries)
    r = q if references is queries else stored(references)
    return knn_ring_shards(q, r, k, mesh, exclude_self=exclude_self,
                           bf16=bf16, num_valid_cols=num_valid_cols)


def pad_rows_to_multiple(x, multiple: int):
    """(``x`` padded with zero rows to a multiple, original row count);
    a numpy array stays numpy, a tensor stays on its device."""
    n = x.shape[0]
    padded = -(-n // multiple) * multiple
    if padded == n:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, 0, 0, padded - n)), n
    x = np.asarray(x)
    return np.pad(x, ((0, padded - n), (0, 0))), n
