"""The layout epoch over the mesh: O(table) collectives per epoch.

Counterpart of ``multimodal_umap_tpu/models/layout_sharded.py`` (there a
``jax.shard_map`` program; here the same per-rank program on
``torch.distributed``, one process per rank). Each rank holds its rows
of every embedding table, Adam (``torch.optim.Adam``) steps its own
rows, and the communication is:

  * fit forward: ONE all-gather of each modality's (N, D) table per
    epoch (:func:`..parallel.collectives.all_gather_rows`); every
    neighbour, negative and InfoNCE access reads the gathered copy;
  * fit backward: that all-gather's backward, ONE reduce-scatter of the
    (N, D) cotangent per modality -- attraction, repulsion and InfoNCE
    gradients all merge into it;
  * bookkeeping: per modality one (N,) all-reduce (transposed-slot
    counts) and one (N,) all-gather (row counts); per chunk one all-reduce
    of the loss history;
  * transform / invert: the frozen reference table is gathered ONCE PER
    CHUNK ("full"), or kept sharded with its rows fetched by
    :func:`_ring_rows` ("ring": attraction rows once per chunk, negative
    rows in one ring per epoch); epochs then move only (Q,) window
    bookkeeping.

Draws: every rank makes each epoch's draws at FULL shape from the same
generators (``layout.epoch_rng(seed, epoch)``) and slices its rows, so
the draws equal the single-device run's; only float summation order
differs. The fit loss reads every table through its gathered copy (the
local rows too), so at one rank it builds the single-device terms in
the same order and the runs are bit-equal.
"""

from __future__ import annotations

import typing

import torch

from ..ops import losses as L
from ..ops.layout_terms import fit_attraction, fit_repulsion
from ..parallel.collectives import (
    all_gather_rows,
    all_gather_tensor,
    psum,
    ring_pass,
)
from ..utils import prof
from .layout import (
    EpochDraws,
    FitDraws,
    LayoutTask,
    QueryDraws,
    TaskStatic,
    _inv_window_coef,
    _start,
    _window_means_from_rows,
    pack_rolls,
)


def _ring_rows(ref_shard: torch.Tensor, ids: torch.Tensor,
               mesh) -> torch.Tensor:
    """Rows of a row-sharded table selected by GLOBAL id: each rank
    serves the ids in the shard it holds, then passes the shard on --
    P - 1 ring passes, never more than one (N/P, D) shard in flight.
    Returns ``(*ids.shape, D)`` in the table's storage dtype."""
    r_rows = ref_shard.shape[0]
    out = ref_shard.new_zeros((*ids.shape, ref_shard.shape[1]))
    ids = ids.long()
    cur = ref_shard
    for step in range(mesh.size):
        lo = ((mesh.rank - step) % mesh.size) * r_rows
        local = ids - lo
        mask = (local >= 0) & (local < r_rows)
        out[mask] = cur[local[mask]]
        if step < mesh.size - 1:
            cur = ring_pass(cur, mesh)
    return out


def _local_draws(draws: EpochDraws, row0: int, n_local: int,
                 mode: str) -> EpochDraws:
    """This rank's rows of one epoch's full-shape draws (permutations,
    offsets and InfoNCE draws stay whole)."""
    rows = slice(row0, row0 + n_local)
    if mode == "fit":
        mods = [FitDraws(d.keep_u_f[rows], d.keep_u_b[rows], d.pi, d.pi_inv,
                         d.base, d.intra) for d in draws.modality]
    else:
        mods = [QueryDraws(d.keep_u[rows], d.neg_idx[:, rows])
                for d in draws.modality]
    return EpochDraws(mods, draws.infonce)


def _fit_modality_loss_local(embed_full, task: LayoutTask,
                             static: TaskStatic, draws: FitDraws, rolls, *,
                             a, b, num_rep: int, batch_size: int, row0: int,
                             mesh) -> torch.Tensor:
    """This rank's part of ``layout._fit_modality_loss``: summed over
    the ranks it is the single-device loss (same draws). Every term reads
    the gathered table, so the whole gradient leaves through its one
    reduce-scatter; on one rank the terms are the single-device ones,
    built in the same order, and the gradient is bit-equal to it."""
    n_local = task.nbrs.shape[0]
    n = static.num_rows
    keep_f = (draws.keep_u_f < task.weights).float()
    keep_b = ((draws.keep_u_b < task.weights) & task.bwd_valid).float()
    # Transposed-slot counts anchored at every global row: local partial
    # index_add_ + one (N,) all-reduce.
    bwd_cnt = psum(torch.zeros(n, dtype=torch.float32,
                               device=embed_full.device).index_add_(
        0, task.nbrs.reshape(-1), keep_b.reshape(-1)), mesh)
    rowcnt = all_gather_tensor(keep_f.sum(1), mesh) + bwd_cnt
    inv_row = _inv_window_coef(rowcnt, batch_size, static.num_windows)
    inv_local = inv_row[row0:row0 + n_local]
    coef = keep_f * inv_local[:, None] + keep_b * inv_row[task.nbrs]

    # The single-device terms over this rank's anchor rows of the
    # gathered table (layout_terms: kernels on the card); at one rank the
    # range is the whole table, so the terms are the single-device ones.
    loss_attr = fit_attraction(embed_full, task.nbrs, coef, a, b, row0=row0,
                               rev=task.rev)
    if num_rep == 0:
        return loss_attr
    # Round r's negative for global row i is permuted[(i + rolls[r]) % n]
    # (layout._fit_rolls): the local rows of that roll.
    rep_coef = rowcnt[row0:row0 + n_local] * inv_local
    return loss_attr + fit_repulsion(embed_full, draws.pi, draws.pi_inv,
                                     rolls, rep_coef, a, b, row0=row0)


def _query_rows_loss(embed_local, y_attr, neg_rows, task: LayoutTask,
                     static: TaskStatic, draws: QueryDraws, *, mode: str,
                     a, b, num_rep: int, batch_size: int, mesh
                     ) -> torch.Tensor:
    """The query loss from its rows: ``y_attr`` (Q/P, k, D) attraction
    rows, ``neg_rows(r)`` round r's (Q/P, k, D) negative rows. Anchor
    gradients are local; the window means come from (Q,) all-gathers,
    and the result is divided by P so that the sum over ranks is the
    loss once."""
    keep = (draws.keep_u < task.weights).float()
    x = embed_local[:, None, :]
    if mode == "invert":
        attr = L.inv_attr(x, y_attr, a, b, task.sigmas[task.nbrs])
    else:
        attr = L.umap_attr(x, y_attr, a, b)
    if num_rep > 0:
        rep_sum = torch.zeros_like(attr)
        for r in range(num_rep):
            neg = draws.neg_idx[r]
            if mode == "invert":
                rep = L.inv_rep(x, neg_rows(r), task.sigmas[neg],
                                task.rhos[neg])
            else:
                rep = L.umap_rep(x, neg_rows(r), a, b)
            rep_sum = rep_sum + rep
        per_slot = keep * (attr + rep_sum / num_rep)
    else:
        per_slot = keep * attr
    row_vals = all_gather_rows(per_slot.sum(1), mesh)
    row_cnt = all_gather_tensor(keep.sum(1), mesh)
    win_mean = _window_means_from_rows(row_vals, row_cnt, batch_size,
                                       static.num_windows)
    return win_mean.mean() / mesh.size


def _query_modality_loss_local(embed_local, task: LayoutTask,
                               static: TaskStatic, draws: QueryDraws, *,
                               mode: str, a, b, num_rep: int,
                               batch_size: int, mesh) -> torch.Tensor:
    """Transform/invert with ``task.ref`` WHOLE (gathered once per chunk
    by the runner)."""
    return _query_rows_loss(
        embed_local, task.ref[task.nbrs], lambda r: task.ref[draws.neg_idx[r]],
        task, static, draws, mode=mode, a=a, b=b, num_rep=num_rep,
        batch_size=batch_size, mesh=mesh)


def _query_modality_loss_ring(embed_local, y_attr, task: LayoutTask,
                              static: TaskStatic, draws: QueryDraws, *,
                              mode: str, a, b, num_rep: int,
                              batch_size: int, mesh) -> torch.Tensor:
    """Transform/invert with ``task.ref`` kept as this rank's SHARD:
    attraction rows arrive per chunk (``y_attr``), every round's negative
    rows come in one :func:`_ring_rows` per epoch. ``sigmas``/``rhos``
    are whole ((N,): not worth a ring)."""
    y_negs = (_ring_rows(task.ref, draws.neg_idx, mesh) if num_rep > 0
              else None)
    return _query_rows_loss(
        embed_local, y_attr, lambda r: y_negs[r], task, static, draws,
        mode=mode, a=a, b=b, num_rep=num_rep, batch_size=batch_size,
        mesh=mesh)


def _make_local_loss_fn(statics: typing.Sequence[TaskStatic], *, mode: str,
                        num_rep: int, alpha: float, batch_size: int, mesh,
                        n_neg_infonce: int = 8,
                        infonce_temperature: float = 0.5):
    """``loss(params, tasks, y_attrs, a, b, draws) -> this rank's part``:
    summed over the ranks it is ``layout.make_loss_fn``'s loss, and its
    gradient (through the all-gathers' reduce-scatters) is the
    single-device gradient of this rank's rows. ``draws`` are this
    rank's (:func:`_local_draws`); ``y_attrs[i]`` non-None routes
    modality i through the ring engine."""
    p = mesh.size

    def loss_fn(params, tasks, y_attrs, a, b, draws: EpochDraws,
                sections: prof.Sections | None = None):
        total = params[0].new_zeros(())
        kw = dict(a=a, b=b, num_rep=num_rep, batch_size=batch_size,
                  mesh=mesh)
        if mode == "fit":
            rolls = torch.tensor(pack_rolls(draws, statics, num_rep),
                                 dtype=torch.int64, device=params[0].device)
            fulls = [all_gather_rows(e, mesh) for e in params]
            for i, static in enumerate(statics):
                row0 = mesh.rank * params[i].shape[0]
                total = total + _fit_modality_loss_local(
                    fulls[i], tasks[i], static, draws.modality[i],
                    rolls[i * num_rep:(i + 1) * num_rep], row0=row0, **kw)
            if len(statics) > 1 and alpha != 0.0:
                # On the gathered tables, the same on every rank: 1/P
                # makes the sum over ranks count loss and gradient once.
                nce = (fulls if sections is None else sections.through(
                    fulls, "infonce_fwd", "modality_bwd"))
                pair = iter(draws.infonce)
                terms = []
                for i in range(len(statics)):
                    for j in range(i + 1, len(statics)):
                        d_ij, d_ji = next(pair)
                        l_ij = L.infonce(d_ij, nce[i], nce[j],
                                         n_neg=n_neg_infonce,
                                         temperature=infonce_temperature)
                        l_ji = L.infonce(d_ji, nce[j], nce[i],
                                         n_neg=n_neg_infonce,
                                         temperature=infonce_temperature)
                        terms.append(alpha * (l_ij + l_ji) / p)
                _start(sections, "infonce_bwd")
                for term in terms:
                    total = total + term
                return total
        else:
            for i, static in enumerate(statics):
                if y_attrs is not None and y_attrs[i] is not None:
                    total = total + _query_modality_loss_ring(
                        params[i], y_attrs[i], tasks[i], static,
                        draws.modality[i], mode=mode, **kw)
                else:
                    total = total + _query_modality_loss_local(
                        params[i], tasks[i], static, draws.modality[i],
                        mode=mode, **kw)
        _start(sections, "modality_bwd")
        return total

    return loss_fn


def sharded_compatible(params, tasks, statics, mesh) -> bool:
    """True when the mesh has more than one rank and every task holds
    this rank's equal share of its rows (local params and slot arrays of
    num_rows / P rows, the reference shard of rep_count / P rows, whole
    bandwidths) -- the gate for ``train_layout``'s sharded route."""
    p = 1 if mesh is None else mesh.size
    if p <= 1:
        return False
    for e, t, s in zip(params, tasks, statics):
        rows = e.shape[0]
        if rows != t.nbrs.shape[0] or rows * p != s.num_rows:
            return False
        if t.ref is not None and t.ref.shape[0] * p != s.rep_count:
            return False
        for leaf in (t.sigmas, t.rhos):
            if leaf is not None and leaf.shape[0] != s.rep_count:
                return False
    return True


def sharded_chunk_runner(statics: tuple, mode: str, num_rep: int,
                         alpha: float, batch_size: int, mesh,
                         ref_gather: str = "full"):
    """``train_layout``'s epoch loop on the mesh:
    ``run_chunk(params, optimizer, tasks, a, b, draws, start, take)``
    runs epochs [start, start + take) -- ``draws(epoch)`` gives each
    epoch's full-shape draws, ``optimizer`` (Adam) steps the local
    ``params`` -- and returns the (take,) loss history summed over the
    ranks (one all-reduce per chunk). ``ref_gather``: "full" gathers the
    frozen reference tables once per chunk (O(N * D) per rank); "ring"
    keeps them sharded and fetches rows by ring passes (O(N/P) per
    rank). Fit tasks on the card carry their rank's reverse index
    (``layout.with_reverse_index``, which ``train_layout`` applies).
    ``sections`` (``prof.Sections``) times every epoch's
    ``layout.EPOCH_SECTIONS``, the draws the full-shape ones."""
    if ref_gather not in ("full", "ring"):
        raise ValueError(f"ref_gather must be full|ring, got {ref_gather!r}")
    loss_fn = _make_local_loss_fn(statics, mode=mode, num_rep=num_rep,
                                  alpha=alpha, batch_size=batch_size,
                                  mesh=mesh)

    def run_chunk(params, optimizer, tasks, a, b, draws, start: int,
                  take: int,
                  sections: prof.Sections | None = None) -> torch.Tensor:
        y_attrs = None
        if mode != "fit":
            with torch.no_grad():
                if ref_gather == "ring":
                    # Attraction rows are the same every epoch: one ring.
                    y_attrs = [_ring_rows(t.ref, t.nbrs, mesh) for t in tasks]
                else:
                    tasks = [t._replace(ref=all_gather_tensor(t.ref, mesh))
                             for t in tasks]
        hist = torch.empty(take, dtype=torch.float32,
                           device=params[0].device)
        n_local = params[0].shape[0]
        for t in range(take):
            _start(sections, "draws")
            local = _local_draws(draws(start + t), mesh.rank * n_local,
                                 n_local, mode)
            _start(sections, "modality_fwd")
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(params, tasks, y_attrs, a, b, local, sections)
            loss.backward()
            _start(sections, "adam")
            optimizer.step()
            if sections is not None:
                sections.stop()
            hist[t] = loss.detach()
        return psum(hist, mesh)

    return run_chunk
