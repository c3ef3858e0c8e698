"""Layout optimizer: the embeddings themselves are the parameters.

Counterpart of ``multimodal_umap_tpu/models/layout.py`` (single device,
the fused epoch engine). Semantics:

  * per epoch each nonzero of the symmetric fuzzy matrix is kept by a
    Bernoulli draw with probability equal to its weight; both directed
    copies of a pair are distinct draws;
  * each kept entry contributes one attraction term plus ``num_rep``
    repulsion terms;
  * entries are grouped into row windows of ``batch_size``; a
    modality's loss is the mean over windows of per-window means;
  * in fit mode the symmetric InfoNCE loss is added with effective
    weight 2*alpha (``losses.infonce_pair``: on the card a forward kernel
    a direction and one backward kernel for the pair's two tables);
  * Adam takes ONE full-batch step per epoch on the summed loss.

The fit graph lives in its forward (N, k) layout: transposed copies are
per-slot Bernoulli masks and coefficients, so the loss is a sum over
forward slots of (c_fwd + c_bwd) * f(x_i, x_j). Fit repulsion negatives
are rolls of ONE randomly permuted copy of the table (round r's negative
for row i is permuted[(i + off_r) % n]). Both terms are
``ops.layout_terms``': on the card fused kernels with a gather-only
backward (the attraction's in-edges through a transposed index built
once with the fit task), on the CPU autodiff PyTorch (the neighbour
gather's backward an ``index_add_``, rolls as gathers). Transform and
invert keep iid uniform negatives. Invert mode runs the inverse
attract/repel losses against the frozen training data with the fit-time
bandwidths (sigmas, rhos) of the reference rows.

Randomness is explicit: every loss takes its draws as tensors
(:class:`FitDraws`, :class:`QueryDraws`, ``losses.InfoNCEDraws``), and
``draw_*`` helpers make them from ``torch.Generator``s seeded per epoch
from (seed, epoch), so a run resumed at ``start_epoch`` replays the
draws an uninterrupted run would have used. ``deterministic=True``
replaces Bernoulli keeps with their expectation. The drawn roll offsets
reach the loss as one int64 device vector (:func:`pack_rolls`), read by
the repulsion kernels or by gathers (``scatter_free.dynamic_roll``), as
JAX traces them.

``train_layout`` runs the single-device epochs on CUDA as one captured
CUDA graph replayed once per epoch (:func:`_graph_chunk_runner`, the
counterpart of the JAX package's compiled ``_chunk_runner``), and on
the CPU as an eager loop (:func:`_eager_chunk_runner`); both read the
epoch's draws from buffers allocated once per call
(:class:`_EpochInputs`). Its steps are ``utils.prof`` spans of the
caller's phase: ``prepare`` (Adam, the reverse index, the epoch's
buffers), ``warmup`` and ``capture`` (the graph runner's) and
``epochs``; under an active ``torch.profiler`` the epoch's
:data:`EPOCH_SECTIONS` are timed too (``prof.Sections``: border events,
in a captured epoch event-record nodes, none while no profiler runs).

On a mesh of P > 1 ranks (the counterpart of
``multimodal_umap_tpu/models/layout_sharded.py``'s ``shard_map`` epoch,
one process a rank on ``torch.distributed``) each rank holds its rows of
every table and Adam steps them; the loss and the step are the same
functions, made with the ``mesh`` (:func:`make_loss_fn`), on the rank's
rows of the same full-shape draws, so that summed over the ranks the loss
and its gradient are the single-device ones (at one rank bit-equal). Per
epoch the fit loss makes ONE all-gather of each modality's table
(``parallel.collectives.all_gather_rows``; every term reads the gathered
copy, so the whole gradient leaves through its ONE reduce-scatter), one
(N,) all-reduce (transposed-slot counts) and one (N,) all-gather (row
counts) a modality; the loss history takes one all-reduce a chunk. In
transform / invert the frozen reference tables are gathered once a chunk,
or kept sharded with their rows fetched by :func:`_ring_rows` (attraction
rows once a chunk, each epoch's negative rows in one ring); epochs then
move only (Q,) window sums. The mesh runs eagerly, without recompute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import typing

import torch

from ..ops import layout_terms as LT
from ..ops import losses as L
from ..ops.graph import DenseSymGraph
from ..ops.layout_terms import _recompute
from ..ops.scatter_free import random_permutation_pair
from ..parallel.collectives import (
    all_gather_rows,
    all_gather_tensor,
    psum,
    ring_pass,
)
from ..utils import prof


class LayoutTask(typing.NamedTuple):
    """Per-modality state for the layout optimizer.

    Fit: ``nbrs/weights/bwd_valid`` of the :class:`DenseSymGraph`,
    ``ref`` None. Transform/invert: (Q, k) query graph and the frozen
    reference table ``ref`` (embeddings / training data);
    ``sigmas``/``rhos`` are the fit-time bandwidths (invert only).
    """

    nbrs: torch.Tensor  # (Q, k) int64
    weights: torch.Tensor  # (Q, k) f32
    bwd_valid: torch.Tensor | None  # (N, k) bool, fit only
    ref: torch.Tensor | None
    sigmas: torch.Tensor | None = None
    rhos: torch.Tensor | None = None
    # fit on the card: ``layout_terms.reverse_index`` of ``nbrs`` over the
    # table's rows and its chunk plan (built only by
    # :func:`with_reverse_index`)
    rev: typing.Any = None


class TaskStatic(typing.NamedTuple):
    num_rows: int
    num_windows: int
    rep_count: int


def fit_task(dense: DenseSymGraph, batch_size: int
             ) -> tuple[LayoutTask, TaskStatic]:
    return (
        LayoutTask(nbrs=dense.nbrs.long(), weights=dense.weights,
                   bwd_valid=dense.bwd_valid, ref=None),
        TaskStatic(num_rows=dense.num_rows,
                   num_windows=max(1, -(-dense.num_rows // batch_size)),
                   rep_count=dense.num_rows),
    )


def query_task(nbrs: torch.Tensor, weights: torch.Tensor, batch_size: int,
               ref: torch.Tensor, sigmas: torch.Tensor | None = None,
               rhos: torch.Tensor | None = None, num_rows: int | None = None,
               rep_count: int | None = None
               ) -> tuple[LayoutTask, TaskStatic]:
    """``num_rows`` / ``rep_count`` (default: the rows of ``nbrs`` /
    ``ref``) are the whole query and reference counts when a mesh rank
    passes its shards."""
    q = nbrs.shape[0] if num_rows is None else num_rows
    return (
        LayoutTask(nbrs=nbrs.long(), weights=weights.float(),
                   bwd_valid=None, ref=ref, sigmas=sigmas, rhos=rhos),
        TaskStatic(num_rows=q, num_windows=max(1, -(-q // batch_size)),
                   rep_count=int(ref.shape[0] if rep_count is None
                                 else rep_count)),
    )


@dataclasses.dataclass
class FitDraws:
    """One modality's fit-epoch draws: (N, k) keep uniforms for the
    forward and transposed copies, the repulsion permutation pair, the
    shared base offset and the per-round intra-stratum offsets."""

    keep_u_f: torch.Tensor
    keep_u_b: torch.Tensor
    pi: torch.Tensor
    pi_inv: torch.Tensor
    base: int
    intra: list[int]


@dataclasses.dataclass
class QueryDraws:
    """One modality's transform- or invert-epoch draws: (Q, k) keep
    uniforms and (num_rep, Q, k) iid negative ids."""

    keep_u: torch.Tensor
    neg_idx: torch.Tensor


@dataclasses.dataclass
class EpochDraws:
    """All draws of one epoch: per modality, and per modality pair the
    InfoNCE draws of both directions (i->j, j->i)."""

    modality: list
    infonce: list[tuple[L.InfoNCEDraws, L.InfoNCEDraws]]


@dataclasses.dataclass
class EpochRng:
    """Generators of one epoch: ``device`` for tensor draws, ``host``
    (CPU) for the scalar offsets. A None generator leaves its draws to
    be made elsewhere: the ``draw_*`` helpers then keep what their
    ``out`` holds (a captured graph makes the device draws)."""

    device: torch.Generator | None
    host: torch.Generator | None
    dev: torch.device


def _epoch_seed(seed: int, epoch: int) -> int:
    return (int(seed) * 0x9E3779B1 + int(epoch) * 0x85EBCA77 + 1) % (2**63)


def epoch_rng(seed: int, epoch: int, device: torch.device) -> EpochRng:
    """Generators of epoch ``epoch``, seeded from (seed, epoch) only."""
    s = _epoch_seed(seed, epoch)
    return EpochRng(device=torch.Generator(device=device).manual_seed(s),
                    host=torch.Generator().manual_seed(s),
                    dev=device)


def draw_fit(rng: EpochRng, static: TaskStatic, k: int, num_rep: int,
             out: FitDraws | None = None) -> FitDraws:
    """One modality's fit draws; ``out``'s buffers receive the tensors."""
    n, m = static.num_rows, static.rep_count
    if out is None:
        out = FitDraws(torch.empty(n, k, device=rng.dev),
                       torch.empty(n, k, device=rng.dev),
                       torch.empty(m, dtype=torch.int64, device=rng.dev),
                       torch.empty(m, dtype=torch.int64, device=rng.dev),
                       0, [])
    if rng.device is not None:
        torch.rand(n, k, generator=rng.device, out=out.keep_u_f)
        torch.rand(n, k, generator=rng.device, out=out.keep_u_b)
        random_permutation_pair(m, rng.device, rng.dev,
                                out=(out.pi, out.pi_inv))
    if rng.host is None:
        return out
    stride = max(1, m // max(num_rep, 1))
    base = int(torch.randint(0, m, (), generator=rng.host))
    intra = torch.randint(0, stride, (num_rep,), generator=rng.host).tolist()
    return dataclasses.replace(out, base=base, intra=intra)


def draw_query(rng: EpochRng, static: TaskStatic, k: int, num_rep: int,
               out: QueryDraws | None = None) -> QueryDraws:
    """One modality's transform / invert draws (device only)."""
    q = static.num_rows
    if out is None:
        out = QueryDraws(torch.empty(q, k, device=rng.dev),
                         torch.empty(num_rep, q, k, dtype=torch.int64,
                                     device=rng.dev))
    if rng.device is not None:
        torch.rand(q, k, generator=rng.device, out=out.keep_u)
        torch.randint(0, static.rep_count, (num_rep, q, k),
                      generator=rng.device, out=out.neg_idx)
    return out


def draw_epoch(rng: EpochRng, tasks, statics, *, mode: str, num_rep: int,
               alpha: float, n_neg_infonce: int = 8,
               infonce_group_size: int = 1000,
               out: EpochDraws | None = None) -> EpochDraws:
    """Every draw of one epoch, in a fixed order; ``out`` (an earlier
    epoch's draws) receives the tensors in its buffers."""
    draw = draw_fit if mode == "fit" else draw_query
    per_mod = [draw(rng, s, t.nbrs.shape[1], num_rep,
                    None if out is None else out.modality[i])
               for i, (t, s) in enumerate(zip(tasks, statics))]
    pairs = []
    if mode == "fit" and len(statics) > 1 and alpha != 0.0:
        bufs = iter(out.infonce) if out is not None else None
        for i in range(len(statics)):
            for j in range(i + 1, len(statics)):
                num = min(statics[i].num_rows, statics[j].num_rows)
                pair = next(bufs) if bufs is not None else (None, None)
                pairs.append(tuple(
                    L.draw_infonce(num, n_neg_infonce, infonce_group_size,
                                   rng.device, rng.host, rng.dev, out=b)
                    for b in pair))
    return EpochDraws(per_mod, pairs)


def _fit_rolls(draws: FitDraws, static: TaskStatic,
               num_rep: int) -> list[int]:
    """Round r's repulsion offset: the rounds lie in disjoint strata
    shifted by a shared uniform base, so two rounds never share one."""
    stride = max(1, static.rep_count // max(num_rep, 1))
    return [(draws.base + r * stride + draws.intra[r]) % static.rep_count
            for r in range(num_rep)]


def pack_rolls(draws: EpochDraws, statics, num_rep: int) -> list[int]:
    """The epoch's roll offsets in the order the loss reads them: each
    fit modality's ``num_rep`` repulsion offsets, then each InfoNCE
    direction's ``losses.infonce_rolls``."""
    rolls = []
    for d, s in zip(draws.modality, statics):
        if isinstance(d, FitDraws):
            rolls += _fit_rolls(d, s, num_rep)
    for pair in draws.infonce:
        for d in pair:
            rolls += L.infonce_rolls(d)
    return rolls


def _window_means_from_rows(row_vals, row_cnt, batch_size: int,
                            num_windows: int) -> torch.Tensor:
    """Per-window mean of per-entry values given per-row sums/counts."""
    padded = num_windows * batch_size

    def wsum(x):
        return torch.nn.functional.pad(x, (0, padded - x.shape[0])).view(
            num_windows, batch_size).sum(1)

    win_sum = wsum(row_vals)
    cnt = wsum(row_cnt)
    return torch.where(cnt > 0, win_sum / cnt.clamp_min(1.0), 0.0)


def _inv_window_coef(row_cnt, batch_size: int, num_windows: int
                     ) -> torch.Tensor:
    """(N,) per-row coefficient 1/(cnt_window(row) * W), 0 on empty."""
    n = row_cnt.shape[0]
    padded = num_windows * batch_size
    cnt_w = torch.nn.functional.pad(row_cnt, (0, padded - n)).view(
        num_windows, batch_size).sum(1)
    inv = torch.where(cnt_w > 0, 1.0 / cnt_w.clamp_min(1.0), 0.0)
    inv = inv / num_windows
    # expand, not repeat_interleave: no host sync inside a graph capture
    return inv[:, None].expand(num_windows, batch_size).reshape(-1)[:n]


# Above this many bytes of the (N, k, D) attraction gather the plain fit
# loss loops over the k neighbour slots, each recomputed in the backward
# (multimodal_umap_tpu/models/layout.py:183): per-slot transients are
# (N, D). The CUDA kernel never makes the gather, so this bounds the CPU.
_ATTR_SLOT_BYTES = 1 << 30

# Above this many rows each modality's fit loss is recomputed in the
# backward (layout.py:189), so the modalities' autograd residuals are
# never held together: peak is the largest modality's, not their sum.
_MODALITY_REMAT_ROWS = 1 << 18


def with_reverse_index(tasks, statics):
    """Fit tasks on the card with the transposed index of their neighbour
    ids and its chunk plan (``layout_terms.reverse_index`` over the
    table's rows), which the attraction kernel's backward reads. The one
    place they are built: :func:`train_layout` calls this, and so does a
    direct caller of the sharded engine's runner, once for all epochs and
    before any capture (the plan's sizes take a host sync), since the
    graph is fixed. A task that has them keeps them."""
    return tuple(
        t._replace(rev=LT.reverse_index(t.nbrs, s.num_rows))
        if t.rev is None and t.nbrs.is_cuda
        else t for t, s in zip(tasks, statics))


def _fit_coefs(task: LayoutTask, static: TaskStatic, draws: FitDraws, *,
               batch_size: int, deterministic: bool, row0: int = 0,
               mesh=None):
    """One epoch's (rows, k) attraction and (rows,) repulsion coefficients
    of the task's anchor rows ``[row0, row0 + rows)``: each kept entry's
    window weight 1/(cnt_window * W)."""
    mine = slice(row0, row0 + task.nbrs.shape[0])
    if deterministic:
        keep_f = task.weights
        keep_b = task.weights * task.bwd_valid.float()
    else:
        keep_f = (draws.keep_u_f[mine] < task.weights).float()
        keep_b = ((draws.keep_u_b[mine] < task.weights)
                  & task.bwd_valid).float()

    # Kept-entry counts anchored at each row: forward slots directly,
    # transposed slots grouped by column (no gradient path); on a mesh
    # one (N,) all-reduce and one (N,) all-gather give every row's.
    bwd_cnt = torch.zeros(static.num_rows, dtype=torch.float32,
                          device=task.nbrs.device).index_add_(
        0, task.nbrs.reshape(-1), keep_b.reshape(-1))
    if mesh is None:
        rowcnt = keep_f.sum(1) + bwd_cnt
    else:
        bwd_cnt = psum(bwd_cnt, mesh)
        rowcnt = all_gather_tensor(keep_f.sum(1), mesh) + bwd_cnt
    inv_row = _inv_window_coef(rowcnt, batch_size, static.num_windows)
    # Both copies of a pair share f(x_i, x_j); the forward copy is
    # windowed by i, the transposed copy by j.
    coef = keep_f * inv_row[mine, None] + keep_b * inv_row[task.nbrs]
    return coef, rowcnt[mine] * inv_row[mine]


def _fit_modality_loss(embed, task: LayoutTask, static: TaskStatic,
                       draws: FitDraws, *, a, b, num_rep: int,
                       batch_size: int, deterministic: bool,
                       slot_bytes: int | None = None,
                       rolls: torch.Tensor | None = None, row0: int = 0,
                       mesh=None) -> torch.Tensor:
    """The fit loss of the task's anchor rows ``[row0, row0 + rows)`` of
    the whole table ``embed`` (on a mesh the rank's rows of its gathered
    copy; summed over the ranks, the loss once). ``rolls``: the
    (num_rep,) int64 device vector of the repulsion offsets (None: made
    from ``draws``' ints). The attraction and the repulsion are
    ``ops.layout_terms``' (kernels on the card)."""
    if rolls is None:
        rolls = torch.tensor(_fit_rolls(draws, static, num_rep),
                             dtype=torch.int64, device=embed.device)
    coef, rep_coef = _fit_coefs(task, static, draws, batch_size=batch_size,
                                deterministic=deterministic, row0=row0,
                                mesh=mesh)
    loss_attr = LT.fit_attraction(
        embed, task.nbrs, coef, a, b, row0=row0, rev=task.rev,
        slot_bytes=_ATTR_SLOT_BYTES if slot_bytes is None else slot_bytes)
    if num_rep == 0:
        return loss_attr
    # Round r's negative for row i is permuted[(i + rolls[r]) % n]
    # (:func:`_fit_rolls`).
    return loss_attr + LT.fit_repulsion(embed, draws.pi, draws.pi_inv, rolls,
                                        rep_coef, a, b, row0=row0)


def _query_modality_loss(embed, task: LayoutTask, static: TaskStatic,
                         draws: QueryDraws, *, a, b, num_rep: int,
                         batch_size: int, deterministic: bool,
                         mode: str = "transform", row0: int = 0, mesh=None,
                         attr_rows: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Transform/invert: queries attract to frozen reference rows and
    repel from iid-uniform reference rows; nothing reaches ``ref``.
    Invert uses the inverse losses with the reference rows' fit-time
    sigma (attraction) and sigma/rho (repulsion).

    On a mesh ``embed`` and the task's slots are the rank's query rows
    from ``row0``: the window sums are all-gathered and the loss divided
    by P, so that the sum over the ranks is the loss once. ``attr_rows``
    (the ring engine's): the slots' (rows, k, D) attraction rows, with
    ``task.ref`` the rank's shard, whose negative rows one
    :func:`_ring_rows` fetches."""
    mine = slice(row0, row0 + task.nbrs.shape[0])
    keep = (task.weights if deterministic
            else (draws.keep_u[mine] < task.weights).float())
    neg_idx = draws.neg_idx[:, mine]
    y_negs = (_ring_rows(task.ref, neg_idx, mesh)
              if attr_rows is not None and num_rep > 0 else None)

    # The reference rows of ``ids``: ``fetched`` (by ring) or gathered
    # from the whole table. Each is an argument, freed once its term is
    # made.
    def rows(ids, fetched):
        return task.ref[ids] if fetched is None else fetched

    x = embed[:, None, :]
    if mode == "invert":
        attr = L.inv_attr(x, rows(task.nbrs, attr_rows), a, b,
                          task.sigmas[task.nbrs])
    else:
        attr = L.umap_attr(x, rows(task.nbrs, attr_rows), a, b)
    if num_rep > 0:
        rep_sum = torch.zeros_like(attr)
        for r in range(num_rep):
            neg = neg_idx[r]
            fetched = None if y_negs is None else y_negs[r]
            if mode == "invert":
                rep = L.inv_rep(x, rows(neg, fetched), task.sigmas[neg],
                                task.rhos[neg])
            else:
                rep = L.umap_rep(x, rows(neg, fetched), a, b)
            rep_sum = rep_sum + rep
        per_slot = keep * (attr + rep_sum / num_rep)
    else:
        per_slot = keep * attr
    row_vals, row_cnt = per_slot.sum(1), keep.sum(1)
    if mesh is not None:
        row_vals = all_gather_rows(row_vals, mesh)
        row_cnt = all_gather_tensor(row_cnt, mesh)
    win_mean = _window_means_from_rows(row_vals, row_cnt, batch_size,
                                       static.num_windows)
    return win_mean.mean() if mesh is None else win_mean.mean() / mesh.size


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


_MODES = ("fit", "transform", "invert")


@dataclasses.dataclass
class AdamState:
    """``torch.optim.Adam``'s state of the layout parameters in optax's
    leaf order: the step count, then the first moment (mu) and the second
    moment (nu) of each modality."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """The layout's Adam: ``torch.optim.Adam``'s defaults (betas
    0.9/0.999, eps 1e-8) are optax.adam's, the same bias-corrected
    update. On CUDA it is capturable (the step count lives on the device
    and the bias correction is computed there in f32), so the update can
    be captured in a CUDA graph; an eager loop on the card takes the same
    update."""
    return torch.optim.Adam(params, lr=lr,
                            capturable=params[0].device.type == "cuda")


def adam_state(optimizer: torch.optim.Adam, params) -> AdamState:
    """The optimizer's state for ``params`` (all initialized)."""
    states = [optimizer.state[p] for p in params]
    return AdamState(count=int(states[0]["step"]),
                     mu=[s["exp_avg"] for s in states],
                     nu=[s["exp_avg_sq"] for s in states])


def _set_adam_state(optimizer: torch.optim.Adam, params,
                    state: AdamState) -> None:
    # The step lives beside its parameter: on the CPU, as torch.optim
    # keeps it there; on CUDA, as a capturable Adam needs it.
    for p, mu, nu in zip(params, state.mu, state.nu):
        optimizer.state[p] = {
            "step": torch.tensor(float(state.count), dtype=torch.float32,
                                 device=p.device),
            "exp_avg": mu.detach().to(p.device, torch.float32).clone(),
            "exp_avg_sq": nu.detach().to(p.device, torch.float32).clone(),
        }


def make_loss_fn(statics: typing.Sequence[TaskStatic], *, mode: str,
                 num_rep: int, alpha: float, batch_size: int,
                 n_neg_infonce: int = 8, infonce_temperature: float = 0.5,
                 deterministic: bool = False,
                 remat_rows: int | None = None,
                 slot_bytes: int | None = None, mesh=None):
    """The total loss of one epoch:
    ``loss(params, tasks, a, b, draws: EpochDraws, rolls=None,
    sections=None, attr_rows=None) -> scalar``, ``rolls`` the epoch's
    :func:`pack_rolls` as an int64 device vector (None: made from
    ``draws``' ints), ``sections`` a ``prof.Sections`` that marks
    InfoNCE's borders (:data:`EPOCH_SECTIONS`; None: nothing is marked).

    Fit mode recomputes a modality's loss in the backward past
    ``remat_rows`` rows (default :data:`_MODALITY_REMAT_ROWS`) and scans
    its attraction's slots past ``slot_bytes`` (default
    :data:`_ATTR_SLOT_BYTES`); both defaults are read at each call.

    With a ``mesh`` the loss is this rank's part (the module's
    docstring): ``params`` and ``tasks`` hold the rank's rows, ``draws``
    are the epoch's full-shape ones, and summed over the ranks loss and
    gradient are the single-device ones; InfoNCE runs on the gathered
    tables, divided by P. ``attr_rows[i]`` non-None (the ring engine's
    attraction rows of query modality i) leaves ``tasks[i].ref`` a
    shard."""
    if mode not in _MODES:
        raise ValueError(f"invalid mode: {mode}")

    def loss_fn(params, tasks, a, b, draws: EpochDraws, rolls=None,
                sections: prof.Sections | None = None, attr_rows=None):
        if rolls is None:
            rolls = torch.tensor(pack_rolls(draws, statics, num_rep),
                                 dtype=torch.int64, device=params[0].device)
        tables = params
        if mesh is not None and mode == "fit":
            tables = [all_gather_rows(e, mesh) for e in params]
        pos = 0  # rolls read so far
        total = params[0].new_zeros(())
        for i, static in enumerate(statics):
            kw = dict(a=a, b=b, num_rep=num_rep, batch_size=batch_size,
                      deterministic=deterministic, mesh=mesh,
                      row0=0 if mesh is None
                      else mesh.rank * params[i].shape[0])
            if mode == "fit":
                args = (tables[i], tasks[i], static, draws.modality[i])
                kw["slot_bytes"] = slot_bytes
                kw["rolls"] = rolls[pos:pos + num_rep]
                pos += num_rep
                rows = (_MODALITY_REMAT_ROWS if remat_rows is None
                        else remat_rows)
                # Not on a mesh: the recomputed forward would issue its
                # count collectives again in the backward.
                if static.num_rows > rows and mesh is None:
                    loss = _recompute(_fit_modality_loss, *args, **kw)
                else:
                    loss = _fit_modality_loss(*args, **kw)
            else:
                loss = _query_modality_loss(
                    params[i], tasks[i], static, draws.modality[i],
                    mode=mode, attr_rows=None if attr_rows is None
                    else attr_rows[i], **kw)
            total = total + loss
        if mode == "fit" and len(statics) > 1 and alpha != 0.0:
            # Symmetric InfoNCE added to both modality buckets => 2*alpha
            # effective weight.
            nce = (tables if sections is None else
                   sections.through(tables, "infonce_fwd", "modality_bwd"))
            pair = iter(draws.infonce)
            terms = []
            for i in range(len(statics)):
                for j in range(i + 1, len(statics)):
                    d_ij, d_ji = next(pair)
                    r_ij, r_ji = (rolls[pos + c * (n_neg_infonce + 2):
                                        pos + (c + 1) * (n_neg_infonce + 2)]
                                  for c in range(2))
                    pos += 2 * (n_neg_infonce + 2)
                    l_ij, l_ji = L.infonce_pair(
                        d_ij, d_ji, nce[i], nce[j], n_neg=n_neg_infonce,
                        temperature=infonce_temperature, rolls=(r_ij, r_ji))
                    term = alpha * (l_ij + l_ji)
                    # the same on every rank: 1/P counts it once
                    terms.append(term if mesh is None else term / mesh.size)
            _start(sections, "infonce_bwd")
            for term in terms:
                total = total + term
        else:
            _start(sections, "modality_bwd")
        return total

    return loss_fn


class _EpochInputs:
    """One epoch's inputs at fixed addresses, for the chunk runners: the
    draws in buffers allocated once per ``train_layout`` call and
    refilled in place each epoch, and the roll offsets packed into one
    int64 device vector (``rolls``, :func:`pack_rolls`).

    :meth:`set_epoch` (host side: never captured) draws the epoch's ints
    on the CPU and copies them in, and re-seeds the device generator
    ``gen`` from (seed, epoch); :meth:`draw_device` then makes the device
    draws from ``gen`` (captured in the CUDA graph), so both runners draw
    the numbers ``epoch_rng`` gives. A caller's ``draws(epoch)`` is
    copied in whole by :meth:`set_epoch` instead."""

    def __init__(self, tasks, statics, *, mode: str, num_rep: int,
                 alpha: float, seed: int, device: torch.device, draws=None,
                 first_epoch: int = 0):
        self.tasks, self.statics, self.num_rep = tasks, statics, num_rep
        self.seed, self.device, self.user = seed, device, draws
        self.kw = dict(mode=mode, num_rep=num_rep, alpha=alpha)
        self.gen = torch.Generator(device=device)
        self.draws = (_copy_draws(draws(first_epoch)) if draws is not None
                      else draw_epoch(epoch_rng(seed, first_epoch, device),
                                      tasks, statics, **self.kw))
        self.rolls = torch.tensor(pack_rolls(self.draws, statics, num_rep),
                                  dtype=torch.int64, device=device)

    def set_epoch(self, epoch: int) -> None:
        if self.user is not None:
            self.draws = _copy_draws(self.user(epoch), self.draws)
        else:
            s = _epoch_seed(self.seed, epoch)
            self.gen.manual_seed(s)
            self.draws = draw_epoch(
                EpochRng(None, torch.Generator().manual_seed(s), self.device),
                self.tasks, self.statics, out=self.draws, **self.kw)
        if self.rolls.numel():
            host = torch.tensor(pack_rolls(self.draws, self.statics,
                                           self.num_rep), dtype=torch.int64)
            if self.device.type == "cuda":
                # A fresh pinned tensor per epoch: the caching host
                # allocator keeps it until its copy has run, so a later
                # epoch's ints never overwrite an earlier one's in flight.
                host = host.pin_memory()
            self.rolls.copy_(host, non_blocking=True)

    def draw_device(self) -> None:
        if self.user is None:
            draw_epoch(EpochRng(self.gen, None, self.device), self.tasks,
                       self.statics, out=self.draws, **self.kw)


def _copy_draws(src: EpochDraws, bufs: EpochDraws | None = None
                ) -> EpochDraws:
    """``src`` with its tensors copied into ``bufs``' (in place; None:
    into fresh clones) and its ints kept."""
    def one(d, b):
        return dataclasses.replace(d, **{
            f.name: (v.clone() if b is None else getattr(b, f.name).copy_(v))
            for f in dataclasses.fields(d)
            if isinstance(v := getattr(d, f.name), torch.Tensor)})

    if bufs is None:
        bufs = EpochDraws([None] * len(src.modality),
                          [(None, None)] * len(src.infonce))
    return EpochDraws(
        [one(d, b) for d, b in zip(src.modality, bufs.modality)],
        [tuple(one(d, b) for d, b in zip(p, bp))
         for p, bp in zip(src.infonce, bufs.infonce)])


# The sections of a layout epoch in the order they run (``prof.Sections``):
# the device draws; the modality terms' forward (coefficients, K2 / K3);
# InfoNCE's forward; from InfoNCE's output (the loss's last adds and the
# backward's seed included) to the end of its backward; the rest of the
# backward (the modality terms', K2 / K3's included); Adam. Without
# InfoNCE the backward is all ``modality_bwd``.
EPOCH_SECTIONS = ("draws", "modality_fwd", "infonce_fwd", "infonce_bwd",
                  "modality_bwd", "adam")


def _start(sections: prof.Sections | None, name: str) -> None:
    if sections is not None:
        sections.start(name)


def _epoch_step(params, optimizer, loss_fn, tasks, a, b,
                inputs: _EpochInputs,
                sections: prof.Sections | None = None) -> torch.Tensor:
    """One epoch on ``inputs``' buffers: device draws, loss, backward,
    Adam update, each section marked in ``sections``. Returns the
    (detached) loss."""
    _start(sections, "draws")
    inputs.draw_device()
    _start(sections, "modality_fwd")
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, tasks, a, b, inputs.draws, inputs.rolls,
                   sections=sections)
    loss.backward()
    _start(sections, "adam")
    optimizer.step()
    if sections is not None:
        sections.stop()
    return loss.detach()


@contextlib.contextmanager
def _eager_chunk_runner(params, optimizer, loss_fn, tasks, a, b,
                        inputs: _EpochInputs, first_epoch: int,
                        sections: prof.Sections | None = None, mesh=None,
                        ring: bool = False):
    """One eager step per epoch (the CPU's runner, and the mesh's on any
    device): yields ``run_chunk(start, take) -> (take,) losses``;
    ``sections`` times every epoch. With a ``mesh`` (``loss_fn`` made
    with it) the history is summed over the ranks, one all-reduce a
    chunk, and query tasks' reference tables are gathered whole once a
    chunk or, with ``ring``, kept sharded, their attraction rows fetched
    by :func:`_ring_rows` once a chunk."""
    del first_epoch

    def run_chunk(start: int, take: int) -> torch.Tensor:
        chunk_tasks, chunk_loss = tasks, loss_fn
        if mesh is not None and tasks[0].ref is not None:
            with torch.no_grad():
                if ring:
                    chunk_loss = functools.partial(loss_fn, attr_rows=[
                        _ring_rows(t.ref, t.nbrs, mesh) for t in tasks])
                else:
                    chunk_tasks = [
                        t._replace(ref=all_gather_tensor(t.ref, mesh))
                        for t in tasks]
        hist = torch.empty(take, dtype=torch.float32,
                           device=params[0].device)
        for t in range(take):
            inputs.set_epoch(start + t)
            hist[t] = _epoch_step(params, optimizer, chunk_loss, chunk_tasks,
                                  a, b, inputs, sections)
        return hist if mesh is None else psum(hist, mesh)

    yield run_chunk


# Eager epochs run before the capture, on a side stream, so that every
# lazy initialisation (Adam's foreach path, the autograd engine's device
# threads, kernel modules) happens outside it; they are undone after.
_WARMUP_EPOCHS = 2


@contextlib.contextmanager
def _graph_chunk_runner(params, optimizer, loss_fn, tasks, a, b,
                        inputs: _EpochInputs, first_epoch: int,
                        sections: prof.Sections | None = None):
    """The counterpart of the JAX package's ``_chunk_runner`` (a jitted
    ``lax.scan`` of epoch steps: one compiled device program): one epoch
    -- device draws, loss, backward, Adam update, the loss into a static
    scalar -- captured once as a CUDA graph on this call's tasks and
    replayed once per epoch after :meth:`_EpochInputs.set_epoch`. Yields
    ``run_chunk(start, take) -> (take,) losses`` with no host sync inside
    a chunk. The warm-up epochs are undone from host copies of the
    parameters and Adam's state. ``sections`` marks the captured epoch
    (its borders become event-record nodes) and counts its replays; the
    warm-up epochs are not marked. A capture that fails raises; the graph
    and its memory pool are released on exit."""
    device = params[0].device
    with prof.span("prepare"):
        if not optimizer.state:
            _set_adam_state(optimizer, params, AdamState(
                0, [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params]))
    live = [*params, *(optimizer.state[p][k] for p in params
                       for k in ("step", "exp_avg", "exp_avg_sq"))]
    with prof.span("warmup"):
        saved = [t.detach().cpu() for t in live]
        inputs.set_epoch(first_epoch)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_EPOCHS):
                _epoch_step(params, optimizer, loss_fn, tasks, a, b, inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        del saved
    if sections is not None:
        sections.captured = True
    static_loss = torch.zeros((), device=device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(inputs.gen)
    try:
        # The span's own events are recorded outside the capture.
        with prof.span("capture"), torch.cuda.graph(graph):
            static_loss.copy_(_epoch_step(params, optimizer, loss_fn, tasks,
                                          a, b, inputs, sections))

        def run_chunk(start: int, take: int) -> torch.Tensor:
            hist = torch.empty(take, dtype=torch.float32, device=device)
            for t in range(take):
                inputs.set_epoch(start + t)
                graph.replay()
                hist[t] = static_loss
            if sections is not None:
                sections.replays += take
            return hist

        yield run_chunk
    finally:
        graph.reset()
        optimizer.zero_grad(set_to_none=True)


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


def train_layout(
    init_embeds: typing.Sequence[torch.Tensor],
    tasks: typing.Sequence[LayoutTask],
    statics: typing.Sequence[TaskStatic],
    *,
    mode: str,
    epochs: int,
    num_rep: int,
    lr: float,
    alpha: float,
    batch_size: int,
    a: float,
    b: float,
    seed: int = 0,
    draws=None,
    epoch_chunk: int | None = None,
    chunk_callback=None,
    start_epoch: int = 0,
    init_opt_state: AdamState | None = None,
    mesh=None,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Full-batch Adam layout optimization, one step per epoch: on CUDA
    one replay of a captured CUDA graph per epoch
    (:func:`_graph_chunk_runner`), on the CPU an eager loop
    (:func:`_eager_chunk_runner`), on the same draws.

    ``draws(epoch) -> EpochDraws`` supplies each epoch's randomness;
    None draws from generators seeded by (``seed``, epoch). Every
    ``epoch_chunk`` epochs (default ``MMUMAP_EPOCH_CHUNK``, else 100)
    ``chunk_callback(done, params, optimizer, losses)`` fires; the loss
    history stays on the device until then (no host sync inside the
    epoch loop). The chunk sets only that cadence.

    ``start_epoch``/``init_opt_state`` resume a run: the draws of epoch
    e depend on (seed, e) only, so a resumed run replays exactly the
    epochs the original would have run.

    ``mesh`` with more than one rank, with tasks and inits holding this
    rank's rows (:func:`sharded_compatible`), makes the loss with the
    mesh and runs it eagerly (:func:`_eager_chunk_runner`): in query
    modes it keeps the reference tables sharded and fetches their rows by
    ring once a table is over ``MMUMAP_REF_GATHER_BYTES`` (default 1
    GiB) whole. Anything else runs the single-device runner (on every
    rank).

    Returns (final embeddings per modality, (epochs - start_epoch,) f32
    loss history on the CPU).
    """
    if mode not in _MODES:
        raise ValueError(f"invalid mode: {mode}")
    if epoch_chunk is None:
        epoch_chunk = max(1, int(os.environ.get("MMUMAP_EPOCH_CHUNK", 100)))
    device = init_embeds[0].device
    params = [e.detach().float().clone().requires_grad_(True)
              for e in init_embeds]
    if start_epoch >= epochs:
        # A snapshot already recorded the final epoch; the loaded params
        # come back untouched.
        return [p.detach() for p in params], torch.zeros(0)
    with prof.span("prepare"):
        optimizer = make_optimizer(params, lr)
        if init_opt_state is not None:
            _set_adam_state(optimizer, params, init_opt_state)
        tasks = tuple(tasks)
        if mode == "fit":
            tasks = with_reverse_index(tasks, statics)
        if not sharded_compatible(params, tasks, statics, mesh):
            mesh = None
        loss_fn = make_loss_fn(statics, mode=mode, num_rep=num_rep,
                               alpha=alpha, batch_size=batch_size, mesh=mesh)
        inputs = _EpochInputs(tasks, statics, mode=mode, num_rep=num_rep,
                              alpha=alpha, seed=seed, device=device,
                              draws=draws, first_epoch=start_epoch)
        sections = prof.traced_sections(device)
        if mesh is not None:
            thresh = float(os.environ.get("MMUMAP_REF_GATHER_BYTES", 1 << 30))
            chunk_runner = functools.partial(
                _eager_chunk_runner, mesh=mesh, ring=any(
                    t.ref is not None and
                    t.ref.numel() * t.ref.element_size() * mesh.size > thresh
                    for t in tasks))
        elif device.type == "cuda":
            chunk_runner = _graph_chunk_runner
        else:
            chunk_runner = _eager_chunk_runner
        runner = chunk_runner(params, optimizer, loss_fn, tasks, a, b,
                              inputs, start_epoch, sections)

    history = []
    done = start_epoch
    with runner as run_chunk, prof.span("epochs"):
        if sections is not None:
            prof.defer(sections.seconds)
        while done < epochs:
            take = min(epoch_chunk, epochs - done)
            hist = run_chunk(done, take)
            done += take
            history.append(hist)
            if chunk_callback is not None:
                chunk_callback(done, params, optimizer, hist)
    return [p.detach() for p in params], torch.cat(history).cpu()
