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
    weight 2*alpha;
  * Adam takes ONE full-batch step per epoch on the summed loss.

The fit graph lives in its forward (N, k) layout: transposed copies are
per-slot Bernoulli masks and coefficients, so the loss is a sum over
forward slots of (c_fwd + c_bwd) * f(x_i, x_j) and the neighbor gather
is the only gradient aggregation (an ``index_add_`` in the backward).
Fit repulsion negatives are rolls of ONE randomly permuted copy of the
table (round r's negative for row i is permuted[(i + off_r) % n]);
transform and invert keep iid uniform negatives. Invert mode runs the
inverse attract/repel losses against the frozen training data with the
fit-time bandwidths (sigmas, rhos) of the reference rows.

Randomness is explicit: every loss takes its draws as tensors
(:class:`FitDraws`, :class:`QueryDraws`, ``losses.InfoNCEDraws``), and
``draw_*`` helpers make them from ``torch.Generator``s seeded per epoch
from (seed, epoch), so a run resumed at ``start_epoch`` replays the
draws an uninterrupted run would have used. ``deterministic=True``
replaces Bernoulli keeps with their expectation.
"""

from __future__ import annotations

import dataclasses
import os
import typing

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import losses as L
from ..ops.graph import DenseSymGraph
from ..ops.scatter_free import permutation_gather, random_permutation_pair


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
    (CPU) for the scalar offsets."""

    device: torch.Generator
    host: torch.Generator
    dev: torch.device


def epoch_rng(seed: int, epoch: int, device: torch.device) -> EpochRng:
    """Generators of epoch ``epoch``, seeded from (seed, epoch) only."""
    s = (int(seed) * 0x9E3779B1 + int(epoch) * 0x85EBCA77 + 1) % (2**63)
    return EpochRng(device=torch.Generator(device=device).manual_seed(s),
                    host=torch.Generator().manual_seed(s),
                    dev=device)


def draw_fit(rng: EpochRng, static: TaskStatic, k: int,
             num_rep: int) -> FitDraws:
    n = static.num_rows
    u_f = torch.rand(n, k, generator=rng.device, device=rng.dev)
    u_b = torch.rand(n, k, generator=rng.device, device=rng.dev)
    pi, pi_inv = random_permutation_pair(static.rep_count, rng.device, rng.dev)
    stride = max(1, static.rep_count // max(num_rep, 1))
    base = int(torch.randint(0, static.rep_count, (), generator=rng.host))
    intra = torch.randint(0, stride, (num_rep,), generator=rng.host).tolist()
    return FitDraws(u_f, u_b, pi, pi_inv, base, intra)


def draw_query(rng: EpochRng, static: TaskStatic, k: int,
               num_rep: int) -> QueryDraws:
    q = static.num_rows
    keep_u = torch.rand(q, k, generator=rng.device, device=rng.dev)
    neg_idx = torch.randint(0, static.rep_count, (num_rep, q, k),
                            generator=rng.device, device=rng.dev)
    return QueryDraws(keep_u, neg_idx)


def draw_epoch(rng: EpochRng, tasks, statics, *, mode: str, num_rep: int,
               alpha: float, n_neg_infonce: int = 8,
               infonce_group_size: int = 1000) -> EpochDraws:
    """Every draw of one epoch, in a fixed order."""
    draw = draw_fit if mode == "fit" else draw_query
    per_mod = [draw(rng, s, t.nbrs.shape[1], num_rep)
               for t, s in zip(tasks, statics)]
    pairs = []
    if mode == "fit" and len(statics) > 1 and alpha != 0.0:
        for i in range(len(statics)):
            for j in range(i + 1, len(statics)):
                num = min(statics[i].num_rows, statics[j].num_rows)
                pairs.append(tuple(
                    L.draw_infonce(num, n_neg_infonce, infonce_group_size,
                                   rng.device, rng.host, rng.dev)
                    for _ in range(2)))
    return EpochDraws(per_mod, pairs)


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
    return inv.repeat_interleave(batch_size)[:n]


# Above this many bytes of the (N, k, D) attraction gather the fit loss
# loops over the k neighbour slots, each recomputed in the backward
# (multimodal_umap_tpu/models/layout.py:183): per-slot transients are
# (N, D).
_ATTR_SLOT_BYTES = 1 << 30

# Above this many rows each modality's fit loss is recomputed in the
# backward (layout.py:189), so the modalities' autograd residuals are
# never held together: peak is the largest modality's, not their sum.
_MODALITY_REMAT_ROWS = 1 << 18


def _recompute(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` whose residuals are recomputed in the
    backward. Its inputs carry every random draw, so no RNG state is
    kept for the recompute."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def _fit_modality_loss(embed, task: LayoutTask, static: TaskStatic,
                       draws: FitDraws, *, a, b, num_rep: int,
                       batch_size: int, deterministic: bool,
                       slot_bytes: int | None = None) -> torch.Tensor:
    n, k = task.nbrs.shape
    if deterministic:
        keep_f = task.weights
        keep_b = task.weights * task.bwd_valid.float()
    else:
        keep_f = (draws.keep_u_f < task.weights).float()
        keep_b = ((draws.keep_u_b < task.weights) & task.bwd_valid).float()

    # Kept-entry counts anchored at each row: forward slots directly,
    # transposed slots grouped by column (no gradient path).
    bwd_cnt = torch.zeros(static.num_rows, dtype=torch.float32,
                          device=embed.device).index_add_(
        0, task.nbrs.reshape(-1), keep_b.reshape(-1))
    rowcnt = keep_f.sum(1) + bwd_cnt
    inv_row = _inv_window_coef(rowcnt, batch_size, static.num_windows)

    loss_attr = _fit_attraction(embed, task, keep_f, keep_b, inv_row,
                                a=a, b=b, slot_bytes=slot_bytes)
    if num_rep == 0:
        return loss_attr
    return loss_attr + _fit_repulsion(embed, static, draws, rowcnt, inv_row,
                                      a=a, b=b, num_rep=num_rep)


def _fit_attraction(embed, task, keep_f, keep_b, inv_row, *, a, b,
                    slot_bytes: int | None = None):
    # Both copies of a pair share f(x_i, x_j); the forward copy is
    # windowed by i, the transposed copy by j. The plain (N, k, D)
    # gather's backward is the modality's one index_add_. Past
    # ``slot_bytes`` (default _ATTR_SLOT_BYTES) of that gather the k
    # slots run one at a time, each recomputed in the backward: k
    # index_add_s of (N, D) instead of one of (N*k, D).
    coef = keep_f * inv_row[:, None] + keep_b * inv_row[task.nbrs]
    n, k = task.nbrs.shape
    slot_bytes = _ATTR_SLOT_BYTES if slot_bytes is None else slot_bytes
    if n * k * embed.shape[1] * 4 > slot_bytes:
        nbrs_t, coef_t = task.nbrs.T.contiguous(), coef.T.contiguous()
        loss = embed.new_zeros(())
        for m in range(k):
            loss = loss + _recompute(_attr_slot, embed, nbrs_t[m],
                                     coef_t[m], a, b)
        return loss
    y = embed[task.nbrs]  # (N, k, D)
    attr = L.umap_attr(embed[:, None, :], y, a, b)  # (N, k)
    return (coef * attr).sum()


def _attr_slot(embed, nbrs_m, coef_m, a, b):
    """One neighbour slot's attraction: (N,) ids and coefficients."""
    return (coef_m * L.umap_attr(embed, embed[nbrs_m], a, b)).sum()


def _fit_repulsion(embed, static, draws: FitDraws, rowcnt, inv_row, *,
                   a, b, num_rep):
    # Round r's negative for row i is permuted[(i + off_r) % n]; the
    # offsets lie in disjoint strata shifted by a shared uniform base, so
    # two rounds never share an offset.
    rep_coef = rowcnt * inv_row
    permuted = permutation_gather(embed, draws.pi, draws.pi_inv)
    stride = max(1, static.rep_count // num_rep)
    rep_sum = torch.zeros(embed.shape[0], dtype=torch.float32,
                          device=embed.device)
    for r in range(num_rep):
        off = (draws.base + r * stride + draws.intra[r]) % static.rep_count
        rep_sum = rep_sum + L.umap_rep(embed, torch.roll(permuted, -off, 0),
                                       a, b)
    return (rep_coef * (rep_sum / num_rep)).sum()


def _query_modality_loss(embed, task: LayoutTask, static: TaskStatic,
                         draws: QueryDraws, *, a, b, num_rep: int,
                         batch_size: int, deterministic: bool,
                         mode: str = "transform") -> torch.Tensor:
    """Transform/invert: queries attract to frozen reference rows and
    repel from iid-uniform reference rows; nothing reaches ``ref``.
    Invert uses the inverse losses with the reference rows' fit-time
    sigma (attraction) and sigma/rho (repulsion)."""
    keep = (task.weights if deterministic
            else (draws.keep_u < task.weights).float())
    x = embed[:, None, :]
    if mode == "invert":
        attr = L.inv_attr(x, task.ref[task.nbrs], a, b,
                          task.sigmas[task.nbrs])
    else:
        attr = L.umap_attr(x, task.ref[task.nbrs], a, b)
    if num_rep > 0:
        rep_sum = torch.zeros_like(attr)
        for r in range(num_rep):
            neg = draws.neg_idx[r]
            if mode == "invert":
                rep = L.inv_rep(x, task.ref[neg], task.sigmas[neg],
                                task.rhos[neg])
            else:
                rep = L.umap_rep(x, task.ref[neg], a, b)
            rep_sum = rep_sum + rep
        per_slot = keep * (attr + rep_sum / num_rep)
    else:
        per_slot = keep * attr
    win_mean = _window_means_from_rows(per_slot.sum(1), keep.sum(1),
                                       batch_size, static.num_windows)
    return win_mean.mean()


_MODES = ("fit", "transform", "invert")


@dataclasses.dataclass
class AdamState:
    """``torch.optim.Adam``'s state of the layout parameters in optax's
    leaf order: the step count, then the first moment (mu) and the second
    moment (nu) of each modality."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


def adam_state(optimizer: torch.optim.Adam, params) -> AdamState:
    """The optimizer's state for ``params`` (all initialized)."""
    states = [optimizer.state[p] for p in params]
    return AdamState(count=int(states[0]["step"]),
                     mu=[s["exp_avg"] for s in states],
                     nu=[s["exp_avg_sq"] for s in states])


def _set_adam_state(optimizer: torch.optim.Adam, params,
                    state: AdamState) -> None:
    for p, mu, nu in zip(params, state.mu, state.nu):
        optimizer.state[p] = {
            "step": torch.tensor(float(state.count), dtype=torch.float32),
            "exp_avg": mu.detach().to(p.device, torch.float32).clone(),
            "exp_avg_sq": nu.detach().to(p.device, torch.float32).clone(),
        }


def make_loss_fn(statics: typing.Sequence[TaskStatic], *, mode: str,
                 num_rep: int, alpha: float, batch_size: int,
                 n_neg_infonce: int = 8, infonce_temperature: float = 0.5,
                 deterministic: bool = False,
                 remat_rows: int | None = None,
                 slot_bytes: int | None = None):
    """The total loss of one epoch:
    ``loss(params, tasks, a, b, draws: EpochDraws) -> scalar``.

    Fit mode recomputes a modality's loss in the backward past
    ``remat_rows`` rows (default :data:`_MODALITY_REMAT_ROWS`) and scans
    its attraction's slots past ``slot_bytes`` (default
    :data:`_ATTR_SLOT_BYTES`); both defaults are read at each call."""
    if mode not in _MODES:
        raise ValueError(f"invalid mode: {mode}")

    def loss_fn(params, tasks, a, b, draws: EpochDraws):
        total = params[0].new_zeros(())
        for i, static in enumerate(statics):
            kw = dict(a=a, b=b, num_rep=num_rep, batch_size=batch_size,
                      deterministic=deterministic)
            if mode == "fit":
                args = (params[i], tasks[i], static, draws.modality[i])
                kw["slot_bytes"] = slot_bytes
                rows = (_MODALITY_REMAT_ROWS if remat_rows is None
                        else remat_rows)
                if static.num_rows > rows:
                    loss = _recompute(_fit_modality_loss, *args, **kw)
                else:
                    loss = _fit_modality_loss(*args, **kw)
            else:
                loss = _query_modality_loss(params[i], tasks[i], static,
                                            draws.modality[i], mode=mode,
                                            **kw)
            total = total + loss
        if mode == "fit" and len(statics) > 1 and alpha != 0.0:
            # Symmetric InfoNCE added to both modality buckets => 2*alpha
            # effective weight.
            pair = iter(draws.infonce)
            for i in range(len(statics)):
                for j in range(i + 1, len(statics)):
                    d_ij, d_ji = next(pair)
                    l_ij = L.infonce(d_ij, params[i], params[j],
                                     n_neg=n_neg_infonce,
                                     temperature=infonce_temperature)
                    l_ji = L.infonce(d_ji, params[j], params[i],
                                     n_neg=n_neg_infonce,
                                     temperature=infonce_temperature)
                    total = total + alpha * (l_ij + l_ji)
        return total

    return loss_fn


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
    """Full-batch Adam layout optimization, one step per epoch.

    ``draws(epoch) -> EpochDraws`` supplies each epoch's randomness;
    None draws from generators seeded by (``seed``, epoch). Every
    ``epoch_chunk`` epochs (default ``MMUMAP_EPOCH_CHUNK``, else 100)
    ``chunk_callback(done, params, optimizer, losses)`` fires; the loss
    history stays on the device until then (no host sync inside the
    epoch loop).

    ``start_epoch``/``init_opt_state`` resume a run: the draws of epoch
    e depend on (seed, e) only, so a resumed run replays exactly the
    epochs the original would have run.

    ``mesh`` with more than one rank, with tasks and inits holding this
    rank's rows (``layout_sharded.sharded_compatible``), takes the
    sharded engine (``layout_sharded.sharded_chunk_runner``): in query
    modes it keeps the reference tables sharded and fetches their rows by
    ring once a table is over ``MMUMAP_REF_GATHER_BYTES`` (default 1
    GiB) whole. Anything else runs the single-device loop (on every rank).

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
    # torch.optim.Adam's defaults (betas 0.9/0.999, eps 1e-8) are
    # optax.adam's: the same bias-corrected update.
    optimizer = torch.optim.Adam(params, lr=lr)
    if init_opt_state is not None:
        _set_adam_state(optimizer, params, init_opt_state)
    loss_fn = make_loss_fn(statics, mode=mode, num_rep=num_rep, alpha=alpha,
                           batch_size=batch_size)
    tasks = tuple(tasks)
    sharded = None
    if mesh is not None and mesh.size > 1:
        from .layout_sharded import sharded_chunk_runner, sharded_compatible

        if sharded_compatible(params, tasks, statics, mesh):
            ref_gather = "full"
            thresh = float(os.environ.get("MMUMAP_REF_GATHER_BYTES", 1 << 30))
            if mode != "fit" and any(
                    t.ref is not None
                    and t.ref.numel() * t.ref.element_size() * mesh.size
                    > thresh for t in tasks):
                ref_gather = "ring"
            sharded = sharded_chunk_runner(
                tuple(statics), mode, num_rep, alpha, batch_size, mesh,
                ref_gather)
    if draws is None:
        def draws(epoch):
            return draw_epoch(epoch_rng(seed, epoch, device), tasks, statics,
                              mode=mode, num_rep=num_rep, alpha=alpha)

    history = []
    done = start_epoch
    while done < epochs:
        take = min(epoch_chunk, epochs - done)
        if sharded is not None:
            hist = sharded(params, optimizer, tasks, a, b, draws, done, take)
        else:
            hist = torch.empty(take, dtype=torch.float32, device=device)
            for t in range(take):
                optimizer.zero_grad(set_to_none=True)
                loss = loss_fn(params, tasks, a, b, draws(done + t))
                loss.backward()
                optimizer.step()
                hist[t] = loss.detach()
        done += take
        history.append(hist)
        if chunk_callback is not None:
            chunk_callback(done, params, optimizer, hist)
    if not history:
        # start_epoch >= epochs: a snapshot already recorded the final
        # epoch; the loaded params come back untouched.
        return [p.detach() for p in params], torch.zeros(0)
    return [p.detach() for p in params], torch.cat(history).cpu()
