"""Layout losses: UMAP attract/repel, inverse-mode attract/repel, InfoNCE.

Counterpart of ``multimodal_umap_tpu/ops/losses.py`` with its
conventions: "dist" inside the attract/repel curves is the **squared**
Euclidean distance clamped >= 1e-6 (so a*d^b realizes a*||delta||^(2b));
repulsion adds 1e-6 inside the log; inverse-mode attraction is
||delta|| / (q*sigma_j + 1e-6). Everything returns per-sample values.

InfoNCE takes its random draws (rotation, negative permutation, roll
offsets) as an explicit :class:`InfoNCEDraws`; :func:`draw_infonce`
makes them from ``torch.Generator``s. Its rolls reach the loss as one
int64 device vector ``[rot, *offsets]`` (:func:`infonce_rolls`), so a
captured CUDA graph reads each epoch's offsets from a buffer.

:func:`infonce` is one direction in plain autodiff PyTorch, on any
device. :func:`infonce_pair` (both directions of a pair of tables, what
the layout calls) takes it for CPU tensors; CUDA tensors launch the
kernels of ``csrc/infonce.cu`` (whose header note gives their design and
bound) or raise, never a fallback: a forward kernel a direction, a
finishing kernel that sums both losses, and one gather-only backward
kernel for both tables' gradients. Launch counts:
``INFONCE_FWD_LAUNCHES`` (forward kernels, one a direction) and
``INFONCE_BWD_LAUNCHES`` (backward kernels, one a pair).
:func:`_infonce_twin_forward` / :func:`_infonce_twin_backward` are the
kernels' algorithm in PyTorch (the saved coefficients, the backward's
gathers through ``q_inv``), so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import knn_tile
from .knn_tile import _raise_on, _stream
from .scatter_free import (
    dynamic_roll,
    dynamic_slice,
    permutation_gather,
    random_permutation_pair,
)


def _sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).sum(-1).clamp_min(1e-6)


def umap_attr(x, y, a, b) -> torch.Tensor:
    """Per-edge attraction log(1 + a d^b), d = squared distance."""
    return torch.log1p(a * torch.pow(_sq_dist(x, y), b))


def umap_rep(x, y, a, b) -> torch.Tensor:
    """Per-sample repulsion -log(a d^b / (1 + a d^b) + 1e-6)."""
    ad_b = a * torch.pow(_sq_dist(x, y), b)
    return -torch.log(ad_b / (1.0 + ad_b) + 1e-6)


def inv_attr(x, ref, a, b, sigma_j) -> torch.Tensor:
    """Inverse-mode attraction ||delta|| / (q*sigma_j + 1e-6), q the
    output-space curve weight."""
    sq = _sq_dist(x, ref)
    q = 1.0 / (1.0 + a * torch.pow(sq, b))
    return torch.sqrt(sq) / (q * sigma_j + 1e-6)


def inv_rep(x, ref, sigma_j, rho_j) -> torch.Tensor:
    """Inverse-mode repulsion
    -log(1 - exp(-max(d-rho,1e-6)/(sigma+1e-6)) + 1e-6)."""
    dist = torch.sqrt(_sq_dist(x, ref))
    w = torch.exp(-(dist - rho_j).clamp_min(1e-6) / (sigma_j + 1e-6))
    return -torch.log(1.0 - w + 1e-6)


def _l2_normalize(x: torch.Tensor, dim: int = -1,
                  eps: float = 1e-12) -> torch.Tensor:
    # Clamping the squared norm keeps the gradient finite at x == 0.
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))


# Above this many rows infonce streams row blocks (the whole-table form
# holds ~12-17 (num, D) buffers across forward and backward).
_INFONCE_BLOCK_ROWS = 1 << 16


@dataclasses.dataclass
class InfoNCEDraws:
    """Random draws of one InfoNCE direction.

    rot: slot i holds the row with natural id (i + rot) % num;
    q, q_inv: (num,) int64 permutation of the negatives and its inverse;
    offsets: n_neg + 1 roll offsets (negative column c of slot i is
    q[(i + offsets[c]) % num]).
    """

    rot: int
    q: torch.Tensor
    q_inv: torch.Tensor
    offsets: list[int]


def draw_infonce(num: int, n_neg: int, group_size: int,
                 gen: torch.Generator | None,
                 host_gen: torch.Generator | None,
                 device: torch.device | str,
                 out: InfoNCEDraws | None = None) -> InfoNCEDraws:
    """Draws of one InfoNCE direction: the permutation from ``gen`` (on
    ``device``), the integers from the CPU generator ``host_gen`` (no
    device sync to read them). ``out`` receives the permutation in its
    buffers; a None generator keeps what ``out`` holds of its draws."""
    if gen is None:
        q, q_inv = out.q, out.q_inv
    else:
        q, q_inv = random_permutation_pair(
            num, gen, device, out=None if out is None else (out.q, out.q_inv))
    if host_gen is None:
        return InfoNCEDraws(rot=out.rot, q=q, q_inv=q_inv,
                            offsets=out.offsets)
    rot = (0 if num % group_size == 0 else
           int(torch.randint(0, num, (), generator=host_gen)))
    offsets = torch.randint(0, num, (n_neg + 1,), generator=host_gen).tolist()
    return InfoNCEDraws(rot=rot, q=q, q_inv=q_inv, offsets=offsets)


def infonce_rolls(draws: InfoNCEDraws) -> list[int]:
    """One direction's roll offsets in the order :func:`infonce` reads
    them: the rotation, then the negative columns' offsets."""
    return [draws.rot, *draws.offsets]


def _infonce_per_elem(e0, e1, permuted_1, q, rot, offsets, temperature,
                      block_rows):
    """Whole-table per-element InfoNCE values (slot order). ``rot`` and
    the ``offsets`` are 0-d int64 device tensors."""
    del block_rows
    num = e0.shape[0]
    anchors = _l2_normalize(dynamic_roll(e0, rot))
    positives = _l2_normalize(dynamic_roll(e1, rot))
    pos_sim = (anchors * positives).sum(1) / temperature

    ar = torch.arange(num, device=e0.device)
    anchor_ids = (ar + rot) % num
    normed_1 = _l2_normalize(permuted_1)
    cols = []
    for off in offsets:
        # Negative column c is roll(permuted_1, -off): a roll, whose
        # backward is a gather -- no scatter.
        sim = (anchors * dynamic_roll(normed_1, off)).sum(1) / temperature
        neg_rows = dynamic_roll(q, off)
        cols.append(sim.masked_fill(neg_rows == anchor_ids, float("-inf")))
    logits = torch.stack([pos_sim] + cols, dim=1)
    return -F.log_softmax(logits, dim=1)[:, 0]


def _infonce_per_elem_blocked(e0, e1, permuted_1, q, rot, offsets,
                              temperature, block_rows):
    """Row-blocked per-element InfoNCE: same values as
    :func:`_infonce_per_elem` with O(block) live transients. Every
    access is a cyclic shift, so each table gets a wrap copy of its
    first ``block_rows`` rows and every block is a contiguous slice
    (:func:`dynamic_slice`: the starts are device tensors); blocks are
    recomputed in the backward (activation checkpointing)."""
    num = e0.shape[0]
    block = block_rows
    e0x = torch.cat([e0, e0[:block]])
    e1x = torch.cat([e1, e1[:block]])
    p1x = torch.cat([permuted_1, permuted_1[:block]])
    qx = torch.cat([q, q[:block]])

    def body(s, e0x, e1x, p1x):
        st = (s + rot) % num
        a = _l2_normalize(dynamic_slice(e0x, st, block))
        p = _l2_normalize(dynamic_slice(e1x, st, block))
        pos_sim = (a * p).sum(1) / temperature
        anchor_ids = (s + torch.arange(block, device=e0x.device) + rot) % num
        cols = []
        for off in offsets:
            so = (s + off) % num
            nrm = _l2_normalize(dynamic_slice(p1x, so, block))
            sim = (a * nrm).sum(1) / temperature
            neg_rows = dynamic_slice(qx, so, block)
            cols.append(sim.masked_fill(neg_rows == anchor_ids, float("-inf")))
        logits = torch.stack([pos_sim] + cols, dim=1)
        return -F.log_softmax(logits, dim=1)[:, 0]

    # Nothing in a block draws, so no RNG state is kept (restoring one
    # is not allowed inside a CUDA graph capture).
    parts = [checkpoint(body, s, e0x, e1x, p1x, use_reentrant=False,
                        preserve_rng_state=False)
             for s in range(0, num, block)]
    return torch.cat(parts)[:num]


def infonce(draws: InfoNCEDraws, embeds_0: torch.Tensor,
            embeds_1: torch.Tensor, n_neg: int = 8, temperature: float = 0.5,
            group_size: int = 1000, block_rows: int | None = None,
            rolls: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-modal InfoNCE alignment (directional: anchors from
    ``embeds_0``), the plain version: autodiff PyTorch on any device (the
    layout calls :func:`infonce_pair`, which launches the kernels on CUDA
    tensors). Paired rows are positives; ``n_neg + 1`` negatives per
    anchor with anchor collisions masked to -inf; the loss is the mean of
    per-``group_size`` group means over a padded fixed-shape grouping, so
    the short last group carries a full group's weight. ``rolls``, the
    (n_neg + 2,) int64 device vector of :func:`infonce_rolls`, takes the
    place of the draws' ints (None: made from them). Past ``block_rows``
    rows (None: :data:`_INFONCE_BLOCK_ROWS`) row blocks are recomputed in
    the backward."""
    num = min(embeds_0.shape[0], embeds_1.shape[0])
    if num == 0:
        return embeds_0.new_zeros(())
    rolls = _device_rolls(draws, n_neg, embeds_0.device, rolls)
    num_groups = -(-num // group_size)
    padded = num_groups * group_size

    permuted_1 = permutation_gather(embeds_1[:num], draws.q, draws.q_inv)
    if block_rows is None:
        block_rows = _INFONCE_BLOCK_ROWS
    per_fn = (_infonce_per_elem_blocked if num > block_rows
              else _infonce_per_elem)
    per_elem = per_fn(embeds_0[:num], embeds_1[:num], permuted_1, draws.q,
                      rolls[0], rolls[1:], temperature, block_rows)

    per_elem = F.pad(per_elem, (0, padded - num)).view(num_groups, group_size)
    pad_mask = (torch.arange(padded, device=per_elem.device) < num
                ).view(num_groups, group_size)
    grp_counts = pad_mask.sum(1).clamp_min(1)
    grp_means = torch.where(pad_mask, per_elem, 0.0).sum(1) / grp_counts
    return grp_means.mean()


def _device_rolls(draws: InfoNCEDraws, n_neg: int, device,
                  rolls: torch.Tensor | None) -> torch.Tensor:
    if len(draws.offsets) != n_neg + 1:
        raise ValueError(f"expected {n_neg + 1} offsets, got "
                         f"{len(draws.offsets)}")
    if rolls is None:
        rolls = torch.tensor(infonce_rolls(draws), dtype=torch.int64,
                             device=device)
    return rolls


def infonce_pair(draws_ij: InfoNCEDraws, draws_ji: InfoNCEDraws,
                 embeds_i: torch.Tensor, embeds_j: torch.Tensor,
                 n_neg: int = 8, temperature: float = 0.5,
                 group_size: int = 1000, rolls: tuple | None = None):
    """Both directions of a pair, ``(infonce(draws_ij, embeds_i,
    embeds_j), infonce(draws_ji, embeds_j, embeds_i))`` (``rolls``: None
    or each direction's vector): the two plain calls for CPU tensors; for
    CUDA ones the kernels, whose one backward launch ends both tables'
    gradient rows; any other device raises."""
    r_ij, r_ji = (None, None) if rolls is None else rolls
    kw = dict(n_neg=n_neg, temperature=temperature, group_size=group_size)
    num = min(embeds_i.shape[0], embeds_j.shape[0])
    if embeds_i.device.type == "cpu" or num == 0:
        return (infonce(draws_ij, embeds_i, embeds_j, rolls=r_ij, **kw),
                infonce(draws_ji, embeds_j, embeds_i, rolls=r_ji, **kw))
    dev = embeds_i.device
    directions = [(draws_ij, _device_rolls(draws_ij, n_neg, dev, r_ij)),
                  (draws_ji, _device_rolls(draws_ji, n_neg, dev, r_ji))]
    _check_kernel_inputs(embeds_i, embeds_j, directions, n_neg, num,
                         group_size)
    (d0, r0), (d1, r1) = directions
    return _InfoNCEPair.apply(embeds_i, embeds_j, d0.q, d0.q_inv, r0, d1.q,
                              d1.q_inv, r1, int(n_neg), float(temperature),
                              int(group_size))


# --- the kernels' algorithm in PyTorch ---------------------------------

def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(clamp_min(|x|^2, 1e-24)) over the last dimension, as
    :func:`_l2_normalize` divides by it."""
    return torch.sqrt((x * x).sum(-1).clamp_min(1e-24))


def _group_counts(num: int, group_size: int, device):
    """(the slots of each slot's group, (num,) int64; the groups)."""
    i = torch.arange(num, device=device)
    count = (num - (i // group_size) * group_size).clamp_max(group_size)
    return count, -(-num // group_size)


def _infonce_slots(num: int, q: torch.Tensor, rolls: torch.Tensor):
    """Each slot's anchor row (num,) and its n_neg + 2 columns' partner
    rows (num, n_neg + 2): the positive, then the negatives, -1 where a
    negative is the anchor's own row (masked)."""
    offs = rolls % num
    i = torch.arange(num, device=q.device)
    a = (i + offs[0]) % num
    neg = q[(i[:, None] + offs[1:]) % num]
    return a, torch.cat([a[:, None], torch.where(neg == a[:, None], -1, neg)],
                        1)


def _infonce_twin_forward(e0, e1, q, rolls, temperature: float,
                          group_size: int):
    """One direction's forward kernel in PyTorch: (loss, coef, ga).
    coef (num, n_neg + 2): (p_c - [c == 0]) / (T |anchor|), p the
    softmax over the slot's logits (0 where masked); ga (num, D): the
    anchor's gradient in normalised space, sum_c (p_c - [c == 0])
    partner_c / (T |partner_c|); both before the slot's constant."""
    num = min(e0.shape[0], e1.shape[0])
    a, rows = _infonce_slots(num, q, rolls)
    on = rows >= 0
    x = e0[a]
    y = torch.where(on[..., None], e1[rows.clamp_min(0)], 0.0)
    sa, sw = _norm(x), _norm(y)
    logits = torch.where(
        on, (x[:, None, :] * y).sum(-1) / (sa[:, None] * sw) / temperature,
        float("-inf"))
    lse = torch.logsumexp(logits, 1)
    pm = torch.exp(logits - lse[:, None])
    pm[:, 0] -= 1.0
    coef = pm / (temperature * sa[:, None])
    ga = ((pm / (temperature * sw))[..., None] * y).sum(1)
    count, groups = _group_counts(num, group_size, e0.device)
    loss = ((lse - logits[:, 0]) / count).sum() / groups
    return loss, coef, ga


def _infonce_twin_backward(dirs: list, num: int, group_size: int) -> list:
    """The backward kernel in PyTorch. ``dirs``: the pair's two
    directions, each a dict of ``A`` (its anchors' table), ``q_inv``,
    ``rolls``, ``coef``, ``ga`` (its forward's) and ``g`` (the upstream
    gradient of its loss); table k holds direction k's anchors and is
    direction 1 - k's partner. Row j of table k: dv ga[(j - rot) % num]
    from direction k, then from direction 1 - k the positive's
    dv coef[t, 0] A_j, t = (j - rot) % num, and negative column c's
    dv coef[t_c, c] A_{(t_c + rot) % num}, t_c = (q_inv[j] - off_c) % num;
    then the normalisation's backward. Returns both tables' gradients
    (rows past num 0)."""
    count, groups = _group_counts(num, group_size, dirs[0]["A"].device)
    j = torch.arange(num, device=count.device)
    grads = []
    for k in range(2):
        d, e = dirs[k], dirs[1 - k]
        x = d["A"][:num]
        so = (j - d["rolls"][0]) % num
        gu = (d["g"] / groups / count[so])[:, None] * d["ga"][so]
        offs = e["rolls"] % num
        t = torch.cat([((j - offs[0]) % num)[:, None],
                       (e["q_inv"][j][:, None] - offs[1:]) % num], 1)
        cols = torch.arange(t.shape[1], device=t.device)
        w = e["coef"][t, cols] * (e["g"] / groups / count[t])
        rows = torch.cat([j[:, None], (t[:, 1:] + offs[0]) % num], 1)
        gu = gu + (w[..., None] * e["A"][rows]).sum(1)
        sq = (x * x).sum(1)
        nx = torch.sqrt(sq.clamp_min(1e-24))
        k_ = torch.where(sq >= 1e-24, (gu * x).sum(1) / (nx * nx) / nx, 0.0)
        grad = torch.zeros_like(d["A"])
        grad[:num] = gu / nx[:, None] - k_[:, None] * x
        grads.append(grad)
    return grads


# --- the kernels -------------------------------------------------------

# Launches of the CUDA kernels in this process: forward kernels (one a
# direction; the finishing kernel of each pair is not counted) and
# backward kernels (one a pair).
INFONCE_FWD_LAUNCHES = 0
INFONCE_BWD_LAUNCHES = 0

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library (one build with every kernel of the port)."""
    global _lib
    if _lib is None:
        lib = knn_tile.build()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.infonce_fwd_blocks.argtypes = [i, i, p, p, p]
        lib.infonce_fwd_launch.argtypes = [p] * 7 + [i, i, i, i, f, p]
        lib.infonce_finish_launch.argtypes = [p, i, p, i, p, p, i, i, p]
        lib.infonce_bwd_launch.argtypes = [p] * 14 + [i] * 4 + [p]
        for fn in (lib.infonce_fwd_blocks, lib.infonce_fwd_launch,
                   lib.infonce_finish_launch, lib.infonce_bwd_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(e0, e1, directions, n_neg: int, num: int,
                         group_size: int) -> None:
    if e0.device.type != "cuda":
        raise ValueError(f"unsupported device {e0.device}")
    for name, e in (("embeds_i", e0), ("embeds_j", e1)):
        if (e.dim() != 2 or e.dtype != torch.float32 or not e.is_contiguous()
                or e.device != e0.device):
            raise ValueError(f"{name} must be a contiguous 2-D float32 "
                             f"tensor on {e0.device}, got {e.dtype} "
                             f"{tuple(e.shape)} on {e.device}")
    if e0.shape[1] != e1.shape[1] or e0.shape[1] == 0:
        raise ValueError(f"widths {e0.shape[1]} and {e1.shape[1]} differ")
    if not (num < 2**31 and n_neg >= 0 and group_size > 0):
        raise ValueError(f"num {num}, n_neg {n_neg}, group_size "
                         f"{group_size} out of the kernels' range")
    for draws, rolls in directions:
        for name, v, n in (("q", draws.q, num), ("q_inv", draws.q_inv, num),
                           ("rolls", rolls, n_neg + 2)):
            if (v.shape != (n,) or v.dtype != torch.int64
                    or v.device != e0.device or not v.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous ({n},) int64 "
                                 f"tensor on {e0.device}, got {v.dtype} "
                                 f"{tuple(v.shape)} on {v.device}")


def _fwd_launch(a, b, q, rolls, num: int, ncols: int, temperature: float,
                group_size: int):
    """One direction's forward kernel (anchors ``a``, partner ``b``):
    (coef, ga, the blocks' partials of its loss)."""
    global INFONCE_FWD_LAUNCHES
    lib = _library()
    coef = torch.empty(num, ncols, dtype=torch.float32, device=a.device)
    ga = torch.empty(num, a.shape[1], dtype=torch.float32, device=a.device)
    partial = torch.empty(
        lib.infonce_fwd_blocks(num, a.shape[1], a.data_ptr(), b.data_ptr(),
                               ga.data_ptr()),
        dtype=torch.float32, device=a.device)
    _raise_on(lib.infonce_fwd_launch(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), rolls.data_ptr(),
        coef.data_ptr(), ga.data_ptr(), partial.data_ptr(), num, ncols,
        a.shape[1], group_size, temperature, _stream(a)), "infonce_fwd")
    INFONCE_FWD_LAUNCHES += 1
    return coef, ga, partial


def _finish_launch(partials, num: int, group_size: int):
    """The finishing kernel: both directions' losses from their
    forwards' partials."""
    p0, p1 = partials
    out = [torch.empty((), dtype=torch.float32, device=p0.device)
           for _ in range(2)]
    _raise_on(_library().infonce_finish_launch(
        p0.data_ptr(), p0.numel(), p1.data_ptr(), p1.numel(),
        out[0].data_ptr(), out[1].data_ptr(), num, group_size, _stream(p0)),
        "infonce_finish")
    return tuple(out)


def _bwd_launch(tables, dirs, num: int, ncols: int, group_size: int):
    """The backward kernel: both tables' gradients. ``dirs``: per
    direction (q_inv, rolls, coef, ga, upstream gradient); table k holds
    direction k's anchors."""
    global INFONCE_BWD_LAUNCHES
    grads = [torch.empty_like(e) if e.shape[0] == num else torch.zeros_like(e)
             for e in tables]
    args = [t.data_ptr() for k in range(2)
            for t in (tables[k], *dirs[k], grads[k])]
    _raise_on(_library().infonce_bwd_launch(
        *args, num, ncols, tables[0].shape[1], group_size,
        _stream(tables[0])), "infonce_bwd")
    INFONCE_BWD_LAUNCHES += 1
    return grads


class _InfoNCEPair(torch.autograd.Function):
    """Both directions of a pair: a forward kernel a direction and the
    finishing kernel; one backward kernel for every gradient row of both
    tables."""

    @staticmethod
    def forward(ctx, e0, e1, q0, q_inv0, rolls0, q1, q_inv1, rolls1, n_neg,
                temperature, group_size):
        num, ncols = min(e0.shape[0], e1.shape[0]), n_neg + 2
        with torch.cuda.device(e0.device):
            coef0, ga0, p0 = _fwd_launch(e0, e1, q0, rolls0, num, ncols,
                                         temperature, group_size)
            coef1, ga1, p1 = _fwd_launch(e1, e0, q1, rolls1, num, ncols,
                                         temperature, group_size)
            losses = _finish_launch((p0, p1), num, group_size)
        ctx.save_for_backward(e0, e1, q_inv0, rolls0, coef0, ga0, q_inv1,
                              rolls1, coef1, ga1)
        ctx.consts = (num, ncols, group_size)
        return losses

    @staticmethod
    def backward(ctx, g0, g1):
        e0, e1, *saved = ctx.saved_tensors
        g = [x.to(torch.float32).contiguous() for x in (g0, g1)]
        with torch.cuda.device(e0.device):
            grads = _bwd_launch((e0, e1), (saved[:4] + [g[0]],
                                           saved[4:] + [g[1]]), *ctx.consts)
        return (*grads,) + (None,) * 9
