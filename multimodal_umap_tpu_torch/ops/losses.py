"""Layout losses: UMAP attract/repel, inverse-mode attract/repel, InfoNCE.

Counterpart of ``multimodal_umap_tpu/ops/losses.py`` with its
conventions: "dist" inside the attract/repel curves is the **squared**
Euclidean distance clamped >= 1e-6 (so a*d^b realizes a*||delta||^(2b));
repulsion adds 1e-6 inside the log; inverse-mode attraction is
||delta|| / (q*sigma_j + 1e-6). Everything returns per-sample values.

InfoNCE takes its random draws (rotation, negative permutation, roll
offsets) as an explicit :class:`InfoNCEDraws`; :func:`draw_infonce`
makes them from ``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .scatter_free import permutation_gather, random_permutation_pair


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
                 gen: torch.Generator, host_gen: torch.Generator,
                 device: torch.device | str) -> InfoNCEDraws:
    """Draws of one InfoNCE direction: the permutation from ``gen`` (on
    ``device``), the integers from the CPU generator ``host_gen`` (no
    device sync to read them)."""
    rot = (0 if num % group_size == 0 else
           int(torch.randint(0, num, (), generator=host_gen)))
    q, q_inv = random_permutation_pair(num, gen, device)
    offsets = torch.randint(0, num, (n_neg + 1,), generator=host_gen).tolist()
    return InfoNCEDraws(rot=rot, q=q, q_inv=q_inv, offsets=offsets)


def _infonce_per_elem(e0, e1, permuted_1, q, rot, offsets, temperature,
                      block_rows):
    """Whole-table per-element InfoNCE values (slot order)."""
    del block_rows
    num = e0.shape[0]
    anchors = _l2_normalize(torch.roll(e0, -rot, 0))
    positives = _l2_normalize(torch.roll(e1, -rot, 0))
    pos_sim = (anchors * positives).sum(1) / temperature

    ar = torch.arange(num, device=e0.device)
    anchor_ids = (ar + rot) % num
    normed_1 = _l2_normalize(permuted_1)
    cols = []
    for off in offsets:
        # Negative column c is roll(permuted_1, -off): a roll, whose
        # backward is a roll -- no scatter.
        sim = (anchors * torch.roll(normed_1, -off, 0)).sum(1) / temperature
        neg_rows = torch.roll(q, -off, 0)
        cols.append(sim.masked_fill(neg_rows == anchor_ids, float("-inf")))
    logits = torch.stack([pos_sim] + cols, dim=1)
    return -F.log_softmax(logits, dim=1)[:, 0]


def _infonce_per_elem_blocked(e0, e1, permuted_1, q, rot, offsets,
                              temperature, block_rows):
    """Row-blocked per-element InfoNCE: same values as
    :func:`_infonce_per_elem` with O(block) live transients. Every
    access is a cyclic shift, so each table gets a wrap copy of its
    first ``block_rows`` rows and every block is a contiguous slice;
    blocks are recomputed in the backward (activation checkpointing)."""
    num = e0.shape[0]
    block = block_rows
    e0x = torch.cat([e0, e0[:block]])
    e1x = torch.cat([e1, e1[:block]])
    p1x = torch.cat([permuted_1, permuted_1[:block]])
    qx = torch.cat([q, q[:block]])

    def body(s, e0x, e1x, p1x):
        st = (s + rot) % num
        a = _l2_normalize(e0x[st:st + block])
        p = _l2_normalize(e1x[st:st + block])
        pos_sim = (a * p).sum(1) / temperature
        anchor_ids = (s + torch.arange(block, device=e0x.device) + rot) % num
        cols = []
        for off in offsets:
            so = (s + off) % num
            nrm = _l2_normalize(p1x[so:so + block])
            sim = (a * nrm).sum(1) / temperature
            neg_rows = qx[so:so + block]
            cols.append(sim.masked_fill(neg_rows == anchor_ids, float("-inf")))
        logits = torch.stack([pos_sim] + cols, dim=1)
        return -F.log_softmax(logits, dim=1)[:, 0]

    parts = [checkpoint(body, s, e0x, e1x, p1x, use_reentrant=False)
             for s in range(0, num, block)]
    return torch.cat(parts)[:num]


def infonce(draws: InfoNCEDraws, embeds_0: torch.Tensor,
            embeds_1: torch.Tensor, n_neg: int = 8, temperature: float = 0.5,
            group_size: int = 1000, block_rows: int | None = None
            ) -> torch.Tensor:
    """Cross-modal InfoNCE alignment (directional: anchors from
    ``embeds_0``). Paired rows are positives; ``n_neg + 1`` negatives
    per anchor with anchor collisions masked to -inf; the loss is the
    mean of per-``group_size`` group means over a padded fixed-shape
    grouping, so the short last group carries a full group's weight."""
    num = min(embeds_0.shape[0], embeds_1.shape[0])
    if num == 0:
        return embeds_0.new_zeros(())
    if len(draws.offsets) != n_neg + 1:
        raise ValueError(f"expected {n_neg + 1} offsets, got "
                         f"{len(draws.offsets)}")
    num_groups = -(-num // group_size)
    padded = num_groups * group_size

    permuted_1 = permutation_gather(embeds_1[:num], draws.q, draws.q_inv)
    if block_rows is None:
        block_rows = _INFONCE_BLOCK_ROWS
    per_fn = (_infonce_per_elem_blocked if num > block_rows
              else _infonce_per_elem)
    per_elem = per_fn(embeds_0[:num], embeds_1[:num], permuted_1, draws.q,
                      draws.rot, draws.offsets, temperature, block_rows)

    per_elem = F.pad(per_elem, (0, padded - num)).view(num_groups, group_size)
    pad_mask = (torch.arange(padded, device=per_elem.device) < num
                ).view(num_groups, group_size)
    grp_counts = pad_mask.sum(1).clamp_min(1)
    grp_means = torch.where(pad_mask, per_elem, 0.0).sum(1) / grp_counts
    return grp_means.mean()
