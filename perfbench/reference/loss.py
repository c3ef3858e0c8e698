"""The fit layout's objective at a given state, in float64.

One epoch's loss of the published layout, with draws of its own:

* attraction: each entry of the symmetric fuzzy matrix (both directed
  copies of a pair) is kept with probability equal to its weight; a kept
  copy anchored at row i adds log(1 + a d^b), d the squared distance of the
  pair clamped >= 1e-6;
* repulsion: each kept entry anchored at row i adds the mean over
  ``num_rep`` rounds of -log(a d^b / (1 + a d^b) + 1e-6) against negatives
  drawn as rolls of one random permutation of the rows, in disjoint strata;
* each modality's loss is the mean over row windows of ``batch_size`` of the
  windows' mean over their kept entries;
* InfoNCE, both directions of the pair, at temperature 0.5 with 9 negative
  columns (8 + 1) drawn as rolls of one permutation, anchor collisions
  masked, as the mean of 1000-row group means, added with weight ``alpha``
  each (2 alpha in all).

The value is a random variable with the same law as the program's per-epoch
loss at that state; :func:`fit_loss` averages it over ``draws`` draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _attr(x, y, a, b):
    return torch.log1p(a * ((x - y) ** 2).sum(-1).clamp_min(1e-6) ** b)


def _rep(x, y, a, b):
    adb = a * ((x - y) ** 2).sum(-1).clamp_min(1e-6) ** b
    return -torch.log(adb / (1.0 + adb) + 1e-6)


def _normalize(x):
    return x / (x * x).sum(1, keepdim=True).clamp_min(1e-24).sqrt()


def modality_loss(x, ids, sym, back, *, a, b, num_rep, batch_size, gen):
    """(attraction, repulsion) of one modality at embedding ``x``."""
    n, k = ids.shape
    dev = x.device
    keep_f = (torch.rand(n, k, generator=gen, device=dev,
                         dtype=torch.float64) < sym).double()
    keep_b = ((torch.rand(n, k, generator=gen, device=dev,
                          dtype=torch.float64) < sym) & ~back).double()
    rowcnt = keep_f.sum(1) + torch.zeros(n, dtype=torch.float64,
                                         device=dev).index_add_(
        0, ids.reshape(-1), keep_b.reshape(-1))
    windows = -(-n // batch_size)
    cnt_w = F.pad(rowcnt, (0, windows * batch_size - n)).view(
        windows, batch_size).sum(1)
    inv_w = torch.where(cnt_w > 0, 1.0 / cnt_w.clamp_min(1.0), 0.0) / windows
    inv_row = inv_w.repeat_interleave(batch_size)[:n]
    coef = keep_f * inv_row[:, None] + keep_b * inv_row[ids]
    attr = (coef * _attr(x[:, None, :], x[ids], a, b)).sum()

    perm = torch.randperm(n, generator=gen, device=dev)
    stride = max(1, n // max(num_rep, 1))
    base = int(torch.randint(0, n, (), generator=gen, device=dev))
    intra = torch.randint(0, stride, (num_rep,), generator=gen, device=dev)
    rows = torch.arange(n, device=dev)
    rep = torch.zeros(n, dtype=torch.float64, device=dev)
    for r in range(num_rep):
        off = (base + r * stride + int(intra[r])) % n
        rep += _rep(x, x[perm[(rows + off) % n]], a, b)
    return attr, ((rowcnt * inv_row) * rep / num_rep).sum()


def infonce(e0, e1, *, n_neg, temperature, group_size, gen):
    """One direction of InfoNCE (anchors from ``e0``)."""
    num = min(e0.shape[0], e1.shape[0])
    dev = e0.device
    rot = (0 if num % group_size == 0
           else int(torch.randint(0, num, (), generator=gen, device=dev)))
    perm = torch.randperm(num, generator=gen, device=dev)
    offsets = torch.randint(0, num, (n_neg + 1,), generator=gen, device=dev)
    anchor_ids = (torch.arange(num, device=dev) + rot) % num
    anchors = _normalize(e0[anchor_ids])
    cols = [(anchors * _normalize(e1[anchor_ids])).sum(1) / temperature]
    for off in offsets.tolist():
        neg = perm[(torch.arange(num, device=dev) + off) % num]
        sim = (anchors * _normalize(e1[neg])).sum(1) / temperature
        cols.append(sim.masked_fill(neg == anchor_ids, float("-inf")))
    per = -F.log_softmax(torch.stack(cols, 1), dim=1)[:, 0]
    groups = -(-num // group_size)
    per = F.pad(per, (0, groups * group_size - num)).view(groups, group_size)
    counts = torch.full((groups,), float(group_size), dtype=torch.float64,
                        device=dev)
    counts[-1] = num - (groups - 1) * group_size
    return (per.sum(1) / counts).mean()


def fit_loss(embeds, graphs, *, a, b, num_rep, batch_size, alpha, n_neg,
             temperature, group_size, seed: int, draws: int = 2) -> dict:
    """Mean over ``draws`` of each term and the total at ``embeds`` (one
    (N, out_dim) tensor a modality; ``graphs`` one (ids, sym, back) each).
    The same ``seed`` gives the same draws for any state of these shapes."""
    dev = embeds[0].device
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 62))
    xs = [e.double() for e in embeds]
    terms = {"attr": 0.0, "rep": 0.0, "infonce": 0.0}
    for _ in range(draws):
        for x, (ids, sym, back) in zip(xs, graphs):
            at, rp = modality_loss(x, ids.long(), sym.double(), back,
                                   a=a, b=b, num_rep=num_rep,
                                   batch_size=batch_size, gen=gen)
            terms["attr"] += float(at) / draws
            terms["rep"] += float(rp) / draws
        if len(xs) > 1 and alpha != 0.0:
            for i in range(len(xs)):
                for j in range(i + 1, len(xs)):
                    kw = dict(n_neg=n_neg, temperature=temperature,
                              group_size=group_size, gen=gen)
                    terms["infonce"] += alpha * float(
                        infonce(xs[i], xs[j], **kw)
                        + infonce(xs[j], xs[i], **kw)) / draws
    terms["total"] = terms["attr"] + terms["rep"] + terms["infonce"]
    return terms
