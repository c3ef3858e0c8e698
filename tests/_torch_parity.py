"""Helpers for the PyTorch port's parity tests (not collected itself).

* tie-aware kNN id comparison and principal-angle subspace checks;
* replays of the JAX package's random draws: the JAX code draws "by
  index" from split keys (models/layout.py, ops/losses.py), so the same
  splits computed here give the exact keep masks, permutations and
  offsets a JAX run used, handed to the port as explicit draws.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from multimodal_umap_tpu_torch.models.layout import (
    EpochDraws,
    FitDraws,
    QueryDraws,
)
from multimodal_umap_tpu_torch.ops.losses import InfoNCEDraws
from multimodal_umap_tpu_torch.ops.scatter_free import inverse_permutation


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def assert_ids_tie_aware(d_a, i_a, d_b, i_b, rtol=2e-4, atol=2e-4):
    """Row-wise: every id of ``i_a`` missing from ``i_b``'s row must sit
    at the row's boundary distance (a tie at the cut), and vice versa."""
    d_a, i_a = np.asarray(d_a), np.asarray(i_a)
    d_b, i_b = np.asarray(d_b), np.asarray(i_b)
    for d_x, i_x, i_y in ((d_a, i_a, i_b), (d_b, i_b, i_a)):
        in_y = (i_x[:, :, None] == i_y[:, None, :]).any(-1)
        edge = d_x[:, -1:]
        at_edge = np.abs(d_x - edge) <= atol + rtol * np.abs(edge)
        bad = ~(in_y | at_edge)
        assert not bad.any(), (np.argwhere(bad)[:5], i_x[bad.any(1)][:3],
                               i_y[bad.any(1)][:3])


def subspace_sv(a, b) -> np.ndarray:
    """Cosines of the principal angles between span(a) and span(b)."""
    qa, _ = np.linalg.qr(np.asarray(a, dtype=np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, dtype=np.float64))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def jax_infonce_draws(key, num: int, n_neg: int = 8,
                      group_size: int = 1000) -> InfoNCEDraws:
    """The draws ``multimodal_umap_tpu.ops.losses.infonce(key, ...)``
    makes (ops/losses.py:217-229)."""
    key_rot, key_negperm, key_off = jax.random.split(key, 3)
    rot = (0 if num % group_size == 0
           else int(jax.random.randint(key_rot, (), 0, num)))
    q = t(jax.random.permutation(key_negperm, num), torch.long)
    offsets = np.asarray(
        jax.random.randint(key_off, (n_neg + 1,), 0, num)).tolist()
    return InfoNCEDraws(rot=rot, q=q, q_inv=inverse_permutation(q),
                        offsets=offsets)


def jax_fit_draws(key, num_rows: int, k: int, num_rep: int) -> FitDraws:
    """One modality's draws of ``_fit_modality_loss(..., key)``
    (models/layout.py:213-225, :298-325)."""
    key_f, key_b, key_neg = jax.random.split(key, 3)
    u_f = t(jax.random.uniform(key_f, (num_rows, k)))
    u_b = t(jax.random.uniform(key_b, (num_rows, k)))
    key_negperm, key_base, key_negoff = jax.random.split(key_neg, 3)
    pi = t(jax.random.permutation(key_negperm, num_rows), torch.long)
    stride = max(1, num_rows // max(num_rep, 1))
    base = int(jax.random.randint(key_base, (), 0, num_rows))
    intra = np.asarray(
        jax.random.randint(key_negoff, (num_rep,), 0, stride)).tolist()
    return FitDraws(u_f, u_b, pi, inverse_permutation(pi), base, intra)


def jax_query_draws(key, q: int, k: int, num_rep: int,
                    rep_count: int) -> QueryDraws:
    """One modality's draws of ``_query_modality_loss(..., key)``
    (models/layout.py:352-386)."""
    key_keep, key_neg = jax.random.split(key)
    keep_u = t(jax.random.uniform(key_keep, (q, k)))
    negs = [np.asarray(jax.random.randint(nk, (q, k), 0, rep_count))
            for nk in jax.random.split(key_neg, num_rep)]
    neg_idx = (t(np.stack(negs), torch.long) if negs
               else torch.zeros((0, q, k), dtype=torch.long))
    return QueryDraws(keep_u, neg_idx)


def jax_epoch_draws(ekey, shapes, *, mode: str, num_rep: int,
                    alpha: float, rep_counts=None) -> EpochDraws:
    """All draws of the JAX loss for one epoch key
    (``make_loss_fn``, models/layout.py:445-509). ``shapes`` holds each
    modality's (rows, k)."""
    keys = jax.random.split(ekey, len(shapes) + 1)
    if mode == "fit":
        mods = [jax_fit_draws(keys[i], n, k, num_rep)
                for i, (n, k) in enumerate(shapes)]
    else:
        mods = [jax_query_draws(keys[i], n, k, num_rep, rep_counts[i])
                for i, (n, k) in enumerate(shapes)]
    pairs = []
    if mode == "fit" and len(shapes) > 1 and alpha != 0.0:
        pair_key = keys[-1]
        for i in range(len(shapes)):
            for j in range(i + 1, len(shapes)):
                pair_key, k_ij, k_ji = jax.random.split(pair_key, 3)
                num = min(shapes[i][0], shapes[j][0])
                pairs.append((jax_infonce_draws(k_ij, num),
                              jax_infonce_draws(k_ji, num)))
    return EpochDraws(mods, pairs)


def jax_train_draws(key, epochs: int, shapes, **kw):
    """``draws(epoch)`` replaying ``train_layout(..., key=key)``'s
    per-epoch keys (models/layout.py:864)."""
    epoch_keys = jax.random.split(key, epochs)
    return lambda e: jax_epoch_draws(epoch_keys[e], shapes, **kw)
