"""PyTorch port: losses, InfoNCE, the fit/transform layout losses and
their trajectories against the JAX package, with JAX's own random draws
replayed (tests/_torch_parity.py).

Tolerances: per-sample losses and InfoNCE rtol 1e-5 (same f32 formulas;
reductions in another order); gradients rtol 2e-4 / atol 1e-6 (the
pattern of tests/test_scatter_free.py, whose dense-vs-naive gradients
carry the same summation-order noise); loss histories of the replayed
12-epoch fit and transform trajectories rtol 1e-4 (Adam's update
sqrt/division rounds differently in optax and torch.optim, and each
epoch feeds the next).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    jax_epoch_draws,
    jax_fit_draws,
    jax_infonce_draws,
    jax_query_draws,
    jax_train_draws,
    t,
)

from multimodal_umap_tpu.models import layout as JL
from multimodal_umap_tpu.ops import losses as JLo
from multimodal_umap_tpu.ops.graph import fuzzy_weights, symmetrize_dense
from multimodal_umap_tpu.ops.knn import knn as j_knn
from multimodal_umap_tpu.ops.scatter_free import (
    random_permutation_pair as j_perm_pair,
)
from multimodal_umap_tpu_torch.models import layout as PL
from multimodal_umap_tpu_torch.ops import losses as PLo
from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph
from multimodal_umap_tpu_torch.ops.scatter_free import permutation_gather

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_goldens.npz")
A, B = 1.577, 0.8951


def test_losses_match_goldens():
    g = np.load(GOLDENS)
    emb, ref = t(g["loss_embeds"]), t(g["loss_ref"])
    i_idx, j_idx, jr_idx = (t(g[k], torch.long) for k in
                            ("loss_i_idx", "loss_j_idx", "loss_jr_idx"))
    a, b = (float(v) for v in g["loss_ab"])
    sig, rho = t(g["loss_sigma"]), t(g["loss_rho"])
    got = {
        "loss_attr": PLo.umap_attr(emb[i_idx], emb[j_idx], a, b),
        "loss_rep": PLo.umap_rep(emb[i_idx], emb[j_idx], a, b),
        "loss_attr_ref": PLo.umap_attr(emb[i_idx], ref[jr_idx], a, b),
        "loss_rep_ref": PLo.umap_rep(emb[i_idx], ref[jr_idx], a, b),
        "loss_inv_attr": PLo.inv_attr(emb[i_idx], ref[jr_idx], a, b,
                                      sig[jr_idx]),
        "loss_inv_rep": PLo.inv_rep(emb[i_idx], ref[jr_idx], sig[jr_idx],
                                    rho[jr_idx]),
    }
    for name, vals in got.items():
        np.testing.assert_allclose(float(vals.mean()), g[name], rtol=1e-4,
                                   err_msg=name)


def test_per_sample_losses_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    y = rng.normal(size=(40, 5)).astype(np.float32)
    y[0] = x[0]  # clamped distance
    sig = rng.random(40).astype(np.float32) + 0.5
    rho = rng.random(40).astype(np.float32)
    pairs = [
        (PLo.umap_attr(t(x), t(y), A, B), JLo.umap_attr(x, y, A, B)),
        (PLo.umap_rep(t(x), t(y), A, B), JLo.umap_rep(x, y, A, B)),
        (PLo.inv_attr(t(x), t(y), A, B, t(sig)),
         JLo.inv_attr(x, y, A, B, sig)),
        (PLo.inv_rep(t(x), t(y), t(sig), t(rho)),
         JLo.inv_rep(x, y, sig, rho)),
        (PLo._l2_normalize(t(x)), JLo._l2_normalize(x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("num,block_rows", [(53, None), (53, 16), (40, 8)])
def test_infonce_matches_jax(num, block_rows):
    """Unblocked and blocked InfoNCE, values and gradients, fed JAX's
    draws (40 rows = every group full: no rotation draw)."""
    rng = np.random.default_rng(1)
    e0 = rng.normal(size=(num, 6)).astype(np.float32)
    e1 = rng.normal(size=(num + 3, 6)).astype(np.float32)
    e0[3] = 0.0  # zero rows stay gradient-safe
    key = jax.random.PRNGKey(11)
    group = 20 if num == 40 else 1000

    def j_loss(a, b):
        return JLo.infonce(key, a, b, group_size=group, block_rows=block_rows)

    v_j, (g0_j, g1_j) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(e0), jnp.asarray(e1))
    draws = jax_infonce_draws(key, num, group_size=group)
    p0, p1 = t(e0).requires_grad_(), t(e1).requires_grad_()
    v_p = PLo.infonce(draws, p0, p1, group_size=group, block_rows=block_rows)
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(p0.grad.numpy(), np.asarray(g0_j), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(p1.grad.numpy(), np.asarray(g1_j), rtol=2e-4,
                               atol=1e-6)


def test_permutation_gather_grad():
    pi_j, _ = j_perm_pair(jax.random.PRNGKey(3), 41)
    pi = t(pi_j, torch.long)
    from multimodal_umap_tpu_torch.ops.scatter_free import inverse_permutation

    pi_inv = inverse_permutation(pi)
    assert torch.equal(pi[pi_inv], torch.arange(41))
    rng = np.random.default_rng(2)
    table = t(rng.normal(size=(41, 4)).astype(np.float32)).requires_grad_()
    w = t(rng.normal(size=(41, 4)).astype(np.float32))
    (permutation_gather(table, pi, pi_inv) * w).sum().backward()
    custom = table.grad.clone()
    table.grad = None
    (table[pi] * w).sum().backward()
    assert torch.equal(custom, table.grad)


def test_window_helpers_match_jax():
    rng = np.random.default_rng(3)
    vals = rng.random(70).astype(np.float32)
    cnt = rng.integers(0, 4, size=70).astype(np.float32)
    cnt[:32] = 0.0  # an empty window
    np.testing.assert_allclose(
        PL._window_means_from_rows(t(vals), t(cnt), 32, 3).numpy(),
        np.asarray(JL._window_means_from_rows(vals, cnt, 32, 3)), rtol=1e-6)
    np.testing.assert_allclose(
        PL._inv_window_coef(t(cnt), 32, 3).numpy(),
        np.asarray(JL._inv_window_coef(cnt, 32, 3)), rtol=1e-6)


def _fit_graph(n, d, k, seed):
    """A JAX-built fit graph and its port twin (identical arrays)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    dist, nbrs = j_knn(x, x, k, exclude_self=True)
    w, _, _ = fuzzy_weights(dist)
    jd = symmetrize_dense(nbrs, w)
    pd = DenseSymGraph(nbrs=t(jd.nbrs), weights=t(jd.weights),
                       bwd_valid=t(jd.bwd_valid), num_rows=n)
    return jd, pd


@pytest.mark.parametrize("deterministic,num_rep", [(True, 0), (True, 3),
                                                   (False, 4)])
def test_fit_modality_loss_and_grad_match_jax(deterministic, num_rep):
    jd, pd = _fit_graph(90, 7, 6, seed=4)
    j_task, j_static = JL.fit_task(jd, 32)
    p_task, p_static = PL.fit_task(pd, 32)
    rng = np.random.default_rng(5)
    embed = rng.normal(size=(90, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def j_loss(e):
        return JL._fit_modality_loss(
            e, j_task, j_static, key, a=jnp.float32(A), b=jnp.float32(B),
            num_rep=num_rep, batch_size=32, deterministic=deterministic)

    v_j, g_j = jax.value_and_grad(j_loss)(jnp.asarray(embed))
    draws = jax_fit_draws(key, 90, 6, num_rep)
    e = t(embed).requires_grad_()
    v_p = PL._fit_modality_loss(e, p_task, p_static, draws, a=A, b=B,
                                num_rep=num_rep, batch_size=32,
                                deterministic=deterministic)
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("deterministic", [True, False])
def test_query_modality_loss_and_grad_match_jax(deterministic):
    rng = np.random.default_rng(6)
    ref = rng.normal(size=(80, 5)).astype(np.float32)
    nbrs = rng.integers(0, 80, size=(37, 6)).astype(np.int32)
    w = rng.random((37, 6)).astype(np.float32)
    embed = rng.normal(size=(37, 5)).astype(np.float32)
    j_task, j_static = JL.query_task(jnp.asarray(nbrs), jnp.asarray(w), 16,
                                     ref=jnp.asarray(ref))
    p_task, p_static = PL.query_task(t(nbrs), t(w), 16, ref=t(ref))
    key = jax.random.PRNGKey(9)

    def j_loss(e):
        return JL._query_modality_loss(
            e, j_task, j_static, key, mode="transform", a=jnp.float32(A),
            b=jnp.float32(B), num_rep=3, batch_size=16,
            deterministic=deterministic)

    v_j, g_j = jax.value_and_grad(j_loss)(jnp.asarray(embed))
    draws = jax_query_draws(key, 37, 6, 3, 80)
    e = t(embed).requires_grad_()
    v_p = PL._query_modality_loss(e, p_task, p_static, draws, a=A, b=B,
                                  num_rep=3, batch_size=16,
                                  deterministic=deterministic)
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=1e-6)


def test_fit_total_loss_matches_jax():
    """make_loss_fn(mode="fit"): two modalities + 2*alpha InfoNCE."""
    graphs = [_fit_graph(64, 6, 5, seed=10), _fit_graph(64, 9, 5, seed=11)]
    j_tasks, j_statics = zip(*(JL.fit_task(jd, 16) for jd, _ in graphs))
    p_tasks, p_statics = zip(*(PL.fit_task(pd, 16) for _, pd in graphs))
    rng = np.random.default_rng(12)
    embeds = [rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(13)
    j_fn = JL.make_loss_fn(j_statics, mode="fit", num_rep=2, alpha=0.5,
                           batch_size=16)
    v_j, g_j = jax.value_and_grad(j_fn)(
        tuple(jnp.asarray(e) for e in embeds), j_tasks,
        (jnp.float32(A), jnp.float32(B)), key)
    draws = jax_epoch_draws(key, [(64, 5), (64, 5)], mode="fit", num_rep=2,
                            alpha=0.5)
    params = [t(e).requires_grad_() for e in embeds]
    p_fn = PL.make_loss_fn(p_statics, mode="fit", num_rep=2, alpha=0.5,
                           batch_size=16)
    v_p = p_fn(params, p_tasks, A, B, draws)
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    for p, g in zip(params, g_j):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=1e-6)


def test_fit_trajectory_matches_jax():
    """12 replayed epochs of the full fit engine: loss history and final
    embeddings track JAX's train_layout."""
    graphs = [_fit_graph(72, 6, 5, seed=20), _fit_graph(72, 10, 5, seed=21)]
    j_tasks, j_statics = zip(*(JL.fit_task(jd, 24) for jd, _ in graphs))
    p_tasks, p_statics = zip(*(PL.fit_task(pd, 24) for _, pd in graphs))
    rng = np.random.default_rng(22)
    inits = [rng.normal(size=(72, 4)).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(5)
    kw = dict(mode="fit", epochs=12, num_rep=3, lr=0.05, alpha=0.5,
              batch_size=24, a=A, b=B)
    j_emb, j_hist = JL.train_layout([jnp.asarray(e) for e in inits], j_tasks,
                                    j_statics, key=key, epoch_chunk=5, **kw)
    seen = []
    p_emb, p_hist = PL.train_layout(
        [t(e) for e in inits], p_tasks, p_statics,
        draws=jax_train_draws(key, 12, [(72, 5), (72, 5)], mode="fit",
                              num_rep=3, alpha=0.5),
        epoch_chunk=5, chunk_callback=lambda done, *_: seen.append(done),
        **kw)
    assert seen == [5, 10, 12]
    np.testing.assert_allclose(p_hist.numpy(), np.asarray(j_hist), rtol=1e-4)
    for p, j in zip(p_emb, j_emb):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)


def test_transform_trajectory_matches_jax():
    rng = np.random.default_rng(30)
    refs = [rng.normal(size=(60, 4)).astype(np.float32) for _ in range(2)]
    nbrs = [rng.integers(0, 60, size=(25, 5)).astype(np.int32)
            for _ in range(2)]
    ws = [rng.random((25, 5)).astype(np.float32) for _ in range(2)]
    inits = [rng.normal(size=(25, 4)).astype(np.float32) for _ in range(2)]
    j_tasks, j_statics = zip(*(
        JL.query_task(jnp.asarray(n), jnp.asarray(w), 8, ref=jnp.asarray(r))
        for n, w, r in zip(nbrs, ws, refs)))
    p_tasks, p_statics = zip(*(
        PL.query_task(t(n), t(w), 8, ref=t(r))
        for n, w, r in zip(nbrs, ws, refs)))
    key = jax.random.PRNGKey(6)
    kw = dict(mode="transform", epochs=12, num_rep=4, lr=0.05, alpha=0.5,
              batch_size=8, a=A, b=B)
    j_emb, j_hist = JL.train_layout([jnp.asarray(e) for e in inits], j_tasks,
                                    j_statics, key=key, **kw)
    p_emb, p_hist = PL.train_layout(
        [t(e) for e in inits], p_tasks, p_statics,
        draws=jax_train_draws(key, 12, [(25, 5), (25, 5)],
                              mode="transform", num_rep=4, alpha=0.5,
                              rep_counts=[60, 60]),
        **kw)
    np.testing.assert_allclose(p_hist.numpy(), np.asarray(j_hist), rtol=1e-4)
    for p, j in zip(p_emb, j_emb):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)


def test_own_draws_resume_replays_the_same_epochs():
    """The port's generators are seeded per (seed, epoch): a run resumed
    at start_epoch from the same state draws exactly the epochs an
    uninterrupted run drew."""
    _, pd = _fit_graph(48, 5, 4, seed=40)
    task, static = PL.fit_task(pd, 16)
    init = torch.randn(48, 3, generator=torch.Generator().manual_seed(0))
    d_a = PL.draw_epoch(PL.epoch_rng(3, 7, torch.device("cpu")), [task],
                        [static], mode="fit", num_rep=2, alpha=0.0)
    d_b = PL.draw_epoch(PL.epoch_rng(3, 7, torch.device("cpu")), [task],
                        [static], mode="fit", num_rep=2, alpha=0.0)
    assert torch.equal(d_a.modality[0].keep_u_f, d_b.modality[0].keep_u_f)
    assert torch.equal(d_a.modality[0].pi, d_b.modality[0].pi)
    assert d_a.modality[0].intra == d_b.modality[0].intra
    _, hist = PL.train_layout([init], [task], [static], mode="fit", epochs=6,
                              num_rep=2, lr=0.05, alpha=0.0, batch_size=16,
                              a=A, b=B, seed=3)
    assert hist.shape == (6,) and torch.isfinite(hist).all()
    _, tail = PL.train_layout([init], [task], [static], mode="fit", epochs=6,
                              num_rep=2, lr=0.05, alpha=0.0, batch_size=16,
                              a=A, b=B, seed=3, start_epoch=4)
    assert tail.shape == (2,)
