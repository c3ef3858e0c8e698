"""PyTorch port: invert mode against the JAX package -- the invert layout
loss and its gradient, a replayed invert trajectory, ``invert_graph`` on
a JAX-fitted model, and ``inverse_transform`` / ``embed_and_recon`` end
to end on the CPU.

Tolerances: invert loss values rtol 1e-5 and gradients rtol 2e-4 / atol
1e-6 (the same f32 formulas, reductions in another order -- the port's
transform-loss tolerances); the replayed 12-epoch loss history rtol 1e-4
(optax and torch.optim round Adam's update differently, and each epoch
feeds the next); ``invert_graph`` ids equal as tie-aware sets, curve
weights and the data-space init rtol 5e-4 (expanded-form latent
distances differ in the last bits between the two matmuls, raised to the
power 2b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_ids_tie_aware,
    jax_query_draws,
    jax_train_draws,
    t,
)

from multimodal_umap_tpu.data.synthetic import (
    clustered_modalities as j_clustered,
)
from multimodal_umap_tpu.models import layout as JL
from multimodal_umap_tpu.models.mixture import MultimodalUMAP as JModel
from multimodal_umap_tpu_torch import Config
from multimodal_umap_tpu_torch.eval.validation import embed_and_recon
from multimodal_umap_tpu_torch.models import layout as PL
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP

torch.set_num_threads(1)

A, B = 1.577, 0.8951


def _invert_inputs(seed, q=37, n=80, d=6, k=6):
    rng = np.random.default_rng(seed)
    ref = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    nbrs = rng.integers(0, n, size=(q, k)).astype(np.int32)
    w = rng.random((q, k)).astype(np.float32)
    sig = (rng.random(n) + 0.3).astype(np.float32)
    rho = (rng.random(n) * 2.0).astype(np.float32)
    init = (rng.normal(size=(q, d)) * 2.0).astype(np.float32)
    return ref, nbrs, w, sig, rho, init


def _tasks(ref, nbrs, w, sig, rho, batch_size):
    j = JL.query_task(jnp.asarray(nbrs), jnp.asarray(w), batch_size,
                      ref=jnp.asarray(ref), sigmas=jnp.asarray(sig),
                      rhos=jnp.asarray(rho))
    p = PL.query_task(t(nbrs), t(w), batch_size, ref=t(ref), sigmas=t(sig),
                      rhos=t(rho))
    return j, p


@pytest.mark.parametrize("deterministic,num_rep",
                         [(True, 0), (True, 3), (False, 0), (False, 4)])
def test_invert_loss_and_grad_match_jax(deterministic, num_rep):
    ref, nbrs, w, sig, rho, embed = _invert_inputs(6)
    (j_task, j_static), (p_task, p_static) = _tasks(ref, nbrs, w, sig, rho,
                                                     16)
    key = jax.random.PRNGKey(9)

    def j_loss(e):
        return JL._query_modality_loss(
            e, j_task, j_static, key, mode="invert", a=jnp.float32(A),
            b=jnp.float32(B), num_rep=num_rep, batch_size=16,
            deterministic=deterministic)

    v_j, g_j = jax.value_and_grad(j_loss)(jnp.asarray(embed))
    draws = jax_query_draws(key, 37, 6, num_rep, 80)
    e = t(embed).requires_grad_()
    v_p = PL._query_modality_loss(e, p_task, p_static, draws, a=A, b=B,
                                  num_rep=num_rep, batch_size=16,
                                  deterministic=deterministic, mode="invert")
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=1e-6)


def test_invert_trajectory_matches_jax():
    """12 replayed epochs of two modalities' invert layout."""
    inputs = [_invert_inputs(30 + m, q=25, n=60, d=5, k=5) for m in range(2)]
    pairs = [_tasks(*x[:5], 8) for x in inputs]
    j_tasks, j_statics = zip(*(j for j, _ in pairs))
    p_tasks, p_statics = zip(*(p for _, p in pairs))
    inits = [x[5] for x in inputs]
    key = jax.random.PRNGKey(6)
    kw = dict(mode="invert", epochs=12, num_rep=4, lr=0.05, alpha=0.5,
              batch_size=8, a=A, b=B)
    j_emb, j_hist = JL.train_layout([jnp.asarray(e) for e in inits], j_tasks,
                                    j_statics, key=key, **kw)
    p_emb, p_hist = PL.train_layout(
        [t(e) for e in inits], p_tasks, p_statics,
        draws=jax_train_draws(key, 12, [(25, 5), (25, 5)], mode="invert",
                              num_rep=4, alpha=0.5, rep_counts=[60, 60]),
        **kw)
    np.testing.assert_allclose(p_hist.numpy(), np.asarray(j_hist), rtol=1e-4)
    for p, j in zip(p_emb, j_emb):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def fitted_pair():
    """A JAX-fitted model and its port twin (from_numpy_state)."""
    data = j_clustered(84, dims=(10, 12), n_clusters=4, seed=5)
    jmodel = JModel(6, 3, 0.1, num_encoders=2, seed=1)
    jmodel.fit([data["texts"][:64], data["images"][:64]], epochs=6,
               num_rep=2, lr=0.05, alpha=0.5, batch_size=16)
    state = {"a": jmodel.a, "b": jmodel.b, "k_neighbors": 6, "out_dim": 3,
             "min_dist": 0.1, "num_encoders": 2}
    for i, enc in enumerate(jmodel.encoders):
        state[f"sigmas_{i}"] = np.asarray(enc.sigmas)
        state[f"rhos_{i}"] = np.asarray(enc.rhos)
        state[f"data_{i}"] = np.asarray(jmodel.data[i])
        state[f"embeds_{i}"] = np.asarray(jmodel.embeds[i])
        for f in ("rows", "cols", "weights", "valid"):
            state[f"graph_{i}_{f}"] = np.asarray(getattr(jmodel.graphs[i], f))
    return jmodel, MultimodalUMAP.from_numpy_state(state, device="cpu"), data


def test_invert_graph_matches_jax(fitted_pair):
    jmodel, port, _ = fitted_pair
    rng = np.random.default_rng(3)
    for i in range(2):
        z = (np.asarray(jmodel.embeds[i])[:20]
             + 0.1 * rng.normal(size=(20, 3))).astype(np.float32)
        j_n, j_w, j_init = jmodel.encoders[i].invert_graph(
            jnp.asarray(z), jmodel.embeds[i], jmodel.data[i], jmodel.a,
            jmodel.b)
        p_n, p_w, p_init = port.encoders[i].invert_graph(
            t(z), port.embeds[i], port.data[i], port.a, port.b)
        # Curve weights fall with distance: -w is ascending like distances.
        assert_ids_tie_aware(-p_w.numpy(), p_n.numpy(), -np.asarray(j_w),
                             np.asarray(j_n))
        np.testing.assert_allclose(p_w.numpy(), np.asarray(j_w), rtol=5e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(p_init.numpy(), np.asarray(j_init),
                                   rtol=5e-4, atol=1e-5)


def test_inverse_transform_end_to_end(fitted_pair):
    """Text queries embedded and reconstructed as images on the CPU:
    shapes, the invert phases, the loss history, and a reconstruction
    closer to the targets than the train-mean predictor."""
    _, port, data = fitted_pair
    cfg = Config(k_neighbors=6, out_dim=3, test_epochs=15, num_rep=2,
                 lr=0.05, batch_size=16)
    target = data["images"][64:]
    recon = embed_and_recon(port, [data["texts"][64:]], [0], [1], cfg)[0]
    assert tuple(recon.shape) == (20, 12)
    assert bool(torch.isfinite(recon).all())
    assert port.loss_history["invert"].shape == (15,)
    assert {"invert/graph", "invert/layout"} <= set(port.timer.report())
    mse = float(np.mean((recon.numpy() - target) ** 2))
    baseline = float(np.mean((data["images"][:64].mean(0) - target) ** 2))
    assert mse < baseline, (mse, baseline)
