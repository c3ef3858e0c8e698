"""PyTorch port: bf16-stored feature tables against the JAX package.

The same numpy inputs, cast to bfloat16 (round to nearest even in both
packages, so the stored bits are equal), go through the JAX package and
the port on the CPU: the kNN on bf16 tables (fit's self graph and f32
queries against a bf16 table) with ids equal as tie-aware sets and
distances rtol 2e-4 (both re-score exactly w.r.t. the stored values);
checkpoints with ``bf16_keys`` both ways, bit-equal; the feature
fingerprint; the invert loss against a bf16 table (rtol 1e-5, gradients
rtol 2e-4 / atol 1e-6, the port's invert tolerances) and its
data-space init; the model's lifecycle as tests/test_mixture.py holds
the JAX package's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_ids_tie_aware, jax_query_draws, t

import multimodal_umap_tpu.ops.knn  # noqa: F401  (module, not function)
import multimodal_umap_tpu_torch.ops.knn  # noqa: F401
from multimodal_umap_tpu.models import layout as JL
from multimodal_umap_tpu.models.mixture import MultimodalUMAP as JModel
from multimodal_umap_tpu.ops.graph import embed_query as j_embed_query
from multimodal_umap_tpu.utils.checkpoint import (
    feature_fingerprint as j_fingerprint,
)
from multimodal_umap_tpu_torch.models import layout as PL
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
from multimodal_umap_tpu_torch.ops import knn_tile as KT
from multimodal_umap_tpu_torch.ops.graph import embed_query
from multimodal_umap_tpu_torch.utils.checkpoint import feature_fingerprint

JK = sys.modules["multimodal_umap_tpu.ops.knn"]
PK = sys.modules["multimodal_umap_tpu_torch.ops.knn"]

torch.set_num_threads(1)

A, B = 1.577, 0.8951


def bits(x) -> np.ndarray:
    """uint16 bit patterns of a bf16 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def bf16_pair(x: np.ndarray):
    """(JAX bf16 array, torch bf16 tensor) of ``x``, with equal bits."""
    j, p = jnp.asarray(x, dtype=jnp.bfloat16), t(x).to(torch.bfloat16)
    np.testing.assert_array_equal(bits(p), bits(j))
    return j, p


# name: (query rows (None: self graph), reference rows, dim, k, scale)
CASES = {
    "self": (None, 300, 24, 7, 3.0),
    "self_wide": (None, 260, 70, 15, 1.0),
    "f32_query": (41, 300, 24, 7, 3.0),
    "f32_query_wide": (33, 280, 70, 15, 1.0),
}


@pytest.mark.parametrize("engine", ["xla", "bf16", "approx"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_on_bf16_tables_matches_jax(case, engine):
    """A bf16 table takes the bf16 rank + exact re-score path under every
    engine, in both packages."""
    q_n, n, d, k, scale = CASES[case]
    rng = np.random.default_rng(11)
    r = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    r_j, r_p = bf16_pair(r)
    if q_n is None:
        q_j, q_p, ex = r_j, r_p, True
    else:
        q = (rng.normal(size=(q_n, d)) * scale).astype(np.float32)
        q_j, q_p, ex = jnp.asarray(q), t(q), False
    d_j, i_j = JK.knn(q_j, r_j, k, exclude_self=ex, engine=engine)
    d_p, i_p = PK.knn(q_p, r_p, k, exclude_self=ex, engine=engine)
    assert d_p.dtype == torch.float32 and i_p.dtype == torch.int32
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=2e-4,
                               atol=1e-6)
    assert_ids_tie_aware(d_p.numpy(), i_p.numpy(), np.asarray(d_j),
                         np.asarray(i_j))
    if ex:
        assert np.all(i_p.numpy() != np.arange(n)[:, None])


def test_bf16_tables_reach_the_kernel_uncopied(monkeypatch):
    """The tile function receives the stored bf16 table itself (one table
    for fit's queries and references), an f32 query cast to bf16 for
    ranking only, and the re-score the f32 query."""
    seen, rescored = [], []
    real_tile, real_rescore = KT.knn_tile, PK._exact_rescore_sq

    def tile(q, r, *a, **kw):
        seen.append((q, r))
        return real_tile(q, r, *a, **kw)

    def rescore(q, r, ids, chunk):
        rescored.append((q, r))
        return real_rescore(q, r, ids, chunk)

    monkeypatch.setattr(KT, "knn_tile", tile)
    monkeypatch.setattr(PK, "_exact_rescore_sq", rescore)
    rng = np.random.default_rng(2)
    table = t(rng.normal(size=(300, 16))).to(torch.bfloat16)
    PK.knn(table, table, 5, exclude_self=True, row_block=128)
    assert len(seen) == 3
    assert all(r.data_ptr() == table.data_ptr() for _, r in seen)
    assert seen[0][0].data_ptr() == table.data_ptr()
    assert all(q.dtype == torch.bfloat16 for q, _ in rescored)
    seen.clear()
    rescored.clear()
    query = t(rng.normal(size=(20, 16)).astype(np.float32))
    PK.knn(query, table, 5)
    (q_k, r_k), = seen
    assert q_k.dtype == torch.bfloat16 and r_k.data_ptr() == table.data_ptr()
    (q_r, r_r), = rescored
    assert q_r.dtype == torch.float32 and q_r.data_ptr() == query.data_ptr()
    assert r_r is table


def test_feature_fingerprint_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(130, 12)).astype(np.float32)
    x_j, x_p = bf16_pair(x)
    assert feature_fingerprint(x_p) == j_fingerprint(x_j)
    assert feature_fingerprint(t(x)) == j_fingerprint(x)
    assert feature_fingerprint(x_p) != feature_fingerprint(t(x))


def _invert_inputs(seed, q=29, n=70, d=6, k=5):
    rng = np.random.default_rng(seed)
    ref = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    nbrs = rng.integers(0, n, size=(q, k)).astype(np.int32)
    w = rng.random((q, k)).astype(np.float32)
    sig = (rng.random(n) + 0.3).astype(np.float32)
    rho = (rng.random(n) * 2.0).astype(np.float32)
    init = (rng.normal(size=(q, d)) * 2.0).astype(np.float32)
    return ref, nbrs, w, sig, rho, init


@pytest.mark.parametrize("deterministic,num_rep",
                         [(True, 0), (True, 3), (False, 4)])
def test_invert_loss_against_bf16_table_matches_jax(deterministic, num_rep):
    """The invert loss reads bf16 rows of the table (gathered, promoted
    to f32 in the arithmetic) in both packages."""
    ref, nbrs, w, sig, rho, embed = _invert_inputs(7)
    ref_j, ref_p = bf16_pair(ref)
    j_task, j_static = JL.query_task(
        jnp.asarray(nbrs), jnp.asarray(w), 16, ref=ref_j,
        sigmas=jnp.asarray(sig), rhos=jnp.asarray(rho))
    p_task, p_static = PL.query_task(t(nbrs), t(w), 16, ref=ref_p,
                                     sigmas=t(sig), rhos=t(rho))
    assert p_task.ref.dtype == torch.bfloat16
    key = jax.random.PRNGKey(4)

    def j_loss(e):
        return JL._query_modality_loss(
            e, j_task, j_static, key, mode="invert", a=jnp.float32(A),
            b=jnp.float32(B), num_rep=num_rep, batch_size=16,
            deterministic=deterministic)

    v_j, g_j = jax.value_and_grad(j_loss)(jnp.asarray(embed))
    draws = jax_query_draws(key, 29, 5, num_rep, 70)
    e = t(embed).requires_grad_()
    v_p = PL._query_modality_loss(e, p_task, p_static, draws, a=A, b=B,
                                  num_rep=num_rep, batch_size=16,
                                  deterministic=deterministic, mode="invert")
    v_p.backward()
    assert v_p.dtype == torch.float32
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_j), rtol=2e-4,
                               atol=1e-6)


def test_invert_init_from_bf16_table_matches_jax():
    ref, nbrs, w, *_ = _invert_inputs(8)
    ref_j, ref_p = bf16_pair(ref)
    want = np.asarray(j_embed_query(jnp.asarray(nbrs), jnp.asarray(w), ref_j))
    got = embed_query(t(nbrs), t(w), ref_p)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def bf16_model(blobs):
    x0, x1, _ = blobs
    model = MultimodalUMAP(10, 4, 0.1, num_encoders=2, seed=0, device="cpu",
                           feature_dtype="bfloat16")
    model.fit([x0, x1], epochs=60, num_rep=4, lr=0.05, alpha=0.5,
              batch_size=64)
    return model


def test_feature_dtype_bf16_full_lifecycle(bf16_model, blobs, tmp_path):
    """tests/test_mixture.py's lifecycle on the port: bf16 tables (the
    storage cast's bits equal JAX's), f32 embeddings, cluster structure,
    transform and invert against the bf16 table, checkpoint round trip."""
    x0, _, labels = blobs
    model = bf16_model
    assert all(d.dtype == torch.bfloat16 for d in model.data)
    np.testing.assert_array_equal(bits(model.data[0]),
                                  bits(jnp.asarray(x0, dtype=jnp.bfloat16)))
    assert all(e.dtype == torch.float32 for e in model.embeds)
    assert np.all(np.isfinite(model.loss_history["fit"]))
    emb = model.embeds[0].numpy()
    d = np.linalg.norm(emb[:, None] - emb[None, :], axis=2)
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(len(labels), dtype=bool)
    assert d[same & off_diag].mean() < 0.6 * d[~same].mean()

    out = model.transform([x0[:16]], epochs=20, data_indices=[0], num_rep=2,
                          lr=0.05, batch_size=64)
    assert out[0].dtype == torch.float32
    assert bool(torch.isfinite(out[0]).all())
    rec = model.inverse_transform([out[0]], epochs=20, data_indices=[0],
                                  num_rep=2, lr=0.05, batch_size=64)
    assert rec[0].dtype == torch.float32
    assert tuple(rec[0].shape) == (16, x0.shape[1])
    assert bool(torch.isfinite(rec[0]).all())

    path = str(tmp_path / "bf16_model.npz")
    model.save_state_dict(path)
    loaded = MultimodalUMAP.load_state_dict(path, device="cpu")
    assert loaded.feature_dtype == "bfloat16"
    for a, b in zip(loaded.data, model.data):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
    assert torch.equal(loaded.embeds[0], model.embeds[0])


def test_bf16_checkpoints_both_ways(bf16_model, tmp_path):
    """The port's bf16 archive loads in the JAX package with the same
    bits and ``feature_dtype``; the JAX package's archive of that model
    loads back in the port bit for bit."""
    port_path = str(tmp_path / "port.npz")
    bf16_model.save_state_dict(port_path)
    jmodel = JModel.load_state_dict(port_path)
    assert jmodel.feature_dtype == "bfloat16"
    for j_d, p_d in zip(jmodel.data, bf16_model.data):
        assert j_d.dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits(j_d), bits(p_d))
    jax_path = str(tmp_path / "jax.npz")
    jmodel.save_state_dict(jax_path)
    back = MultimodalUMAP.load_state_dict(jax_path, device="cpu")
    assert back.feature_dtype == "bfloat16"
    for a, b in zip(back.data, bf16_model.data):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for i in range(2):
        assert torch.equal(back.graphs[i].cols, bf16_model.graphs[i].cols)
        assert torch.equal(back.embeds[i], bf16_model.embeds[i])


def test_jax_bf16_graph_cache_loads_in_port(blobs, tmp_path):
    """A graph cache the JAX package wrote for bf16 tables is keyed on the
    same fingerprints, so the port's bf16 fit loads it."""
    x0, x1, _ = blobs
    cache = str(tmp_path / "graphs.npz")
    jmodel = JModel(6, 3, 0.1, num_encoders=2, seed=1,
                    feature_dtype="bfloat16")
    jmodel.fit([x0[:80], x1[:80]], epochs=2, num_rep=2, lr=0.05, alpha=0.5,
               batch_size=32, graph_cache_path=cache)
    port = MultimodalUMAP(6, 3, 0.1, num_encoders=2, seed=1, device="cpu",
                          feature_dtype="bfloat16")
    port.fit([x0[:80], x1[:80]], epochs=2, num_rep=2, lr=0.05, alpha=0.5,
             batch_size=32, graph_cache_path=cache)
    assert "fit/graph_0" not in port.timer.report()
    np.testing.assert_array_equal(port.graphs[1].cols.numpy(),
                                  np.asarray(jmodel.graphs[1].cols))


def test_feature_dtype_validation():
    with pytest.raises(ValueError, match="feature_dtype"):
        MultimodalUMAP(5, 2, 0.1, num_encoders=1, device="cpu",
                       feature_dtype="fp8")
