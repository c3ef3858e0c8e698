"""PyTorch port: the model API, state carried over from a JAX-fitted
model, the eval metrics and the synthetic data against the JAX package,
and the port's import independence.

A JAX-fitted model's state, loaded with ``from_numpy_state``, must give
the same transform graph as the JAX model: ids equal, weights and the
weighted-average init rtol 5e-4 / atol 1e-6 -- both engines take
expanded-form f32 distances whose matmuls sum in another order (last
bits), and exp(-(d - rho) / sigma) divides that difference by a small
sigma (1.1e-4 relative seen). Metrics on the same embeddings agree to
1e-6 (they count the same neighbors).
"""

import ast
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t

from multimodal_umap_tpu.data.synthetic import (
    clustered_modalities as j_clustered,
)
from multimodal_umap_tpu.eval.trustworthiness import (
    trustworthiness as j_trust,
    trustworthiness_sampled as j_trust_sampled,
)
from multimodal_umap_tpu.eval.validation import (
    _mean_pairwise_cosine as j_cosine,
    bidirectional_recall as j_recall,
)
from multimodal_umap_tpu.models.mixture import MultimodalUMAP as JModel
from multimodal_umap_tpu_torch import Config
from multimodal_umap_tpu_torch.data.synthetic import (
    clustered_modalities,
    clustered_modalities_device,
)
from multimodal_umap_tpu_torch.eval.trustworthiness import (
    trustworthiness,
    trustworthiness_sampled,
)
from multimodal_umap_tpu_torch.eval.validation import (
    _mean_pairwise_cosine,
    bidirectional_recall,
    knn_test,
    similarity_test,
    train,
)
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_model():
    data = j_clustered(72, dims=(10, 7), n_clusters=4, seed=5)
    model = JModel(6, 3, 0.1, num_encoders=2, seed=1)
    model.fit([data["texts"][:60], data["images"][:60]], epochs=4, num_rep=2,
              lr=0.05, alpha=0.5, batch_size=16)
    return model, data


def _state_of(model) -> dict:
    state = {"a": np.float64(model.a), "b": np.float64(model.b),
             "k_neighbors": np.int64(model.k_neighbors),
             "out_dim": np.int64(model.out_dim),
             "min_dist": np.float64(model.min_dist),
             "num_encoders": np.int64(model.num_encoders)}
    for i, enc in enumerate(model.encoders):
        state[f"sigmas_{i}"] = np.asarray(enc.sigmas)
        state[f"rhos_{i}"] = np.asarray(enc.rhos)
        state[f"data_{i}"] = np.asarray(model.data[i])
        state[f"embeds_{i}"] = np.asarray(model.embeds[i])
        for f in ("rows", "cols", "weights", "valid"):
            state[f"graph_{i}_{f}"] = np.asarray(getattr(model.graphs[i], f))
    return state


def _check_transform_graph(port, jmodel, data):
    for i, name in enumerate(("texts", "images")):
        q = data[name][60:]
        j_n, j_w, j_init = jmodel.encoders[i].transform_graph(
            jnp.asarray(q), jmodel.data[i], jmodel.embeds[i])
        p_n, p_w, p_init = port.encoders[i].transform_graph(
            t(q), port.data[i], port.embeds[i])
        np.testing.assert_array_equal(p_n.numpy(), np.asarray(j_n))
        np.testing.assert_allclose(p_w.numpy(), np.asarray(j_w), rtol=5e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(p_init.numpy(), np.asarray(j_init),
                                   rtol=5e-4, atol=1e-6)


def test_from_numpy_state_matches_jax_transform_graph(jax_model):
    jmodel, data = jax_model
    port = MultimodalUMAP.from_numpy_state(_state_of(jmodel), device="cpu")
    assert (port.a, port.b) == (jmodel.a, jmodel.b)
    np.testing.assert_array_equal(port.graphs[1].valid.numpy(),
                                  np.asarray(jmodel.graphs[1].valid))
    _check_transform_graph(port, jmodel, data)
    out = port.transform([data["texts"][60:], data["images"][60:]], epochs=3,
                         num_rep=2, lr=0.05, batch_size=16)
    assert [tuple(e.shape) for e in out] == [(12, 3), (12, 3)]
    assert all(bool(torch.isfinite(e).all()) for e in out)


def test_from_numpy_state_reads_a_jax_checkpoint(jax_model, tmp_path):
    jmodel, data = jax_model
    path = str(tmp_path / "state.npz")
    jmodel.save_state_dict(path)
    with np.load(path) as z:
        port = MultimodalUMAP.from_numpy_state(z, device="cpu")
    assert port.k_neighbors == jmodel.k_neighbors
    _check_transform_graph(port, jmodel, data)


def test_num_encoders_must_be_positive():
    with pytest.raises(ValueError, match="num_encoders"):
        MultimodalUMAP(5, 2, 0.1, num_encoders=0, device="cpu")


def test_cuda_default_never_drops_to_cpu():
    if torch.cuda.is_available():
        assert MultimodalUMAP(5, 2, 0.1, 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            MultimodalUMAP(5, 2, 0.1, 1)
    with pytest.raises(RuntimeError, match="not fitted"):
        MultimodalUMAP(5, 2, 0.1, 1, device="cpu").transform([np.zeros((2, 3))],
                                                              epochs=1)


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(90, 12)).astype(np.float32)
    e = (x[:, :3] + 0.3 * rng.normal(size=(90, 3))).astype(np.float32)
    assert abs(trustworthiness(x, t(e), k=7)
               - float(j_trust(x, e, k=7))) < 1e-6
    assert abs(trustworthiness_sampled(x, t(e), k=7, sample_rows=200)
               - float(j_trust_sampled(x, e, k=7, sample_rows=200))) < 1e-6
    # Sampled rows differ (torch vs jax generators); both estimate the
    # same score.
    assert abs(trustworthiness_sampled(x, t(e), k=7, sample_rows=60,
                                       row_block=16)
               - trustworthiness(x, t(e), k=7)) < 0.02
    e1 = (e + 0.2 * rng.normal(size=e.shape)).astype(np.float32)
    assert abs(float(bidirectional_recall(t(e), t(e1), 5))
               - float(j_recall(jnp.asarray(e), jnp.asarray(e1), 5))) < 1e-6
    normed = [v / np.linalg.norm(v, axis=1, keepdims=True) for v in (e, e1)]
    assert abs(float(_mean_pairwise_cosine([t(v) for v in normed]))
               - float(j_cosine(jnp.asarray(np.stack(normed))))) < 1e-6


def test_validation_entry_points_run():
    data = clustered_modalities(160, dims=(9, 6), n_clusters=4, seed=2,
                                centers_seed=8)
    test = clustered_modalities(20, dims=(9, 6), n_clusters=4, seed=3,
                                centers_seed=8)
    cfg = Config(k_neighbors=6, out_dim=3, train_epochs=30, test_epochs=10,
                 lr=0.05, batch_size=32, num_rep=2)
    model = train(data, cfg, device="cpu")
    assert model.loss_history["fit"].shape == (30,)
    cos = similarity_test(test, cfg, model, return_values=True, quiet=True)
    acc = knn_test(test, cfg, 5, model, return_values=True, quiet=True)
    assert np.isfinite(cos) and 0.0 <= acc <= 1.0


def test_synthetic_data_bit_identical_to_jax():
    for centers_seed in (None, 4):
        ours = clustered_modalities(50, dims=(7, 5), n_clusters=3, seed=9,
                                    centers_seed=centers_seed)
        theirs = j_clustered(50, dims=(7, 5), n_clusters=3, seed=9,
                             centers_seed=centers_seed)
        for name in theirs:
            np.testing.assert_array_equal(ours[name], theirs[name])
    dev = clustered_modalities_device(64, dims=(5, 4, 3), seed=1,
                                      device="cpu")
    assert [tuple(v.shape) for v in dev.values()] == [(64, 5), (64, 4),
                                                      (64, 3)]


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "multimodal_umap_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_torch.py",
              ROOT / "main_torch.py", ROOT / "compare_knn_tile.py",
              ROOT / "compare_layout_terms.py",
              ROOT / "spectral_null_space.py",
              ROOT / "scale_ladder_torch.py", ROOT / "mesh_path_torch.py",
              ROOT / "layout_graph_torch.py"]
    assert len(files) > 15
    assert {"app", "nn", "utils", "models", "ops", "parallel"} <= {
        p.parent.name for p in files}
    banned = ("jax", "jaxlib", "flax", "optax", "multimodal_umap_tpu")
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in banned, (os.fspath(path), mod)
