"""PyTorch port: checkpoints both ways between the port and the JAX
package, the fit graph cache, progress snapshots and resume, and the
loss log.

Arrays that cross a checkpoint are compared for equality (the archive
stores them exactly). A run interrupted at a chunk boundary and resumed
must equal the uninterrupted run bit for bit on the CPU: the port's
draws depend on (seed, epoch) only and the snapshot holds the parameters
and Adam's moments exactly. After a cross-load the transform graph
matches JAX's as in tests/test_torch_model.py (ids equal, weights and
init rtol 5e-4 / atol 1e-6).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t

from multimodal_umap_tpu.data.synthetic import (
    clustered_modalities as j_clustered,
)
from multimodal_umap_tpu.models.mixture import MultimodalUMAP as JModel
from multimodal_umap_tpu.utils.logging import write_loss_log as j_write_log
from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
from multimodal_umap_tpu_torch.utils import checkpoint as ckpt
from multimodal_umap_tpu_torch.utils.logging import write_loss_log

torch.set_num_threads(1)

KW = dict(num_rep=2, lr=0.05, alpha=0.5, batch_size=32)
QKW = dict(num_rep=2, lr=0.05, batch_size=32)


@pytest.fixture(scope="module")
def blobs():
    data = clustered_modalities(112, dims=(12, 9), n_clusters=4, seed=4,
                                centers_seed=2)
    return data["texts"][:96], data["images"][:96], data["texts"][96:]


def _model(seed=9, **kw):
    return MultimodalUMAP(6, 3, 0.1, num_encoders=2, seed=seed, device="cpu",
                          **kw)


def _arrays(model) -> dict:
    """Every array a checkpoint holds, as numpy, by archive key."""
    out = {}
    for i, enc in enumerate(model.encoders):
        out[f"sigmas_{i}"] = np.asarray(enc.sigmas)
        out[f"rhos_{i}"] = np.asarray(enc.rhos)
        out[f"data_{i}"] = np.asarray(model.data[i])
        out[f"embeds_{i}"] = np.asarray(model.embeds[i])
        for f in ("rows", "cols", "weights", "valid"):
            out[f"graph_{i}_{f}"] = np.asarray(getattr(model.graphs[i], f))
    return out


def _assert_same_state(a, b):
    assert (a.k_neighbors, a.out_dim, a.min_dist, a.num_encoders,
            a.a, a.b) == (b.k_neighbors, b.out_dim, b.min_dist,
                          b.num_encoders, b.a, b.b)
    arr_a, arr_b = _arrays(a), _arrays(b)
    assert arr_a.keys() == arr_b.keys()
    for key in arr_a:
        assert arr_a[key].dtype == arr_b[key].dtype, key
        np.testing.assert_array_equal(arr_a[key], arr_b[key], err_msg=key)


@pytest.fixture(scope="module")
def jax_fitted(tmp_path_factory):
    """A JAX-fitted model, its data, and the graph cache its fit wrote."""
    data = j_clustered(72, dims=(10, 7), n_clusters=4, seed=5)
    cache = str(tmp_path_factory.mktemp("jcache") / "graphs.npz")
    model = JModel(6, 3, 0.1, num_encoders=2, seed=1)
    model.fit([data["texts"][:60], data["images"][:60]], epochs=4,
              graph_cache_path=cache, **KW)
    return model, data, cache


@pytest.fixture(scope="module")
def port_fitted(blobs):
    x0, x1, _ = blobs
    model = _model()
    model.fit([x0, x1], epochs=20, **KW)
    return model


def test_port_checkpoint_loads_in_jax_and_back(port_fitted, tmp_path):
    path = str(tmp_path / "port_state.npz")
    port_fitted.save_state_dict(path)
    _assert_same_state(JModel.load_state_dict(path), port_fitted)
    again = MultimodalUMAP.load_state_dict(path, device="cpu")
    _assert_same_state(again, port_fitted)
    assert (again.spectral_method, again.knn_engine) == ("auto", None)


def test_jax_checkpoint_loads_in_port(jax_fitted, tmp_path):
    jmodel, data, _ = jax_fitted
    path = str(tmp_path / "jax_state.npz")
    jmodel.save_state_dict(path)
    port = MultimodalUMAP.load(path, device="cpu")
    _assert_same_state(port, jmodel)
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


def test_bf16_checkpoint_loads(jax_fitted, tmp_path):
    """An archive whose table is stored as bf16 bits (``bf16_keys``, the
    JAX package's encoding) loads as a bfloat16 table, bit for bit, and
    the model infers ``feature_dtype``; saved again it keeps the key."""
    jmodel, _, _ = jax_fitted
    path = str(tmp_path / "state.npz")
    jmodel.save_state_dict(path)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(str(arrays["meta"]))
    meta["bf16_keys"] = ["data_1"]
    arrays["meta"] = np.asarray(json.dumps(meta))
    bits = (np.asarray(jmodel.data[1], dtype=jnp.bfloat16)
            .view(np.uint16))
    arrays["data_1"] = bits
    np.savez(path, **arrays)
    port = MultimodalUMAP.load_state_dict(path, device="cpu")
    assert port.feature_dtype == "bfloat16"
    assert port.data[1].dtype == torch.bfloat16
    assert port.data[0].dtype == torch.float32
    np.testing.assert_array_equal(
        port.data[1].view(torch.int16).numpy().view(np.uint16), bits)
    again = str(tmp_path / "again.npz")
    port.save_state_dict(again)
    with np.load(again) as z:
        assert json.loads(str(z["meta"]))["bf16_keys"] == ["data_1"]
        np.testing.assert_array_equal(z["data_1"], bits)


def test_graph_cache_roundtrip_matches_fresh(blobs, tmp_path):
    x0, x1, _ = blobs
    cache = str(tmp_path / "graphs.npz")
    fresh = _model(seed=5)
    fresh.fit([x0, x1], epochs=10, **KW)
    first = _model(seed=5)
    first.fit([x0, x1], epochs=10, graph_cache_path=cache, **KW)
    assert os.path.exists(cache) and not os.path.exists(cache + ".tmp")
    second = _model(seed=5)
    second.fit([x0, x1], epochs=10, graph_cache_path=cache, **KW)
    assert "fit/graph_0" not in second.timer.report()
    for m in range(2):
        assert torch.equal(second.embeds[m], fresh.embeds[m])
        assert torch.equal(second.graphs[m].rows, first.graphs[m].rows)
        assert torch.equal(second.encoders[m].sigmas,
                           first.encoders[m].sigmas)


def test_graph_cache_rejects_mismatched_data(blobs, tmp_path):
    x0, x1, _ = blobs
    cache = str(tmp_path / "graphs.npz")
    _model(seed=5).fit([x0, x1], epochs=3, graph_cache_path=cache, **KW)
    y0 = x0.copy()
    y0[0] += 1.0  # another fingerprint
    b = _model(seed=5)
    b.fit([y0, x1], epochs=3, graph_cache_path=cache, **KW)
    assert "fit/graph_0" in b.timer.report()  # rebuilt, not loaded
    c = _model(seed=5)
    c.fit([y0, x1], epochs=3, graph_cache_path=cache, **KW)
    assert "fit/graph_0" not in c.timer.report()
    assert torch.equal(c.embeds[0], b.embeds[0])


def test_graph_cache_rejects_mismatched_spectral_method(blobs, tmp_path):
    x0, x1, _ = blobs
    cache = str(tmp_path / "graphs.npz")
    _model(seed=5, spectral_method="auto").fit(
        [x0, x1], epochs=3, graph_cache_path=cache, **KW)
    b = _model(seed=5, spectral_method="dense")
    b.fit([x0, x1], epochs=3, graph_cache_path=cache, **KW)
    assert "fit/graph_0" in b.timer.report()
    c = _model(seed=5, spectral_method="dense")
    c.fit([x0, x1], epochs=3, graph_cache_path=cache, **KW)
    assert "fit/graph_0" not in c.timer.report()


def test_jax_graph_cache_loads_in_port(jax_fitted):
    """The same features give the same fingerprint in both packages, so
    the port reuses a cache the JAX package wrote."""
    jmodel, data, cache = jax_fitted
    port = MultimodalUMAP(6, 3, 0.1, num_encoders=2, seed=1, device="cpu")
    port.fit([data["texts"][:60], data["images"][:60]], epochs=2,
             graph_cache_path=cache, **KW)
    assert "fit/graph_0" not in port.timer.report()
    for m in range(2):
        np.testing.assert_array_equal(port.graphs[m].cols.numpy(),
                                      np.asarray(jmodel.graphs[m].cols))
        np.testing.assert_array_equal(port.encoders[m].sigmas.numpy(),
                                      np.asarray(jmodel.encoders[m].sigmas))


def test_fit_resume_matches_uninterrupted(blobs, tmp_path):
    x0, x1, _ = blobs
    full = _model()
    full.fit([x0, x1], epochs=40, **KW)
    snap = str(tmp_path / "progress.npz")
    part = _model()
    part.fit([x0, x1], epochs=20, progress_path=snap, **KW)
    with np.load(snap) as z:
        assert int(z["epoch"]) == 20 and int(z["opt_0"]) == 20
        assert sorted(z.files) == sorted(
            ["epoch", "embeds_0", "embeds_1"]
            + [f"opt_{i}" for i in range(5)])
    resumed = _model()
    resumed.fit([x0, x1], epochs=40, progress_path=snap, resume=True, **KW)
    assert len(resumed.loss_history["fit"]) == 20
    np.testing.assert_array_equal(resumed.loss_history["fit"],
                                  full.loss_history["fit"][20:])
    for m in range(2):
        assert torch.equal(resumed.embeds[m], full.embeds[m])


def test_resume_at_final_epoch_returns_snapshot(blobs, tmp_path):
    x0, x1, _ = blobs
    snap = str(tmp_path / "final.npz")
    done = _model(seed=3)
    done.fit([x0, x1], epochs=20, progress_path=snap, **KW)
    resumed = _model(seed=3)
    resumed.fit([x0, x1], epochs=20, progress_path=snap, resume=True, **KW)
    assert len(resumed.loss_history["fit"]) == 0
    assert torch.equal(resumed.embeds[0], done.embeds[0])


def test_progress_path_without_npz_extension(blobs, tmp_path):
    x0, x1, _ = blobs
    snap = str(tmp_path / "snap")
    _model(seed=5).fit([x0, x1], epochs=20, progress_path=snap, **KW)
    assert os.path.exists(snap + ".npz")
    resumed = _model(seed=5)
    resumed.fit([x0, x1], epochs=40, progress_path=snap, resume=True, **KW)
    assert len(resumed.loss_history["fit"]) == 20
    full = _model(seed=5)
    full.fit([x0, x1], epochs=40, **KW)
    assert torch.equal(resumed.embeds[0], full.embeds[0])


def test_resume_requires_progress_path(blobs):
    x0, x1, _ = blobs
    with pytest.raises(ValueError, match="progress_path"):
        _model().fit([x0, x1], epochs=2, resume=True, **KW)


def test_transform_and_invert_resume_match_uninterrupted(port_fitted, blobs,
                                                         tmp_path):
    _, _, q = blobs
    model = port_fitted
    full = model.transform([q], epochs=30, data_indices=[0], **QKW)
    snap = str(tmp_path / "t_progress.npz")
    model.transform([q], epochs=15, data_indices=[0], progress_path=snap,
                    **QKW)
    resumed = model.transform([q], epochs=30, data_indices=[0],
                              progress_path=snap, resume=True, **QKW)
    assert len(model.loss_history["transform"]) == 15
    assert torch.equal(resumed[0], full[0])

    z = full[0]
    inv_full = model.inverse_transform([z], epochs=30, data_indices=[1],
                                       **QKW)
    snap_i = str(tmp_path / "i_progress")
    model.inverse_transform([z], epochs=15, data_indices=[1],
                            progress_path=snap_i, **QKW)
    inv_resumed = model.inverse_transform([z], epochs=30, data_indices=[1],
                                          progress_path=snap_i, resume=True,
                                          **QKW)
    assert len(model.loss_history["invert"]) == 15
    assert torch.equal(inv_resumed[0], inv_full[0])


def test_snapshot_throttle_and_final_save(blobs, tmp_path, monkeypatch):
    """With small chunks and a huge interval only the first boundary
    (cold timer) and the final one write; the final one resumes."""
    x0, x1, _ = blobs
    snap = str(tmp_path / "throttled.npz")
    monkeypatch.setenv("MMUMAP_EPOCH_CHUNK", "5")
    monkeypatch.setenv("MMUMAP_SNAPSHOT_INTERVAL_S", "1e9")
    writes = []
    real_write = ckpt.write_npz

    def counting_write(path, arrays):
        writes.append(int(arrays["epoch"]))
        real_write(path, arrays)

    monkeypatch.setattr(ckpt, "write_npz", counting_write)
    m = _model(seed=7)
    m.fit([x0, x1], epochs=20, progress_path=snap, **KW)
    assert writes == [5, 20]
    assert int(np.load(snap)["epoch"]) == 20
    resumed = _model(seed=7)
    resumed.fit([x0, x1], epochs=20, progress_path=snap, resume=True, **KW)
    assert len(resumed.loss_history["fit"]) == 0
    assert torch.equal(resumed.embeds[0], m.embeds[0])


def test_write_loss_log_matches_jax(tmp_path):
    losses = np.array([3.5, 2.25, 1.125], dtype=np.float32)
    ours = write_loss_log(str(tmp_path / "p"), "fit", losses)
    theirs = j_write_log(str(tmp_path / "j"), "fit", losses)
    assert os.path.basename(ours).startswith("fit_")
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    assert write_loss_log(None, "fit", losses) is None
