"""PyTorch port end to end on the CPU: fit + transform + inverse
transform against the executed reference's golden bands (the same data,
seeds, configuration and bands as tests/test_reference_parity_e2e.py:
cosine >= ref - 0.03, knn5 >= 0.9 x ref averaged over model seeds 0-2,
text->image recon MSE <= 1.1 x ref, trustworthiness >= ref - 0.02 per
modality).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
from multimodal_umap_tpu_torch.eval.trustworthiness import trustworthiness
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP

torch.set_num_threads(1)

GOLDEN_FILES = sorted(glob.glob(
    os.path.join(os.path.dirname(__file__), "goldens", "reference_e2e*.json")
))
_KNN5_SEEDS = (0, 1, 2)


def _knn5(e0: np.ndarray, e1: np.ndarray) -> float:
    d = np.linalg.norm(e0[:, None] - e1[None, :], axis=2)
    fwd = np.argsort(d, axis=1)[:, :5]
    bwd = np.argsort(d.T, axis=1)[:, :5]
    ids = np.arange(e0.shape[0])[:, None]
    return float(
        (np.any(fwd == ids, 1).mean() + np.any(bwd == ids, 1).mean()) / 2)


def _run_pipeline(golden):
    cfg = golden["config"]
    data = clustered_modalities(
        cfg["n_train"] + cfg["n_test"], dims=tuple(cfg["dims"]),
        n_clusters=cfg["n_clusters"], seed=cfg["seed"],
    )
    n_tr = cfg["n_train"]
    train = [data["texts"][:n_tr], data["images"][:n_tr]]
    test = [data["texts"][n_tr:], data["images"][n_tr:]]
    knn5_vals = []
    for seed in _KNN5_SEEDS:
        m = MultimodalUMAP(cfg["k"], cfg["out_dim"], 0.1, num_encoders=2,
                           seed=seed, device="cpu")
        m.fit(train, epochs=cfg["epochs"], num_rep=4, lr=0.05, alpha=1.0,
              batch_size=64)
        embeds = m.transform(test, epochs=cfg["test_epochs"],
                             data_indices=[0, 1], num_rep=4, lr=0.05,
                             batch_size=64)
        e0, e1 = (e.numpy() for e in embeds)
        knn5_vals.append(_knn5(e0, e1))
        if seed == 0:
            model, c0, c1 = m, e0, e1
    z = model.transform([test[0]], epochs=cfg["test_epochs"],
                        data_indices=[0], num_rep=4, lr=0.05, batch_size=64)
    recon = model.inverse_transform(z, epochs=cfg["test_epochs"],
                                    data_indices=[1], num_rep=4, lr=0.05,
                                    batch_size=64)[0].numpy()
    mse = float(np.mean((recon - test[1]) ** 2))
    c0 = c0 / np.maximum(np.linalg.norm(c0, axis=1, keepdims=True), 1e-12)
    c1 = c1 / np.maximum(np.linalg.norm(c1, axis=1, keepdims=True), 1e-12)
    trust = [trustworthiness(train[i], model.embeds[i], k=10)
             for i in range(2)]
    return {"cosine": float((c0 * c1).sum(1).mean()),
            "knn5": float(np.mean(knn5_vals)), "recon_mse": mse,
            "trustworthiness": trust}


@pytest.fixture(scope="module", params=GOLDEN_FILES,
                ids=[os.path.basename(p) for p in GOLDEN_FILES])
def case(request):
    with open(request.param) as f:
        golden = json.load(f)
    return golden, _run_pipeline(golden)


def test_cosine_parity(case):
    golden, results = case
    ref = golden["reference"]["cosine"]
    assert results["cosine"] >= ref - 0.03, (results, ref)


def test_knn_retrieval_parity(case):
    golden, results = case
    ref = golden["reference"]["knn5"]
    assert results["knn5"] >= 0.9 * ref, (results, ref)


def test_recon_mse_parity(case):
    golden, results = case
    ref = golden["reference"]["recon_mse"]
    assert results["recon_mse"] <= 1.1 * ref, (results, ref)


def test_trustworthiness_parity(case):
    golden, results = case
    refs = golden["reference"]["trustworthiness"]
    for ours, ref in zip(results["trustworthiness"], refs):
        assert ours >= ref - 0.02, (results["trustworthiness"], refs)
