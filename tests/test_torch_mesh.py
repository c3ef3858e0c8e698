"""PyTorch port: the data-parallel mesh against the JAX package's mesh.

Each case spawns P gloo ranks on the CPU (tests/_torch_dist.py: one
torch thread each, a ``file://`` store under ``tmp_path``, a timeout on
the rendezvous and on the join) and holds what they return against the
JAX function on ``create_mesh(P)`` over the conftest's 8 virtual CPU
devices, at P = 2 and 4, on inputs drawn from a numpy seed -- the cases
of tests/test_sharding.py and tests/test_knn_stream.py's ring cases.

Tolerances: ring kNN ids tie-aware, distances rtol 1e-5 (exact
re-scores; f32 panels of the same expansion); mesh graphs against JAX's
single-device graph: weights and bandwidths rtol 1e-5; spectral inits
by principal angles: the port's mesh init against its single-device init
(the same start block) cos >= 1 - 1e-6, against JAX's (another seeded
block) > 0.99 as in tests/test_torch_graph.py; the sharded fit layout
against JAX's sharded engine on JAX's replayed draws: losses rtol 1e-5,
embeddings rtol 1e-4 / atol 1e-5; transform / invert / the ring reference
engine against the port on one device (the same draws): the same.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_dist as TD
from _torch_dist import run_ranks
from _torch_parity import (
    assert_ids_tie_aware,
    jax_train_draws,
    subspace_sv,
    t,
)

from multimodal_umap_tpu.models import layout as JL
from multimodal_umap_tpu.models.encoder import ModalityEncoder as JEnc
from multimodal_umap_tpu.ops.graph import fuzzy_weights, symmetrize_dense
from multimodal_umap_tpu.ops.knn import knn as j_knn
from multimodal_umap_tpu.ops.knn_stream import knn_ring as j_knn_ring
from multimodal_umap_tpu.ops.knn_stream import (
    pad_rows_to_multiple as j_pad_rows,
)
from multimodal_umap_tpu.parallel import ShardingPlan as JPlan
from multimodal_umap_tpu.parallel import create_mesh as j_create_mesh
from multimodal_umap_tpu.parallel import shard_task as j_shard_task
from multimodal_umap_tpu_torch.models.encoder import ModalityEncoder
from multimodal_umap_tpu_torch.models.layout import (
    fit_task,
    query_task,
    train_layout,
)
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
from multimodal_umap_tpu_torch.ops.knn_stream import pad_rows_to_multiple
from multimodal_umap_tpu_torch.parallel import Mesh, ShardingPlan, create_mesh

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

A, B = 1.577, 0.8951
P_SIZES = (2, 4)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _blobs(n_per, dims, seed, n_clusters=4):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(n_clusters), n_per)
    out = []
    for d in dims:
        centers = rng.normal(size=(n_clusters, d)) * 6.0
        out.append((centers[labels]
                    + rng.normal(size=(len(labels), d))).astype(np.float32))
    return out, labels


# ---- ring kNN ------------------------------------------------------------

def _ring_cases():
    """name -> (the whole tables every rank passes, true query rows)."""
    x = _x(1, (256, 16))
    q, r = _x(2, (64, 8)), _x(3, (320, 8))
    q_pad, n_q = j_pad_rows(_x(4, (37, 6)), 8)
    r_pad, n_r = j_pad_rows(_x(5, (100, 6)), 8)
    x12 = _x(6, (64, 12))
    return {
        "self_f32": (dict(q=x, k=9, exclude_self=True, bf16=False), 256),
        "query_f32": (dict(q=q, r=r, k=5, bf16=False), 64),
        "self_bf16_rank": (dict(q=x, k=9, exclude_self=True, bf16=True), 256),
        "self_bf16_stored": (dict(q=x12, k=5, exclude_self=True, bf16=True,
                                  stored="bfloat16"), 64),
        "padded_refs": (dict(q=np.asarray(q_pad), r=np.asarray(r_pad), k=5,
                             bf16=True, num_valid_cols=n_r), n_q),
    }


@pytest.fixture(scope="module", params=P_SIZES)
def ring_run(request, tmp_path_factory):
    p = request.param
    cases = _ring_cases()
    results = run_ranks(TD.knn_ring_rank, p, tmp_path_factory.mktemp("ring"),
                        [c for c, _ in cases.values()])
    refusal = run_ranks(TD.knn_ring_refuses_rank, p,
                        tmp_path_factory.mktemp("refuse"), _x(7, (101, 4)))
    return p, dict(zip(cases, zip(*results))), refusal


@pytest.mark.parametrize("case", list(_ring_cases()))
def test_knn_ring_matches_jax(ring_run, case):
    p, results, _ = ring_run
    c, n_q = _ring_cases()[case]
    d_p = np.concatenate([r["d"] for r in results[case]])[:n_q]
    i_p = np.concatenate([r["i"] for r in results[case]])[:n_q]
    stored = jnp.bfloat16 if c.get("stored") == "bfloat16" else jnp.float32
    q = jnp.asarray(c["q"], dtype=stored)
    r = q if c.get("r") is None else jnp.asarray(c["r"], dtype=stored)
    d_j, i_j = j_knn_ring(q, r, c["k"], j_create_mesh(p),
                          exclude_self=c.get("exclude_self", False),
                          bf16=c["bf16"],
                          num_valid_cols=c.get("num_valid_cols"))
    d_j, i_j = np.asarray(d_j)[:n_q], np.asarray(i_j)[:n_q]
    if c.get("num_valid_cols") is not None:
        assert (i_p < c["num_valid_cols"]).all()
    assert_ids_tie_aware(d_p, i_p, d_j, i_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-5, atol=1e-6)


def test_knn_ring_refuses_indivisible_rows(ring_run):
    p, _, refusal = ring_run
    assert all("divisible" in msg for msg in refusal), refusal
    with pytest.raises(ValueError, match="divisible"):
        j_knn_ring(jnp.asarray(_x(7, (101, 4))), jnp.asarray(_x(7, (101, 4))),
                   3, j_create_mesh(p))


@pytest.mark.parametrize("n", [100, 96])
def test_pad_rows_to_multiple_matches_jax(n):
    x = _x(8, (n, 4))
    ours, n_o = pad_rows_to_multiple(x, 8)
    theirs, n_t = j_pad_rows(x, 8)
    assert n_o == n_t == n
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    tens, _ = pad_rows_to_multiple(torch.as_tensor(x), 8)
    np.testing.assert_array_equal(tens.numpy(), np.asarray(theirs))


# ---- placement -------------------------------------------------------------

@pytest.mark.parametrize("p", P_SIZES)
def test_sharding_plan_rows_match_jax(p):
    x = _x(9, (64, 3))
    jplan = JPlan(j_create_mesh(p))
    shards = {s.device: np.asarray(s.data)
              for s in jplan.rows(jnp.asarray(x)).addressable_shards}
    devs = list(j_create_mesh(p).devices)
    for rank in range(p):
        plan = ShardingPlan(Mesh(rank=rank, size=p,
                                 device=torch.device("cpu"),
                                 backend="gloo"))
        np.testing.assert_array_equal(plan.rows(x).numpy(),
                                      shards[devs[rank]])
        # indivisible: the whole table, as JAX's replication fallback
        np.testing.assert_array_equal(plan.rows(x[:63]).numpy(), x[:63])
        with pytest.raises(ValueError, match="divide"):
            plan.shard(x[:63])


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(2, "cpu")


# ---- the mesh fit graph ----------------------------------------------------

@pytest.fixture(scope="module")
def graph_input():
    x = _x(10, (512, 24))
    enc = JEnc(10, 4)
    g, dense, init = enc.fit_graph(jnp.asarray(x))
    port = ModalityEncoder(10, 4)
    _, _, p_init = port.fit_graph(torch.as_tensor(x))
    return x, (enc, g, dense, np.asarray(init)), p_init.numpy()


@pytest.mark.parametrize("p", P_SIZES)
def test_mesh_fit_graph_matches_single_device(graph_input, p, tmp_path):
    x, (enc, g, dense, j_init), p_init = graph_input
    res = run_ranks(TD.fit_graph_rank, p, tmp_path, x, 10, 4)
    ours = res[0]
    for other in res[1:]:  # whole on every rank
        np.testing.assert_array_equal(other["nbrs"], ours["nbrs"])
    d = np.linalg.norm(x[:, None] - x[ours["nbrs"]], axis=2)
    d_j = np.linalg.norm(x[:, None] - x[np.asarray(dense.nbrs)], axis=2)
    assert_ids_tie_aware(d, ours["nbrs"], d_j, np.asarray(dense.nbrs))
    np.testing.assert_allclose(ours["sigmas"], np.asarray(enc.sigmas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["rhos"], np.asarray(enc.rhos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["weights"], np.asarray(dense.weights),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours["bwd_valid"],
                                  np.asarray(dense.bwd_valid))
    np.testing.assert_allclose(ours["edge_w"], np.asarray(g.weights),
                               rtol=1e-5, atol=1e-6)
    assert subspace_sv(ours["init"], p_init).min() >= 1 - 1e-6
    assert subspace_sv(ours["init"], j_init).min() > 0.99


# ---- the sharded layout engine ---------------------------------------------

def _fit_tasks(n=128, m=2):
    """``m`` modalities (the first two the same whatever ``m``)."""
    xs, _ = _blobs(n // 4, (12, 10, 8)[:m], seed=11)
    tasks_np, j_tasks, j_statics, inits = [], [], [], []
    rng = np.random.default_rng(12)
    for x in xs:
        d, i = j_knn(jnp.asarray(x), jnp.asarray(x), 8, exclude_self=True)
        w, _, _ = fuzzy_weights(d)
        dense = symmetrize_dense(i, w)
        tj, sj = JL.fit_task(dense, 32)
        j_tasks.append(tj)
        j_statics.append(sj)
        tasks_np.append({"nbrs": np.asarray(dense.nbrs),
                         "weights": np.asarray(dense.weights),
                         "bwd_valid": np.asarray(dense.bwd_valid)})
        inits.append((rng.normal(size=(n, 4)) * 0.1).astype(np.float32))
    return tasks_np, j_tasks, j_statics, inits


# Two modalities (ids "2", "4": P alone) and three, whose InfoNCE pair loop
# the mesh shares with the single device.
@pytest.mark.parametrize("p,m", [
    pytest.param(p, m, id=str(p) if m == 2 else f"{p}-three_modalities")
    for m in (2, 3) for p in P_SIZES])
def test_sharded_fit_layout_matches_jax_sharded_engine(p, m, tmp_path):
    tasks_np, j_tasks, j_statics, inits = _fit_tasks(m=m)
    kw = dict(epochs=5, num_rep=2, lr=0.05, alpha=0.5, batch_size=32,
              a=A, b=B)
    key = jax.random.PRNGKey(0)
    replay = jax_train_draws(key, 5, [(128, 8)] * m, mode="fit",
                             num_rep=2, alpha=0.5)
    draws = [replay(e) for e in range(5)]
    statics = [fit_task(_dense_t(tn), 32)[1] for tn in tasks_np]

    def jax_engine():  # runs while the ranks do
        jplan = JPlan(j_create_mesh(p))
        pairs = [j_shard_task(jplan, tk, jnp.asarray(e))
                 for tk, e in zip(j_tasks, inits)]
        return JL.train_layout([e for _, e in pairs],
                               [tk for tk, _ in pairs], j_statics,
                               mode="fit", key=key, **kw)

    res, (j_emb, j_hist) = run_ranks(
        TD.layout_rank, p, tmp_path, "fit", tasks_np, statics, inits, draws,
        kw, meanwhile=jax_engine)
    assert all(r["sharded"] for r in res)
    np.testing.assert_allclose(res[0]["hist"], np.asarray(j_hist), rtol=1e-5)
    for ours, theirs in zip(res[0]["embeds"], j_emb):
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("m", [2, 3])
def test_sharded_fit_engine_at_one_rank_is_single_device(m, tmp_path):
    # At one rank every term of the mesh's fit loss is the single-device
    # one, built in the same order: embeddings and losses bit-equal.
    tasks_np, _, _, inits = _fit_tasks(m=m)
    statics = [fit_task(_dense_t(tn), 32)[1] for tn in tasks_np]
    kw = dict(epochs=5, num_rep=2, lr=0.05, alpha=0.5, batch_size=32,
              a=A, b=B, seed=3)
    (res,) = run_ranks(TD.sharded_vs_single_rank, 1, tmp_path, tasks_np,
                       statics, inits, kw)
    np.testing.assert_array_equal(res["sharded_hist"], res["single_hist"])
    for ours, single in zip(res["sharded"], res["single"]):
        np.testing.assert_array_equal(ours, single)


def _dense_t(tn):
    from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph

    return DenseSymGraph(nbrs=t(tn["nbrs"]), weights=t(tn["weights"]),
                         bwd_valid=t(tn["bwd_valid"]),
                         num_rows=tn["nbrs"].shape[0])


def _query_tasks(mode, n=128, q=32, d=6, seed=13):
    rng = np.random.default_rng(seed)
    tn = {"nbrs": rng.integers(0, n, size=(q, 5)),
          "weights": rng.uniform(0.1, 1.0, size=(q, 5)).astype(np.float32),
          "ref": rng.normal(size=(n, d)).astype(np.float32)}
    if mode == "invert":
        tn["sigmas"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        tn["rhos"] = rng.uniform(0.0, 0.5, size=n).astype(np.float32)
    init = rng.normal(size=(q, d)).astype(np.float32)
    return tn, init


@pytest.mark.parametrize("p", P_SIZES)
@pytest.mark.parametrize("mode", ["transform", "invert"])
def test_ring_reference_engine_matches_full_gather(p, mode, tmp_path):
    """The ring engine (reference table kept sharded, rows fetched by
    ring passes) equals the gathered one, and both equal the port's
    single-device engine on the same draws."""
    tn, init = _query_tasks(mode)
    kw = dict(epochs=4, num_rep=3, lr=0.05, alpha=0.0, batch_size=8, a=A,
              b=B, seed=3)
    static = query_task(t(tn["nbrs"]), t(tn["weights"]), 8,
                        ref=t(tn["ref"]))[1]
    res = run_ranks(TD.layout_engines_rank, p, tmp_path, mode, [tn],
                    [static], [init], kw)
    full, ring = [r["full"] for r in res], [r["ring"] for r in res]
    extra = {k: t(tn[k]) for k in ("sigmas", "rhos") if k in tn}
    task, _ = query_task(t(tn["nbrs"]), t(tn["weights"]), 8,
                         ref=t(tn["ref"]), **extra)
    single, hist = train_layout([t(init)], [task], [static], mode=mode, **kw)
    assert full[0]["sharded"] and ring[0]["sharded"]
    for res in (ring, full):
        np.testing.assert_allclose(res[0]["hist"], hist.numpy(), rtol=1e-5)
        np.testing.assert_allclose(res[0]["embeds"][0], single[0].numpy(),
                                   rtol=1e-4, atol=1e-5)


# ---- the model on the mesh -------------------------------------------------

@pytest.fixture(scope="module")
def model_data():
    (x0, x1), labels = _blobs(32, (12, 10), seed=14)
    return x0, x1, labels


_FIT = dict(epochs=20, num_rep=2, lr=0.05, alpha=0.5, batch_size=32)
_QUERY = dict(epochs=5, num_rep=2, lr=0.05, batch_size=32)


@pytest.mark.parametrize("p,n_q", [(2, 24), (4, 22)])
def test_mesh_transform_and_invert_match_single_device(model_data, p, n_q,
                                                       tmp_path):
    """A mesh model, saved and loaded on one device: its query graph is
    the single-device one; with queries that divide the mesh the
    transform and invert trajectories are too (same draws); with 22 at
    P = 4 the queries are padded, the padded rows masked and sliced off."""
    x0, x1, _ = model_data
    queries = _x(15, (n_q, 12)) * 3.0 + x0[:n_q]
    path = str(tmp_path / "mesh.npz")
    res = run_ranks(TD.model_rank, p, tmp_path, x0, x1, queries, path, _FIT,
                    _QUERY)
    r0 = res[0]
    assert r0["sharded"] and r0["data_rows"] == [128 // p] * 2
    for other in res[1:]:
        np.testing.assert_array_equal(other["transform"], r0["transform"])
    single = MultimodalUMAP.load_state_dict(path, device="cpu")
    np.testing.assert_array_equal(single.embeds[0].numpy(), r0["embeds"][0])
    nbrs, weights, init = single.encoders[0].transform_graph(
        torch.as_tensor(queries), single.data[0], single.embeds[0])
    d_s = np.linalg.norm(queries[:, None] - x0[nbrs.numpy()], axis=2)
    d_m = np.linalg.norm(queries[:, None] - x0[r0["q_nbrs"][:n_q]], axis=2)
    assert_ids_tie_aware(d_m, r0["q_nbrs"][:n_q], d_s, nbrs.numpy())
    np.testing.assert_allclose(r0["q_weights"][:n_q], weights.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r0["q_init"][:n_q], init.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert (r0["q_weights"][n_q:] == 0).all()
    assert r0["transform"].shape == (n_q, 4)
    assert r0["invert"].shape == (n_q, 10)
    assert np.isfinite(r0["transform"]).all() and np.isfinite(
        r0["invert"]).all()
    if n_q % p == 0:
        emb = single.transform([queries], data_indices=[0], **_QUERY)
        rec = single.inverse_transform([torch.as_tensor(r0["transform"])],
                                       data_indices=[1], **_QUERY)
        np.testing.assert_allclose(r0["transform"], emb[0].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r0["transform_hist"],
                                   single.loss_history["transform"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r0["invert"], rec[0].numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r0["invert_hist"],
                                   single.loss_history["invert"], rtol=1e-5)


def test_mesh_indivisible_fit_runs_whole_on_every_rank(model_data, tmp_path):
    """126 rows on 4 ranks: the model stays whole on every rank (the JAX
    plan's replication fallback) and equals the single-device model."""
    x0, x1, _ = model_data
    path = str(tmp_path / "odd.npz")
    res = run_ranks(TD.model_rank, 4, tmp_path, x0[:126], x1[:126],
                    x0[:6], path, _FIT, _QUERY)
    assert not res[0]["sharded"] and res[0]["data_rows"] == [126, 126]
    single = MultimodalUMAP(8, 4, 0.1, 2, device="cpu")
    single.fit([x0[:126], x1[:126]], **_FIT)
    for r in res:
        for ours, theirs in zip(r["embeds"], single.embeds):
            np.testing.assert_array_equal(ours, theirs.numpy())


def test_mesh_resume_matches_uninterrupted(model_data, tmp_path):
    x0, x1, _ = model_data
    snap = str(tmp_path / "snap.npz")
    res = run_ranks(TD.resume_rank, 2, tmp_path, x0, x1, snap,
                    dict(num_rep=2, lr=0.05, alpha=0.5, batch_size=32))
    r0 = res[0]
    assert r0["resumed_rows"] == [64, 64]  # re-sharded on resume
    assert r0["resumed_hist_len"] == 20
    for ours, theirs in zip(r0["resumed"], r0["full"]):
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r0["resumed_hist"], r0["full_hist"][20:],
                               rtol=1e-5)
    with np.load(snap) as z:
        assert z["embeds_0"].shape == (128, 4) and int(z["epoch"]) == 40


def test_mesh_fit_with_bf16_features(model_data, tmp_path):
    x0, x1, labels = model_data
    res = run_ranks(TD.model_rank, 2, tmp_path, x0, x1, x0[:16],
                    str(tmp_path / "bf16.npz"), dict(_FIT, epochs=30),
                    _QUERY, "bfloat16")
    r0 = res[0]
    assert r0["sharded"] and r0["data_dtypes"] == ["torch.bfloat16"] * 2
    assert r0["data_rows"] == [64, 64]
    assert np.isfinite(r0["fit_hist"]).all()
    emb = r0["embeds"][0]
    d = np.linalg.norm(emb[:, None] - emb[None, :], axis=2)
    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(labels), dtype=bool)
    assert d[same & off].mean() < 0.7 * d[~same].mean()
    assert np.isfinite(r0["transform"]).all()
    assert r0["invert"].shape == (16, 10) and np.isfinite(r0["invert"]).all()
    with np.load(tmp_path / "bf16.npz") as z:
        assert z["data_0"].shape == (128, 12)


# ---- data extraction and the CLI -------------------------------------------

def test_mesh_extract_features_matches_one_device(tmp_path):
    from multimodal_umap_tpu_torch.data.flickr30k import (
        Encoders,
        extract_features,
    )

    rng = np.random.default_rng(16)
    samples = [{"alt_text": [f"caption {i}" * (i % 3 + 1)],
                "image": rng.uniform(0, 255, size=(12, 10, 3))}
               for i in range(11)]
    res = run_ranks(TD.extract_rank, 2, tmp_path, samples, 4)
    one = extract_features(samples, Encoders(
        lambda b: np.stack([[len(s), sum(map(ord, s)) % 97] for s in b]
                           ).astype(np.float32),
        lambda b: b.reshape(b.shape[0], -1)[:, :8].astype(np.float32)),
        batch_size=4)
    for r in res:
        np.testing.assert_array_equal(r["texts"], one["texts"])
        np.testing.assert_array_equal(r["images"], one["images"])
        assert r["batches"] == [2, 2, 2]  # each rank half of each batch


def test_cli_mesh_devices_2_matches_mesh_devices_1(tmp_path, monkeypatch,
                                                   capsys):
    import main_torch

    args = ["--synthetic", "--device", "cpu", "--n_samples", "128",
            "--k_neighbors", "6", "--out_dim", "4", "--train_epochs", "30",
            "--test_epochs", "10", "--num_rep", "2", "--batch_size", "64",
            "--save_path", "m.npz", "--log_dir", "logs"]
    mesh_dir, one_dir = tmp_path / "mesh", tmp_path / "one"
    mesh_dir.mkdir()
    one_dir.mkdir()
    res = run_ranks(TD.cli_rank, 2, tmp_path, str(mesh_dir),
                    args + ["--mesh_devices", "2"])
    monkeypatch.chdir(one_dir)
    main_torch.main(args + ["--mesh_devices", "1"])
    capsys.readouterr()
    assert all(r["refused"] == 2 and "world size is 2" in r["refusal"]
               for r in res)
    assert all(r["sharded"] for r in res)
    assert "Average cross-modal cosine similarity" in res[0]["printed"]
    assert res[1]["printed"] == ""  # rank 0 prints and writes
    import json

    ours = json.loads((mesh_dir / "logs" / "metrics.json").read_text())
    theirs = json.loads((one_dir / "logs" / "metrics.json").read_text())
    assert ours["mesh_devices"] == 2 and theirs["mesh_devices"] == 1
    assert ours["cosine_similarity"] >= theirs["cosine_similarity"] - 0.03
    assert ours["knn_accuracy@1"] >= 0.9 * theirs["knn_accuracy@1"]
    with np.load(mesh_dir / "m.npz") as a, np.load(one_dir / "m.npz") as b:
        for key in ("data_0", "data_1"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["embeds_0"].shape == b["embeds_0"].shape
    assert os.path.exists(mesh_dir / "results" / "recon_latents.npz")


def test_mesh_graph_cache_roundtrip(model_data, tmp_path):
    x0, x1, _ = model_data
    cache = str(tmp_path / "graphs.npz")
    res = run_ranks(TD.graph_cache_rank, 2, tmp_path, x0, x1, cache,
                    dict(epochs=10, num_rep=2, lr=0.05, batch_size=32))
    for built, loaded in res:
        assert "fit/graph_0" in built["phases"]
        assert "fit/graph_0" not in loaded["phases"]
        np.testing.assert_array_equal(loaded["sigmas"], built["sigmas"])
        for a, b in zip(loaded["embeds"], built["embeds"]):
            np.testing.assert_array_equal(a, b)
    with np.load(cache) as z:  # whole tables, written once
        assert z["dense_0_nbrs"].shape == (128, 8)
        assert z["init_1"].shape == (128, 4)
