"""PyTorch port: the mesh's collectives, counted by the port's recorder
(``parallel.collectives.recording``) on spawned gloo ranks at P = 2 and
4 (tests/_torch_dist.py), held to the structure
tests/test_layout_sharded_collectives.py pins on the JAX package's
compiled HLO:

* a fit epoch: exactly M table all-gathers and M reduce-scatters (one
  per modality), no table-sized all-reduce, under 3 M table bytes -- the
  same table-sized counts as JAX's lowered epoch on ``create_mesh(P)``;
* transform: the reference table gathered once per chunk, nothing
  table-sized per epoch; the ring reference engine: no table all-gather;
* the ring kNN: exactly P - 1 passes of one (N/P, D) shard (JAX: P - 1
  collective-permutes), bf16 at half the bytes, nothing else;
* the spectral apply: one all-gather of the (N, m) block, no all-reduce;

and each collective's values (and all_gather_rows' reduce-scatter
gradient) on rank-dependent inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _torch_dist as TD
from _torch_dist import run_ranks

from multimodal_umap_tpu.models.layout import fit_task as j_fit_task
from multimodal_umap_tpu.models.layout_sharded import (
    sharded_chunk_runner as j_runner,
)
from multimodal_umap_tpu.ops.graph import symmetrize_dense as j_sym_dense
from multimodal_umap_tpu.ops.knn_stream import knn_ring as j_knn_ring
from multimodal_umap_tpu.parallel import collective_summary as j_summary
from multimodal_umap_tpu.parallel import create_mesh as j_create_mesh

torch.set_num_threads(1)

N, K, D, Q, M = 256, 8, 16, 64, 2
TABLE = N * D * 4
P_SIZES = (2, 4)


@pytest.fixture(scope="module", params=P_SIZES)
def recorded(request, tmp_path_factory):
    p = request.param
    res = run_ranks(TD.collectives_rank, p, tmp_path_factory.mktemp("c"),
                    N, K, D, Q)
    return p, res, None


@pytest.mark.parametrize("p", P_SIZES)
def test_collective_values_and_all_gather_gradient(p, tmp_path):
    prims = run_ranks(TD.primitives_rank, p, tmp_path)
    _check_primitives(p, prims)

def _table_sized(summary, kind, nbytes=TABLE):
    return [b for k, _, b in summary["ops"] if k == kind and b >= nbytes]


def test_fit_epoch_collective_bytes_bounded(recorded):
    p, res, _ = recorded
    for r in res:  # every rank issues the same collectives
        assert r["fit_epoch"]["ops"] == res[0]["fit_epoch"]["ops"]
    s = res[0]["fit_epoch"]
    gathers = _table_sized(s, "all-gather")
    assert gathers == [TABLE] * M, s["ops"]
    rs = [b for k, _, b in s["ops"] if k == "reduce-scatter"]
    assert rs == [TABLE // p] * M, s["ops"]
    assert not _table_sized(s, "all-reduce"), s["ops"]
    assert s["total_bytes"] < 3 * M * TABLE, s["by_kind"]


def test_fit_epoch_table_collectives_match_jax(recorded):
    """The same table-sized all-gathers and reduce-scatters as JAX's
    lowered shard_map epoch on create_mesh(P)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    p, res, _ = recorded
    mesh = j_create_mesh(p)
    shard = NamedSharding(mesh, P("data", None))
    rng = np.random.default_rng(0)
    tasks, statics, params = [], [], []
    for _ in range(M):
        nbrs = jax.device_put(jnp.asarray(
            rng.integers(0, N, size=(N, K)).astype(np.int32)), shard)
        w = jax.device_put(jnp.asarray(
            rng.uniform(0.1, 1.0, size=(N, K)).astype(np.float32)), shard)
        task, static = j_fit_task(j_sym_dense(nbrs, w), 128)
        tasks.append(task)
        statics.append(static)
        params.append(jax.device_put(jnp.asarray(
            rng.normal(size=(N, D)).astype(np.float32)), shard))
    _, run_chunk = j_runner(tuple(statics), "fit", 4, 0.01, 1.0, 128, mesh)
    hlo = run_chunk(tuple(params), optax.adam(0.01).init(tuple(params)),
                    tuple(tasks), (jnp.float32(1.577), jnp.float32(0.8951)),
                    jax.random.split(jax.random.PRNGKey(0), 1),
                    lower_only=True)
    theirs = j_summary(hlo)
    ours = res[0]["fit_epoch"]
    assert (len(_table_sized(ours, "all-gather"))
            == len(_table_sized(theirs, "all-gather")) == M)
    assert (len([1 for k, _, _ in ours["ops"] if k == "reduce-scatter"])
            == len([1 for k, _, _ in theirs["ops"] if k == "reduce-scatter"])
            == M)


def test_transform_epochs_have_no_table_collectives(recorded):
    _, res, _ = recorded
    s = res[0]["transform_full_4"]
    assert _table_sized(s, "all-gather") == [TABLE], s["ops"]
    assert s["total_bytes"] < 2 * TABLE, s["by_kind"]


@pytest.mark.parametrize("mode", ["transform", "invert"])
def test_ring_query_chunk_has_no_table_all_gather(recorded, mode):
    p, res, _ = recorded
    s = res[0][f"{mode}_ring_3"]
    assert not _table_sized(s, "all-gather"), s["ops"]
    assert not _table_sized(s, "all-reduce"), s["ops"]
    permutes = [b for k, _, b in s["ops"] if k == "collective-permute"]
    # attraction rows once per chunk, negatives once per epoch
    assert permutes == [TABLE // p] * ((p - 1) * (1 + 3)), s["ops"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_knn_collective_bytes_are_p_minus_1_shards(recorded, dtype):
    p, res, _ = recorded
    s = res[0][f"ring_{dtype}"]
    size = 4 if dtype == "f32" else 2
    assert [k for k, _, _ in s["ops"]] == ["collective-permute"] * (p - 1)
    assert s["by_kind"] == {"collective-permute":
                            (p - 1) * (N // p) * D * size}
    mesh = j_create_mesh(p)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(N, D)),
                    dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    theirs = j_summary(j_knn_ring(x, x, K, mesh, exclude_self=True,
                                  bf16=dtype == "bf16", lower_only=True))
    assert theirs["by_kind"].get("collective-permute") == \
        s["by_kind"]["collective-permute"]


def test_mesh_spectral_apply_is_one_all_gather(recorded):
    _, res, _ = recorded
    s = res[0]["laplacian_apply"]
    assert s["ops"] == [("all-gather", "f32[256,17]", N * 17 * 4)]
    assert "all-reduce" not in s["by_kind"]


def _check_primitives(p, prims):
    rows = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
            for r in range(p)]
    w = np.arange(3 * p * 2, dtype=np.float32).reshape(3 * p, 2)
    scale = sum(r + 1 for r in range(p))
    for r, out in enumerate(prims):
        np.testing.assert_array_equal(out["full"], np.concatenate(rows))
        # d/dx_r of sum over ranks s of (s + 1) * w * gather(x): the
        # reduce-scatter of the cotangents
        np.testing.assert_array_equal(out["grad"],
                                      scale * w[3 * r:3 * r + 3])
        assert out["psum"] == [sum(1.0 + s for s in range(p))]
        np.testing.assert_array_equal(out["ring"], rows[(r - 1) % p])
        np.testing.assert_array_equal(out["ring_bf16"],
                                      prims[(r - 1) % p]["sent_bf16"])
    np.testing.assert_array_equal(prims[0]["gather"], np.concatenate(rows))
    np.testing.assert_array_equal(
        prims[0]["gather_bf16"],
        np.concatenate([x["sent_bf16"] for x in prims]))
