"""PyTorch port: kNN engines and the tile kernel's plain version vs JAX.

The same numpy inputs go through ``multimodal_umap_tpu.ops.knn`` (and
``knn_pallas`` in interpret mode) and the port on the CPU. Tolerances:
ids equal as tie-aware sets, distances rtol=atol=2e-4 (the JAX kNN
tests' own bound for f32 expanded-form panels); the bf16 plain version
against JAX's bf16 Pallas kernel: ids equal, distances rtol 1e-4,
atol 1e-5 (both re-score exactly in f32). The kernel itself is held
against its plain version on the card in tests/test_torch_cuda.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_ids_tie_aware, t

import multimodal_umap_tpu.ops.knn  # noqa: F401  (module, not function)
import multimodal_umap_tpu_torch.ops.knn  # noqa: F401
from multimodal_umap_tpu.ops.knn_pallas import knn_pallas
from multimodal_umap_tpu_torch.ops import knn_tile as KT

# ``ops.knn`` names the function on both packages; take the modules.
JK = sys.modules["multimodal_umap_tpu.ops.knn"]
PK = sys.modules["multimodal_umap_tpu_torch.ops.knn"]

torch.set_num_threads(1)

# name: (query rows, reference rows, dim, k, exclude_self, row_block)
CASES = {
    "self": (137, 137, 9, 7, True, 8192),
    "query": (33, 211, 5, 4, False, 8192),
    "unaligned": (19, 187, 33, 4, False, 8192),
    "pallas_self": (40, 40, 24, 5, True, 8192),
    "pallas_query": (24, 200, 16, 7, False, 8192),
    "row_blocked": (130, 130, 6, 5, True, 32),
    "multi_col_tile": (70, 400, 12, 9, False, 32),
}


def _inputs(case, seed=0):
    q_n, n, d, k, ex, blk = CASES[case]
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, d)).astype(np.float32)
    q = r[:q_n] if ex else rng.normal(size=(q_n, d)).astype(np.float32)
    return q, r, k, ex, blk


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_matches_jax_exact(case, engine):
    """Port ``xla`` engine and the kernel's plain version in f32 mode
    (``pallas``) against JAX ``knn(engine="xla")``."""
    q, r, k, ex, blk = _inputs(case)
    d_j, i_j = JK.knn(jnp.asarray(q), jnp.asarray(r), k, exclude_self=ex,
                      engine="xla")
    d_p, i_p = PK.knn(t(q), t(r), k, exclude_self=ex, engine=engine,
                      row_block=blk)
    assert i_p.dtype == torch.int32
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=2e-4,
                               atol=2e-4)
    assert_ids_tie_aware(d_p.numpy(), i_p.numpy(), np.asarray(d_j),
                         np.asarray(i_j))
    if ex:
        assert np.all(i_p.numpy() != np.arange(q.shape[0])[:, None])
    assert np.all(np.diff(d_p.numpy(), axis=1) >= -1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_approx_matches_jax_approx(case):
    """Port ``approx`` (the kernel's f32 mode, exact selection) against
    JAX's ``approx`` engine (``lax.approx_max_k``, which returns
    ``top_k``'s result on the CPU): ids equal, distances rtol 2e-4."""
    q, r, k, ex, blk = _inputs(case)
    d_j, i_j = JK.knn(jnp.asarray(q), jnp.asarray(r), k, exclude_self=ex,
                      engine="approx", row_block=blk)
    d_p, i_p = PK.knn(t(q), t(r), k, exclude_self=ex, engine="approx",
                      row_block=blk)
    assert i_p.dtype == torch.int32
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("scale,q_rows,n,d,k,ex", [
    (4.0, 60, 60, 24, 5, True),     # test_pallas_bf16_self_graph_matches_exact
    (1.0, 21, 150, 17, 6, False),   # test_pallas_bf16_query_mode_padded
])
def test_bf16_plain_matches_jax_pallas_bf16(scale, q_rows, n, d, k, ex):
    rng = np.random.default_rng(1)
    r = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    q = r[:q_rows] if ex else rng.normal(size=(q_rows, d)).astype(np.float32)
    d_j, i_j = knn_pallas(jnp.asarray(q), jnp.asarray(r), k, exclude_self=ex,
                          tile_r=8, tile_c=KT.TILE_C, tile_d=128, interpret=True,
                          bf16=True)
    d_p, i_p = PK.knn(t(q), t(r), k, exclude_self=ex, engine="bf16")
    np.testing.assert_array_equal(np.sort(i_p.numpy(), 1),
                                  np.sort(np.asarray(i_j), 1))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=1e-5)
    assert np.all(i_p.numpy() < n)


@pytest.mark.parametrize("engine", ["bf16", "stream"])
def test_bf16_engines_exact_vs_float64_oracle(engine):
    """bf16 ranking + exact f32 re-score: recall 1.0 against a float64
    oracle, including a near-duplicate cluster (tests/test_knn.py:84)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 24)).astype(np.float32)
    x[100:120] = x[99] + 1e-3 * rng.normal(size=(20, 24)).astype(np.float32)
    d64 = np.linalg.norm(x[:, None, :].astype(np.float64)
                         - x[None, :, :].astype(np.float64), axis=2)
    np.fill_diagonal(d64, np.inf)
    oid = np.argsort(d64, axis=1, kind="stable")[:, :10]
    od = np.take_along_axis(d64, oid, axis=1)
    d_p, i_p = PK.knn(t(x), t(x), 10, exclude_self=True, engine=engine)
    assert np.mean(np.sort(i_p.numpy(), 1) == np.sort(oid, 1)) == 1.0
    np.testing.assert_allclose(d_p.numpy(), od, rtol=1e-4, atol=1e-5)
    # JAX's bf16 engine re-scores exactly too ("stream" ranks in f32 on
    # the CPU and keeps expanded-form distances).
    d_j, _ = JK.knn(jnp.asarray(x), jnp.asarray(x), 10, exclude_self=True,
                    engine="bf16")
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)


def test_multi_col_tile_merge():
    """k-best spread across several 128-column tiles merges exactly
    (tests/test_knn_pallas.py:78-88 at this kernel's tile width)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(130, 8)).astype(np.float32)
    r = np.concatenate([x + 100.0, x, x + 50.0])
    for engine in ("pallas", "bf16"):
        _, i_p = PK.knn(t(x), t(r), 3, engine=engine)
        assert np.all(i_p.numpy()[:, 0] == np.arange(130) + 130)


def test_tile_plain_tie_rule_and_exhausted_tiles():
    """Per tile: ascending, ties to the lowest column, each column once;
    padded and self columns +inf with their own ids."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(5, 6)).astype(np.float32)
    r = np.concatenate([base, base, base[:3]])  # 13 rows, exact duplicates
    q = r[:4]
    d, i = KT.knn_tile_plain(t(q), t(r), 20, exclude_self=True)
    assert d.shape == (1, 4, 20) and i.dtype == torch.int32
    panel = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(panel[:, :4], np.inf)
    panel = np.pad(panel, ((0, 0), (0, KT.TILE_C - 13)),
                   constant_values=np.inf)
    order = np.argsort(panel, axis=1, kind="stable")[:, :20]
    np.testing.assert_array_equal(i.numpy()[0], order)
    np.testing.assert_allclose(d.numpy()[0],
                               np.take_along_axis(panel, order, 1),
                               rtol=1e-5, atol=1e-4)
    assert all(len(set(row)) == 20 for row in i.numpy()[0])


def test_rescore_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(37, 11)).astype(np.float32)
    r = rng.normal(size=(90, 11)).astype(np.float32)
    ids = rng.integers(0, 90, size=(37, 9)).astype(np.int32)
    want = JK._exact_rescore_sq(jnp.asarray(q), jnp.asarray(r),
                                jnp.asarray(ids), chunk=16)
    got = PK._exact_rescore_sq(t(q), t(r), t(ids), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_engine_resolution_and_errors(monkeypatch):
    monkeypatch.delenv("MMUMAP_KNN_ENGINE", raising=False)
    assert PK.resolve_engine(None, "cpu") == "xla"
    assert PK.resolve_engine(None, "cuda") == "bf16"
    assert PK.resolve_engine(None) == "bf16"  # the port's default device
    monkeypatch.setenv("MMUMAP_KNN_ENGINE", "pallas")
    assert PK.resolve_engine(None, "cpu") == "pallas"
    assert PK.resolve_engine("xla", "cuda") == "xla"  # explicit wins
    monkeypatch.setenv("MMUMAP_KNN_ENGINE", "ring")
    with pytest.raises(ValueError, match="unknown kNN engine"):
        PK.resolve_engine(None, "cpu")
    monkeypatch.delenv("MMUMAP_KNN_ENGINE")
    x = torch.zeros(6, 3)
    for engine in ("xla", "bf16", "pallas", "approx"):
        with pytest.raises(ValueError, match="exceeds available"):
            PK.knn(x, x, 6, exclude_self=True, engine=engine)
    for k in (1, 5, 15, 40):
        for n_avail in (10, 100, 1000):
            assert PK._candidate_width(k, n_avail) == JK._candidate_width(
                k, n_avail)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper counts only kernel launches; CPU tensors never launch."""
    before = (KT.KNN_TILE_BF16_LAUNCHES, KT.KNN_TILE_F32_LAUNCHES)
    x = torch.randn(50, 8)
    got = KT.knn_tile(x, x, 5, exclude_self=True)
    want = KT.knn_tile_plain(x, x, 5, exclude_self=True)
    assert (KT.KNN_TILE_BF16_LAUNCHES, KT.KNN_TILE_F32_LAUNCHES) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
