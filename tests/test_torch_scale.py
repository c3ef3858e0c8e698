"""PyTorch port: the memory-bounded forms against the JAX package's and
against the port's own whole forms, on the CPU at thresholds small
enough to engage them.

* kNN column streaming (``knn_tiled(col_block=...)``) against
  ``knn_streamed(col_block=...)``, f32 and bf16 modes, with self
  columns in later chunks: distances rtol 1e-6 (bf16: both re-score
  exactly in f32; f32: expanded-form panels at D=16), ids tie-aware.
  With one column chunk the result is the unstreamed form's, bit for bit.
* the plain tile version at a negative ``row_offset`` (a chunk past the
  query block): only self columns inside the chunk are masked.
* the ``xla`` engine's streamed f32 panels against JAX's ``xla`` kNN.
* the blocked reverse-edge lookup: bit-equal to JAX's blocked form and
  to the unblocked one; ``fit_graph`` builds both views from one lookup.
* the edge-blocked Laplacian apply: rtol 1e-5; Chebyshev inits by
  principal angles.
* one fit epoch with the slot-scanned attraction and the per-modality
  recompute: loss and gradients rtol 1e-5 against JAX's (draws
  replayed) and against the port's whole form.
* "cuda" resolves to the current card's index, so ``fit`` keeps a table
  already there without a copy.

JAX's thresholds are module constants read when a function is traced;
they are set with ``monkeypatch`` and the functions called un-jitted, or
after ``jax.clear_caches()`` (and again after the test, so that no trace
with a small constant outlives it).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_ids_tie_aware, jax_epoch_draws, subspace_sv, t

import multimodal_umap_tpu.ops.knn  # noqa: F401  (module, not function)
import multimodal_umap_tpu_torch.ops.knn  # noqa: F401
from multimodal_umap_tpu.models import layout as JL
from multimodal_umap_tpu.ops import graph as JG
from multimodal_umap_tpu.ops import spectral as JS
from multimodal_umap_tpu.ops.knn_stream import knn_streamed
from multimodal_umap_tpu_torch.models import encoder as PE
from multimodal_umap_tpu_torch.models import layout as PL
from multimodal_umap_tpu_torch.ops import graph as PG
from multimodal_umap_tpu_torch.ops import knn_tile as KT
from multimodal_umap_tpu_torch.ops import layout_terms as LT
from multimodal_umap_tpu_torch.ops import spectral as PS

JK = sys.modules["multimodal_umap_tpu.ops.knn"]
PK = sys.modules["multimodal_umap_tpu_torch.ops.knn"]

torch.set_num_threads(1)

A, B = 1.577, 0.8951


@pytest.fixture
def fresh_jax_traces():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _table(n, d, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(
        np.float32)


# --- kNN: column streaming -------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("exclude_self", [True, False], ids=["self", "query"])
def test_knn_tiled_streamed_matches_jax_knn_streamed(bf16, exclude_self):
    """1,300 references in chunks of 512 (the last short) and query blocks
    of 256: every block meets chunks before, at and past its self
    columns (positive, in-chunk and negative ``row_offset``)."""
    r = _table(1_300, 16, seed=0)
    q = r[:700] if exclude_self else _table(300, 16, seed=1)
    d_j, i_j = knn_streamed(jnp.asarray(q), jnp.asarray(r), 7,
                            exclude_self=exclude_self, row_block=256,
                            col_block=512, bf16=bf16)
    d_p, i_p = KT.knn_tiled(t(q), t(r), 7, exclude_self=exclude_self,
                            bf16=bf16, row_block=256, col_block=512)
    d_w, i_w = KT.knn_tiled(t(q), t(r), 7, exclude_self=exclude_self,
                            bf16=bf16, row_block=256, col_block=2_048)
    assert i_p.dtype == torch.int32 and int(i_p.max()) < 1_300
    if exclude_self:
        assert not (i_p.numpy() == np.arange(700)[:, None]).any()
    for d_x, i_x in ((np.asarray(d_j), np.asarray(i_j)),
                     (d_w.numpy(), i_w.numpy())):
        np.testing.assert_allclose(d_p.numpy(), d_x, rtol=1e-6)
        assert_ids_tie_aware(d_p.numpy(), i_p.numpy(), d_x, i_x, rtol=1e-6,
                             atol=0.0)


def _unstreamed_knn_tiled(queries, references, k, *, exclude_self, bf16,
                          row_block):
    """``knn_tiled`` as it was before column streaming: one launch per
    row block against every reference column."""
    num_q, num_r = queries.shape[0], references.shape[0]
    if bf16:
        tile_k = KT.bf16_tile_k(k, num_r - (1 if exclude_self else 0))
        cand = max(4 * k, 64)
    else:
        tile_k = k
    dtype = torch.bfloat16 if bf16 else torch.float32
    rw, qw = references.to(dtype), queries.to(dtype)
    d_parts, i_parts = [], []
    for s in range(0, num_q, row_block):
        e = min(s + row_block, num_q)
        nq = e - s
        d_c, i_c = KT.knn_tile(qw[s:e], rw, tile_k, exclude_self=exclude_self,
                               row_offset=s)
        width = d_c.shape[0] * tile_k
        cand_d = d_c.permute(1, 0, 2).reshape(nq, width)
        cand_i = i_c.permute(1, 0, 2).reshape(nq, width)
        if not bf16:
            vals, pos = torch.topk(cand_d, k, dim=1, largest=False)
            ids = cand_i.gather(1, pos)
        else:
            _, pos = torch.topk(cand_d, min(cand, width), dim=1,
                                largest=False)
            ids_c = cand_i.gather(1, pos)
            d2 = PK._exact_rescore_sq(
                queries[s:e], references, ids_c.clamp(0, num_r - 1),
                chunk=min(KT.rescore_chunk(ids_c.shape[1],
                                           queries.shape[1]), nq))
            invalid = ids_c >= num_r
            if exclude_self:
                invalid |= ids_c == torch.arange(s, e)[:, None]
            d2 = d2.masked_fill(invalid, float("inf"))
            vals, sel = torch.topk(d2, k, dim=1, largest=False)
            ids = ids_c.gather(1, sel)
        d_parts.append(vals.clamp_min(0.0).sqrt())
        i_parts.append(ids)
    return torch.cat(d_parts), torch.cat(i_parts)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_knn_tiled_one_chunk_is_the_unstreamed_form(bf16):
    """At N <= COL_BLOCK (the 31,744-pair main path is one chunk) the
    streamed wrapper returns exactly what the unstreamed one returned."""
    x = torch.from_numpy(_table(900, 24, seed=2, scale=3.0))
    q = torch.from_numpy(_table(130, 24, seed=3, scale=3.0))
    assert x.shape[0] <= KT.COL_BLOCK
    for queries, ex in ((x, True), (q, False)):
        got = KT.knn_tiled(queries, x, 15, exclude_self=ex, bf16=bf16,
                           row_block=256)
        want = _unstreamed_knn_tiled(queries, x, 15, exclude_self=ex,
                                     bf16=bf16, row_block=256)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_tile_negative_row_offset_masks_only_in_chunk_self_columns():
    """A chunk that starts past the query block: ``row_offset`` < 0. Rows
    whose self column lies in the chunk are masked there, the others
    not at all (a negative column index must not wrap round)."""
    x = torch.from_numpy(_table(700, 12, seed=4))
    q, chunk = x[:300], x[200:700]  # query rows [0, 300), columns [200, 700)
    d, i = KT.knn_tile_plain(q, chunk, 9, exclude_self=True, row_offset=-200)
    panel = ((q.double()[:, None, :] - chunk.double()[None]) ** 2).sum(-1)
    rows = torch.arange(200, 300)
    panel[rows, rows - 200] = float("inf")
    nct = -(-500 // KT.TILE_C)
    panel = torch.nn.functional.pad(panel, (0, nct * KT.TILE_C - 500),
                                    value=float("inf"))
    want_d, order = torch.sort(panel.view(300, nct, KT.TILE_C), dim=2,
                               stable=True)
    want_i = (order[..., :9] + torch.arange(nct)[None, :, None] * KT.TILE_C)
    got_d = d.permute(1, 0, 2).reshape(300, -1).double()
    got_i = i.permute(1, 0, 2).reshape(300, -1)
    want_d = want_d[..., :9].reshape(300, -1)
    scale = float(2 * (x.double() ** 2).sum(1).max())
    fin = torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(got_d), fin)
    assert bool(((got_d - want_d).abs()[fin] <= 1e-5 * scale).all())
    assert_ids_tie_aware(got_d.numpy(), got_i.numpy(), want_d.numpy(),
                         want_i.reshape(300, -1).numpy(), rtol=0.0,
                         atol=1e-5 * scale)
    # wholly past the block: nothing masked
    far = KT.knn_tile_plain(q, x[400:], 9, exclude_self=True, row_offset=-400)
    free = KT.knn_tile_plain(q, x[400:], 9)
    assert torch.equal(far[0], free[0]) and torch.equal(far[1], free[1])


def test_xla_engine_streams_columns_past_panel_threshold(monkeypatch):
    """Past the panel threshold (set to 0 here) the xla engine sweeps f32
    column chunks; the result is JAX's unstreamed xla kNN."""
    r = _table(1_100, 10, seed=5)
    monkeypatch.setattr(PK, "_XLA_PANEL_BYTES", 0)
    monkeypatch.setattr(KT, "COL_BLOCK", 256)
    d_p, i_p = PK.knn(t(r), t(r), 6, exclude_self=True, engine="xla",
                      row_block=128)
    d_j, i_j = JK.knn(jnp.asarray(r), jnp.asarray(r), 6, exclude_self=True,
                      engine="xla")
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)
    assert_ids_tie_aware(d_p.numpy(), i_p.numpy(), np.asarray(d_j),
                         np.asarray(i_j))
    monkeypatch.setattr(PK, "_XLA_PANEL_BYTES", 4 * 1024**3)
    d_w, i_w = PK.knn(t(r), t(r), 6, exclude_self=True, engine="xla",
                      row_block=128)
    np.testing.assert_allclose(d_p.numpy(), d_w.numpy(), rtol=1e-6)
    assert_ids_tie_aware(d_p.numpy(), i_p.numpy(), d_w.numpy(), i_w.numpy())


# --- graph: blocked reverse-edge lookup -------------------------------------

def _distinct_nbrs(n, k, seed):
    rng = np.random.default_rng(seed)
    nbrs = np.stack([rng.choice(n - 1, size=k, replace=False)
                     for _ in range(n)]).astype(np.int32)
    nbrs = np.where(nbrs >= np.arange(n)[:, None], nbrs + 1, nbrs)
    return nbrs, rng.random((n, k), dtype=np.float32)


def test_reverse_lookup_blocked_is_bit_equal(monkeypatch):
    nbrs, w = _distinct_nbrs(700, 7, seed=6)
    # make many reverse edges exist: symmetrize half the lists' first slot
    nbrs[nbrs[:350, 0], 1] = np.arange(350)
    monkeypatch.setattr(JG, "_REV_BLOCK", 256)
    j_w, j_e = JG._reverse_edge_weights(jnp.asarray(nbrs), jnp.asarray(w))
    whole = PG._reverse_edge_weights(t(nbrs), t(w), rev_block=700)
    for rev_block in (256, 100, 1):
        got = PG._reverse_edge_weights(t(nbrs), t(w), rev_block=rev_block)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_w))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(j_e))
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    assert bool(whole[1].any())


def test_fit_graph_does_one_reverse_lookup_for_both_views(monkeypatch):
    x = torch.from_numpy(_table(200, 8, seed=7))
    calls = []
    lookup = PE._reverse_edge_weights

    def counted(*args, **kwargs):
        calls.append(1)
        return lookup(*args, **kwargs)

    monkeypatch.setattr(PE, "_reverse_edge_weights", counted)
    enc = PE.ModalityEncoder(6, 3, knn_engine="xla")
    graph, dense, _ = enc.fit_graph(x)
    assert len(calls) == 1
    _, nbrs = PK.knn(x, x, 6, exclude_self=True, engine="xla")
    dists, _ = PK.knn(x, x, 6, exclude_self=True, engine="xla")
    w = PG.fuzzy_weights(dists)[0]
    want, want_d = PG.symmetrize(nbrs, w), PG.symmetrize_dense(nbrs, w)
    for name in ("rows", "cols", "weights", "valid"):
        assert torch.equal(getattr(graph, name), getattr(want, name))
    for name in ("nbrs", "weights", "bwd_valid"):
        assert torch.equal(getattr(dense, name), getattr(want_d, name))


# --- spectral: edge-blocked Laplacian apply ----------------------------------

def _graphs(n, k, d, seed):
    x = _table(n, d, seed)
    dists, nbrs = JK.knn(jnp.asarray(x), jnp.asarray(x), k,
                         exclude_self=True, engine="xla")
    w = np.asarray(JG.fuzzy_weights(dists)[0])
    nbrs = np.asarray(nbrs)
    return (JG.symmetrize(jnp.asarray(nbrs), jnp.asarray(w)),
            PG.symmetrize(t(nbrs), t(w)))


def test_edge_blocked_adjacency_apply_matches_jax(monkeypatch):
    j_graph, p_graph = _graphs(300, 6, 12, seed=8)
    y = _table(300, 9, seed=9)
    monkeypatch.setattr(JS, "_EDGE_BLOCK", 512)
    want = np.asarray(JS._adjacency_apply(j_graph, jnp.asarray(y)))
    w = torch.where(p_graph.valid, p_graph.weights, 0.0)
    assert p_graph.num_edges > 3 * 512
    got = PS._adjacency_apply(p_graph, w, t(y), edge_block=512)
    whole = PS._adjacency_apply(p_graph, w, t(y),
                                edge_block=p_graph.num_edges)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_chebyshev_init_with_edge_blocks_matches_jax(monkeypatch,
                                                     fresh_jax_traces):
    j_graph, p_graph = _graphs(400, 10, 3, seed=4)
    whole = PS.spectral_embedding(p_graph, 6, method="chebyshev").numpy()
    monkeypatch.setattr(PS, "_EDGE_BLOCK", 1_000)
    monkeypatch.setattr(JS, "_EDGE_BLOCK", 1_000)
    assert p_graph.num_edges > 5 * 1_000
    ours = PS.spectral_embedding(p_graph, 6, method="chebyshev").numpy()
    theirs = np.asarray(JS.spectral_embedding(j_graph, 6, method="chebyshev"))
    assert subspace_sv(ours, theirs).min() > 0.99
    assert subspace_sv(ours, whole).min() > 1 - 1e-6


# --- layout: slot-scanned attraction, per-modality recompute -----------------

def _fit_graph(n, d, k, seed):
    x = _table(n, d, seed)
    dist, nbrs = JK.knn(jnp.asarray(x), jnp.asarray(x), k, exclude_self=True)
    w, _, _ = JG.fuzzy_weights(dist)
    jd = JG.symmetrize_dense(nbrs, w)
    pd = PG.DenseSymGraph(nbrs=t(jd.nbrs), weights=t(jd.weights),
                          bwd_valid=t(jd.bwd_valid), num_rows=n)
    return jd, pd


@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["expected", "drawn"])
def test_fit_epoch_with_slot_scan_and_recompute_matches_jax(
        monkeypatch, deterministic):
    graphs = [_fit_graph(90, 6, 6, seed=10), _fit_graph(90, 9, 6, seed=11)]
    j_tasks, j_statics = zip(*(JL.fit_task(jd, 32) for jd, _ in graphs))
    p_tasks, p_statics = zip(*(PL.fit_task(pd, 32) for _, pd in graphs))
    embeds = [_table(90, 4, seed=12 + m) for m in range(2)]
    key = jax.random.PRNGKey(13)
    monkeypatch.setattr(JL, "_ATTR_SLOT_BYTES", 0)
    monkeypatch.setattr(JL, "_MODALITY_REMAT_ROWS", 0)
    j_fn = JL.make_loss_fn(j_statics, mode="fit", num_rep=3, alpha=0.5,
                           batch_size=32, deterministic=deterministic)
    # a fresh jit of a new function: traced now, with the constants set
    v_j, g_j = jax.jit(jax.value_and_grad(j_fn))(
        tuple(jnp.asarray(e) for e in embeds), j_tasks,
        (jnp.float32(A), jnp.float32(B)), key)
    draws = jax_epoch_draws(key, [(90, 6), (90, 6)], mode="fit", num_rep=3,
                            alpha=0.5)

    def port(**bounds):
        params = [t(e).requires_grad_() for e in embeds]
        fn = PL.make_loss_fn(p_statics, mode="fit", num_rep=3, alpha=0.5,
                             batch_size=32, deterministic=deterministic,
                             **bounds)
        v = fn(params, p_tasks, A, B, draws)
        v.backward()
        return v.item(), [p.grad for p in params]

    v_b, g_b = port(slot_bytes=0, remat_rows=0)
    v_w, g_w = port()  # whole forms at this size
    np.testing.assert_allclose(v_b, float(v_j), rtol=1e-5)
    np.testing.assert_allclose(v_b, v_w, rtol=1e-5)
    for gb, gj, gw in zip(g_b, g_j, g_w):
        np.testing.assert_allclose(gb.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(gb.numpy(), gw.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_slot_scan_engages_by_size_and_recomputes(monkeypatch):
    """The slot loop runs one recomputed call per neighbour slot, and
    each modality's loss is recomputed past the row threshold; at the
    defaults neither engages at this size."""
    _, pd = _fit_graph(64, 5, 5, seed=14)
    task, static = PL.fit_task(pd, 16)
    calls = []
    recompute = PL._recompute

    def counted(fn, *args, **kwargs):
        calls.append(fn.__name__)
        return recompute(fn, *args, **kwargs)

    monkeypatch.setattr(PL, "_recompute", counted)  # the modality's
    monkeypatch.setattr(LT, "_recompute", counted)  # the slots'
    draws = jax_epoch_draws(jax.random.PRNGKey(15), [(64, 5)], mode="fit",
                            num_rep=2, alpha=0.0)
    for bounds, want in (({}, []),
                         ({"slot_bytes": 64 * 5 * 3 * 4 - 1},
                          ["_attr_slot"] * 5),
                         ({"remat_rows": 63},
                          ["_fit_modality_loss"]),
                         ({"remat_rows": 0, "slot_bytes": 0},
                          ["_fit_modality_loss"] + ["_attr_slot"] * 5)):
        calls.clear()
        fn = PL.make_loss_fn([static], mode="fit", num_rep=2, alpha=0.0,
                             batch_size=16, **bounds)
        p = t(_table(64, 3, seed=16)).requires_grad_()
        fn([p], [task], A, B, draws)
        assert calls == want, (bounds, calls)


def test_default_cuda_device_names_the_current_card(monkeypatch):
    """"cuda" resolves to the current card's index, so a table already on
    the card compares equal to the model's device and ``fit`` stores it
    without a copy (a bf16 table at 524,288 rows is 4.75 GiB)."""
    from multimodal_umap_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda:0")
    assert resolve_device("cuda") == torch.device("cuda:0")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")
