"""PyTorch port on the card: the CUDA kNN tile kernel against its plain
version, and a captured three-modality layout epoch against the eager
one. Imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a GPU every case skips (the kernel has no CPU mode). Tolerance
on squared distances: rtol (|plain| + max|q|^2 + max|r|^2), rtol 1e-5
in f32 mode (split-precision products, summed per 16-wide slice and
promoted to round-to-nearest totals) and 1e-4 in bf16 mode (the tensor
cores' f32 accumulation does not round to nearest); ids equal as
tie-aware sets.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import KERNEL_CASES, case_inputs  # noqa: E402

from multimodal_umap_tpu_torch.ops import knn_tile as KT  # noqa: E402
from multimodal_umap_tpu_torch.ops.knn import knn  # noqa: E402

torch.set_num_threads(1)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


def _assert_tie_aware(d_a, i_a, d_b, i_b, tol):
    """Rows of ascending squared distances agree within ``tol`` (same
    shape as ``d_b``) and their ids as tie-aware sets: an id missing
    from the other row sits at the row's boundary value."""
    k = d_a.shape[-1]
    d_a, d_b, tol = (x.reshape(-1, k) for x in (d_a, d_b, tol))
    i_a, i_b = i_a.reshape(-1, k), i_b.reshape(-1, k)
    fin = torch.isfinite(d_b)
    assert torch.equal(torch.isfinite(d_a), fin)
    assert bool(((d_a - d_b).abs() <= tol)[fin].all())
    in_b = (i_a[:, :, None] == i_b[:, None, :]).any(-1)
    at_edge = (d_a - d_a[:, -1:]).abs() <= tol
    assert bool((in_b | at_edge).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_cuda(bf16, case):
    """The edge cases of chip_smoke.KERNEL_CASES (ragged Q and N, padded
    D, tile_k 1 / 32 / TILE_C, self-exclusion at a row offset, exact
    duplicate rows, an all-+inf tile)."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16 if bf16 else torch.float32
    rtol = 1e-4 if bf16 else 1e-5
    q, r, tk, ex, off = case_inputs(case, gen, "cuda", dt)
    tk = KT.TILE_C if tk is None else tk
    counter = "KNN_TILE_BF16_LAUNCHES" if bf16 else "KNN_TILE_F32_LAUNCHES"
    before = getattr(KT, counter)
    d_k, i_k = KT.knn_tile(q, r, tk, exclude_self=ex, row_offset=off)
    torch.cuda.synchronize()
    assert getattr(KT, counter) == before + 1
    d_p, i_p = KT.knn_tile_plain(q, r, tk, exclude_self=ex, row_offset=off)
    scale = float((q.float() ** 2).sum(1).max()
                  + (r.float() ** 2).sum(1).max())
    _assert_tie_aware(d_k, i_k, d_p, i_p, rtol * (d_p.abs() + scale))


@pytest.mark.cuda
@pytest.mark.parametrize("q_rows", [16, 1024])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_at_invert_shape(bf16, q_rows):
    """The invert graph's kNN: latent queries (16 for the recon app,
    1,024 for a test split) near N = 3,000 train embeddings at D = 64,
    with the main path's per-tile width."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = torch.randn(3000, 64, generator=gen, device="cuda") * 2.0
    q = r[:q_rows] + 0.05 * torch.randn(q_rows, 64, generator=gen,
                                        device="cuda")
    dt = torch.bfloat16 if bf16 else torch.float32
    q, r = q.to(dt), r.to(dt)
    tk = KT.bf16_tile_k(15, 3000) if bf16 else 15
    d_k, i_k = KT.knn_tile(q, r, tk)
    torch.cuda.synchronize()
    d_p, i_p = KT.knn_tile_plain(q, r, tk)
    scale = float((q.float() ** 2).sum(1).max()
                  + (r.float() ** 2).sum(1).max())
    rtol = 1e-4 if bf16 else 1e-5
    _assert_tie_aware(d_k, i_k, d_p, i_p, rtol * (d_p.abs() + scale))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d", [(1024, 8192, 4096), (16, 131_072, 64)])
def test_f32_mode_matches_plain_at_width(nq, n, d):
    """The f32 mode (split-precision tensor-core products) at D = 4096,
    where its per-slice promotion to round-to-nearest sums matters, and
    at the recon app's invert-graph launch (16 x 131,072, D = 64), with
    clustered rows so that near neighbours cancel most of the terms."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    centers = torch.randn(64, d, generator=gen, device="cuda") * 3.0
    r = centers[torch.randint(0, 64, (n,), generator=gen, device="cuda")]
    r += 0.1 * torch.randn(n, d, generator=gen, device="cuda")
    q = r[:nq] + 0.05 * torch.randn(nq, d, generator=gen, device="cuda")
    before = KT.KNN_TILE_F32_LAUNCHES
    d_k, i_k = KT.knn_tile(q, r, 15)
    torch.cuda.synchronize()
    assert KT.KNN_TILE_F32_LAUNCHES == before + 1
    d_p, i_p = KT.knn_tile_plain(q, r, 15)
    scale = float((q ** 2).sum(1).max() + (r ** 2).sum(1).max())
    _assert_tie_aware(d_k, i_k, d_p, i_p, 1e-5 * (d_p.abs() + scale))


@pytest.mark.cuda
def test_row_norms_and_geometry_on_cuda():
    """The norm pre-pass against its plain version (another summation
    order: 1e-5 of the norm), and the shared memory the library asks
    for against launch_geometry."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(1000, 200, generator=gen, device="cuda") * 3).bfloat16()
    before = KT.ROW_NORM_LAUNCHES
    got = KT.row_norms_sq(x)
    torch.cuda.synchronize()
    assert KT.ROW_NORM_LAUNCHES == before + 1
    want = KT.row_norms_sq_plain(x)
    assert bool(((got - want).abs() <= 1e-5 * want).all())
    lib = KT.build()
    for bf16 in (True, False):
        geo = KT.launch_geometry(100, 1000, 64, bf16)
        assert lib.knn_tile_smem_bytes(int(bf16)) == geo.smem_bytes


@pytest.mark.cuda
def test_kernel_engines_match_exact_engine_on_cuda():
    """bf16 / stream / pallas engines (kernel) against the exact f32
    engine on the card: the kernel engines re-score or rank in f32."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(700, 40, generator=gen, device="cuda") * 3.0
    q = torch.randn(90, 40, generator=gen, device="cuda") * 3.0
    for queries, ex in ((x, True), (q, False)):
        d_x, i_x = knn(queries, x, 15, exclude_self=ex, engine="xla")
        scale = float((queries ** 2).sum(1).max() + (x ** 2).sum(1).max())
        for engine in ("bf16", "stream", "pallas"):
            d_k, i_k = knn(queries, x, 15, exclude_self=ex, engine=engine,
                           row_block=64)
            assert i_k.dtype == torch.int32
            _assert_tie_aware(d_k ** 2, i_k, d_x ** 2, i_x,
                              1e-5 * (d_x ** 2 + scale))


@pytest.mark.cuda
def test_bf16_stored_knn_tiled_allocates_no_f32_table_copy():
    """A bf16-stored 262,144 x 2,048 table (1.07 GB; 2.15 GB in f32)
    through ``knn_tiled``'s bf16 mode: the call's peak allocation above
    what was live before stays below one f32 copy of the table (its own
    transients -- a 1,024-row block's candidates of one column chunk,
    their merge copies and a re-score chunk -- are under 1 GB), one
    launch per (row block, column chunk), and the result equals the
    f32-table call's up to the stored rounding (ids tie-aware)."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = (torch.randn(262_144, 2_048, generator=gen, device="cuda")
             * 2.0).bfloat16()
    queries = table[:2_048]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = KT.KNN_TILE_BF16_LAUNCHES
    d_b, i_b = KT.knn_tiled(queries, table, 15, exclude_self=True,
                            bf16=True, row_block=1_024)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert KT.KNN_TILE_BF16_LAUNCHES == before + 2 * -(-262_144
                                                       // KT.COL_BLOCK)
    f32_copy = table.numel() * 4
    assert extra < f32_copy, (extra, f32_copy)
    d_x, i_x = knn(queries.float(), table.float(), 15, exclude_self=True,
                   engine="xla")
    scale = float(2 * (table.float() ** 2).sum(1).max())
    _assert_tie_aware(d_b ** 2, i_b, d_x ** 2, i_x,
                      1e-5 * (d_x ** 2 + scale))


@pytest.mark.cuda
def test_approx_engine_matches_xla_on_cuda():
    """``approx`` (the kernel's f32 mode, exact selection) against the
    exact f32 engine on the card, and counted as f32-mode launches."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(3_000, 96, generator=gen, device="cuda") * 3.0
    q = torch.randn(500, 96, generator=gen, device="cuda") * 3.0
    for queries, ex in ((x, True), (q, False)):
        before = KT.KNN_TILE_F32_LAUNCHES
        d_a, i_a = knn(queries, x, 15, exclude_self=ex, engine="approx",
                       row_block=1_024)
        torch.cuda.synchronize()
        assert KT.KNN_TILE_F32_LAUNCHES == before + -(-queries.shape[0]
                                                      // 1_024)
        d_x, i_x = knn(queries, x, 15, exclude_self=ex, engine="xla")
        scale = float((queries ** 2).sum(1).max() + (x ** 2).sum(1).max())
        _assert_tie_aware(d_a ** 2, i_a, d_x ** 2, i_x,
                          1e-5 * (d_x ** 2 + scale))


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: with
    the build made to fail, it raises instead of computing."""
    _require_cuda()

    def broken():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(KT, "build", broken)
    x = torch.randn(10, 8, device="cuda")
    with pytest.raises(RuntimeError, match="no nvcc"):
        KT.knn_tile(x, x, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_streamed_knn_tiled_matches_xla_on_cuda(bf16):
    """Column chunks of 512 on the card: query blocks of 256 meet chunks
    before, at and past their self columns (negative ``row_offset``), one
    launch per (row block, chunk); the result is the exact f32 engine's
    (ids tie-aware)."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(1_300, 96, generator=gen, device="cuda") * 3.0
    counter = "KNN_TILE_BF16_LAUNCHES" if bf16 else "KNN_TILE_F32_LAUNCHES"
    before = getattr(KT, counter)
    d_k, i_k = KT.knn_tiled(x[:700], x, 15, exclude_self=True, bf16=bf16,
                            row_block=256, col_block=512)
    torch.cuda.synchronize()
    assert getattr(KT, counter) == before + 3 * 3
    d_x, i_x = knn(x[:700], x, 15, exclude_self=True, engine="xla")
    scale = float(2 * (x ** 2).sum(1).max())
    _assert_tie_aware(d_k ** 2, i_k, d_x ** 2, i_x,
                      1e-5 * (d_x ** 2 + scale))


@pytest.mark.cuda
def test_bf16_table_already_on_the_card_is_not_copied():
    """``fit`` stores a bf16 table that is already on the model's card as
    it is: the model's default device ("cuda") names the card its tensors
    report ("cuda:0"), so no second copy of the table is made."""
    _require_cuda()
    from multimodal_umap_tpu_torch import MultimodalUMAP

    model = MultimodalUMAP(15, 64, 0.1, 1, feature_dtype="bfloat16")
    table = torch.randn(4_096, 768, device="cuda").bfloat16()
    assert model.device == table.device
    assert model._as_table(table).data_ptr() == table.data_ptr()


@pytest.mark.cuda
def test_captured_three_modality_epoch_matches_eager():
    """A three-modality fit layout, three InfoNCE pairs an epoch, captured
    as one CUDA graph against the eager runner at 2,048 rows, with the
    tolerances of ``tests/test_torch_layout_graph.py``; every epoch step
    (the warm-up's and the captured one) launches six InfoNCE forward
    kernels and three backward ones."""
    _require_cuda()
    from layout_graph_torch import eager_runner
    from test_torch_layout_graph import KW, _assert_close_runs, _fit_graph

    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.ops import losses as L
    from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph

    n = 2048
    gen = torch.Generator().manual_seed(7)
    dense = [_fit_graph(n, 6, 7 + m) for m in range(3)]
    tasks, statics = zip(*(PL.fit_task(DenseSymGraph(
        d.nbrs.cuda(), d.weights.cuda(), d.bwd_valid.cuda(), n), 32)
        for d in dense))
    inits = [torch.randn(n, 4, generator=gen).cuda() for _ in range(3)]
    kw = dict(KW, alpha=0.5, mode="fit", epochs=40)
    before = (L.INFONCE_FWD_LAUNCHES, L.INFONCE_BWD_LAUNCHES)
    captured = PL.train_layout(inits, tasks, statics, **kw)
    steps = PL._WARMUP_EPOCHS + 1
    assert (L.INFONCE_FWD_LAUNCHES - before[0],
            L.INFONCE_BWD_LAUNCHES - before[1]) == (6 * steps, 3 * steps)
    with eager_runner():
        eager = PL.train_layout(inits, tasks, statics, **kw)
    assert len(captured[0]) == 3
    assert all(bool(torch.isfinite(e).all()) for e in captured[0])
    _assert_close_runs(captured, eager)
