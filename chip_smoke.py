"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout (it builds the kNN tile
kernel and the fit layout's term kernels from
``multimodal_umap_tpu_torch/csrc``); exits non-zero, with no
result line, on any failed phase, without a GPU, or outside the repo.
Imports neither JAX nor the JAX package. Prints one JSON object per
line:

1. device -- the card (``nvidia-smi`` name and power limit) and the TF32
   flags; fails if float32 matmuls may use TF32;
2. build -- builds the kernels (one ``nvcc`` of ``csrc/knn_tile.cu`` and
   ``csrc/layout_terms.cu``), prints the build seconds, each kernel's (and
   each template instance's) registers and spill bytes from ``-Xptxas -v``
   and, for both tile kernels, the count of ``HGMMA``
   (wgmma; in the f32 kernel those on TF32), ``UTMALDG`` (TMA load) and
   ``FFMA`` SASS instructions (``cuobjdump -sass``; the f32 kernel's
   FFMAs are its row norms and the selection's, not a product loop);
   fails on a spill or a wgmma / TMA count of 0;
3. kernel_vs_plain -- each kernel against its plain PyTorch version on
   the card: the tile kernel in f32 and bf16 modes on the edge cases of
   ``KERNEL_CASES`` plus two main-path blocks (rows [8192, 16384) of the
   31,744 x 4,096 image table and the last fit block, rows [24576,
   31744) of the 768-d text table, k=15, exclude_self), and column
   chunks of the streamed kNN (``knn_tiled`` launches the kernel on
   ``COL_BLOCK`` = 32,768 reference columns at a time) on a 65,536-row
   table at D = 4,096 and 768: an 8,192-row block against the chunk past
   it (negative ``row_offset``: no self column inside), against the chunk
   holding it, and 300 rows against a 500-column chunk holding half their
   self columns. Squared
   distances within rtol (|b| + max|q|^2 + max|r|^2), rtol 1e-5 in f32
   mode (split-precision TF32 products, summed per 16-wide D slice and
   promoted to round-to-nearest f32 totals) and 1e-4 in bf16 mode
   (tensor-core f32 accumulation), and ids equal as tie-aware sets; the
   norm pre-pass within 1e-5 of the norm;
4. reference -- the port on the card against the repo's end-to-end
   golden band (tests/goldens/reference_e2e.json: cosine, trust, and the
   text->image recon MSE <= 1.1 x the reference's after transform +
   ``inverse_transform``) and the kernel kNN engine against the exact f32
   engine on a small input;
5. layout_graph -- the captured layout epoch (``train_layout`` on CUDA
   replays one CUDA graph per epoch) against the eager loop on the same
   buffers, draws and update (``layout_graph_torch.py``), at the main
   path's data: 100 fit epochs (losses rtol 1e-5 over the first 20 and
   1e-4 at each, embeddings rtol 2e-3 / atol 2e-4; the captured draws
   bit-equal to ``draw_epoch``'s), 20 transform and 20 invert epochs at
   the 1,024 test queries, a captured fit cut at epoch 50 and resumed
   against the uninterrupted one, ms per epoch of both runners, and the
   host launches per captured fit epoch (fails above 40). Every later
   phase runs its layouts captured;
6. main_path -- ``clustered_modalities(31,744 + 1,024, (768, 4096))``,
   ``train`` with ``Config`` defaults (k=15, out_dim=64, 600 epochs),
   ``similarity_test`` and ``knn_test`` (k=5) on 1,024 held-out pairs at
   120 test epochs, ``trustworthiness_sampled`` on both modalities;
   kernel launches counted after fit, transform and knn_test; fails on
   a non-finite metric, cosine < 0.9 or a kernel the path never ran (the
   tile kernel, the norm pre-pass, and the four layout-term kernels,
   counted in the fit; the first layout call's inputs are kept for
   phase 13);
7. recon_path -- the rest of the library flow on the fitted model, with
   the launch counts set to 0 just before it: ``save_state_dict`` ->
   ``load_state_dict`` into a fresh model (every array bit-equal; archive
   size and seconds), ``embed_and_recon`` of the 1,024 test texts to
   images as its two halves ``embed`` then ``recon`` (seconds,
   ``invert/*`` phases, peak memory, recon MSE against the train-mean
   predictor, kernel launches inside ``recon``: the invert graph's kNN),
   and ``crossmodal_recon`` of 16 test pairs (picked as ``main.py``
   picks them) through the SD-VAE at its published widths with weights
   drawn from seed 0: decoded (16, 3, 256, 256), finite, 16 PNG pairs
   written under ``chip_smoke_out/``, and 2 latents decoded by the same
   module on the CPU in float32 and float64: the card's float32 decode
   agrees with both (rtol 1e-4, atol 1e-5 per unit of the output's
   largest magnitude);
8. f32_table -- the f32 mode at full width on a driven path, with the
   launch counts set to 0 just before it: ``knn(images, images, 15,
   exclude_self=True, engine="pallas")`` over the whole 31,744 x 4,096
   f32 image table (four row blocks: four f32-mode launches) against
   ``engine="xla"``, squared distances at the f32 tolerance and ids
   tie-aware; prints seconds of both and the launches;
9. cli_path -- the CLI, ``main_torch.main`` in process, with the launch
   counts set to 0 just before it: ``--synthetic --n_samples 131072
   --feature_dtype bfloat16 --knn_engine approx`` and the ``Config``
   defaults otherwise (k=15, out_dim=64, 600 / 120 epochs), its model,
   logs and recon-app output under ``chip_smoke_out/cli/`` (no VAE
   weights: the app's offline latent dump). Prints the phase seconds,
   ``metrics.json``, the table dtypes, the peak device memory at the end
   of each fit phase (above what was live before), the archive's bytes
   and ``bf16_keys``, and the kernel launches per mode and per launch
   signature (Q, N, D, dtype, tile_k, self); reloads the archive (tables
   bit-equal and bf16, ``feature_dtype`` "bfloat16"). Fails on cosine <
   0.9, a non-finite metric or fit loss, a table that is not bf16, a
   graph stage whose peak holds an f32 copy of the image table (peak
   minus the tables minus the kNN's candidate buffers of one column
   chunk -- the kernel's outputs and their merge copies -- at or above the
   table's f32 size), or a kernel mode the run never launched (bf16
   tables in the kernel's bf16 mode; ``approx`` runs its f32 mode in the
   recon app's latent-space invert graph; the fit runs the four
   layout-term kernels);
10. engine_checks -- ``lobpcg`` on the CLI model's text graph, from
   ``--spectral lobpcg``'s operator and start block: the default run
   (the JAX package's tolerance, whose test scales with the row count)
   must stop at the iteration where the JAX package's rule, computed
   here on the iterate, first passes for every column (its null-space
   cosines and energy are printed); a run with ``tol=0`` (all 64
   iterations) must find the graph's null space and agree with
   Chebyshev: the graph's 32 clusters are disconnected, so its null space
   is spanned by d^1/2 times each connected component's indicator
   (components found on the card by label propagation) and the
   33rd-65th eigenvalues lie close together. Both methods' null-space
   columns (the first components - 1 of the returned block, whose
   dropped first column is some null vector, not always d^1/2) must lie
   in that exact null space by principal angles (cosines > 0.99), and
   lobpcg's block Rayleigh energy must be within 1 % of Chebyshev's (the
   cosines of the whole blocks are printed); ``knn(engine="approx")`` against
   ``engine="xla"`` at the main-path block (ids tie-aware, f32
   tolerance);
11. scale_path -- ``scale_ladder_torch.run_rung`` at 524,288 pairs, with
   the launch counts set to 0 just before it: bf16 tables drawn on the
   card (768 / 4,096 dims, 256 clusters), ``fit`` with the ``Config``
   defaults (k=15, out_dim=64, 600 / 120 epochs), ``similarity_test``,
   ``knn_test`` (k=1) and ``embed_and_recon`` of 16 texts; prints phase
   seconds, each fit stage's peak memory above what was live before it
   beside its reckoned gate, which bounded forms engaged (kNN column
   chunks, reverse-lookup and edge blocks, the per-modality recompute, and
   the attraction kernel in place of the slot scan: launched, with the
   layout stage's peak within the slot scan's 2.750 GiB) and the kernel
   launches per signature.
   Fails on cosine < 0.9, a non-finite metric or fit loss, recon MSE not
   below the train-mean predictor's, a bounded form that did not engage,
   a gated stage at or above its gate, or a kernel never launched;
12. mesh_path -- the data-parallel mesh (``mesh_path_torch.py``), with
   the launch counts set to 0 just before it: (a) in process, NCCL at
   world size 1: ``knn_ring`` against ``knn`` on both training tables and
   the test images (ids tie-aware, distances rtol 1e-5), the
   destination-sharded Laplacian apply against the single-device one
   (rel 1e-6) and its Chebyshev init's null-space columns in the exact
   null space (principal cosines > 0.99) at the single-device block
   energy (1 %), the sharded layout engine for 20 fit epochs against
   ``train_layout`` on the same draws (losses rtol 1e-5, embeddings rtol
   2e-3 / atol 2e-4, the JAX package's sharded-vs-single tolerance) and
   its recorded collectives (one table all-gather and one reduce-scatter
   per modality a fit epoch; the reference table gathered once per
   transform chunk); (b) two spawned ranks on this card over
   gloo: ``train(..., mesh=)`` -> ``similarity_test`` -> ``knn_test``
   (k=5) -> ``embed_and_recon`` of 16 texts at full width, each tile
   kernel launch signature of rank 0 held against its plain version and
   timed. Fails on a disagreement, cosine < 0.99 or more than 0.005 from
   the main path's, or a kernel the path never launched (the layout-term
   kernels in both parts);
13. layout_terms -- the fit layout's attraction (K2) and repulsion (K3)
   kernels, forward and backward (``csrc/layout_terms.cu``), against
   their plain PyTorch versions (autodiff, ``ops/layout_terms.py``, on
   the same inputs cast to float64) at
   the main path's first fit-layout call (its graph and draws: 31,744 x
   64, k = 15, 8 rounds), at a rank's row range of it (row0 = 15,872, the
   second half), at the scale rung's 524,288 x 64 (random graph and
   draws of the same shape) and at 31,744 x 200 (an --out_dim past the
   128 columns the kernels hold in registers; random graph and draws),
   and the attraction at 31,744 x 64 on a random graph (no hubs; its
   ``work`` gives the in-degrees and the backward's chunk plan beside
   the main graph's):
   the loss within rtol 1e-5, the gradient of
   the whole table within rtol 1e-5 plus 1e-5 of its largest entry, two
   kernel runs bit-equal; the kernels' and the plain version's ms of a
   forward whose gradient is wanted, of one under ``no_grad`` and of a
   forward with its backward (device time: calls captured in a CUDA graph
   and replayed; the plain repulsion of a row range cannot be captured
   and is timed eagerly, ``plain_timing``), each kernel's own device time
   from ``torch.profiler`` (``kernel_ms``: a backward's passes one by
   one) and the bound from the bytes and operations of these inputs
   (library: none, no one PyTorch call computes a term);
14. knn_stages -- ``knn_tiled``'s stages timed at the main-path block
   (norm pre-pass, tile kernel, candidate permute + merge ``topk``,
   exact f32 re-score), and the tile kernel at the other main-path
   shapes (D=768; the 1,024-row transform block; the invert block, the
   1,024 recon-query embeddings against the train embeddings at D=64;
   the app's 16 of those rows; the f32 mode at the main-path block) and
   at every launch signature of the CLI path, on the inputs of its first
   launch there (bf16-stored fit blocks, f32 queries cast to bf16 in the
   transform blocks, ``knn_test``'s recall blocks, the app's transform
   and its f32-mode invert graph) and of the scale path (its column
   chunks): held against its plain version as in
   phase 3, with its time, bound, plain and library times (the f32
   mode's bound is the larger of its bytes and its three TF32 passes at
   the tensor cores' TF32 rate; ``bound_fma_ms`` is one f32 pass on the
   CUDA cores' FMA pipe);
15. kernels -- ``{"kernels": [...]}``: time, bound, plain and library
    times of each kernel (the tile kernel's bf16 and f32 modes are its
    two entry points) at the main-path block shape -- the bf16 mode with
    its scale-path column chunk (8,192 x 32,768 at D = 4,096 and 768)
    beside it, the f32 mode with its launch on the CLI path -- and
    launches on the fit/eval path, the recon path, the f32 table path,
    the CLI path, the scale path and both mesh parts, and the bf16 mode
    at the mesh path's fit ring steps (8,192 x 15,872 at both D); and the
    four layout-term kernels (``fit_attr``, ``fit_attr_bwd``, ``fit_rep``,
    ``fit_rep_bwd``) at the main path's shape with the row range and the
    scale rung beside, their launches on the fit/eval, CLI, scale and
    both mesh paths (host launches: a captured epoch's replays run the
    captured kernels again; a forward's count is its calls that saved the
    backward's weights and anchor part, every forward on those paths, and
    its ``passes`` give the loss-only instance's launches, none there, and
    device ms; a backward's count is its calls, and its ``passes`` give
    each of its kernels' own launches and device ms);
16. infonce -- the fit layout's InfoNCE kernels (``csrc/infonce.cu``:
    a forward kernel a direction, the finishing kernel, one backward
    kernel for the pair) at both benchmark cells' shapes (31,783 and
    118,287 x 64), the main path's (31,744) and the scale path's
    (524,288), n_neg = 8, group_size = 1,000: one pair forward and
    backward against the plain version (autodiff, ``ops/losses.py``):
    each loss within rtol 1e-5, each gradient within 1e-4 of its largest
    entry, two kernel runs bit-equal; the forward's and forward +
    backward's device ms and each kernel's own ms (both directions'
    forwards, the finishing kernel, the backward: each captured alone in
    a CUDA graph and replayed), the plain version's ms, and the bound
    (bytes at 3.35 TB/s: each table, id vector and gradient once;
    ``gather_bound_ms`` counts every row the kernels gather); the
    kernels' launches on every path that fits (fit_eval, cli, scale,
    mesh_nccl, mesh_gloo), each of which must launch both counted ones;
17. last line -- ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_TRAIN, N_TEST, DIMS, K = 31_744, 1_024, (768, 4096), 15
BLOCK_ROWS = 8192
N_APP = 16  # crossmodal_recon samples, as main.py picks them
# The CLI path's pairs: 4x the flickr main path, about COCO train2017's
# 118,287 images; its synthetic data has clustered_modalities' default
# 32 clusters.
N_CLI, N_CLUSTERS = 131_072, 32
# The scale path's pairs: the scale ladder's first rung (bf16 tables).
N_SCALE = 524_288
OUT_DIR = "chip_smoke_out"  # checkpoint + recon app output (git-ignored)
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, H100 SXM
TF32_PASSES = 3  # the f32 mode's split-precision products
# Tolerances on squared distances, relative to the cancelled-term scale:
# f32 mode takes split-precision (3xTF32) products, summed per 16-wide D
# slice on the tensor cores and then into round-to-nearest f32 totals;
# bf16 mode accumulates on the tensor cores, whose f32 sums do not round
# to nearest (1.8e-5 seen at the D=4096 block).
RTOL = {False: 1e-5, True: 1e-4}

# Edge cases of the tile kernel: (Q, N, D, tile_k, exclude_self,
# row_offset, duplicate rows); tile_k None is the full column tile. Q
# not a multiple of the row tile, N below one column tile and with a
# partial last one, D padded (8, 17, 33), a whole number of slices, or
# more slices than the bf16 ring holds (768: 12 slices, 4 stages),
# tile_k 1 / 32 / all, self-exclusion at a row offset, exact duplicate
# rows, and (Q = N = 257, exclude_self) a tile of +inf only.
KERNEL_CASES = [
    (40, 40, 24, 5, True, 0, False), (24, 200, 16, 7, False, 0, False),
    (19, 187, 33, 4, False, 0, False), (60, 60, 24, 13, True, 0, False),
    (21, 150, 17, 14, False, 0, False), (16, 48, 8, 3, False, 0, False),
    (300, 1000, 96, 32, True, 0, False), (19, 600, 64, 1, False, 0, False),
    (130, 600, 64, None, True, 0, False), (100, 700, 40, 32, True, 300, False),
    (64, 512, 33, 32, True, 0, True), (257, 257, 33, 32, True, 0, False),
    (19, 300, 768, 32, True, 5, False),
]


def case_inputs(case, gen, device, dtype):
    """(q, r, tile_k, exclude_self, row_offset) of a KERNEL_CASES entry;
    q is rows [row_offset, row_offset + Q) of r under exclude_self."""
    q_n, n, d, tk, ex, off, dup = case
    r = torch.randn(n, d, generator=gen, device=device) * 4.0
    if dup:
        r[1::2] = r[0::2][: n // 2]
    q = r[off:off + q_n] if ex else torch.randn(
        q_n, d, generator=gen, device=device) * 4.0
    return q.to(dtype), r.to(dtype), tk, ex, off


def library_tile_topk(q, r, tile_k, tile_c, *, exclude_self=False,
                      row_offset=0):
    """Yardstick only, never called by the port: the tile kernel's
    function as a chain of PyTorch calls (bf16 ``torch.matmul``, norms of
    the rows as given, clamp, masks, per-tile ``topk``). Returns
    ((Q, num_col_tiles, tile_k) squared distances, global column ids);
    the order among ties is ``topk``'s."""
    nq, n = q.shape[0], r.shape[0]
    q_sq = (q.float() ** 2).sum(1)
    r_sq = (r.float() ** 2).sum(1)
    panel = ((-2.0 * torch.matmul(q, r.T).float() + q_sq[:, None])
             + r_sq[None, :]).clamp_min(0.0)
    if exclude_self:
        rows = torch.arange(nq, device=q.device)
        ok = (rows + row_offset >= 0) & (rows + row_offset < n)
        panel[rows[ok], rows[ok] + row_offset] = float("inf")
    nct = -(-n // tile_c)
    panel = torch.nn.functional.pad(panel, (0, nct * tile_c - n),
                                    value=float("inf"))
    vals, idx = panel.view(nq, nct, tile_c).topk(tile_k, dim=2,
                                                 largest=False)
    return vals, idx + (torch.arange(nct, device=q.device)
                        * tile_c)[None, :, None]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# The fit layout's term kernels (csrc/layout_terms.cu) by the name the
# kernels line gives them: each term's forward that saves its backward's
# weights and anchor part (ops/layout_terms.py's FWD_LAUNCHES, with_grad:
# every forward of a fit) and its backward (its calls). Every path that
# fits launches each.
TERM_KERNELS = ("fit_attr", "fit_attr_bwd", "fit_rep", "fit_rep_bwd")
# The forwards that computed the loss alone (FWD_LAUNCHES, loss_only):
# none on a path that fits.
TERM_LOSS_ONLY = ("fit_attr_loss_only", "fit_rep_loss_only")
# Each backward's kernels, counted one by one in ops/layout_terms.py's
# BWD_PASS_LAUNCHES: the gather and (the attraction, where a row has more
# than CHUNK_EDGES in-edges) the finishing pass.
TERM_PASSES = {"fit_attr_bwd": ("fit_attr_bwd_kernel",
                                "fit_attr_bwd_finish_kernel"),
               "fit_rep_bwd": ("fit_rep_bwd_kernel",)}
# Every count term_launches() gives
TERM_COUNTS = (*TERM_KERNELS, *TERM_LOSS_ONLY,
               *(k for ks in TERM_PASSES.values() for k in ks))


def reset_counts(KT) -> None:
    """Sets every kernel's launch count to 0 (the tile kernel's, the norm
    pre-pass's, the layout terms' and InfoNCE's)."""
    from multimodal_umap_tpu_torch.ops import layout_terms as LT
    from multimodal_umap_tpu_torch.ops import losses as L

    L.INFONCE_FWD_LAUNCHES = L.INFONCE_BWD_LAUNCHES = 0
    KT.KNN_TILE_BF16_LAUNCHES = KT.KNN_TILE_F32_LAUNCHES = 0
    KT.ROW_NORM_LAUNCHES = 0
    LT.FIT_ATTR_BWD_LAUNCHES = LT.FIT_REP_BWD_LAUNCHES = 0
    for counts in (*LT.FWD_LAUNCHES.values(), LT.BWD_PASS_LAUNCHES):
        for key in counts:
            counts[key] = 0


def term_launches() -> dict:
    """Launches of the layout-term kernels since the last reset, by the
    kernels line's name (TERM_COUNTS) and each backward kernel by its own
    (host launches: a captured epoch launches them in its warm-up and
    capture, and each replay runs the captured ones again)."""
    from multimodal_umap_tpu_torch.ops import layout_terms as LT

    fwd = LT.FWD_LAUNCHES
    return {"fit_attr": fwd["fit_attr"]["with_grad"],
            "fit_attr_bwd": LT.FIT_ATTR_BWD_LAUNCHES,
            "fit_rep": fwd["fit_rep"]["with_grad"],
            "fit_rep_bwd": LT.FIT_REP_BWD_LAUNCHES,
            "fit_attr_loss_only": fwd["fit_attr"]["loss_only"],
            "fit_rep_loss_only": fwd["fit_rep"]["loss_only"],
            **{k: LT.BWD_PASS_LAUNCHES[k] for ks in TERM_PASSES.values()
               for k in ks}}


def terms_engaged(launches: dict, recomputed: bool = False) -> bool:
    """Whether every forward of a fit saved its backward's weights and
    anchor part and every backward consumed them: no loss-only forward,
    and each term's with-grad forwards as many as its backward calls
    (twice as many where each modality's loss is recomputed in its
    backward, past ``layout._MODALITY_REMAT_ROWS``)."""
    per = 2 if recomputed else 1
    return all(launches[f"{t}_loss_only"] == 0 and launches[t] > 0
               and launches[t] == per * launches[f"{t}_bwd"]
               for t in ("fit_attr", "fit_rep"))


def tile_launches(KT) -> int:
    """Launches of the tile kernel in either mode."""
    return KT.KNN_TILE_BF16_LAUNCHES + KT.KNN_TILE_F32_LAUNCHES


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def tie_aware_match(d_a, i_a, d_b, i_b, scale, rtol, chunk=1 << 16):
    """Compares rows of ascending squared distances and their ids.

    Returns max |d_a - d_b| over finite entries, whether the values agree
    (finite where the other is, within rtol * (|d_b| + scale); ``scale``
    = max |q|^2 + max |r|^2 is the size of the terms the expanded form
    cancels), whether the ids agree as tie-aware sets (every id of a row
    missing from the other's row sits at the row's boundary value), and
    the fraction of ids equal position by position."""
    d_a, d_b = d_a.reshape(-1, d_a.shape[-1]), d_b.reshape(-1, d_b.shape[-1])
    i_a, i_b = i_a.reshape(d_a.shape), i_b.reshape(d_b.shape)
    fin = torch.isfinite(d_b)
    diff = (d_a - d_b).abs()
    err = float(diff[fin].max()) if fin.any() else 0.0
    vals_ok = bool((torch.isfinite(d_a) == fin).all()) and bool(
        (diff <= rtol * (d_b.abs() + scale))[fin].all())
    ids_ok = True
    for s in range(0, d_a.shape[0], chunk):
        a, b = i_a[s:s + chunk], i_b[s:s + chunk]
        in_b = (a[:, :, None] == b[:, None, :]).any(-1)
        edge = d_a[s:s + chunk, -1:]
        at_edge = (d_a[s:s + chunk] - edge).abs() <= rtol * (edge.abs() + scale)
        ids_ok &= bool((in_b | at_edge).all())
    return {"max_abs_err": err, "values_ok": vals_ok, "ids_ok": ids_ok,
            "ids_equal_frac": float((i_a == i_b).float().mean())}


def sq_scale(q, r) -> float:
    """max |q_i|^2 + max |r_j|^2 in f32."""
    return float((q.float() ** 2).sum(1).max() + (r.float() ** 2).sum(1).max())


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, stream) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph on ``stream``, one replay timed between events, so that the
    host's launch cost stays out of the time."""
    with torch.cuda.stream(stream):
        fn()  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def term_kernel_ms(events, per: int) -> dict:
    """Device ms of each layout-term kernel (``csrc/layout_terms.cu``, by
    its name without template arguments) among ``torch.profiler``'s
    kernel events (``key_averages()`` entries on the device), per ``per``
    calls."""
    out = {}
    for e in events:
        m = re.search(r"fit_\w+_kernel", e.key)
        if m:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + e.self_device_time_total / 1e3 / per)
    return out


def profiled_term_ms(fn, reps: int) -> dict:
    """:func:`term_kernel_ms` of ``reps`` eager calls of ``fn``."""
    fn()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return term_kernel_ms([e for e in prof.key_averages() if e.device_type
                           == torch.autograd.DeviceType.CUDA], reps)


# The InfoNCE kernels' shapes: each benchmark cell's rows, the main
# path's and the scale path's, at the fit's out_dim, n_neg, group_size and
# temperature.
INFONCE_SHAPES = (("flickr30k", 31_783), ("coco2017", 118_287),
                  ("main", N_TRAIN), ("scale", N_SCALE))
INFONCE_D, INFONCE_NEG, INFONCE_GROUP, INFONCE_T = 64, 8, 1000, 0.5


def infonce_launches() -> dict:
    """The InfoNCE kernels' launches in this process (ops/losses.py)."""
    from multimodal_umap_tpu_torch.ops import losses as L

    return {"infonce_fwd": L.INFONCE_FWD_LAUNCHES,
            "infonce_bwd": L.INFONCE_BWD_LAUNCHES}


def infonce_bytes(num: int, d: int, n_neg: int) -> dict:
    """A pair's bytes, forward and backward. ``compulsory``: each table,
    id vector and roll vector read once, the losses and both gradients
    written once. ``gathered``: what the kernels move -- a slot's anchor
    and n_neg + 2 partner rows read, its coefficients and anchor gradient
    written; an output row read with its saved anchor gradient and the
    other direction's n_neg + 2 anchor rows and coefficients, and its
    gradient written."""
    table, ids, ncols = 4.0 * num * d, 8.0 * num, n_neg + 2
    fwd = 2 * table + 2 * ids + 2 * 8.0 * ncols + 8.0
    bwd = 4 * table + 2 * ids + 2 * 8.0 * ncols
    row = 4.0 * d
    g_fwd = 2 * num * ((1 + ncols) * row + 8.0 * (ncols - 1) + 4.0 * ncols
                       + row)
    g_bwd = 2 * num * ((3 + ncols) * row + 8.0 + 4.0 * ncols)
    return {"compulsory": fwd + bwd, "gathered": g_fwd + g_bwd}


def infonce_kernel_ms(e, dr, rolls, stream) -> dict:
    """Each InfoNCE kernel's device ms a pair, launched alone (each
    captured 20 times in a CUDA graph and replayed, :func:`graph_ms`):
    both directions' forward kernels, the finishing kernel on their
    partials and the backward kernel on their saved buffers."""
    from multimodal_umap_tpu_torch.ops import losses as L

    num, ncols = e[0].shape[0], INFONCE_NEG + 2

    def forwards():
        return [L._fwd_launch(a, b, d.q, r, num, ncols, INFONCE_T,
                              INFONCE_GROUP)
                for a, b, d, r in ((e[0], e[1], dr[0], rolls[0]),
                                   (e[1], e[0], dr[1], rolls[1]))]

    (c0, ga0, p0), (c1, ga1, p1) = forwards()
    g = torch.ones((), device=e[0].device)
    dirs = ((dr[0].q_inv, rolls[0], c0, ga0, g),
            (dr[1].q_inv, rolls[1], c1, ga1, g))
    return {"infonce_fwd_kernel": graph_ms(forwards, 20, stream),
            "infonce_finish_kernel": graph_ms(
                lambda: L._finish_launch((p0, p1), num, INFONCE_GROUP), 20,
                stream),
            "infonce_bwd_kernel": graph_ms(
                lambda: L._bwd_launch(e, dirs, num, ncols, INFONCE_GROUP),
                20, stream)}


def infonce_phase(dev) -> dict:
    """Phase 16 (see the module docstring)."""
    from multimodal_umap_tpu_torch.ops import losses as L

    out = {"phase": "infonce",
           "source": "multimodal_umap_tpu_torch/csrc/infonce.cu",
           "replaces": "none: XLA-fused on the TPU "
                       "(multimodal_umap_tpu/ops/losses.py infonce)",
           "library": "none (no one call)",
           "tolerance": {"loss_rtol": 1e-5, "grad_rtol_of_max": 1e-4}}
    stream = torch.cuda.Stream()
    for name, num in INFONCE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(num)
        host = torch.Generator().manual_seed(num)
        e = [torch.randn(num, INFONCE_D, generator=gen, device=dev)
             for _ in range(2)]
        dr = [L.draw_infonce(num, INFONCE_NEG, INFONCE_GROUP, gen, host, dev)
              for _ in range(2)]
        rolls = tuple(torch.tensor(L.infonce_rolls(x), device=dev)
                      for x in dr)
        leaves = [x.clone().requires_grad_(True) for x in e]

        def kernels(a, b):
            return L.infonce_pair(dr[0], dr[1], a, b, n_neg=INFONCE_NEG,
                                  temperature=INFONCE_T,
                                  group_size=INFONCE_GROUP, rolls=rolls)

        def plain(a, b):
            kw = dict(n_neg=INFONCE_NEG, temperature=INFONCE_T,
                      group_size=INFONCE_GROUP)
            return (L.infonce(dr[0], a, b, rolls=rolls[0], **kw),
                    L.infonce(dr[1], b, a, rolls=rolls[1], **kw))

        def step(fn):
            for x in leaves:
                x.grad = None
            losses = fn(*leaves)
            torch.autograd.backward(losses)
            return [x.detach() for x in losses] + [x.grad for x in leaves]

        got, again, want = step(kernels), step(kernels), step(plain)
        torch.cuda.synchronize()
        loss_err = max(abs(float(g) - float(w)) / abs(float(w))
                       for g, w in zip(got[:2], want[:2]))
        grad_err = max(float((g - w).abs().max() / w.abs().max())
                       for g, w in zip(got[2:], want[2:]))

        def forward():
            with torch.no_grad():
                kernels(*leaves)

        nbytes = infonce_bytes(num, INFONCE_D, INFONCE_NEG)
        fwd_ms = graph_ms(forward, 20, stream)
        total_ms = graph_ms(lambda: step(kernels), 20, stream)
        own = infonce_kernel_ms(e, dr, rolls, stream)
        bound = nbytes["compulsory"] / H100_BYTES_PER_S * 1e3
        out[name] = {
            "shape": {"rows": num, "D": INFONCE_D, "n_neg": INFONCE_NEG,
                      "group_size": INFONCE_GROUP},
            "loss_rel_err": loss_err, "grad_err_of_max": grad_err,
            "bit_equal_twice": all(torch.equal(x, y)
                                   for x, y in zip(got, again)),
            "fwd_ms": fwd_ms, "ms": total_ms, "bwd_ms": total_ms - fwd_ms,
            "kernel_ms": own, "kernel_sum_ms": sum(own.values()),
            "plain_ms": graph_ms(lambda: step(plain), 5, stream),
            "bound_ms": bound, "bound_by": "bytes",
            "gather_bound_ms": nbytes["gathered"] / H100_BYTES_PER_S * 1e3,
            "roofline_pct": 100.0 * bound / total_ms}
        out[name]["ok"] = (loss_err <= 1e-5 and grad_err <= 1e-4
                           and out[name]["bit_equal_twice"])
        del e, leaves, got, again, want
    torch.cuda.empty_cache()
    return out


def bound_ms(nq, n, d, tile_k, bf16=True):
    """The tile kernel's bound: operations at the mode's peak (bf16 tensor
    cores, or the f32 mode's three TF32 passes) against the bytes: both
    tables read once (plus the bf16 norms), the (col_tiles, nq, tile_k)
    distances and ids written. Returns (ms, "operations" | "bytes")."""
    from multimodal_umap_tpu_torch.ops.knn_tile import TILE_C

    peak, size = ((H100_BF16_FLOPS, 2.0) if bf16
                  else (H100_TF32_FLOPS / TF32_PASSES, 4.0))
    t_ops = 2.0 * nq * n * d / peak * 1e3
    nbytes = (size * (nq + n) * d + (4.0 * (nq + n) if bf16 else 0.0)
              + 8.0 * -(-n // TILE_C) * nq * tile_k)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


KERNEL_FUNCTIONS = ("knn_tile_bf16_kernel", "knn_tile_f32_kernel",
                    "rownorm_bf16_kernel", "fit_attr_fwd_kernel",
                    "fit_attr_bwd_kernel", "fit_attr_bwd_finish_kernel",
                    "fit_rep_fwd_kernel", "fit_rep_bwd_kernel",
                    "infonce_fwd_kernel", "infonce_finish_kernel",
                    "infonce_bwd_kernel")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``; a
    template instance is named with its arguments
    (``fit_attr_fwd_kernel<16,4,1>``: 16 lanes a row, 4 columns a load,
    the instance that saves the backward's weights and anchor part)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            cur = next((k for k in KERNEL_FUNCTIONS
                        if re.search(k + r"(I|E|v|$)", name)), name)
            args = re.search(re.escape(cur) + r"I((?:L[ib]\d+E)+)E", name)
            if args and cur in KERNEL_FUNCTIONS:
                cur += "<" + ",".join(re.findall(r"L[ib](\d+)E",
                                                 args.group(1))) + ">"
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


# SASS counted per tile kernel: name -> pattern (one match per instruction)
SASS_PATTERNS = {"HGMMA": r"\bHGMMA\b", "HGMMA_TF32": r"\bHGMMA\b[^\n]*TF32",
                 "UTMALDG": r"\bUTMALDG\b", "FFMA": r"\bFFMA\b"}


def sass_counts(so_path, kernels) -> dict:
    """Counts of the SASS_PATTERNS in each named kernel of a built
    library."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so_path)],
        capture_output=True, text=True, check=True).stdout
    out = {}
    for kernel in kernels:
        body = next((f for f in sass.split("Function : ") if kernel in
                     f.split("\n", 1)[0]), "")
        out[kernel] = {name: len(re.findall(pat, body))
                       for name, pat in SASS_PATTERNS.items()}
    return out


@contextlib.contextmanager
def first_term_inputs(store: dict):
    """Keeps the inputs of the first ``fit_attraction`` and
    ``fit_repulsion`` calls in ``store["attr"]`` / ``store["rep"]``: the
    first modality's in the first warm-up epoch of a fit layout (the
    epoch's inits and draws), eager, before any capture. The counts stay
    the wrappers' own."""
    from multimodal_umap_tpu_torch.ops import layout_terms as LT

    attr, rep = LT.fit_attraction, LT.fit_repulsion

    def keep(name, **tensors):
        if name not in store:
            store[name] = {k: v.detach().clone() if isinstance(
                v, torch.Tensor) else v for k, v in tensors.items()}

    def observed_attr(embed, nbrs, coef, a, b, *, row0=0, rev=None,
                      slot_bytes=None):
        keep("attr", embed=embed, nbrs=nbrs, coef=coef, a=a, b=b)
        return attr(embed, nbrs, coef, a, b, row0=row0, rev=rev,
                    slot_bytes=slot_bytes)

    def observed_rep(embed, pi, pi_inv, rolls, rep_coef, a, b, *, row0=0):
        keep("rep", embed=embed, pi=pi, pi_inv=pi_inv, rolls=rolls,
             rep_coef=rep_coef, a=a, b=b)
        return rep(embed, pi, pi_inv, rolls, rep_coef, a, b, row0=row0)

    LT.fit_attraction, LT.fit_repulsion = observed_attr, observed_rep
    try:
        yield store
    finally:
        LT.fit_attraction, LT.fit_repulsion = attr, rep


# Kernel against plain (on the inputs cast to float64) on the card: loss
# rtol; gradient rtol and atol per unit of the largest gradient entry (a
# row's gradient sums signed terms, each rounded in float32 by the
# kernels; their powf / logf round apart from the exact by an ulp or two).
TERM_LOSS_RTOL, TERM_GRAD_RTOL, TERM_GRAD_ATOL = 1e-5, 1e-5, 1e-5


def synthetic_terms(n: int, dev, seed: int = 0, d: int = 64) -> dict:
    """Inputs of both terms at n rows of the fit layout's shape (k = 15,
    D = 64 unless given, 8 rounds): normal rows, uniform neighbour ids,
    about half the coefficients 0 (the main path keeps a slot with its
    weight), a permutation and 8 offsets in disjoint strata
    (layout._fit_rolls)."""
    from multimodal_umap_tpu_torch.models.curve import get_ab_coeffs

    g = torch.Generator(device=dev).manual_seed(seed)
    cfg_k, r = K, 8
    embed = torch.randn(n, d, generator=g, device=dev)
    nbrs = torch.randint(0, n, (n, cfg_k), generator=g, device=dev)
    coef = torch.rand(n, cfg_k, generator=g, device=dev) * 1e-4
    coef = coef * (torch.rand(n, cfg_k, generator=g, device=dev) < 0.5)
    pi = torch.randperm(n, generator=g, device=dev)
    pi_inv = torch.empty_like(pi)
    pi_inv[pi] = torch.arange(n, device=dev)
    stride = n // r
    rolls = (torch.arange(r, device=dev) * stride
             + torch.randint(0, stride, (r,), generator=g, device=dev)) % n
    rep_coef = torch.rand(n, generator=g, device=dev) * 1e-4
    a, b = get_ab_coeffs(0.1)  # Config's min_dist
    return {"attr": {"embed": embed, "nbrs": nbrs, "coef": coef, "a": a,
                     "b": b},
            "rep": {"embed": embed, "pi": pi, "pi_inv": pi_inv,
                    "rolls": rolls, "rep_coef": rep_coef, "a": a, "b": b}}


def term_work(term: str, inp: dict, row0: int) -> dict:
    """Compulsory bytes and operations on these inputs (each input read
    once, each output written once, only what the data needs: slots and
    anchors whose coefficient is 0 read nothing; per anchor-neighbour pair
    3 D operations for the distance, 2 D for each part of the gradient and
    40 for each curve): ``fwd_loss_only`` (the loss alone), ``fwd`` (the
    loss, and the weights and anchor rows the backward reads), ``bwd``
    (the gather: the table, the weights, the attraction's CSR and the
    anchor rows read, the gradient table written), ``step`` (the term as
    one: its inputs once, the loss's partials and the gradient table
    once)."""
    from multimodal_umap_tpu_torch.ops import layout_terms as LT

    e = inp["embed"]
    n, d = e.shape
    table = n * d * 4
    if term == "attr":
        nbrs, coef = inp["nbrs"], inp["coef"]
        n_rows, k = nbrs.shape
        live = coef != 0
        pairs = int(live.sum())
        anchors = torch.arange(row0, row0 + n_rows, device=e.device)
        rows = int(torch.unique(torch.cat([anchors, nbrs[live]])).numel())
        # the inputs: the rows read, the live slots' ids, the
        # coefficients; the backward's CSR (int32, built once per fit;
        # its chunk plan and scratch are the kernels' own work, not
        # counted)
        inputs = pairs * 8 + n_rows * k * 4
        csr = (n + 1) * 4 + n_rows * k * 4
        weights = n_rows * k * 4
        rev = LT.reverse_index(nbrs, n)
        # kept in-edges a row (a hub's set its warp's time before the
        # chunk plan), and the plan's work items (a tree from before the
        # plan, as compare_layout_terms.py may run, has none)
        in_deg = torch.bincount(nbrs[live], minlength=n)
        skew = {"max_in_degree": int(in_deg.max()),
                "mean_in_degree": pairs / n,
                "max_csr_in_degree": int((rev.offsets[1:]
                                          - rev.offsets[:-1]).max())}
        if hasattr(rev, "chunk_multi"):
            skew.update(chunk_edges=LT.CHUNK_EDGES,
                        multi_chunk_rows=int(rev.multi_row.numel()),
                        chunks=int(rev.chunk_multi.numel()),
                        work_items=n + int(rev.chunk_multi.numel()))
    else:
        pi, rolls, rep_coef = inp["pi"], inp["rolls"], inp["rep_coef"]
        n_rows, r = rep_coef.shape[0], rolls.shape[0]
        anchors = (torch.nonzero(rep_coef != 0).reshape(-1) + row0)
        pairs = int(anchors.numel()) * r
        negs = pi[(anchors[:, None] + rolls[None, :]) % n].reshape(-1)
        rows = int(torch.unique(torch.cat([anchors, negs])).numel())
        # the permutation's entries read, the offsets, the coefficients;
        # the backward's inverse permutation
        inputs = pairs * 8 + r * 8 + n_rows * 4
        csr = n * 8 + r * 8
        weights = n_rows * r * 4
        skew = {}
    anchor_rows = n_rows * d * 4
    loss_ops, grad_ops = pairs * (3 * d + 40), pairs * (2 * d + 40)
    work = {
        "fwd_loss_only": (rows * d * 4 + inputs + n_rows * 4, loss_ops),
        "fwd": (rows * d * 4 + inputs + n_rows * 4 + weights + anchor_rows,
                loss_ops + grad_ops),
        "bwd": (table + weights + csr + 4 + anchor_rows + table,
                pairs * 2 * d),
        "step": (table + inputs + csr + n_rows * 4 + 4 + table,
                 loss_ops + grad_ops + pairs * 2 * d)}
    out = {**skew}
    for name, (nbytes, ops) in work.items():
        t_b = nbytes / H100_BYTES_PER_S * 1e3
        t_o = ops / H100_F32_FLOPS * 1e3
        out[name] = {"bytes": nbytes, "operations": ops,
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def check_term(term: str, inp: dict, row0: int = 0, reps: int = 20) -> dict:
    """One term's kernels against its plain version on these inputs cast
    to float64 (the float32 plain autograd of the repulsion cancels for
    far negatives, by about a s^b ulps, past the tolerance where every
    pair is far, as at D = 200): the loss and the gradient of the whole
    table (gradient output 1), two kernel runs bit-equal, and the times
    of each kernel and of the plain version (in float32, as the port runs
    it): ``fwd`` a forward whose gradient is wanted, ``fwd_loss_only`` one
    under ``no_grad``, ``step`` a forward and its backward, ``bwd`` their
    difference (a backward ends its forward's gradient table in place, so
    it runs once a forward); device time of a replayed CUDA graph
    (``graph_ms``; an eager loop of these sub-0.1 ms calls would time the
    host's launches), but for the plain repulsion of a row range, which
    copies its row0 from the host and cannot be captured (eager,
    ``cuda_ms``, marked in ``plain_timing``); and each kernel's own
    device time from ``torch.profiler`` (``kernel_ms``, by the same three
    calls: a step's gives the backward's passes one by one)."""
    from multimodal_umap_tpu_torch.ops import layout_terms as LT

    e, a, b = inp["embed"], inp["a"], inp["b"]
    if term == "attr":
        args = (inp["nbrs"], inp["coef"], a, b)
        rev = LT.reverse_index(inp["nbrs"], e.shape[0])

        def kernel(x):
            return LT.fit_attraction(x, *args, row0=row0, rev=rev)

        def plain(x):
            return LT.fit_attraction_plain(x, *args, row0=row0)

        def exact(x):
            return LT.fit_attraction_plain(x, args[0], args[1].double(),
                                           a, b, row0=row0)
    else:
        args = (inp["pi"], inp["pi_inv"], inp["rolls"], inp["rep_coef"], a, b)

        def kernel(x):
            return LT.fit_repulsion(x, *args, row0=row0)

        def plain(x):
            return LT.fit_repulsion_plain(x, *args, row0=row0)

        def exact(x):
            return LT.fit_repulsion_plain(x, *args[:3], args[3].double(), a,
                                          b, row0=row0)

    def run(fn, dtype=torch.float32):
        x = e.detach().to(dtype, copy=True).requires_grad_(True)
        loss = fn(x)
        loss.backward()
        return loss.detach().to(dtype), x.grad

    v1, g1 = run(kernel)
    v2, g2 = run(kernel)
    torch.cuda.synchronize()
    vp, gp = run(exact, torch.float64)
    v1, g1 = v1.double(), g1.double()
    scale = float(gp.abs().max())
    excess = float(((g1 - gp).abs() - TERM_GRAD_RTOL * gp.abs()
                    - TERM_GRAD_ATOL * scale).max())
    loss_rel = float((v1 - vp).abs() / vp.abs())
    line = {
        "rows": list(e.shape), "row0": row0,
        "anchor_rows": int(args[0].shape[0] if term == "attr"
                           else args[3].shape[0]),
        "loss": float(v1), "loss_plain": float(vp), "loss_rel_err": loss_rel,
        "loss_abs_err": float((v1 - vp).abs()),
        "grad_max_abs_err": float((g1 - gp).abs().max()),
        "grad_max_abs": scale,
        "bit_equal_twice": bool(torch.equal(v1.float(), v2)
                                and torch.equal(g1.float(), g2)),
        "ok": bool(loss_rel <= TERM_LOSS_RTOL and excess <= 0
                   and torch.isfinite(g1).all())}
    line["ok"] = line["ok"] and line["bit_equal_twice"]
    del g1, g2, gp

    x = e.detach().clone().requires_grad_(True)

    def calls(fn):
        """The three timed calls of ``fn``."""
        def loss_only():
            with torch.no_grad():
                fn(x)

        return {"fwd": lambda: fn(x), "fwd_loss_only": loss_only,
                "step": lambda: torch.autograd.grad(fn(x), x)}

    # the backward runs on its forward's stream: the side stream, where
    # graph_ms captures both
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def timed(fn, reps, how):
        ms = {k: how(c, reps) for k, c in calls(fn).items()}
        return {**ms, "bwd": ms["step"] - ms["fwd"]}

    line["ms"] = timed(kernel, reps, lambda c, r: graph_ms(c, r, side))
    line["kernel_ms"] = {k: profiled_term_ms(c, reps)
                         for k, c in calls(kernel).items()}
    plain_reps = max(2, reps // 4)
    if term == "rep" and row0 != 0:
        line["plain_timing"] = "eager"
        line["plain_ms"] = timed(plain, plain_reps, cuda_ms)
    else:
        line["plain_timing"] = "graph"
        line["plain_ms"] = timed(plain, plain_reps,
                                 lambda c, r: graph_ms(c, r, side))
    line["work"] = term_work(term, inp, row0)
    return line


def layout_terms(main_inputs: dict, dev, cells: bool = False) -> dict:
    """Phase 13 (see the module docstring): each term's kernels against
    its plain version at the main path's first fit-layout call, at a
    rank's row range of it (the second half: row0 = N / 2, as rank 1 of
    two reads the gathered table), at the scale rung's 524,288 x 64 and
    at the main path's rows with an --out_dim past 128 (D = 200: two
    column tiles a row); and the attraction
    on a random graph of the main path's shape (no hubs), beside its
    hub-heavy main graph. ``cells``: also at each benchmark cell's rows
    (``TERM_CELL_SHAPES``, synthetic inputs at D = 64)."""
    out = {"phase": "layout_terms", "library": "none (no one call)",
           "tolerance": {"loss_rtol": TERM_LOSS_RTOL,
                         "grad_rtol": TERM_GRAD_RTOL,
                         "grad_atol_per_max": TERM_GRAD_ATOL}}
    n = main_inputs["attr"]["embed"].shape[0]
    half = n // 2
    ranged = {
        "attr": {**main_inputs["attr"],
                 "nbrs": main_inputs["attr"]["nbrs"][half:].contiguous(),
                 "coef": main_inputs["attr"]["coef"][half:].contiguous()},
        "rep": {**main_inputs["rep"],
                "rep_coef": main_inputs["rep"]["rep_coef"][half:]
                .contiguous()}}
    scale = synthetic_terms(N_SCALE, dev)
    for term in ("attr", "rep"):
        out[term] = {
            "main": check_term(term, main_inputs[term]),
            "row_range": check_term(term, ranged[term], row0=half),
            "scale": check_term(term, scale[term], reps=10)}
    del scale
    # the main path's shape without its hubs: uniform random ids
    out["attr"]["random_graph"] = check_term(
        "attr", synthetic_terms(n, dev, seed=2)["attr"])
    wide = synthetic_terms(n, dev, seed=1, d=WIDE_D)
    for term in ("attr", "rep"):
        out[term]["wide"] = check_term(term, wide[term], reps=5)
    del wide
    for name, rows in TERM_CELL_SHAPES if cells else ():
        inp = synthetic_terms(rows, dev, seed=3)
        for term in ("attr", "rep"):
            out[term][name] = check_term(term, inp[term])
        del inp
    torch.cuda.empty_cache()
    return out


# The benchmark cells' rows (perfbench/configs/), for layout_terms(cells=)
TERM_CELL_SHAPES = (("flickr30k", 31_783), ("coco2017", 118_287),
                    ("spokencoco", 113_287))


# An --out_dim past the 128 columns that the kernels hold in registers
WIDE_D = 200

# Where each term kernel's work sits in the JAX package: XLA-fused
# functions inside the jitted epoch (no pallas_call).
TERM_REPLACES = {
    "attr": "multimodal_umap_tpu/models/layout.py:252",
    "rep": "multimodal_umap_tpu/models/layout.py:288"}


def term_entries(tline: dict, by_path: dict) -> list[dict]:
    """The kernels line's entries of the four layout-term kernels at the
    main path's shape, with the row range and the scale rung beside."""
    out = []
    for name in TERM_KERNELS:
        term = "attr" if name.startswith("fit_attr") else "rep"
        way = "bwd" if name.endswith("_bwd") else "fwd"

        def numbers(v):
            return {"max_abs_err": (v["grad_max_abs_err"] if way == "bwd"
                                    else v["loss_abs_err"]),
                    "ms": v["ms"][way], "plain_ms": v["plain_ms"][way],
                    "plain_timing": v["plain_timing"],
                    "bound_ms": v["work"][way]["bound_ms"],
                    "bound_by": v["work"][way]["bound_by"]}

        paths = {p: c[name] for p, c in by_path.items()}
        main = tline[term]["main"]
        # a backward is one call of its passes' kernels: each one's own
        # launches (all paths) and device ms at the main path's shape (in
        # a step's profile); a forward's loss-only instance beside it
        passes = {k: {"launches": sum(c[k] for c in by_path.values()),
                      "ms": main["kernel_ms"]["step"].get(k, 0.0)}
                  for k in TERM_PASSES.get(name, ())}
        if way == "fwd":
            passes = {f"{name}_loss_only": {
                "launches": sum(c[f"{name}_loss_only"]
                                for c in by_path.values()),
                "ms": main["ms"]["fwd_loss_only"]}}
        out.append({
            "name": name, "route": "cuda",
            "source": "multimodal_umap_tpu_torch/csrc/layout_terms.cu",
            "replaces": TERM_REPLACES[term],
            "replaces_function": ("_fit_attraction" if term == "attr"
                                  else "_fit_repulsion")
            + " (XLA-fused in the jitted epoch; no pallas_call)",
            "launches": sum(paths.values()), "launches_by_path": paths,
            **({"passes": passes} if passes else {}),
            **numbers(main), "library_ms": None,
            "shape": {"rows": main["rows"], "anchor_rows": main["anchor_rows"]},
            "at_row_range": {"row0": tline[term]["row_range"]["row0"],
                             **numbers(tline[term]["row_range"])},
            "at_scale": {"rows": tline[term]["scale"]["rows"],
                         **numbers(tline[term]["scale"])}})
    return out


def recon_path(model, train_np, test_np, cfg, dev, out_dir):
    """Phase 7 (see the module docstring). Returns (the phase's JSON
    line, the 1,024 recon-query embeddings the invert graph searched
    with, the rows of the 16 app samples among them)."""
    from multimodal_umap_tpu_torch.app.crossmodal import crossmodal_recon
    from multimodal_umap_tpu_torch.eval.validation import embed, recon
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
    from multimodal_umap_tpu_torch.nn.vae import VAEConfig, random_vae
    from multimodal_umap_tpu_torch.ops import knn_tile as KT

    os.makedirs(out_dir, exist_ok=True)
    line = {"phase": "recon_path"}
    sync = torch.cuda.synchronize

    # save -> load into a fresh model, every array bit-equal
    path = os.path.join(out_dir, "state.npz")
    t0 = time.perf_counter()
    model.save_state_dict(path)
    line["save_seconds"] = time.perf_counter() - t0
    line["archive_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = MultimodalUMAP.load_state_dict(path, device=dev)
    sync()
    line["load_seconds"] = time.perf_counter() - t0
    os.remove(path)

    def arrays(m):
        out = [m.a, m.b, m.k_neighbors, m.out_dim, m.min_dist]
        for i, enc in enumerate(m.encoders):
            out += [enc.sigmas, enc.rhos, m.data[i], m.embeds[i],
                    *(getattr(m.graphs[i], f)
                      for f in ("rows", "cols", "weights", "valid"))]
        return out

    line["roundtrip_bit_equal"] = all(
        torch.equal(x, y) and x.dtype == y.dtype
        if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(arrays(model), arrays(loaded)))
    del loaded

    # embed_and_recon of the test texts, run as its two halves (embed,
    # then recon) so that recon's kernel launches -- the invert graph's
    # latent-space kNN at D=64 -- are read on their own
    texts, images = test_np["texts"], test_np["images"]
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    z = embed(model, [texts], [0], cfg)
    before = tile_launches(KT)
    recon_out = recon(model, z, [1], cfg)[0]
    sync()
    line["embed_and_recon_seconds"] = time.perf_counter() - t0
    line["invert_tile_launches"] = tile_launches(KT) - before
    line["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    line["invert_phase_seconds"] = {
        k: v for k, v in model.timer.report().items()
        if k.startswith("invert/")}
    recon_out = recon_out.cpu().numpy()
    line["recon_shape"] = list(recon_out.shape)
    line["recon_finite"] = bool(np.isfinite(recon_out).all())
    line["recon_mse"] = float(np.mean((recon_out - images) ** 2))
    line["train_mean_mse"] = float(np.mean(
        (train_np["images"].mean(0) - images) ** 2))
    line["invert_loss_first_last"] = [
        float(model.loss_history["invert"][0]),
        float(model.loss_history["invert"][-1])]

    # the recon app: 16 pairs through the SD-VAE at published widths
    idx = np.random.default_rng(cfg.seed).permutation(len(texts))[:N_APP]
    samples = [texts[idx], images[idx]]
    vae = random_vae(VAEConfig(), seed=0, device=dev)
    app_dir = os.path.join(out_dir, "crossmodal")
    shutil.rmtree(app_dir, ignore_errors=True)
    before = tile_launches(KT)
    t0 = time.perf_counter()
    app_recon = crossmodal_recon(samples, cfg, model, out_dir=app_dir,
                                 vae=vae)[0]
    sync()
    line["crossmodal_recon_seconds"] = time.perf_counter() - t0
    line["app_tile_launches"] = tile_launches(KT) - before
    latents = app_recon.reshape(-1, 4, 32, 32)
    vae.decode(latents)  # warm-up
    sync()
    t0 = time.perf_counter()
    imgs = vae.decode(latents)
    sync()
    line["vae_decode_seconds"] = time.perf_counter() - t0
    line["decoded_shape"] = list(imgs.shape)
    line["decoded_finite"] = bool(torch.isfinite(imgs).all())
    # 2 latents on the CPU, in float32 and in float64, by the same module.
    # The float32 decodes are held to rtol 1e-4 and an atol of 1e-5 per
    # unit of the output's largest magnitude: float32 rounding through the
    # decoder's ~30 chained convolutions grows with the values it carries.
    cpu_vae = copy.deepcopy(vae.module).cpu()
    z2 = torch.from_numpy(latents[:2]).float()
    with torch.inference_mode():
        on_cpu = cpu_vae.decode(z2)
        exact = cpu_vae.double().decode(z2.double())
    card = imgs[:2].cpu()
    out_max = float(exact.abs().max())
    atol = 1e-5 * max(1.0, out_max)
    line["vae_vs_float64"] = {
        "output_max_abs": out_max, "rtol": 1e-4, "atol": atol,
        "card_max_abs_err": float((card.double() - exact).abs().max()),
        "cpu_max_abs_err": float((on_cpu.double() - exact).abs().max()),
        "card_vs_cpu_max_abs_err": float((card - on_cpu).abs().max())}
    line["cpu_vs_card_ok"] = bool(
        torch.allclose(card, on_cpu, rtol=1e-4, atol=atol)
        and torch.allclose(card.double(), exact, rtol=1e-4, atol=atol))
    pngs = sorted(f for f in os.listdir(app_dir) if f.endswith(".png"))
    line["png_files"] = len(pngs)
    line["png_images"] = 2 * len(pngs)  # each file: original over recon
    return line, z[0], idx


def cli_path(dev, out_dir):
    """Phase 9 (see the module docstring). Returns (the phase's JSON
    line, the model ``main_torch.main`` returned, its launch counts, its
    tile-kernel census: per launch signature, the first launch's inputs
    and the launch count)."""
    import main_torch
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
    from multimodal_umap_tpu_torch.ops import knn_tile as KT

    cli_dir = os.path.abspath(os.path.join(out_dir, "cli"))
    shutil.rmtree(cli_dir, ignore_errors=True)
    os.makedirs(cli_dir)
    save_path = os.path.join(cli_dir, "models", "state.npz")
    log_dir = os.path.join(cli_dir, "logs")
    argv = ["--synthetic", "--n_samples", str(N_CLI),
            "--feature_dtype", "bfloat16", "--knn_engine", "approx",
            "--save_path", save_path, "--log_dir", log_dir]
    # An observer around the wrapper (``knn_tiled`` looks it up at each
    # call): it keeps the inputs of the first launch of each signature,
    # so that phase 14 holds the kernel against its plain version at
    # every shape this path gave it. The counts stay the wrapper's own.
    census = {}
    wrapper = KT.knn_tile

    def observed(q, r, tile_k, *, exclude_self=False, row_offset=0,
                 q_sq=None, r_sq=None):
        key = (q.shape[0], r.shape[0], q.shape[1], str(q.dtype), tile_k,
               exclude_self)
        if key not in census:
            census[key] = {"q": q.clone(), "r": r, "row_offset": row_offset,
                           "launches": 0}
        census[key]["launches"] += 1
        return wrapper(q, r, tile_k, exclude_self=exclude_self,
                       row_offset=row_offset, q_sq=q_sq, r_sq=r_sq)

    cwd = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(KT)
    t0 = time.perf_counter()
    os.chdir(cli_dir)  # the recon app writes results/ where it runs
    KT.knn_tile = observed
    try:
        model = main_torch.main(argv)
    finally:
        KT.knn_tile = wrapper
        os.chdir(cwd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"knn_tile_bf16": KT.KNN_TILE_BF16_LAUNCHES,
                "knn_tile_f32": KT.KNN_TILE_F32_LAUNCHES,
                "knn_rownorm": KT.ROW_NORM_LAUNCHES, **term_launches(),
                **infonce_launches()}
    peak_run = torch.cuda.max_memory_allocated() - base

    tables = sum(d.numel() * d.element_size() for d in model.data)
    peaks = {k: v - base for k, v in model.timer.peak_bytes.items()
             if k.startswith("fit/")}
    tk = KT.bf16_tile_k(K, N_CLI - 1)
    # One column chunk's candidates (knn_tiled launches the kernel on
    # COL_BLOCK reference columns at a time): the kernel's (col_tiles,
    # rows, tile_k) f32 distances and int32 ids, and the merge's permuted
    # copies.
    cand_bytes = (4 * 4 * KT._num_col_tiles(min(N_CLI, KT.COL_BLOCK))
                  * BLOCK_ROWS * tk)
    f32_image = N_CLI * DIMS[1] * 4
    graph_extra = peaks["fit/graph_1"] - tables - cand_bytes
    with open(os.path.join(log_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(save_path) as z:
        bf16_keys = json.loads(str(z["meta"]))["bf16_keys"]
    t0 = time.perf_counter()
    loaded = MultimodalUMAP.load_state_dict(save_path, device=dev)
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    reload_ok = loaded.feature_dtype == "bfloat16" and all(
        a.dtype == torch.bfloat16 and torch.equal(a, b)
        for a, b in zip(loaded.data, model.data))
    del loaded
    fit_loss = model.loss_history["fit"]
    gib = 2.0**-30
    line = {
        "phase": "cli_path", "argv": argv, "n_train": N_CLI,
        "n_test": max(16, N_CLI // 10), "main_seconds": seconds,
        "phase_seconds": model.timer.report(), "metrics": metrics,
        "data_dtypes": [str(d.dtype) for d in model.data],
        "feature_dtype": model.feature_dtype,
        "fit_loss_first_last": [float(fit_loss[0]), float(fit_loss[-1])],
        "peak_gib_at_end_of": {k: v * gib for k, v in peaks.items()},
        "peak_gib_whole_run": peak_run * gib,
        "tables_gib": tables * gib,
        "knn_candidate_gib": cand_bytes * gib,
        "graph_peak_minus_tables_and_candidates_gib": graph_extra * gib,
        "f32_image_table_gib": f32_image * gib,
        "archive_bytes": os.path.getsize(save_path), "bf16_keys": bf16_keys,
        "reload_seconds": load_seconds, "reload_bit_equal_bf16": reload_ok,
        "launches": launches,
        "tile_launches_by_signature": [
            {"Q": q, "N": n, "D": d, "dtype": dt, "tile_k": tk,
             "exclude_self": ex, "launches": v["launches"]}
            for (q, n, d, dt, tk, ex), v in census.items()],
    }
    return line, model, launches, census


def component_labels(graph) -> torch.Tensor:
    """(num_rows,) int64: each row's component, as the least row index in
    it, by min-label propagation over the valid edges (both directions)
    with pointer jumping, on the graph's device."""
    rows = graph.rows.long()[graph.valid]
    cols = graph.cols.long()[graph.valid]
    labels = torch.arange(graph.num_rows, device=rows.device)
    while True:
        new = labels.clone()
        new.scatter_reduce_(0, rows, labels[cols], "amin")
        new.scatter_reduce_(0, cols, labels[rows], "amin")
        new = new[new]
        if torch.equal(new, labels):
            return labels
        labels = new


def exact_null_space(graph) -> torch.Tensor:
    """(num_rows, components) float64 orthonormal basis of the normalized
    Laplacian's null space: d^1/2 on each connected component."""
    from multimodal_umap_tpu_torch.ops import spectral as PS

    d_sqrt = (1.0 / PS._Laplacian(graph).d_inv_sqrt).double()
    _, comp = torch.unique(component_labels(graph), return_inverse=True)
    basis = torch.zeros((graph.num_rows, int(comp.max()) + 1),
                        dtype=torch.float64, device=d_sqrt.device)
    basis[torch.arange(graph.num_rows, device=d_sqrt.device), comp] = d_sqrt
    return basis / torch.linalg.vector_norm(basis, dim=0)


def subspace_cosines(a, b) -> torch.Tensor:
    """Cosines of the principal angles between the column spans."""
    qa, _ = torch.linalg.qr(a.double())
    qb, _ = torch.linalg.qr(b.double())
    return torch.linalg.svdvals(qa.T @ qb)


def engine_checks(cli_model, images, dev):
    """Phase 10 (see the module docstring)."""
    from multimodal_umap_tpu_torch.ops import spectral as PS
    from multimodal_umap_tpu_torch.ops.knn import knn

    graph = cli_model.graphs[0]
    out_dim, n = cli_model.out_dim, graph.num_rows
    sync = torch.cuda.synchronize
    # --spectral lobpcg's operator and start block; lobpcg_standard's
    # defaults are the JAX package's (m=64, tol = f32 epsilon)
    matvec, x0 = PS.lobpcg_problem(graph, out_dim)
    runs = {"lobpcg": lambda: PS.lobpcg_standard(matvec, x0, m=64),
            "lobpcg_tol0": lambda: PS.lobpcg_standard(matvec, x0, m=64,
                                                      tol=0.0),
            "chebyshev": lambda: PS.spectral_embedding(
                graph, out_dim, method="chebyshev")}
    out, seconds = {}, {}
    for name, run in runs.items():
        sync()
        t0 = time.perf_counter()
        out[name] = run()
        sync()
        seconds[name] = time.perf_counter() - t0

    def jax_rule_converged(theta, x):
        """Columns that pass the JAX package's stopping test,
        |A v - theta v| < eps * 10 * n * (theta + |A v|)."""
        ax = matvec(x)
        res = torch.linalg.vector_norm(ax - theta[None, :] * x, dim=0)
        eps = torch.finfo(torch.float32).eps
        bound = eps * 10 * n * (torch.linalg.vector_norm(ax, dim=0) + theta)
        return int((res < bound).sum())

    # The default run stops where the JAX rule says: every column passes
    # at its last iteration (unless it ran all 64), and not every column
    # passed one iteration earlier.
    theta, vecs, iters = out["lobpcg"]
    at_stop = jax_rule_converged(theta, vecs)
    before = None
    if iters > 1:
        before = jax_rule_converged(*PS.lobpcg_standard(matvec, x0,
                                                        m=iters - 1)[:2])
    rule = {"columns": out_dim + 1, "converged_at_stop": at_stop,
            "converged_one_iteration_earlier": before,
            "stops_as_jax": (iters == 64 or at_stop == out_dim + 1)
            and (before is None or before < out_dim + 1)}
    vectors = {"lobpcg": vecs[:, 1:], "lobpcg_tol0": out["lobpcg_tol0"][1][:, 1:],
               "chebyshev": out["chebyshev"]}
    iterations = {"lobpcg": iters, "lobpcg_tol0": out["lobpcg_tol0"][2]}
    lap = PS._Laplacian(graph)
    null_basis = exact_null_space(graph)
    n_comp = null_basis.shape[1]
    cosines = subspace_cosines

    def energy(v):
        qv, _ = torch.linalg.qr(v)
        return float((qv * lap(qv)).sum())

    cheb = out["chebyshev"]
    e_cheb = energy(cheb)
    lobpcg = {"graph_rows": n, "out_dim": out_dim,
              "null_space_dim": n_comp, "energy_chebyshev": e_cheb,
              "chebyshev_seconds": seconds["chebyshev"],
              "default_run_stopping_rule": rule}
    for name, v in vectors.items():
        whole = cosines(v, cheb)
        lobpcg[name] = {
            "iterations": iterations.get(name), "seconds": seconds[name],
            "finite": bool(torch.isfinite(v).all()),
            "null_space_cosine_min": float(
                cosines(v[:, :n_comp - 1], null_basis).min()),
            "whole_block_cosines_min": float(whole.min()),
            "whole_block_cosines_median": float(whole.median()),
            "energy": energy(v)}
    q32 = images[:BLOCK_ROWS]
    d_a, i_a = knn(q32, images, K, exclude_self=True, engine="approx")
    d_x, i_x = knn(q32, images, K, exclude_self=True, engine="xla")
    approx_cmp = tie_aware_match(d_a ** 2, i_a, d_x ** 2, i_x,
                                 sq_scale(q32, images), RTOL[False])
    return {"phase": "engine_checks", "lobpcg": lobpcg,
            "approx_vs_xla": {"shape": [BLOCK_ROWS, images.shape[0],
                                        images.shape[1]], **approx_cmp}}


def f32_table(images):
    """Phase 8 (see the module docstring). Returns (the phase's JSON line,
    the f32-mode launches it made)."""
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops.knn import knn

    sync = torch.cuda.synchronize
    sync()
    reset_counts(KT)
    t0 = time.perf_counter()
    d_p, i_p = knn(images, images, K, exclude_self=True, engine="pallas")
    sync()
    seconds = time.perf_counter() - t0
    launches = KT.KNN_TILE_F32_LAUNCHES
    t0 = time.perf_counter()
    d_x, i_x = knn(images, images, K, exclude_self=True, engine="xla")
    sync()
    xla_seconds = time.perf_counter() - t0
    cmp = tie_aware_match(d_p ** 2, i_p, d_x ** 2, i_x,
                          sq_scale(images, images), RTOL[False])
    return {"phase": "f32_table", "shape": list(images.shape), "k": K,
            "engine": "pallas", "seconds": seconds,
            "xla_seconds": xla_seconds, "knn_tile_f32_launches": launches,
            "other_launches": tile_launches(KT) - launches
            + KT.ROW_NORM_LAUNCHES, "vs_xla": cmp}, launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- needs a "
              "CUDA GPU", file=sys.stderr)
        raise SystemExit(2)
    from multimodal_umap_tpu_torch import Config
    from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
    from multimodal_umap_tpu_torch.eval.trustworthiness import (
        trustworthiness, trustworthiness_sampled)
    from multimodal_umap_tpu_torch.eval.validation import (
        knn_test, similarity_test, train)
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops.knn import knn

    # 1. device
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, **tf32})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")

    # 2. build
    t0 = time.perf_counter()
    KT.build()
    ptxas = ptxas_report(KT.BUILD_LOG)
    sass = sass_counts(KT.SO_PATH, ("knn_tile_bf16_kernel",
                                    "knn_tile_f32_kernel"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": KT.BUILD_SECONDS, "ptxas": ptxas,
          "sass_counts": sass})
    check(all(any(k == f or k.startswith(f + "<") for k in ptxas)
              for f in KERNEL_FUNCTIONS), "ptxas report incomplete")
    check(all(v.get("spill_bytes") == 0 for v in ptxas.values()),
          "a kernel spills registers")
    check(sass["knn_tile_bf16_kernel"]["HGMMA"] > 0
          and sass["knn_tile_bf16_kernel"]["UTMALDG"] > 0,
          "bf16 tile kernel has no wgmma or no TMA load")
    check(sass["knn_tile_f32_kernel"]["HGMMA_TF32"] > 0
          and sass["knn_tile_f32_kernel"]["UTMALDG"] > 0,
          "f32 tile kernel has no TF32 wgmma or no TMA load")

    t0 = time.perf_counter()
    data = clustered_modalities(N_TRAIN + N_TEST, dims=DIMS, seed=0,
                                centers_seed=1)
    train_np = {k: v[:N_TRAIN] for k, v in data.items()}
    test_np = {k: v[N_TRAIN:] for k, v in data.items()}
    images = torch.from_numpy(train_np["images"]).to(dev)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "shapes": {k: list(v.shape) for k, v in data.items()}})

    # 3. kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    texts = torch.from_numpy(train_np["texts"]).to(dev)
    last = N_TRAIN - (N_TRAIN - 1) // BLOCK_ROWS * BLOCK_ROWS  # 7,168 rows
    blocks = [(images, BLOCK_ROWS, BLOCK_ROWS), (texts, N_TRAIN - last, last)]
    big = torch.randn(2 * KT.COL_BLOCK, DIMS[1], generator=gen, device=dev)
    results = []
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        for case in KERNEL_CASES:
            q, r, tk, ex, off = case_inputs(case, gen, dev, dt)
            tk = KT.TILE_C if tk is None else tk
            got = KT.knn_tile(q, r, tk, exclude_self=ex, row_offset=off)
            torch.cuda.synchronize()
            want = KT.knn_tile_plain(q, r, tk, exclude_self=ex, row_offset=off)
            results.append({
                "case": list(case), "tile_k": tk, "bf16": bf16,
                **tie_aware_match(*got, *want, sq_scale(q, r), RTOL[bf16])})
        # main-path blocks of the fit graph
        tk = KT.bf16_tile_k(K, N_TRAIN - 1) if bf16 else K
        for table, start, rows in blocks:
            qb, rb = table[start:start + rows].to(dt), table.to(dt)
            got = KT.knn_tile(qb, rb, tk, exclude_self=True, row_offset=start)
            torch.cuda.synchronize()
            want = KT.knn_tile_plain(qb, rb, tk, exclude_self=True,
                                     row_offset=start)
            results.append({
                "shape": list(qb.shape) + [N_TRAIN], "row_offset": start,
                "tile_k": tk, "bf16": bf16,
                **tie_aware_match(*got, *want, sq_scale(qb, rb), RTOL[bf16])})
            del got, want
        # column chunks of the streamed kNN (one launch per COL_BLOCK
        # columns): a chunk past the query block (negative row_offset,
        # no self column inside), the chunk holding it, and a chunk that
        # holds half the block's self columns
        for d in DIMS:
            chunk_table = big[:, :d].to(dt).contiguous()
            tk = KT.bf16_tile_k(K, 2 * KT.COL_BLOCK - 1) if bf16 else K
            for name, start, c0, rows, cols in (
                    ("chunk past the block", 0, KT.COL_BLOCK, BLOCK_ROWS,
                     KT.COL_BLOCK),
                    ("chunk holding the block", KT.COL_BLOCK + BLOCK_ROWS,
                     KT.COL_BLOCK, BLOCK_ROWS, KT.COL_BLOCK),
                    ("chunk holding half the block", 0, 150, 300, 500)):
                qb = chunk_table[start:start + rows]
                rb = chunk_table[c0:c0 + cols]
                off = start - c0
                got = KT.knn_tile(qb, rb, tk, exclude_self=True,
                                  row_offset=off)
                torch.cuda.synchronize()
                want = KT.knn_tile_plain(qb, rb, tk, exclude_self=True,
                                         row_offset=off)
                results.append({
                    "chunk": name, "shape": [rows, cols, d],
                    "row_offset": off, "tile_k": tk, "bf16": bf16,
                    **tie_aware_match(*got, *want, sq_scale(qb, rb),
                                      RTOL[bf16])})
                del got, want
            del chunk_table
    del big
    main_block_err = next(c["max_abs_err"] for c in results
                          if c.get("row_offset") == BLOCK_ROWS
                          and c["bf16"] and "chunk" not in c)
    rb = images.to(torch.bfloat16)
    norm_k = KT.row_norms_sq(rb)
    torch.cuda.synchronize()
    norm_p = KT.row_norms_sq_plain(rb)
    norm_err = float((norm_k - norm_p).abs().max())
    norm_ok = bool(((norm_k - norm_p).abs() <= 1e-5 * norm_p).all())
    emit({"phase": "kernel_vs_plain", "rtol_of_scale": RTOL,
          "cases": results, "row_norms": {"shape": list(rb.shape),
                                          "max_abs_err": norm_err,
                                          "rtol": 1e-5, "ok": norm_ok}})
    check(all(c["values_ok"] and c["ids_ok"] for c in results),
          "tile kernel disagrees with plain")
    check(norm_ok, "norm pre-pass disagrees with plain")

    # 4. small reference: golden band + kernel engine vs exact engine
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens", "reference_e2e.json")) as f:
        golden = json.load(f)
    gc = golden["config"]
    small = clustered_modalities(gc["n_train"] + gc["n_test"],
                                 dims=tuple(gc["dims"]),
                                 n_clusters=gc["n_clusters"], seed=gc["seed"])
    s_train = {k: v[:gc["n_train"]] for k, v in small.items()}
    s_test = {k: v[gc["n_train"]:] for k, v in small.items()}
    s_cfg = Config(k_neighbors=gc["k"], out_dim=gc["out_dim"],
                   train_epochs=gc["epochs"], test_epochs=gc["test_epochs"],
                   num_rep=4, lr=0.05, alpha=1.0, batch_size=64)
    s_model = train(s_train, s_cfg, device=dev)
    s_cos = similarity_test(s_test, s_cfg, s_model, return_values=True,
                            quiet=True)
    s_trust = [trustworthiness(s_train[k], s_model.embeds[i], k=10)
               for i, k in enumerate(s_train)]
    # recon as tests/test_reference_parity_e2e.py runs it
    s_z = s_model.transform([s_test["texts"]], epochs=gc["test_epochs"],
                            data_indices=[0], num_rep=4, lr=0.05,
                            batch_size=64)
    s_recon = s_model.inverse_transform(
        s_z, epochs=gc["test_epochs"], data_indices=[1], num_rep=4, lr=0.05,
        batch_size=64)[0].cpu().numpy()
    s_mse = float(np.mean((s_recon - s_test["images"]) ** 2))
    x = torch.from_numpy(s_train["images"]).to(dev)
    d_k, i_k = knn(x, x, gc["k"], exclude_self=True, engine="bf16")
    d_x, i_x = knn(x, x, gc["k"], exclude_self=True, engine="xla")
    knn_cmp = tie_aware_match(d_k ** 2, i_k, d_x ** 2, i_x, sq_scale(x, x),
                              RTOL[False])
    ref = golden["reference"]
    emit({"phase": "reference", "cosine": s_cos,
          "cosine_band": ref["cosine"] - 0.03, "trust": s_trust,
          "trust_band": [t - 0.02 for t in ref["trustworthiness"]],
          "recon_mse": s_mse, "recon_mse_band": 1.1 * ref["recon_mse"],
          "knn_bf16_vs_xla": knn_cmp})
    check(s_cos >= ref["cosine"] - 0.03, "small-input cosine below band")
    check(all(t >= r - 0.02 for t, r in zip(s_trust, ref["trustworthiness"])),
          "small-input trustworthiness below band")
    check(knn_cmp["values_ok"] and knn_cmp["ids_ok"],
          "bf16 kernel engine disagrees with the exact engine")
    check(s_mse <= 1.1 * ref["recon_mse"], "small-input recon MSE above band")

    # 5. the captured layout epoch against the eager loop
    # (layout_graph_torch.py); every later layout runs captured
    import layout_graph_torch as LG

    gline, graph_fails = LG.run(train_np, test_np, dev)
    emit(gline)
    check(not graph_fails, "layout_graph: " + "; ".join(graph_fails))

    # 6. main path at full width
    cfg = Config()
    torch.cuda.synchronize()
    reset_counts(KT)
    launches = {}
    phases = {}
    t0 = time.perf_counter()
    with first_term_inputs({}) as main_terms:
        model = train(train_np, cfg, device=dev)
    torch.cuda.synchronize()
    phases["train"] = time.perf_counter() - t0
    launches["after_fit"] = tile_launches(KT)
    main_term_launches = term_launches()
    main_nce = infonce_launches()
    t0 = time.perf_counter()
    cosine = similarity_test(test_np, cfg, model, return_values=True,
                             quiet=True)
    phases["similarity_test"] = time.perf_counter() - t0
    launches["after_transform"] = tile_launches(KT)
    t0 = time.perf_counter()
    knn5 = knn_test(test_np, cfg, k=5, model=model, return_values=True,
                    quiet=True)
    phases["knn_test"] = time.perf_counter() - t0
    launches["after_knn_test"] = tile_launches(KT)
    t0 = time.perf_counter()
    trust = [trustworthiness_sampled(train_np[k], model.embeds[i], k=10)
             for i, k in enumerate(train_np)]
    phases["trustworthiness_sampled"] = time.perf_counter() - t0
    main_launches = KT.KNN_TILE_BF16_LAUNCHES
    main_f32_launches = KT.KNN_TILE_F32_LAUNCHES
    norm_launches = KT.ROW_NORM_LAUNCHES
    embeds_ok = all(
        tuple(e.shape) == (N_TRAIN, cfg.out_dim) and bool(torch.isfinite(e).all())
        for e in model.embeds)
    fit_loss = model.loss_history["fit"]
    emit({"phase": "main_path", "n_train": N_TRAIN, "n_test": N_TEST,
          "dims": list(DIMS), "k": cfg.k_neighbors, "out_dim": cfg.out_dim,
          "train_epochs": cfg.train_epochs, "test_epochs": cfg.test_epochs,
          "cut": "none", "phase_seconds": phases,
          "model_phase_seconds": model.timer.report(),
          "fit_loss_first_last": [float(fit_loss[0]), float(fit_loss[-1])],
          "cosine": cosine, "knn5": knn5, "trust": trust,
          "knn_tile_launches": launches,
          "row_norm_launches": norm_launches,
          "layout_term_launches": main_term_launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    check(embeds_ok, "fit embeddings not finite or of the wrong shape")
    check(all(np.isfinite(v) for v in [cosine, knn5, *trust, *fit_loss]),
          "non-finite metric")
    check(cosine >= 0.9, f"cosine {cosine} < 0.9")
    check(launches["after_fit"] > 0, "fit launched no kNN kernel")
    check(launches["after_transform"] > launches["after_fit"],
          "transform launched no kNN kernel")
    check(launches["after_knn_test"] > launches["after_transform"],
          "knn_test launched no kNN kernel")
    check(norm_launches > 0, "the main path launched no norm pre-pass")
    check(all(v > 0 for k, v in main_term_launches.items()
              if k not in TERM_LOSS_ONLY),
          f"the main path left a layout-term kernel unlaunched: "
          f"{main_term_launches}")
    check(terms_engaged(main_term_launches),
          f"a main-path fit forward did not save its backward's weights: "
          f"{main_term_launches}")

    # 7. the recon path (save/load, embed_and_recon, crossmodal_recon)
    torch.cuda.synchronize()
    reset_counts(KT)
    rline, invert_q, app_rows = recon_path(model, train_np, test_np, cfg,
                                           dev, OUT_DIR)
    recon_launches = KT.KNN_TILE_BF16_LAUNCHES
    recon_norm_launches = KT.ROW_NORM_LAUNCHES
    rline.update(knn_tile_launches=recon_launches,
                 row_norm_launches=recon_norm_launches)
    emit(rline)
    check(rline["roundtrip_bit_equal"], "save/load round trip not bit-equal")
    check(rline["recon_finite"] and rline["recon_shape"] == [N_TEST, DIMS[1]],
          "recon not finite or of the wrong shape")
    check(rline["recon_mse"] < rline["train_mean_mse"],
          "recon MSE not below the train-mean predictor")
    check(rline["invert_tile_launches"] > 0,
          "recon's invert graph launched no kNN kernel")
    check(rline["app_tile_launches"] >= 2,
          "the recon app's transform + invert launched < 2 kNN kernels")
    check(rline["decoded_shape"] == [N_APP, 3, 256, 256]
          and rline["decoded_finite"], "VAE decode wrong shape or not finite")
    check(rline["cpu_vs_card_ok"],
          "VAE decode on the card differs from the CPU / float64 decode")
    check(rline["png_files"] == N_APP, "recon app wrote the wrong PNG count")
    check(recon_launches > 0 and recon_norm_launches > 0,
          "the recon path launched no kernel")
    recon_f32_launches = KT.KNN_TILE_F32_LAUNCHES

    # 8. the f32 mode over the whole image table
    fline, table_f32_launches = f32_table(images)
    emit(fline)
    check(fline["vs_xla"]["values_ok"] and fline["vs_xla"]["ids_ok"],
          "pallas engine (f32 mode) disagrees with the exact engine")
    check(table_f32_launches == -(-N_TRAIN // BLOCK_ROWS)
          and fline["other_launches"] == 0,
          f"f32 table path: {table_f32_launches} f32-mode launches, "
          f"{fline['other_launches']} others")

    # 9. the CLI path at 131,072 pairs, bf16-stored tables
    cline, cli_model, cli_launches, census = cli_path(dev, OUT_DIR)
    emit(cline)
    metrics = cline["metrics"]
    cli_cos = metrics["cosine_similarity"]
    check(cline["data_dtypes"] == ["torch.bfloat16"] * 2
          and cline["feature_dtype"] == "bfloat16",
          "CLI fit tables are not bf16")
    check(all(np.isfinite(v) for v in [cli_cos, metrics["knn_accuracy@1"],
                                       *cli_model.loss_history["fit"]]),
          "CLI path: non-finite metric or fit loss")
    check(cli_cos >= 0.9, f"CLI path cosine {cli_cos} < 0.9")
    check(cline["graph_peak_minus_tables_and_candidates_gib"]
          < cline["f32_image_table_gib"],
          "CLI fit's graph stage holds an f32 copy of the image table")
    check(cline["bf16_keys"] == ["data_0", "data_1"]
          and cline["reload_bit_equal_bf16"],
          "CLI archive not bf16, or its reload not bit-equal bf16")
    check(metrics["knn_engine"] == "approx", "CLI metrics lost the engine")
    check(all(v > 0 for k, v in cli_launches.items()
              if k not in TERM_LOSS_ONLY),
          f"CLI path left a kernel mode unlaunched: {cli_launches}")
    check(terms_engaged(cli_launches),
          f"a CLI fit forward did not save its backward's weights: "
          f"{cli_launches}")

    # 10. lobpcg and approx on the card
    eline = engine_checks(cli_model, images, dev)
    emit(eline)
    lob = eline["lobpcg"]
    full = lob["lobpcg_tol0"]
    check(lob["lobpcg"]["finite"] and full["finite"],
          "lobpcg returned non-finite vectors")
    check(lob["default_run_stopping_rule"]["stops_as_jax"],
          "--spectral lobpcg did not stop where the JAX package's rule does")
    check(lob["null_space_dim"] == N_CLUSTERS,
          f"CLI graph has {lob['null_space_dim']} components, not "
          f"{N_CLUSTERS}")
    check(full["null_space_cosine_min"] > 0.99,
          "lobpcg's null-space columns leave the graph's null space")
    check(lob["chebyshev"]["null_space_cosine_min"] > 0.99,
          "Chebyshev's null-space columns leave the graph's null space")
    check(full["energy"] <= 1.01 * lob["energy_chebyshev"],
          "lobpcg's block energy is > 1 % above Chebyshev's")
    check(eline["approx_vs_xla"]["values_ok"]
          and eline["approx_vs_xla"]["ids_ok"],
          "approx engine disagrees with the exact engine")

    # 11. the scale path: the ladder's first rung in process, 524,288
    # pairs with bf16 tables at full width (scale_ladder_torch.py)
    import scale_ladder_torch as ladder

    torch.cuda.synchronize()
    reset_counts(KT)
    sline, scale_census = ladder.run_rung(N_SCALE, dev)
    scale_launches = {"knn_tile_bf16": KT.KNN_TILE_BF16_LAUNCHES,
                      "knn_tile_f32": KT.KNN_TILE_F32_LAUNCHES,
                      "knn_rownorm": KT.ROW_NORM_LAUNCHES, **term_launches(),
                      **infonce_launches()}
    scale_fails = ladder.failures(sline)
    sline.update(cut="none", launches=scale_launches, failures=scale_fails)
    emit(sline)
    check(not scale_fails, "scale path: " + "; ".join(scale_fails))
    check(all(scale_launches[k] > 0 for k in ("knn_tile_bf16", "knn_rownorm",
                                               *TERM_KERNELS,
                                               *infonce_launches())),
          f"scale path left a kernel unlaunched: {scale_launches}")
    from multimodal_umap_tpu_torch.models import layout as PL

    check(terms_engaged(scale_launches,
                        recomputed=N_SCALE > PL._MODALITY_REMAT_ROWS),
          f"a scale-path fit forward did not save its backward's weights: "
          f"{scale_launches}")

    # 12. the mesh path: NCCL at world size 1 in process, then two gloo
    # ranks sharing this card (mesh_path_torch.py)
    import mesh_path_torch as MP

    torch.cuda.synchronize()
    reset_counts(KT)
    mline, mesh_fails, mesh_launches = MP.run(
        train_np, test_np, dev, os.path.join(OUT_DIR, "mesh"), cosine)
    emit(mline)
    check(not mesh_fails, "mesh path: " + "; ".join(mesh_fails))
    mesh_gloo = mesh_launches["gloo_two_ranks"]
    ring_steps = [s for s in mline["gloo_two_ranks"]["signatures"]
                  if s["mode"] == "bf16" and s["Q"] == BLOCK_ROWS
                  and s["D"] in DIMS]
    check(sorted(s["D"] for s in ring_steps if s["exclude_self"])
          == sorted(DIMS), "mesh path: no fit ring step of "
          f"{BLOCK_ROWS} rows at D = {DIMS}")
    mesh_terms = {part: mesh_launches[f"{part}_layout_terms"]
                  for part in ("nccl_world1", "gloo_two_ranks")}
    check(all(part[k] > 0 for part in mesh_terms.values()
              for k in TERM_KERNELS),
          f"mesh path left a layout-term kernel unlaunched: {mesh_terms}")
    check(all(terms_engaged(part) for part in mesh_terms.values()),
          f"a mesh-path fit forward did not save its backward's weights: "
          f"{mesh_terms}")
    mesh_nce = {part: mesh_launches[f"{part}_infonce"]
                for part in ("nccl_world1", "gloo_two_ranks")}
    check(all(v > 0 for part in mesh_nce.values() for v in part.values()),
          f"mesh path left an InfoNCE kernel unlaunched: {mesh_nce}")

    # 13. the fit layout's term kernels against their plain versions at
    # the main path's first layout call, a rank's row range of it and the
    # scale rung's shape
    tline = layout_terms(main_terms, dev)
    emit(tline)
    bad = [f"{term} {shape}" for term in ("attr", "rep")
           for shape, v in tline[term].items() if not v["ok"]]
    check(not bad, f"layout-term kernels disagree with plain: {bad}")
    del main_terms

    # 14. knn_tiled's stages at the main-path block (rows [0, 8192) of the
    # D=4096 fit graph, bf16), and the tile kernel at the other shapes,
    # each also held against its plain version there
    from multimodal_umap_tpu_torch.ops.knn import _exact_rescore_sq

    tk = KT.bf16_tile_k(K, N_TRAIN - 1)
    cand = max(4 * K, 64)
    q32 = images[:BLOCK_ROWS]
    qb, rb = q32.to(torch.bfloat16), images.to(torch.bfloat16)
    q_sq, r_sq = KT.row_norms_sq(qb), KT.row_norms_sq(rb)

    def tile():
        return KT.knn_tile(qb, rb, tk, exclude_self=True, q_sq=q_sq, r_sq=r_sq)

    d_c, i_c = tile()

    def merge():
        cand_d = d_c.permute(1, 0, 2).reshape(BLOCK_ROWS, -1)
        cand_i = i_c.permute(1, 0, 2).reshape(BLOCK_ROWS, -1)
        _, pos = torch.topk(cand_d, cand, dim=1, largest=False)
        return cand_i.gather(1, pos)

    ids_c = merge()
    rows = torch.arange(BLOCK_ROWS, device=dev)[:, None]

    def rescore():
        d2 = _exact_rescore_sq(q32, images, ids_c.clamp(0, N_TRAIN - 1),
                               chunk=KT.rescore_chunk(cand, DIMS[1]))
        d2 = d2.masked_fill((ids_c >= N_TRAIN) | (ids_c == rows), float("inf"))
        vals, sel = torch.topk(d2, K, dim=1, largest=False)
        return vals, ids_c.gather(1, sel)

    def bound_fma_ms(nq, n, d):
        """The f32 mode's products as one f32 pass on the CUDA cores' FMA
        pipe (what a kernel off the tensor cores could at best reach)."""
        return 2.0 * nq * n * d / H100_F32_FLOPS * 1e3

    stages = {
        "norm_prepass_ms": cuda_ms(lambda: (KT.row_norms_sq(qb),
                                            KT.row_norms_sq(rb)), 10),
        "tile_kernel_ms": cuda_ms(tile, 10),
        "merge_topk_ms": cuda_ms(merge, 10),
        "rescore_ms": cuda_ms(rescore, 10),
    }
    del d_c, i_c, ids_c
    other = []
    test_images = torch.from_numpy(test_np["images"]).to(dev)
    cases = [
        ("fit block, D=768", texts[:BLOCK_ROWS], texts, tk, True, 0, True),
        ("transform block, D=4096", test_images, images, tk, False, 0, True),
        ("invert block, D=64", invert_q, model.embeds[1], tk, False, 0, True),
        ("app invert query, D=64",
         invert_q[torch.as_tensor(app_rows, device=dev)], model.embeds[1],
         tk, False, 0, True),
        ("fit block, D=4096, f32 mode (pallas / approx)", q32, images, K,
         True, 0, False)]
    # every signature the CLI path launched, at its first launch's inputs
    for (nq, n, d, dt, tko, ex), v in census.items():
        bf16 = dt == str(torch.bfloat16)
        cases.append((f"CLI {nq} x {n}, D={d}, {'bf16' if bf16 else 'f32'}"
                      f"{', self' if ex else ''} ({v['launches']} launches)",
                      v["q"], v["r"], tko, ex, v["row_offset"], bf16))
    # and every signature of the scale path (its column chunks)
    for (nq, n, d, dt, tko, ex, path), v in scale_census.items():
        bf16 = dt == str(torch.bfloat16)
        cases.append((f"scale {path} {nq} x {n}, D={d}, "
                      f"{'bf16' if bf16 else 'f32'}{', self' if ex else ''} "
                      f"({v['launches']} launches)",
                      v["q"], v["r"], tko, ex, v["row_offset"], bf16))
    for name, qo, ro, tko, ex, off, bf16 in cases:
        dt = torch.bfloat16 if bf16 else torch.float32
        qo, ro = qo.to(dt), ro.to(dt)  # no copy for the bf16-stored tables
        qs, rs = ((KT.row_norms_sq(qo), KT.row_norms_sq(ro)) if bf16
                  else (None, None))
        got = KT.knn_tile(qo, ro, tko, exclude_self=ex, row_offset=off,
                          q_sq=qs, r_sq=rs)
        torch.cuda.synchronize()
        want = KT.knn_tile_plain(qo, ro, tko, exclude_self=ex, row_offset=off)
        cmp = tie_aware_match(*got, *want, sq_scale(qo, ro), RTOL[bf16])
        del got, want
        b_ms, b_by = bound_ms(qo.shape[0], ro.shape[0], ro.shape[1], tko,
                              bf16)
        fma = {} if bf16 else {"bound_fma_ms": bound_fma_ms(
            qo.shape[0], ro.shape[0], ro.shape[1])}
        other.append({
            "shape": name, "mode": "bf16" if bf16 else "f32",
            "Q": qo.shape[0], "N": ro.shape[0], "D": ro.shape[1],
            "tile_k": tko, "bound_ms": b_ms, "bound_by": b_by, **fma,
            "ms": cuda_ms(lambda: KT.knn_tile(
                qo, ro, tko, exclude_self=ex, row_offset=off, q_sq=qs,
                r_sq=rs), 10),
            "plain_ms": cuda_ms(lambda: KT.knn_tile_plain(
                qo, ro, tko, exclude_self=ex, row_offset=off), 3),
            "library_ms": cuda_ms(lambda: library_tile_topk(
                qo, ro, tko, KT.TILE_C, exclude_self=ex, row_offset=off), 10),
            "vs_plain": cmp})
    # launches of the fit graph's (8,192 x COL_BLOCK) chunk, by D
    chunk_launches = {key[2]: v["launches"]
                      for key, v in scale_census.items()
                      if key[-1] == "fit" and key[:2] == (BLOCK_ROWS,
                                                          KT.COL_BLOCK)}
    del census, scale_census, cases
    emit({"phase": "knn_stages", "shape": {"Q": BLOCK_ROWS, "N": N_TRAIN,
                                           "D": DIMS[1], "tile_k": tk,
                                           "cand": cand, "k": K},
          **stages, "tile_kernel_other_shapes": other})
    check(all(o["vs_plain"]["values_ok"] and o["vs_plain"]["ids_ok"]
              for o in other),
          "tile kernel disagrees with plain at a main-path shape")
    f32_block = next(o for o in other if o["mode"] == "f32"
                     and not o["shape"].startswith(("CLI", "scale")))
    f32_cli = [o for o in other if o["mode"] == "f32"
               and o["shape"].startswith("CLI")]
    check(len(f32_cli) == 1, "expected one f32-mode signature on the CLI "
          f"path, got {len(f32_cli)}")
    f32_row = f32_cli[0]  # the recon app's invert graph under approx

    scale_chunk = {
        o["D"]: {"launches": chunk_launches[o["D"]],
                 "max_abs_err": o["vs_plain"]["max_abs_err"],
                 **{k: o[k] for k in ("Q", "N", "D", "tile_k", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}
        for o in other if o["shape"].startswith("scale fit")
        and (o["Q"], o["N"]) == (BLOCK_ROWS, KT.COL_BLOCK)}
    check(sorted(scale_chunk) == sorted(DIMS),
          f"scale path: no fit chunk launch of {BLOCK_ROWS} x "
          f"{KT.COL_BLOCK} at D = {DIMS}")

    # 15. kernels line: the fit graph's main-path block at D=4096, bf16,
    # with its column chunk on the scale path (8,192 x COL_BLOCK, D = 4,096
    # and 768) beside it; f32 mode at the same block (phase 8 drives it
    # there), with its launch on the CLI path (the recon app's 16 x
    # COL_BLOCK chunks at D=64) beside it
    ms = stages["tile_kernel_ms"]
    plain_ms = cuda_ms(lambda: KT.knn_tile_plain(qb, rb, tk, exclude_self=True), 3)
    library_ms = cuda_ms(lambda: library_tile_topk(
        qb, rb, tk, KT.TILE_C, exclude_self=True), 10)
    b_ms, b_by = bound_ms(BLOCK_ROWS, N_TRAIN, DIMS[1], tk)
    rows_all = BLOCK_ROWS + N_TRAIN
    n_bytes = 2.0 * rows_all * DIMS[1] + 4.0 * rows_all
    n_ops = 2.0 * rows_all * DIMS[1]
    t_nb = n_bytes / H100_BYTES_PER_S * 1e3
    t_no = n_ops / H100_F32_FLOPS * 1e3
    f32_by_path = {"fit_eval": main_f32_launches,
                   "recon": recon_f32_launches,
                   "f32_table": table_f32_launches,
                   "cli": cli_launches["knn_tile_f32"],
                   "scale": scale_launches["knn_tile_f32"],
                   "mesh_gloo": mesh_gloo["knn_tile_f32"]}
    f32_keys = ("Q", "N", "D", "tile_k", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_fma_ms", "library_ms")
    print(json.dumps({"kernels": [{
        "name": "knn_tile",
        "route": "cuda",
        "source": "multimodal_umap_tpu_torch/csrc/knn_tile.cu",
        "replaces": "multimodal_umap_tpu/ops/knn_pallas.py:48",
        "launches": main_launches + recon_launches
        + cli_launches["knn_tile_bf16"] + scale_launches["knn_tile_bf16"]
        + mesh_launches["nccl_world1"] + mesh_gloo["knn_tile_bf16"],
        "launches_by_path": {"fit_eval": main_launches,
                             "recon": recon_launches,
                             "cli": cli_launches["knn_tile_bf16"],
                             "scale": scale_launches["knn_tile_bf16"],
                             "mesh_nccl": mesh_launches["nccl_world1"],
                             "mesh_gloo": mesh_gloo["knn_tile_bf16"]},
        "max_abs_err": main_block_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"Q": BLOCK_ROWS, "N": N_TRAIN, "D": DIMS[1], "tile_k": tk,
                  "mode": "bf16"},
        "at_scale_chunk": [scale_chunk[d] for d in DIMS],
        "at_ring_step": [
            {"max_abs_err": s["vs_plain"]["max_abs_err"],
             **{k: s[k] for k in ("Q", "N", "D", "tile_k", "launches", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}
            for s in sorted(ring_steps, key=lambda s: (-s["D"], s["N"]))
            if s["exclude_self"]],
    }, {
        "name": "knn_tile_f32",
        "route": "cuda",
        "source": "multimodal_umap_tpu_torch/csrc/knn_tile.cu",
        "replaces": "multimodal_umap_tpu/ops/knn_pallas.py:48",
        "launches": sum(f32_by_path.values()),
        "launches_by_path": f32_by_path,
        "max_abs_err": f32_block["vs_plain"]["max_abs_err"],
        "ms": f32_block["ms"],
        "plain_ms": f32_block["plain_ms"],
        "bound_ms": f32_block["bound_ms"],
        "bound_by": f32_block["bound_by"],
        "bound_fma_ms": f32_block["bound_fma_ms"],
        "library_ms": f32_block["library_ms"],
        "shape": {"Q": f32_block["Q"], "N": f32_block["N"],
                  "D": f32_block["D"], "tile_k": f32_block["tile_k"],
                  "mode": "f32"},
        "at_cli_app_shape": {
            "max_abs_err": f32_row["vs_plain"]["max_abs_err"],
            **{k: f32_row[k] for k in f32_keys}},
    }, {
        "name": "knn_rownorm",
        "route": "cuda",
        "source": "multimodal_umap_tpu_torch/csrc/knn_tile.cu",
        "replaces": "multimodal_umap_tpu/ops/knn_pallas.py:74",
        "launches": norm_launches + recon_norm_launches
        + cli_launches["knn_rownorm"] + scale_launches["knn_rownorm"]
        + mline["nccl_world1"]["ring_norm_launches"]
        + mesh_gloo["knn_rownorm"],
        "launches_by_path": {"fit_eval": norm_launches,
                             "recon": recon_norm_launches,
                             "cli": cli_launches["knn_rownorm"],
                             "scale": scale_launches["knn_rownorm"],
                             "mesh_nccl": mline["nccl_world1"][
                                 "ring_norm_launches"],
                             "mesh_gloo": mesh_gloo["knn_rownorm"]},
        "max_abs_err": norm_err,
        "ms": stages["norm_prepass_ms"],
        "plain_ms": cuda_ms(lambda: (KT.row_norms_sq_plain(qb),
                                     KT.row_norms_sq_plain(rb)), 10),
        "bound_ms": max(t_nb, t_no),
        "bound_by": "bytes" if t_nb >= t_no else "operations",
        "library_ms": None,
        "shape": {"rows": [BLOCK_ROWS, N_TRAIN], "D": DIMS[1],
                  "mode": "bf16"},
    }, *term_entries(tline, {
        "fit_eval": main_term_launches, "cli": cli_launches,
        "scale": scale_launches, "mesh_nccl": mesh_terms["nccl_world1"],
        "mesh_gloo": mesh_terms["gloo_two_ranks"]})]}), flush=True)
    # 16. the InfoNCE kernels at both benchmark cells' shapes
    nline = infonce_phase(dev)
    nce_by_path = {
        "fit_eval": main_nce,
        **{p: {k: c[k] for k in main_nce}
           for p, c in (("cli", cli_launches), ("scale", scale_launches))},
        "mesh_nccl": mesh_nce["nccl_world1"],
        "mesh_gloo": mesh_nce["gloo_two_ranks"]}
    nline["launches_by_path"] = nce_by_path
    emit(nline)
    check(all(v > 0 for path in nce_by_path.values() for v in path.values()),
          f"a path that fits left an InfoNCE kernel unlaunched: {nce_by_path}")
    check(all(nline[name]["ok"] for name, _ in INFONCE_SHAPES),
          "InfoNCE kernels disagree with plain or are not bit-reproducible")

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
