"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout (it builds the kNN tile
kernel from ``multimodal_umap_tpu_torch/csrc``); exits non-zero, with no
result line, on any failed phase, without a GPU, or outside the repo.
Imports neither JAX nor the JAX package. Prints one JSON object per
line:

1. device -- the card (``nvidia-smi`` name and power limit) and the TF32
   flags; fails if float32 matmuls may use TF32;
2. build -- builds the kernel, prints the build seconds;
3. kernel_vs_plain -- the kernel against its plain PyTorch version on
   the card, in f32 and bf16 modes: small cases plus one main-path block
   (8,192 rows against the full 31,744 x 4,096 table, k=15,
   exclude_self). Squared distances within rtol (|b| + max|q|^2 +
   max|r|^2), rtol 1e-5 in f32 mode (another summation order) and 1e-4
   in bf16 mode (tensor-core f32 accumulation), and ids equal as
   tie-aware sets;
4. reference -- the port on the card against the repo's end-to-end
   golden band (tests/goldens/reference_e2e.json: cosine, trust) and the
   kernel kNN engine against the exact f32 engine on a small input;
5. main_path -- ``clustered_modalities(31,744 + 1,024, (768, 4096))``,
   ``train`` with ``Config`` defaults (k=15, out_dim=64, 600 epochs),
   ``similarity_test`` and ``knn_test`` (k=5) on 1,024 held-out pairs at
   120 test epochs, ``trustworthiness_sampled`` on both modalities;
   kernel launches counted after fit, transform and knn_test; fails on
   a non-finite metric or cosine < 0.9;
6. kernels -- ``{"kernels": [...]}``: time, bound, plain and library
   times of each kernel at the main-path block shape;
7. last line -- ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_TRAIN, N_TEST, DIMS, K = 31_744, 1_024, (768, 4096), 15
BLOCK_ROWS = 8192
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
# Tolerances on squared distances, relative to the cancelled-term scale:
# f32 mode sums in another order than the plain version (~1e-7 seen);
# bf16 mode accumulates on the tensor cores, whose f32 sums do not round
# to nearest (1.8e-5 seen at the D=4096 block).
RTOL = {False: 1e-5, True: 1e-4}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": KT.BUILD_SECONDS,
          "ptxas": [ln for ln in KT.BUILD_LOG.splitlines() if "Used" in ln]})

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
    cases = [  # (Q, N, D, tile_k, exclude_self): tests/test_knn_pallas.py
        (40, 40, 24, 5, True), (24, 200, 16, 7, False),
        (19, 187, 33, 4, False), (60, 60, 24, 13, True),
        (21, 150, 17, 14, False), (16, 48, 8, 3, False)]
    results = []
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        for q_n, n, d, tk, ex in cases:
            r = torch.randn(n, d, generator=gen, device=dev) * 4.0
            q = r[:q_n] if ex else torch.randn(q_n, d, generator=gen,
                                               device=dev) * 4.0
            got = KT.knn_tile(q.to(dt), r.to(dt), tk, exclude_self=ex)
            torch.cuda.synchronize()
            want = KT.knn_tile_plain(q.to(dt), r.to(dt), tk, exclude_self=ex)
            results.append({
                "shape": [q_n, n, d], "tile_k": tk, "bf16": bf16,
                **tie_aware_match(*got, *want, sq_scale(q.to(dt), r.to(dt)),
                                  RTOL[bf16])})
        # main-path block: rows [8192, 16384) of the fit graph at D=4096
        tk = KT.bf16_tile_k(K, N_TRAIN - 1) if bf16 else K
        qb = images[BLOCK_ROWS:2 * BLOCK_ROWS].to(dt)
        rb = images.to(dt)
        got = KT.knn_tile(qb, rb, tk, exclude_self=True, row_offset=BLOCK_ROWS)
        torch.cuda.synchronize()
        want = KT.knn_tile_plain(qb, rb, tk, exclude_self=True,
                                 row_offset=BLOCK_ROWS)
        results.append({
            "shape": [BLOCK_ROWS, N_TRAIN, DIMS[1]], "tile_k": tk,
            "bf16": bf16,
            **tie_aware_match(*got, *want, sq_scale(qb, rb), RTOL[bf16])})
        del got, want
    main_block_err = results[-1]["max_abs_err"]
    emit({"phase": "kernel_vs_plain", "rtol_of_scale": RTOL,
          "cases": results})
    check(all(c["values_ok"] and c["ids_ok"] for c in results),
          "kernel disagrees with plain")

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
    x = torch.from_numpy(s_train["images"]).to(dev)
    d_k, i_k = knn(x, x, gc["k"], exclude_self=True, engine="bf16")
    d_x, i_x = knn(x, x, gc["k"], exclude_self=True, engine="xla")
    knn_cmp = tie_aware_match(d_k ** 2, i_k, d_x ** 2, i_x, sq_scale(x, x),
                              RTOL[False])
    ref = golden["reference"]
    emit({"phase": "reference", "cosine": s_cos,
          "cosine_band": ref["cosine"] - 0.03, "trust": s_trust,
          "trust_band": [t - 0.02 for t in ref["trustworthiness"]],
          "knn_bf16_vs_xla": knn_cmp})
    check(s_cos >= ref["cosine"] - 0.03, "small-input cosine below band")
    check(all(t >= r - 0.02 for t, r in zip(s_trust, ref["trustworthiness"])),
          "small-input trustworthiness below band")
    check(knn_cmp["values_ok"] and knn_cmp["ids_ok"],
          "bf16 kernel engine disagrees with the exact engine")

    # 5. main path at full width
    cfg = Config()
    torch.cuda.synchronize()
    KT.KNN_TILE_LAUNCHES = 0
    launches = {}
    phases = {}
    t0 = time.perf_counter()
    model = train(train_np, cfg, device=dev)
    torch.cuda.synchronize()
    phases["train"] = time.perf_counter() - t0
    launches["after_fit"] = KT.KNN_TILE_LAUNCHES
    t0 = time.perf_counter()
    cosine = similarity_test(test_np, cfg, model, return_values=True,
                             quiet=True)
    phases["similarity_test"] = time.perf_counter() - t0
    launches["after_transform"] = KT.KNN_TILE_LAUNCHES
    t0 = time.perf_counter()
    knn5 = knn_test(test_np, cfg, k=5, model=model, return_values=True,
                    quiet=True)
    phases["knn_test"] = time.perf_counter() - t0
    launches["after_knn_test"] = KT.KNN_TILE_LAUNCHES
    t0 = time.perf_counter()
    trust = [trustworthiness_sampled(train_np[k], model.embeds[i], k=10)
             for i, k in enumerate(train_np)]
    phases["trustworthiness_sampled"] = time.perf_counter() - t0
    main_launches = KT.KNN_TILE_LAUNCHES
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

    # 6. kernels line: the fit graph's main-path block at D=4096, bf16
    tk = KT.bf16_tile_k(K, N_TRAIN - 1)
    qb = images[:BLOCK_ROWS].to(torch.bfloat16)
    rb = images.to(torch.bfloat16)
    ms = cuda_ms(lambda: KT.knn_tile(qb, rb, tk, exclude_self=True), 10)
    plain_ms = cuda_ms(lambda: KT.knn_tile_plain(qb, rb, tk, exclude_self=True), 3)

    def library():  # yardstick only: never called by the port
        panel = torch.matmul(qb, rb.T)
        return torch.topk(panel, K, dim=1)

    library_ms = cuda_ms(library, 10)
    nct = -(-N_TRAIN // KT.TILE_C)
    flops = 2.0 * BLOCK_ROWS * N_TRAIN * DIMS[1]
    nbytes = 2.0 * (BLOCK_ROWS + N_TRAIN) * DIMS[1] + 8.0 * nct * BLOCK_ROWS * tk
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    print(json.dumps({"kernels": [{
        "name": "knn_tile",
        "route": "cuda",
        "source": "multimodal_umap_tpu_torch/csrc/knn_tile.cu",
        "replaces": "multimodal_umap_tpu/ops/knn_pallas.py:48",
        "launches": main_launches,
        "max_abs_err": main_block_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": {"Q": BLOCK_ROWS, "N": N_TRAIN, "D": DIMS[1], "tile_k": tk,
                  "mode": "bf16"},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
