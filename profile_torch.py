"""Profile the PyTorch port's layout epoch on one CUDA GPU.

    python3 profile_torch.py [--mode fit|invert] [--epochs 20] [--out DIR]
                             [--n_train 31744]

``fit`` builds the fit graphs of the chip-smoke main path (31,744
synthetic pairs at 768 / 4096 dims, k=15, out_dim=64; ``--n_train
131072`` for its CLI path; past 131,072 the scale ladder's data: bf16
tables drawn on the card, 256 clusters) and profiles the fit layout.
Where the layout's memory bounds engage (the attraction's slot scan, the
per-modality recompute: ``--n_train 524288``) the epoch is timed with
them and with every form whole, in turns (bounded, whole, whole,
bounded), and both are printed. ``invert`` fits
that model (60 epochs: the invert epoch's
cost depends on shapes, not on how well the layout converged), embeds
1,024 held-out texts and profiles the invert layout that reconstructs
them as 4,096-d images (the ``embed_and_recon`` main path). Either mode
runs ``--epochs`` layout epochs twice: once timed (host clock around a
synchronized run) and once under ``torch.profiler``. Prints JSON lines:
the card, the ms per epoch, the device-busy share (summed kernel time
over the profiled wall time), peak device memory and the kernels that
take the most device time. Writes the Chrome trace to ``--out``. Needs
a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("fit", "invert"), default="fit")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--n_train", type=int, default=31_744)
    args = ap.parse_args()
    n = args.n_train
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA GPU")
    from multimodal_umap_tpu_torch import Config, MultimodalUMAP
    from multimodal_umap_tpu_torch.data.synthetic import (
        clustered_modalities, clustered_modalities_device)
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.models.layout import (
        fit_task, query_task, train_layout)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    cfg = Config()
    if args.mode == "fit" and n > 131_072:
        train = list(clustered_modalities_device(
            n, (768, 4096), n_clusters=256, seed=0, centers_seed=0,
            device="cuda", dtype=torch.bfloat16).values())
    else:
        data = clustered_modalities(n + 1_024, dims=(768, 4096), seed=0,
                                    centers_seed=1)
        train = [torch.from_numpy(x[:n]).cuda() for x in data.values()]
    model = MultimodalUMAP(cfg.k_neighbors, cfg.out_dim, cfg.min_dist, 2,
                           device="cuda")
    if args.mode == "fit":
        graphs = [enc.fit_graph(x) for enc, x in zip(model.encoders, train)]
        tasks, statics = zip(*(fit_task(d, cfg.batch_size)
                               for _, d, _ in graphs))
        inits = [init for _, _, init in graphs]
    else:
        model.fit(train, epochs=60, num_rep=cfg.num_rep, lr=cfg.lr,
                  alpha=cfg.alpha, batch_size=cfg.batch_size)
        z = model.transform([data["texts"][n:]], cfg.test_epochs, [0],
                            num_rep=cfg.num_rep, lr=cfg.lr,
                            batch_size=cfg.batch_size)[0]
        enc = model.encoders[1]
        nbrs, weights, init = enc.invert_graph(z, model.embeds[1],
                                               model.data[1], model.a,
                                               model.b)
        task, static = query_task(nbrs, weights, cfg.batch_size,
                                  ref=model.data[1], sigmas=enc.sigmas,
                                  rhos=enc.rhos)
        tasks, statics, inits = [task], [static], [init]

    def run(epochs):
        return train_layout(inits, tasks, statics, mode=args.mode,
                            epochs=epochs, num_rep=cfg.num_rep, lr=cfg.lr,
                            alpha=cfg.alpha, batch_size=cfg.batch_size,
                            a=model.a, b=model.b)

    bounds = (PL._ATTR_SLOT_BYTES, PL._MODALITY_REMAT_ROWS)

    def set_forms(whole):
        PL._ATTR_SLOT_BYTES, PL._MODALITY_REMAT_ROWS = (
            (1 << 62, 1 << 62) if whole else bounds)

    def timed():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(args.epochs)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / args.epochs,
                torch.cuda.max_memory_allocated() / 2**30)

    rows = max(s.num_rows for s in statics)
    engaged = args.mode == "fit" and (
        rows * cfg.k_neighbors * cfg.out_dim * 4 > bounds[0]
        or rows > bounds[1])
    runs = {False: [], True: []}
    for whole in (False, True) if engaged else (False,):
        set_forms(whole)
        run(2)  # warm-up
    for whole in (False, True, True, False) if engaged else (False,):
        set_forms(whole)
        runs[whole].append(timed())
    set_forms(False)
    epoch_ms = sum(ms for ms, _ in runs[False]) / len(runs[False])
    peak_gib = max(gib for _, gib in runs[False])
    ab = {}
    if engaged:
        ab = {"bounded_runs_ms": [ms for ms, _ in runs[False]],
              "whole_forms": {
                  "epoch_ms": sum(ms for ms, _ in runs[True]) / 2,
                  "runs_ms": [ms for ms, _ in runs[True]],
                  "peak_mem_gib": max(gib for _, gib in runs[True])}}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.epochs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel events only: an aten op's self device time repeats the time
    # of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "mode": args.mode, "n_train": n, "epochs": args.epochs,
        "epoch_ms": epoch_ms,
        "peak_mem_gib": peak_gib,
        **ab,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_share": device_us / wall_us,
        "kernel_launches_per_epoch": sum(e.count for e in events) / args.epochs,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms_per_epoch":
                             e.self_device_time_total / 1e3 / args.epochs}
                        for e in top],
    }), flush=True)
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(args.out, f"{args.mode}_layout_trace.json"))


if __name__ == "__main__":
    main()
