"""Profile the PyTorch port's layout epoch on one CUDA GPU: the captured
CUDA-graph epoch that ``train_layout`` runs on the card against the eager
loop, in turns.

    python3 profile_torch.py [--mode fit|invert] [--epochs 20] [--out DIR]
                             [--n_train 31744]

``fit`` builds the fit graphs of the chip-smoke main path (31,744
synthetic pairs at 768 / 4096 dims, k=15, out_dim=64; ``--n_train
131072`` for its CLI path; past 131,072 the scale ladder's data: bf16
tables drawn on the card, 256 clusters) and profiles the fit layout.
``invert`` fits that model (60 epochs: the invert epoch's cost depends on
shapes, not on how well the layout converged), embeds 1,024 held-out
texts and profiles the invert layout that reconstructs them as 4,096-d
images (the ``embed_and_recon`` main path).

Each variant runs ``--epochs`` layout epochs: ``captured`` (one CUDA
graph replay per epoch, what ``train_layout`` runs on CUDA) and
``eager`` (``layout_graph_torch.eager_runner``: the same buffers, draws
and update, one eager step per epoch), timed in turns (captured, eager,
eager, captured) at ms per epoch between chunk ends (the capture's
set-up, printed apart, stays out). Then each variant runs once under
``torch.profiler``
over the epochs after its first chunk. Prints JSON lines: the card, and
per variant the ms per epoch, the device-busy share (summed kernel time
over the profiled wall time), host launches per epoch
(``cudaLaunchKernel`` / ``cuLaunchKernel`` / ``cudaGraphLaunch`` events),
peak device memory, the kernels that take the most device time and the
device time of the fit terms' kernels (``csrc/layout_terms.cu``), by term
and pass and by kernel.
Writes each variant's Chrome trace to ``--out``. Needs a GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import torch

# The fit terms' passes (csrc/layout_terms.cu) by name prefix: a
# backward's prefix covers its edge, gather and finishing kernels.
TERM_KERNELS = ("fit_attr_fwd", "fit_attr_bwd", "fit_rep_fwd", "fit_rep_bwd")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("fit", "invert"), default="fit")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", default="chip_smoke_out/profile")
    ap.add_argument("--n_train", type=int, default=31_744)
    args = ap.parse_args()
    n = args.n_train
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA GPU")
    from multimodal_umap_tpu_torch import Config, MultimodalUMAP
    from multimodal_umap_tpu_torch.data.synthetic import (
        clustered_modalities, clustered_modalities_device)
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

    import chip_smoke as CS
    import layout_graph_torch as LG

    chunk = 5

    def run(epochs, **kw):
        return train_layout(inits, tasks, statics, mode=args.mode,
                            epochs=epochs, num_rep=cfg.num_rep, lr=cfg.lr,
                            alpha=cfg.alpha, batch_size=cfg.batch_size,
                            a=model.a, b=model.b, **kw)

    def variant(name):
        return (LG.eager_runner() if name == "eager"
                else contextlib.nullcontext())

    names = ("captured", "eager")
    for name in names:
        with variant(name):
            run(2)  # warm-up
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        with variant(name):
            runs[name].append(LG.timed_layout(
                lambda **kw: run(args.epochs, **kw), chunk))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        prof = torch.profiler.profile(activities=acts)
        wall = {}

        def window(done, *_):
            torch.cuda.synchronize()
            if done == chunk:
                prof.start()
                wall["t0"] = time.perf_counter()
            elif done == args.epochs:
                wall["us"] = (time.perf_counter() - wall["t0"]) * 1e6
                prof.stop()

        with variant(name):
            run(args.epochs, epoch_chunk=chunk, chunk_callback=window)
        epochs = args.epochs - chunk
        averages = prof.key_averages()
        # Kernel events only: an aten op's self device time repeats the
        # time of the kernels it launched.
        events = [e for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        terms = CS.term_kernel_ms(events, epochs)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        host = {e.key: e.count / epochs for e in averages
                if e.key in LG.LAUNCH_EVENTS + ("cudaMemcpyAsync",)}
        timed = runs[name]
        print(json.dumps({
            "mode": args.mode, "n_train": n, "variant": name,
            "epochs": args.epochs,
            "epoch_ms": sum(r["ms_per_epoch"] for r in timed) / len(timed),
            "runs_ms": [r["ms_per_epoch"] for r in timed],
            "setup_seconds": [r["setup_seconds"] for r in timed],
            "peak_above_live_gib": max(r["peak_above_live_gib"]
                                       for r in timed),
            "profiled_epochs": epochs,
            "profiled_wall_ms": wall["us"] / 1e3,
            "device_busy_share": device_us / wall["us"],
            "device_ms_per_epoch": device_us / 1e3 / epochs,
            "host_launches_per_epoch": sum(
                v for k, v in host.items() if k in LG.LAUNCH_EVENTS),
            "host_events_per_epoch": host,
            "kernels_per_epoch": sum(e.count for e in events) / epochs,
            # the fit terms' kernels (csrc/layout_terms.cu): by term and
            # pass, and by kernel
            "layout_terms_ms_per_epoch": {
                name: sum(v for k, v in terms.items() if k.startswith(name))
                for name in TERM_KERNELS},
            "layout_term_kernels_ms_per_epoch": terms,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms_per_epoch":
                                 e.self_device_time_total / 1e3 / epochs}
                            for e in top],
        }), flush=True)
        prof.export_chrome_trace(
            os.path.join(args.out, f"{args.mode}_{n}_{name}_trace.json"))


if __name__ == "__main__":
    main()
