"""The PyTorch port's captured layout epoch against its eager loop, on one
CUDA GPU.

    python3 layout_graph_torch.py

``chip_smoke.py``'s ``layout_graph`` phase, on the main path's data
(31,744 training + 1,024 test pairs, D = 768 / 4,096, the ``Config``
defaults). ``train_layout`` on CUDA replays one captured CUDA graph per
epoch (``models/layout.py::_graph_chunk_runner``); :func:`eager_runner`
swaps in the eager loop the CPU runs (``_eager_chunk_runner``, the same
buffers, draws and capturable Adam), so each comparison isolates the
capture:

(a) fit, 100 epochs from the same inits and (seed, epoch) draws: losses
    within rtol 1e-5 over the first 20 epochs and rtol 1e-4 at every
    epoch, embeddings within rtol 2e-3 / atol 2e-4 (``index_add_``
    atomics may reorder sums, and Adam, whose steps are about lr, the
    rows' own size, grows the difference from epoch to epoch: the JAX
    package's sharded-vs-single tolerance); and the captured
    device draws bit-equal to ``draw_epoch(epoch_rng(seed, e))`` at
    three epochs (the graph draws from a registered generator re-seeded
    per epoch);
(b) transform and invert, 20 epochs each at the 1,024 test queries
    (transform of the test texts against the fitted text embeddings;
    invert of those embeddings to 4,096-d images), the same tolerances;
(c) resume: a captured 100-epoch fit cut at epoch 50 and resumed through
    ``start_epoch`` / ``init_opt_state`` against the uninterrupted
    captured run, the same tolerances;
(d) timing: ms per epoch of both runners at fit (steady state, between
    chunk ends, after the capture), transform and invert, the set-up of
    the captured runner (warm-up and capture), peak device memory of
    each fit run, and the host-side launches per captured epoch
    (``cudaLaunchKernel`` / ``cuLaunchKernel`` / ``cudaGraphLaunch``
    events of ``torch.profiler``, the difference between a 40- and a
    20-epoch run over 20); fails above 40 at fit.

Returns one JSON-able dict and its failures; ``chip_smoke.py`` prints the
line and fails on any. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

N_TRAIN, N_TEST, DIMS = 31_744, 1_024, (768, 4096)
FIT_EPOCHS, QUERY_EPOCHS, CUT = 100, 20, 50
LAUNCH_EPOCHS = 20
MAX_LAUNCHES_PER_EPOCH = 40
TIMING_CHUNK = 10  # chunk ends timestamp the steady state
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


@contextlib.contextmanager
def eager_runner():
    """``train_layout`` runs its eager loop on CUDA for the block."""
    from multimodal_umap_tpu_torch.models import layout as PL

    graph = PL._graph_chunk_runner
    PL._graph_chunk_runner = PL._eager_chunk_runner
    try:
        yield
    finally:
        PL._graph_chunk_runner = graph


def _sync():
    torch.cuda.synchronize()


def timed_layout(run, chunk: int = TIMING_CHUNK) -> dict:
    """``run(epoch_chunk=, chunk_callback=)`` timed: total seconds, and ms
    per epoch between the first and the last chunk end (each chunk end
    synchronizes), so set-up (warm-up, capture) stays out of it."""
    marks = []

    def mark(done, *_):
        _sync()
        marks.append((done, time.perf_counter()))

    _sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    embeds, hist = run(epoch_chunk=chunk, chunk_callback=mark)
    _sync()
    total = time.perf_counter() - t0
    (d0, t_first), (d1, t_last) = marks[0], marks[-1]
    ms = (t_last - t_first) * 1e3 / (d1 - d0)
    return {"embeds": embeds, "hist": hist, "seconds": total,
            "ms_per_epoch": ms,
            "setup_seconds": (t_first - t0) - d0 * ms / 1e3,
            "peak_above_live_gib": (torch.cuda.max_memory_allocated()
                                    - base) / 2**30}


def launches(run) -> dict:
    """Host-side launch events of ``run(epochs)`` per epoch: the
    difference between 2E and E epochs over E (set-up cancels)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = {}
    for e in (LAUNCH_EPOCHS, 2 * LAUNCH_EPOCHS):
        _sync()
        with torch.profiler.profile(activities=acts) as prof:
            run(e)
            _sync()
        counts[e] = {k.key: k.count for k in prof.key_averages()
                     if k.key in LAUNCH_EVENTS + ("cudaMemcpyAsync",)}
    keys = set(counts[LAUNCH_EPOCHS]) | set(counts[2 * LAUNCH_EPOCHS])
    per = {k: (counts[2 * LAUNCH_EPOCHS].get(k, 0)
               - counts[LAUNCH_EPOCHS].get(k, 0)) / LAUNCH_EPOCHS
           for k in sorted(keys)}
    return {"by_event": per,
            "launches_per_epoch": sum(v for k, v in per.items()
                                      if k in LAUNCH_EVENTS)}


def compare(graph: dict, eager: dict, n_first: int = 20) -> dict:
    """Captured against eager: losses (rtol 1e-5 over the first
    ``n_first`` epochs, 1e-4 at each) and embeddings (rtol 2e-3 / atol
    2e-4), with the max abs differences and bit-equality."""
    hg, he = graph["hist"].double(), eager["hist"].double()
    rel = ((hg - he).abs() / he.abs().clamp_min(1e-30))
    emb_excess = max(float(((g - e).abs() - 2e-3 * e.abs() - 2e-4).max())
                     for g, e in zip(graph["embeds"], eager["embeds"]))
    return {
        "loss_max_abs_diff": float((hg - he).abs().max()),
        "loss_rel_first": float(rel[:n_first].max()),
        "loss_rel_all": float(rel.max()),
        "embeds_max_abs_diff": max(float((g - e).abs().max())
                                   for g, e in zip(graph["embeds"],
                                                   eager["embeds"])),
        "bit_equal": bool(torch.equal(graph["hist"], eager["hist"])
                          and all(torch.equal(g, e) for g, e in
                                  zip(graph["embeds"], eager["embeds"]))),
        "ok": bool(rel[:n_first].max() <= 1e-5 and rel.max() <= 1e-4
                   and emb_excess <= 0)}


def captured_draws_equal(tasks, statics, seed: int, epochs, **kw) -> bool:
    """The device draws of a captured ``_EpochInputs.draw_device`` (a
    registered generator re-seeded per epoch) bit-equal to
    ``draw_epoch(epoch_rng(seed, e))`` at each of ``epochs``."""
    from multimodal_umap_tpu_torch.models import layout as PL

    dev = tasks[0].nbrs.device
    inputs = PL._EpochInputs(tasks, statics, seed=seed, device=dev, **kw)
    inputs.set_epoch(epochs[0])
    inputs.draw_device()  # warm-up, outside the capture
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(inputs.gen)
    with torch.cuda.graph(graph):
        inputs.draw_device()
    ok = True
    for e in epochs:
        inputs.set_epoch(e)
        graph.replay()
        want = PL.draw_epoch(PL.epoch_rng(seed, e, dev), tasks, statics, **kw)
        got = inputs.draws
        for g, w in zip(got.modality + [d for p in got.infonce for d in p],
                        want.modality + [d for p in want.infonce for d in p]):
            for name, v in vars(w).items():
                if isinstance(v, torch.Tensor):
                    ok &= torch.equal(getattr(g, name), v)
        ok &= PL.pack_rolls(got, statics, kw["num_rep"]) == PL.pack_rolls(
            want, statics, kw["num_rep"])
    graph.reset()
    return bool(ok)


def run(train_np, test_np, dev) -> tuple[dict, list]:
    """The phase (see the module docstring): (its JSON line, failures)."""
    from multimodal_umap_tpu_torch import Config, MultimodalUMAP
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.models.layout import (
        adam_state, fit_task, query_task, train_layout)

    cfg = Config()
    fails = []
    texts, images = (torch.from_numpy(train_np[k]).to(dev)
                     for k in ("texts", "images"))
    test_texts = torch.from_numpy(test_np["texts"]).to(dev)
    model = MultimodalUMAP(cfg.k_neighbors, cfg.out_dim, cfg.min_dist, 2,
                           device=dev)
    t0 = time.perf_counter()
    graphs = [enc.fit_graph(x) for enc, x in zip(model.encoders,
                                                 (texts, images))]
    _sync()
    graph_seconds = time.perf_counter() - t0
    tasks, statics = zip(*(fit_task(d, cfg.batch_size) for _, d, _ in graphs))
    inits = [init for _, _, init in graphs]
    kw = dict(num_rep=cfg.num_rep, alpha=cfg.alpha, batch_size=cfg.batch_size,
              lr=cfg.lr, a=model.a, b=model.b, seed=cfg.seed)

    def fit(epochs=FIT_EPOCHS, **more):
        return train_layout(inits, tasks, statics, mode="fit", epochs=epochs,
                            **kw, **more)

    # (a) fit, after one short run of each runner: the first layout call
    # of a process loads kernels and starts autograd's device threads
    fit(epochs=TIMING_CHUNK)
    with eager_runner():
        fit(epochs=TIMING_CHUNK)
    line = {"phase": "layout_graph", "n_train": N_TRAIN, "n_test": N_TEST,
            "fit_graph_seconds": graph_seconds, "epochs": FIT_EPOCHS}
    g_fit = timed_layout(fit)
    with eager_runner():
        e_fit = timed_layout(fit)
    line["fit"] = compare(g_fit, e_fit)
    line["captured_draws_bit_equal"] = captured_draws_equal(
        tasks, statics, cfg.seed, (0, 1, FIT_EPOCHS - 1), mode="fit",
        num_rep=cfg.num_rep, alpha=cfg.alpha)
    if not line["fit"]["ok"]:
        fails.append(f"captured fit disagrees with eager: {line['fit']}")
    if not line["captured_draws_bit_equal"]:
        fails.append("captured draws differ from draw_epoch's")

    # (b) transform, then invert of its result, at the test queries
    fit_embeds = g_fit["embeds"]
    enc_t, enc_i = model.encoders
    nbrs, weights, q_init = enc_t.transform_graph(test_texts, texts,
                                                  fit_embeds[0])
    t_task, t_static = query_task(nbrs, weights, cfg.batch_size,
                                  ref=fit_embeds[0])
    qkw = dict(kw, alpha=0.0, seed=cfg.seed + 1)

    def transform(**more):
        return train_layout([q_init], [t_task], [t_static], mode="transform",
                            epochs=QUERY_EPOCHS, **qkw, **more)

    g_tr = timed_layout(transform)
    with eager_runner():
        e_tr = timed_layout(transform)
    nbrs, weights, x_init = enc_i.invert_graph(g_tr["embeds"][0],
                                               fit_embeds[1], images,
                                               model.a, model.b)
    i_task, i_static = query_task(nbrs, weights, cfg.batch_size, ref=images,
                                  sigmas=enc_i.sigmas, rhos=enc_i.rhos)

    def invert(**more):
        return train_layout([x_init], [i_task], [i_static], mode="invert",
                            epochs=QUERY_EPOCHS, **qkw, **more)

    g_inv = timed_layout(invert)
    with eager_runner():
        e_inv = timed_layout(invert)
    line["transform"] = compare(g_tr, e_tr)
    line["invert"] = compare(g_inv, e_inv)
    for mode in ("transform", "invert"):
        if not line[mode]["ok"]:
            fails.append(f"captured {mode} disagrees with eager: "
                         f"{line[mode]}")

    # (c) resume at epoch CUT under capture
    snap = {}

    def keep(done, params, optimizer, hist):
        if done == CUT:
            st = adam_state(optimizer, params)
            snap.update(embeds=[p.detach().clone() for p in params],
                        state=PL.AdamState(st.count,
                                           [m.clone() for m in st.mu],
                                           [v.clone() for v in st.nu]))

    _, head = fit(epochs=CUT, epoch_chunk=CUT, chunk_callback=keep)
    tail_embeds, tail = train_layout(
        snap["embeds"], tasks, statics, mode="fit", epochs=FIT_EPOCHS,
        start_epoch=CUT, init_opt_state=snap["state"], **kw)
    resumed = {"embeds": tail_embeds, "hist": torch.cat([head, tail])}
    line["resume"] = {"cut": CUT, "adam_count_at_cut": snap["state"].count,
                      **compare(resumed, g_fit)}
    if not line["resume"]["ok"] or snap["state"].count != CUT:
        fails.append(f"resumed captured fit disagrees: {line['resume']}")

    # (d) timing and launches
    line["timing"] = {
        name: {"captured_ms_per_epoch": g["ms_per_epoch"],
               "eager_ms_per_epoch": e["ms_per_epoch"],
               "captured_setup_seconds": g["setup_seconds"],
               "captured_seconds": g["seconds"], "eager_seconds": e["seconds"],
               "captured_peak_above_live_gib": g["peak_above_live_gib"],
               "eager_peak_above_live_gib": e["peak_above_live_gib"]}
        for name, g, e in (("fit", g_fit, e_fit), ("transform", g_tr, e_tr),
                           ("invert", g_inv, e_inv))}
    captured = launches(lambda e: fit(epochs=e))
    with eager_runner():
        eager = launches(lambda e: fit(epochs=e))
    line["launches"] = {"fit_captured": captured, "fit_eager": eager,
                        "limit_per_epoch": MAX_LAUNCHES_PER_EPOCH}
    if captured["launches_per_epoch"] > MAX_LAUNCHES_PER_EPOCH:
        fails.append(f"{captured['launches_per_epoch']} host launches per "
                     f"captured fit epoch > {MAX_LAUNCHES_PER_EPOCH}")
    for name, g in (("fit", g_fit), ("transform", g_tr), ("invert", g_inv)):
        if not all(bool(torch.isfinite(e).all()) for e in g["embeds"]):
            fails.append(f"captured {name} embeddings not finite")
    return line, fails


def main() -> None:
    if not torch.cuda.is_available():
        print("layout_graph_torch: needs a CUDA GPU", file=sys.stderr)
        raise SystemExit(2)
    from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities

    data = clustered_modalities(N_TRAIN + N_TEST, dims=DIMS, seed=0,
                                centers_seed=1)
    train_np = {k: v[:N_TRAIN] for k, v in data.items()}
    test_np = {k: v[N_TRAIN:] for k, v in data.items()}
    line, fails = run(train_np, test_np, torch.device("cuda"))
    print(json.dumps(line), flush=True)
    if fails:
        raise SystemExit("layout_graph FAILED: " + "; ".join(fails))


if __name__ == "__main__":
    main()
