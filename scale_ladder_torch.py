"""The PyTorch port's scale ladder on one CUDA GPU.

    python3 scale_ladder_torch.py 524288 [--whole]
    python3 scale_ladder_torch.py 1048576

Runs the library flow at one rung of 524,288 or 1,048,576 pairs with
bf16-stored feature tables, the counterpart of the JAX package's
``tools/run_flickr_scale_e2e.py`` driven by ``tools/run_scale_ladder.sh``:
synthetic paired features at the flickr geometry (768-d texts, 4,096-d
images, 256 clusters) drawn on the card, ``MultimodalUMAP(...,
feature_dtype="bfloat16").fit`` with the ``Config`` defaults (k=15,
out_dim=64, 600 epochs), ``similarity_test`` and ``knn_test`` (k=1) on
1,024 held-out pairs at 120 test epochs, and ``embed_and_recon`` of 16
texts to images, its recon MSE beside the train-mean predictor's. Nothing
goes through the host (no table there, no archive written).

Each fit stage runs with the device's peak memory reset at its start and
reports its peak above what was live then: per modality the kNN, the
reverse-edge lookup, the spectral init and each Laplacian apply inside it
(the largest), then the layout. The memory-bounded forms must engage by
size and each gated stage must stay below the gate :func:`reckoned_gates`
derives from the code's own buffers; observed, not assumed: the kNN's
column chunks from the tile kernel's launch signatures, the reverse-lookup
and edge blocks and the recomputed modality losses from counted calls
(the layout's are Python calls: on CUDA the epoch runs them only in its
warm-up and capture, and the graph replays them). The fit attraction's
bound is the plain form's recomputed slot scan on the CPU; on CUDA the
fused attraction kernel, which never makes the gather the scan bounds,
must have launched and the layout stage's peak above live must stay
within the slot scan's 2.750 GiB and below its gate
(:func:`attraction_bound`). Prints the card (``nvidia-smi`` name and power
limit) and one JSON line; exits non-zero on a failed check.

``--whole`` sets the port's bound constants past any size, so that every
bounded form runs whole, for an A/B of time and memory at a rung: its
gates and engagement are reported, not checked. ``chip_smoke.py`` runs the
524,288 rung in process (:func:`run_rung`). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import torch

RUNGS = (524_288, 1_048_576)
N_TEST, N_RECON, DIMS, N_CLUSTERS = 1_024, 16, (768, 4096), 256
ROW_BLOCK = 8192  # knn_tiled's query rows per block
MARGIN = 1.5  # gate = MARGIN x the reckoned bytes
GIB = 2.0**-30


def reckoned_gates(n: int, dims=DIMS, k: int = 15, out_dim: int = 64,
                   num_rep: int = 8) -> dict[str, float]:
    """Bytes each gated fit stage may hold above what was live before it:
    MARGIN x the buffers the bounded code allocates at once (the formulas
    are written out in PERF.md). Keys are the stage names of
    :class:`StageMemory`."""
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops import graph as PG
    from multimodal_umap_tpu_torch.ops import spectral as PS

    tile_k, cand = KT.bf16_tile_k(k, n - 1), max(4 * k, 64)
    # one chunk's (tiles, rows, tile_k) f32 values or int32 ids
    buf = KT._num_col_tiles(min(n, KT.COL_BLOCK)) * ROW_BLOCK * tile_k * 4
    out = 16 * n * k  # (N, k) distances and ids, and their concatenation
    rev_rows = min(n, PG._REV_BLOCK)
    edges, block_b = 2 * n * k, out_dim + 1 + 8  # Chebyshev block width
    edge_rows = min(edges, PS._EDGE_BLOCK)
    gates = {}
    for i, d in enumerate(dims):
        # the kernel's two outputs, their merge copies and the merge's
        # topk workspace (3 more), or a re-score chunk (bf16 gather + f32)
        rescore = KT.rescore_chunk(cand, d) * cand * d * 6
        gates[f"fit/graph_{i}/knn"] = max(7 * buf, rescore) + out
        # (rows, k, k) int64 ids, f32 weights, f32 select, bool match;
        # the (N, k) results and their concatenation, the int64 table
        gates[f"fit/graph_{i}/reverse_lookup"] = (
            17 * rev_rows * k * k + 18 * n * k)
        # one block's (edges, B) f32 gather and int64 rows / cols; the
        # (N, B) output
        gates[f"fit/graph_{i}/laplacian_apply"] = (
            edge_rows * (4 * block_b + 16) + 4 * n * block_b)
    # params, grads, Adam moments and step temporaries (2 modalities x 6
    # x (N, D) f32); InfoNCE's saved wrap copies (2 directions x 4);
    # one modality's recompute: repulsion residuals (num_rep) and slot
    # transients (6) of (N, D), masks / coefficients / transposed ids
    # (24 bytes a slot); draws (16 bytes a slot, 64 a row)
    gates["fit/layout"] = (n * out_dim * 4 * (12 + 8 + num_rep + 6)
                           + 40 * n * k + 64 * n)
    return {name: MARGIN * v for name, v in gates.items()}


class StageMemory:
    """Per-stage wall time and device peak above what was live at the
    stage's start. Stages nest: a stage's reset folds the peak so far
    into every open stage first, so an outer stage's peak spans its inner
    ones. A stage entered several times keeps its largest peak."""

    def __init__(self, log=None) -> None:
        self.log = log  # log(name, seconds, peak bytes) at each stage end
        self.open: list[list] = []  # [base, running peak]
        self.peak: dict[str, int] = {}
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def _fold(self) -> None:
        m = torch.cuda.max_memory_allocated()
        for entry in self.open:
            entry[1] = max(entry[1], m)

    @contextlib.contextmanager
    def stage(self, name: str):
        torch.cuda.synchronize()
        self._fold()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        entry = [base, base]
        self.open.append(entry)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self._fold()
            self.open.pop()
            self.peak[name] = max(self.peak.get(name, 0), entry[1] - base)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            if self.log is not None:
                self.log(name, time.perf_counter() - t0, entry[1] - base)


def _stage_timer(device, mem: StageMemory):
    """A PhaseTimer whose fit phases are also StageMemory stages; its
    ``current`` names the phase that is running."""
    from multimodal_umap_tpu_torch.utils.prof import PhaseTimer

    class StageTimer(PhaseTimer):
        current = ""

        @contextlib.contextmanager
        def phase(self, name):
            self.current = name
            outer = (mem.stage(name) if name.startswith("fit/")
                     else contextlib.nullcontext())
            with outer, super().phase(name):
                yield

    return StageTimer(device)


@contextlib.contextmanager
def patched(patches):
    """Sets (module, name, wrapper_factory) attributes for the block's
    duration: each attribute becomes ``wrapper_factory(original)``."""
    saved = []
    try:
        for m, name, make in patches:  # a later patch wraps an earlier one
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, make(saved[-1][2]))
        yield
    finally:
        for m, name, orig in reversed(saved):
            setattr(m, name, orig)


def whole_forms() -> None:
    """Sets every bound constant of the port past any size: the kNN, the
    reverse lookup, the Laplacian apply and the fit attraction then run
    whole (the A/B of ``--whole``)."""
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops import graph as PG
    from multimodal_umap_tpu_torch.ops import spectral as PS

    KT.COL_BLOCK = 1 << 30  # a multiple of TILE_C
    PG._REV_BLOCK = PS._EDGE_BLOCK = 1 << 62
    PL._ATTR_SLOT_BYTES = PL._MODALITY_REMAT_ROWS = 1 << 62


def _device_mean(table: torch.Tensor, rows: int = 65_536) -> torch.Tensor:
    """Column means of a bf16 table in f32, a row chunk at a time."""
    total = torch.zeros(table.shape[1], device=table.device)
    for s in range(0, table.shape[0], rows):
        total += table[s:s + rows].float().sum(0)
    return total / table.shape[0]


# The layout stage's peak above live at 524,288 pairs with the attraction's
# slot scan (measured on an H100 80GB HBM3, PERF.md §5): the fused
# attraction kernel must not hold more.
LAYOUT_PEAK_SLOT_SCAN_GIB = 2.750


def attraction_bound(dev, calls: dict, kernel_launches: int,
                     layout_peak: int | None, gate: float,
                     csr_bytes: int = 0) -> dict:
    """How the fit attraction's memory was bounded. On the CPU the plain
    form's slot scan past ``layout._ATTR_SLOT_BYTES`` (counted recomputed
    slot calls). On CUDA the fused kernel (``ops/layout_terms.py``) never
    makes the (N, k, D) gather that the scan bounds, so the bound holds
    when the kernel ran (its launches at this rung) and the layout stage's
    peak above live stays within the slot scan's measured peak and below
    the stage's gate. That peak counts the kernel's transposed indices
    (``csr_bytes``, reported beside it): ``train_layout`` builds them
    inside the stage, and they exist only for this kernel."""
    if torch.device(dev).type != "cuda":
        return {"attraction_slot_scan": {
            "slot_calls_traced": calls.get("_attr_slot", 0),
            "engaged": calls.get("_attr_slot", 0) > 0}}
    peak_gib = None if layout_peak is None else layout_peak * GIB
    return {"attraction_kernel": {
        "fit_attr_launches": kernel_launches,
        "layout_peak_gib": peak_gib,
        "slot_scan_peak_gib": LAYOUT_PEAK_SLOT_SCAN_GIB,
        "gate_gib": gate * GIB,
        "reverse_index_gib_in_peak": csr_bytes * GIB,
        "engaged": bool(kernel_launches > 0 and peak_gib is not None
                        and peak_gib <= LAYOUT_PEAK_SLOT_SCAN_GIB
                        and peak_gib < gate * GIB)}}


def run_rung(n: int, device=None) -> tuple[dict, dict]:
    """One rung (see the module docstring). Returns (its JSON line, the
    tile kernel's launch census: per signature (Q, N, D, dtype, tile_k,
    exclude_self, path) the first launch's inputs and the launch
    count)."""
    from multimodal_umap_tpu_torch import Config, MultimodalUMAP
    from multimodal_umap_tpu_torch.data.synthetic import (
        clustered_modalities_device)
    from multimodal_umap_tpu_torch.eval.validation import (
        embed_and_recon, knn_test, similarity_test)
    from multimodal_umap_tpu_torch.models import encoder as PE
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.ops import graph as PG
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops import layout_terms as LT
    from multimodal_umap_tpu_torch.ops import spectral as PS

    dev = torch.device("cuda" if device is None else device)
    cfg = Config()
    k = cfg.k_neighbors
    line = {"phase": "scale_path", "n_train": n, "n_test": N_TEST,
            "dims": list(DIMS), "n_clusters": N_CLUSTERS, "k": k,
            "out_dim": cfg.out_dim, "train_epochs": cfg.train_epochs,
            "test_epochs": cfg.test_epochs, "feature_dtype": "bfloat16",
            "bounds": {"col_block": KT.COL_BLOCK, "rev_block": PG._REV_BLOCK,
                       "edge_block": PS._EDGE_BLOCK,
                       "attr_slot_bytes": PL._ATTR_SLOT_BYTES,
                       "modality_remat_rows": PL._MODALITY_REMAT_ROWS}}
    seconds = {}
    sync = torch.cuda.synchronize

    # The tile kernel's launches by signature and path; the counts stay
    # the wrapper's own.
    census, path = {}, ["fit"]

    def observe(wrapper):
        def observed(q, r, tile_k, *, exclude_self=False, row_offset=0,
                     q_sq=None, r_sq=None):
            key = (q.shape[0], r.shape[0], q.shape[1], str(q.dtype), tile_k,
                   exclude_self, path[0])
            if key not in census:
                census[key] = {"q": q.clone(), "r": r,
                               "row_offset": row_offset, "launches": 0}
            census[key]["launches"] += 1
            return wrapper(q, r, tile_k, exclude_self=exclude_self,
                           row_offset=row_offset, q_sq=q_sq, r_sq=r_sq)
        return observed

    t0 = time.perf_counter()
    train = clustered_modalities_device(
        n, DIMS, n_clusters=N_CLUSTERS, seed=0, centers_seed=0, device=dev,
        dtype=torch.bfloat16)
    test = clustered_modalities_device(
        N_TEST, DIMS, n_clusters=N_CLUSTERS, seed=1, centers_seed=0,
        device=dev)
    sync()
    seconds["data"] = time.perf_counter() - t0

    def log(name, secs, peak):
        if not name.endswith("laplacian_apply"):
            print(f"[scale {n}] {name}: {secs:.2f} s, peak above live "
                  f"{peak * GIB:.3f} GiB", file=sys.stderr, flush=True)

    mem, calls = StageMemory(log), {}
    model = MultimodalUMAP(k, cfg.out_dim, cfg.min_dist, num_encoders=2,
                           seed=cfg.seed, device=dev,
                           feature_dtype="bfloat16")
    model.timer = timer = _stage_timer(dev, mem)

    def staged(label):
        def make(fn):
            def run(*args, **kwargs):
                with mem.stage(f"{timer.current}/{label}"):
                    return fn(*args, **kwargs)
            return run
        return make

    def counted(name):
        def make(fn):
            def run(*args, **kwargs):
                key = (args[0].__name__ if name == "_recompute" else name)
                calls[key] = calls.get(key, 0) + 1
                return fn(*args, **kwargs)
            return run
        return make

    fit_patches = [
        (PE, "knn", staged("knn")),
        (PE, "_reverse_edge_weights", staged("reverse_lookup")),
        (PE, "spectral_embedding", staged("spectral")),
        (PS, "_adjacency_apply", staged("laplacian_apply")),
        (PG, "_reverse_edge_block", counted("_reverse_edge_block")),
        (PS, "_add_edges", counted("_add_edges")),
        (PS, "_adjacency_apply", counted("_adjacency_apply")),
        (PL, "_recompute", counted("_recompute")),
        (LT, "_recompute", counted("_recompute")),
    ]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    def attr_launches():  # the attraction forward kernel, either instance
        return sum(LT.FWD_LAUNCHES["fit_attr"].values())

    attr_before = attr_launches()
    t0 = time.perf_counter()
    with patched([(KT, "knn_tile", observe)]):
        with patched(fit_patches):
            model.fit([train.pop(name) for name in list(train)],
                      epochs=cfg.train_epochs, num_rep=cfg.num_rep,
                      lr=cfg.lr, alpha=cfg.alpha, batch_size=cfg.batch_size)
        sync()
        seconds["fit"] = time.perf_counter() - t0
        fit_peak = torch.cuda.max_memory_allocated() - base
        fit_attr_launches = attr_launches() - attr_before
        path[0] = "eval"
        t0 = time.perf_counter()
        cosine = similarity_test(test, cfg, model, return_values=True,
                                 quiet=True)
        seconds["similarity_test"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        knn1 = knn_test(test, cfg, k=1, model=model, return_values=True,
                        quiet=True)
        seconds["knn_test"] = time.perf_counter() - t0
        path[0] = "recon"
        t0 = time.perf_counter()
        recon = embed_and_recon(model, [test["texts"][:N_RECON]], [0], [1],
                                cfg)[0]
        sync()
        seconds["embed_and_recon"] = time.perf_counter() - t0
    images = test["images"][:N_RECON]
    recon_mse = float(((recon - images) ** 2).mean())
    mean_mse = float(((_device_mean(model.data[1])[None] - images) ** 2)
                     .mean())
    fit_loss = model.loss_history["fit"]
    edges = 2 * n * k
    applies = calls.get("_adjacency_apply", 0)
    fit_sigs = [key for key in census if key[-1] == "fit"]
    gates = reckoned_gates(n, DIMS, k, cfg.out_dim, cfg.num_rep)
    line.update({
        "seconds": seconds,
        "model_phase_seconds": model.timer.report(),
        "stage_seconds": mem.seconds,
        "stage_peak_gib": {name: v * GIB for name, v in mem.peak.items()},
        "gates_gib": {name: v * GIB for name, v in gates.items()},
        "fit_peak_gib": fit_peak * GIB,
        "tables_gib": sum(d.numel() * d.element_size()
                          for d in model.data) * GIB,
        "peak_gib_whole_run": torch.cuda.max_memory_allocated() * GIB,
        "engaged": {
            "knn_column_streaming": {
                "fit_launch_N": sorted({key[1] for key in fit_sigs}),
                "engaged": bool(fit_sigs) and all(key[1] < n
                                                  for key in fit_sigs)},
            "reverse_lookup_blocks": {
                "blocks": calls.get("_reverse_edge_block", 0),
                "engaged": calls.get("_reverse_edge_block", 0)
                >= 2 * -(-n // PG._REV_BLOCK) > 2},
            "edge_blocks": {
                "blocks_per_apply": (calls.get("_add_edges", 0)
                                     / max(applies, 1)),
                "applies": applies,
                "engaged": applies > 0 and calls.get("_add_edges", 0)
                == applies * -(-edges // PS._EDGE_BLOCK) > applies},
            **attraction_bound(dev, calls, fit_attr_launches,
                               mem.peak.get("fit/layout"),
                               gates["fit/layout"],
                               len(DIMS) * 4 * (n * k + n + 1)),
            "modality_recompute": {
                "calls_traced": calls.get("_fit_modality_loss", 0),
                "engaged": calls.get("_fit_modality_loss", 0) > 0},
        },
        "tile_launches_by_signature": [
            {"Q": q, "N": nr, "D": d, "dtype": dt, "tile_k": tk,
             "exclude_self": ex, "path": p, "launches": v["launches"]}
            for (q, nr, d, dt, tk, ex, p), v in census.items()],
        "fit_loss_first_last": [float(fit_loss[0]), float(fit_loss[-1])],
        "fit_loss_finite": bool(torch.isfinite(torch.as_tensor(fit_loss))
                                .all()),
        "cosine": cosine, "knn1": knn1, "recon_mse": recon_mse,
        "train_mean_mse": mean_mse,
        "recon_finite": bool(torch.isfinite(recon).all()),
    })
    return line, census


def failures(line: dict) -> list[str]:
    """The checks a bounded rung must pass (quality, engagement, gates)."""
    out = []
    metrics = [line["cosine"], line["knn1"], line["recon_mse"]]
    if not (all(math.isfinite(v) for v in metrics)
            and line["fit_loss_finite"] and line["recon_finite"]):
        out.append("non-finite metric, fit loss or recon")
    if not line["cosine"] >= 0.9:
        out.append(f"cosine {line['cosine']} < 0.9")
    if not line["recon_mse"] < line["train_mean_mse"]:
        out.append("recon MSE not below the train-mean predictor's")
    for form, v in line["engaged"].items():
        if not v["engaged"]:
            out.append(f"bounded form {form} did not engage: {v}")
    for stage, gate in line["gates_gib"].items():
        peak = line["stage_peak_gib"].get(stage)
        if peak is None or peak >= gate:
            out.append(f"stage {stage}: peak {peak} GiB, gate {gate} GiB")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, choices=RUNGS)
    ap.add_argument("--whole", action="store_true",
                    help="run every bounded form whole (an A/B)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scale_ladder_torch: torch.cuda.is_available() is False -- "
              "needs a CUDA GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.whole:
        whole_forms()
    line, _ = run_rung(args.n)
    line.update(forms="whole" if args.whole else "bounded", device=smi)
    fails = [] if args.whole else failures(line)
    line["failures"] = fails
    print(json.dumps(line), flush=True)
    if fails:
        raise SystemExit("scale_ladder_torch FAILED: " + "; ".join(fails))


if __name__ == "__main__":
    main()
