"""Closed-loop fits, back to back, from one client.

Set-up draws the configuration's tables on the device from the run's seed,
builds the program's kernels (``build/`` in the checkout) and runs one warm
fit of a few epochs at the cell's own shapes (the graph stage and the layout
epoch's capture included). The window then starts a fresh
``MultimodalUMAP`` fit (its own seed, derived from the run's) while it is
open; a fit that starts inside the window runs to its end and only whole fits
count. ``fit_s`` is (end of the last fit - start of the first) / fits;
``fit_peak_gib`` the highest ``torch.cuda.max_memory_allocated`` over the
fits, reset before each, the tables included.

Each fit's outputs (the symmetric graph, bandwidths, spectral
initialisation, embeddings) are copied to the host when it ends, so no fit
holds device memory during the next; the reference judges them all once the
window has closed. The spectral initialisation is read by a pass-through
wrapper around the encoder's ``spectral_embedding`` (it keeps a reference to
what the call returns and copies nothing on the device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from .. import data as D
from .. import trace as T
from ..judge import ModalityOutputs, judge, reference_modality

GIB = float(1 << 30)


@dataclasses.dataclass
class FitRecord:
    start: float
    end: float
    peak_bytes: int
    phases: dict
    traced: bool
    outputs: list  # per modality: dict of host tensors

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _InitObserver:
    """Keeps what ``encoder.spectral_embedding`` returns, call by call."""

    def __init__(self, encoder_module):
        self.module = encoder_module
        self.original = encoder_module.spectral_embedding
        self.seen: list[torch.Tensor] = []

        def observed(*args, **kwargs):
            out = self.original(*args, **kwargs)
            self.seen.append(out)
            return out

        encoder_module.spectral_embedding = observed

    def close(self) -> None:
        self.module.spectral_embedding = self.original


@dataclasses.dataclass
class State:
    tables: list
    observer: _InitObserver
    setup_peak: int
    build_s: float | None
    setup_parts: dict


def fit_seed(seed: int, i: int) -> int:
    """The model seed of the run's i-th fit (i = -1: the warm fit)."""
    return (int(seed) * 1_000_003 + 7_919 * (i + 2)) % (1 << 62)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model(cfg: dict, seed: int, dev: torch.device):
    from multimodal_umap_tpu_torch import MultimodalUMAP

    p = cfg["program"]
    return MultimodalUMAP(p["k_neighbors"], p["out_dim"], p["min_dist"],
                          len(cfg["dims"]), seed=seed,
                          spectral_method=p["spectral_method"],
                          knn_engine=p["knn_engine"], device=dev,
                          feature_dtype=cfg["feature_dtype"])


def _fit(model, tables, cfg: dict, epochs: int) -> None:
    p = cfg["program"]
    model.fit(tables, epochs=epochs, num_rep=p["num_rep"], lr=p["lr"],
              alpha=p["alpha"], batch_size=p["batch_size"])


def setup(cell) -> State:
    cfg, dev = cell.config, cell.device
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    parts = {"device_init_s": time.perf_counter() - t0}
    build_s = None
    if dev.type == "cuda":
        from multimodal_umap_tpu_torch.ops import knn_tile

        t0 = time.perf_counter()
        knn_tile.build()
        build_s = (time.perf_counter() - t0 if knn_tile.BUILD_SECONDS
                   is not None else None)
    t0 = time.perf_counter()
    tables, _ = D.clustered_tables(
        cfg["n_pairs"], cfg["dims"], cfg["n_clusters"], cfg["cluster_scale"],
        cfg["noise_scale"], cell.seed, dev,
        D.storage_dtype(cfg["feature_dtype"]))
    from multimodal_umap_tpu_torch.models import encoder

    _sync(dev)
    parts["tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    observer = _InitObserver(encoder)
    model = _model(cfg, fit_seed(cell.seed, -1), dev)
    _fit(model, tables, cfg, cell.traffic["warm_epochs"])
    del model
    _sync(dev)
    observer.seen.clear()
    parts["warm_fit_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return State(tables, observer, peak, build_s, parts)


def _host_outputs(model, inits: list) -> list:
    out = []
    for m, (g, enc, e) in enumerate(zip(model.graphs, model.encoders,
                                        model.embeds)):
        out.append({
            "num_rows": g.num_rows, "rows": g.rows.cpu(), "cols": g.cols.cpu(),
            "weights": g.weights.cpu(), "valid": g.valid.cpu(),
            "rho": enc.rhos.cpu(), "sigma": enc.sigmas.cpu(), "embed": e.cpu(),
            "init": inits[m].cpu() if len(inits) == len(model.graphs)
            else None})
    return out


def window(cell, state: State, seconds: float, trace_first: bool) -> dict:
    """Fits back to back while the window is open. Returns the fit records,
    the end-to-end metrics and, with ``trace_first``, the first fit's
    profile."""
    cfg, dev = cell.config, cell.device
    epochs = cfg["program"]["train_epochs"]
    fits: list[FitRecord] = []
    prof = None
    t_open = time.perf_counter()
    while not fits or time.perf_counter() - t_open < seconds:
        i = len(fits)
        model = _model(cfg, fit_seed(cell.seed, i), dev)
        state.observer.seen.clear()
        traced = trace_first and i == 0
        ctx = T.traced_fit() if traced else contextlib.nullcontext()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with ctx as holder:
            _fit(model, state.tables, cfg, epochs)
            _sync(dev)
            t1 = time.perf_counter()
        if traced:
            prof = holder
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        fits.append(FitRecord(t0, t1, peak, dict(model.timer.phases), traced,
                              _host_outputs(model, state.observer.seen)))
        state.observer.seen.clear()
        del model
    state.observer.close()
    span = fits[-1].end - fits[0].start
    metrics = {
        "fit_s": (span / len(fits), "s"),
        "fit_peak_gib": (max(f.peak_bytes for f in fits) / GIB, "GiB"),
    }
    return {"fits": fits, "metrics": metrics, "profile": prof,
            "memory_peak_bytes": max([state.setup_peak]
                                     + [f.peak_bytes for f in fits]),
            "attempted": len(fits), "failed": 0}


def _outputs(raw: dict, k: int) -> ModalityOutputs:
    n = raw["num_rows"]
    nk = n * k
    rows, cols = raw["rows"].long(), raw["cols"].long()
    w, valid = raw["weights"], raw["valid"]
    ok = (rows.numel() == 2 * nk and cols.numel() == 2 * nk
          and w.numel() == 2 * nk and valid.numel() == 2 * nk)
    if not ok:
        z = torch.zeros(n, k)
        return ModalityOutputs(torch.zeros(n, k, dtype=torch.long), z[:, 0],
                               z[:, 0], z, z, z.bool(), False)
    own = torch.arange(n).repeat_interleave(k)
    ok = (torch.equal(rows[:nk], own) and torch.equal(rows[nk:], cols[:nk])
          and torch.equal(cols[nk:], own) and bool(valid[:nk].all()))
    return ModalityOutputs(
        ids=cols[:nk].view(n, k), rho=raw["rho"], sigma=raw["sigma"],
        sym=w[:nk].view(n, k), sym_t=w[nk:].view(n, k),
        back=~valid[nk:].view(n, k), layout_ok=ok, init=raw["init"],
        embed=raw["embed"])


def check(cell, state: State, result: dict) -> tuple[dict, dict]:
    """The reference's numbers over every fit of the window, once the
    program's state is freed; only the input tables stay."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    k = cell.config["program"]["k_neighbors"]
    fits = [[_outputs(raw, k) for raw in f.outputs] for f in result["fits"]]
    refs = [reference_modality(t, k) for t in state.tables]
    return judge(fits, refs, cell.config["program"] | {
        "infonce": cell.config["infonce"]}, cell.seed)
