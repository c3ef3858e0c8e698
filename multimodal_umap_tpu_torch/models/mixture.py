"""Multimodal UMAP mixture model: the public model API.

Counterpart of ``multimodal_umap_tpu/models/mixture.py`` with its
lifecycle surface: ``fit`` / ``fit_transform`` / ``transform`` /
``inverse_transform`` / ``save_state_dict`` / ``load_state_dict`` /
``get_ab_coeffs``, the progress snapshots and resume of fit, transform
and invert, and fit's graph cache; plus
:meth:`MultimodalUMAP.from_numpy_state`, which builds a fitted model from
numpy arrays named as the checkpoint names them. Method defaults mirror
the reference's signatures (lr=0.2, alpha=0.5, batch_size=512); the
experiment values come from ``Config``.

Every tensor lives on ``device`` (default CUDA; without a GPU that
raises unless the caller passes ``device="cpu"``). The training feature
tables are stored in ``feature_dtype`` (float32 or bfloat16); graph,
sigma, spectral and layout math stays float32.

``mesh=`` (``parallel.create_mesh``; one process per rank, every rank
making the same calls with the same host arrays) shards the model over
the ranks when every fit table's rows divide the mesh size: ``data`` and
``embeds`` then hold this rank's rows, the graphs and bandwidths are
whole on every rank, the kNN rides the ring and the layout runs the
sharded engine. Queries are padded to a mesh multiple (padded rows'
weights zeroed) and ``transform`` / ``inverse_transform`` return the
whole result on every rank. A table whose rows do not divide keeps the
whole model on every rank (the JAX plan's replication fallback), each
rank running the single-device path. Only rank 0 writes files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.graph import EdgeGraph
from ..ops.knn_stream import pad_rows_to_multiple
from ..parallel.collectives import (
    all_gather_tensor,
    barrier,
    gather_rows,
    psum,
)
from ..parallel.mesh import ShardingPlan, shard_task
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.prof import PhaseTimer
from .curve import get_ab_coeffs as _get_ab_coeffs
from .encoder import ModalityEncoder, _ring_ok
from .layout import AdamState, adam_state, fit_task, query_task, train_layout

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Rows per host-to-device chunk of a bf16 table (a 128 MB f32 transient
# at D=4096).
_UPLOAD_ROWS = 8192


def _npz_path(path: str | None) -> str | None:
    """``np.savez`` appends '.npz' to a path without it; normalizing once
    keeps the resume existence check and the save on one path."""
    if path is None or path.endswith(".npz"):
        return path
    return path + ".npz"


def _progress_callback(label: str, epochs: int, progress_path: str | None,
                       verbose: bool, mesh=None, sharded: bool = False):
    """Chunk-boundary callback: loss readout and a snapshot of the
    optimizer state (parameters, Adam moments, epoch), so a preempted
    run loses at most one snapshot interval. Shared by fit, transform
    and inverse_transform.

    Snapshots are throttled to one per ``MMUMAP_SNAPSHOT_INTERVAL_S``
    (default 120 s); the final chunk always saves. Each snapshot is
    written synchronously and moved into place atomically, so the final
    one is durable before the call returns. Keys are the JAX package's:
    ``epoch``, ``embeds_{m}`` and ``opt_{i}`` in optax's leaf order
    (count, then mu and nu per modality).

    Under a mesh only rank 0 prints and writes; ``sharded`` parameters
    are gathered to it first, after the ranks agree (one all-reduce) on
    whether this chunk saves.
    """
    if progress_path is None and not verbose:
        return None
    interval = float(os.environ.get("MMUMAP_SNAPSHOT_INTERVAL_S", 120.0))
    last_save = [float("-inf")]
    writer = mesh is None or mesh.rank == 0

    def callback(done, params, optimizer, hist):
        if verbose and writer:
            print(f"{label} {done}/{epochs}  loss {float(hist[-1]):.4f}",
                  flush=True)
        if progress_path is None:
            return
        now = time.monotonic()
        save = done >= epochs or now - last_save[0] >= interval
        if sharded:
            flag = torch.tensor([float(save)], device=mesh.device)
            save = bool(psum(flag, mesh, op=torch.distributed.ReduceOp.MAX))
        if not save:
            return
        last_save[0] = now
        state = adam_state(optimizer, params)
        if sharded:
            params = [gather_rows(p, mesh) for p in params]
            state = AdamState(state.count,
                              [gather_rows(v, mesh) for v in state.mu],
                              [gather_rows(v, mesh) for v in state.nu])
        if not writer:
            return
        leaves = [np.int32(state.count), *state.mu, *state.nu]
        arrays = {"epoch": np.int64(done)}
        arrays.update({f"embeds_{m}": p for m, p in enumerate(params)})
        arrays.update({f"opt_{i}": v for i, v in enumerate(leaves)})
        ckpt.write_npz(progress_path, arrays)

    return callback


def _load_progress(progress_path: str | None, resume: bool, num_modes: int,
                   device: torch.device, plan: ShardingPlan | None = None):
    """Restores a :func:`_progress_callback` snapshot: ``(start_epoch,
    params or None, AdamState or None)``. No snapshot: a fresh start.
    With a ``plan`` (a sharded model) parameters and moments are cut to
    this rank's rows."""
    if not resume:
        return 0, None, None
    if progress_path is None:
        raise ValueError("resume=True requires progress_path")
    if not os.path.exists(progress_path):
        return 0, None, None
    with np.load(progress_path, allow_pickle=False) as snap:
        def t(key):
            if plan is not None:
                return plan.shard(snap[key]).float()
            return torch.as_tensor(snap[key], dtype=torch.float32,
                                   device=device)

        inits = [t(f"embeds_{m}") for m in range(num_modes)]
        state = AdamState(
            count=int(snap["opt_0"]),
            mu=[t(f"opt_{1 + m}") for m in range(num_modes)],
            nu=[t(f"opt_{1 + num_modes + m}") for m in range(num_modes)])
        return int(snap["epoch"]), inits, state


class MultimodalUMAP:
    """Shared-latent multimodal UMAP with InfoNCE alignment.

    Attributes:
        k_neighbors, out_dim, min_dist, num_encoders: hyperparameters.
        a, b: fitted UMAP curve coefficients.
        encoders: per-modality :class:`ModalityEncoder` graph state.
        data: training features per modality (transform and invert
            query them, so checkpoints store them).
        graphs: symmetric fuzzy EdgeGraphs per modality.
        embeds: trained latent embeddings per modality.
    """

    def __init__(
        self,
        k_neighbors: int,
        out_dim: int,
        min_dist: float,
        num_encoders: int,
        seed: int = 0,
        spectral_method: str = "auto",
        knn_engine: str | None = None,
        device: torch.device | str | None = None,
        feature_dtype: str = "float32",
        mesh=None,
    ):
        if num_encoders < 1:
            raise ValueError(f"num_encoders must be >= 1, got {num_encoders}")
        # "bfloat16" halves the largest tensors on the card; the kNN then
        # ranks them in the kernel's bf16 mode as they are and re-scores
        # exactly w.r.t. the stored values.
        if feature_dtype not in _STORAGE:
            raise ValueError(f"feature_dtype must be float32 or bfloat16, "
                             f"got {feature_dtype!r}")
        self.feature_dtype = feature_dtype
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh rank's "
                             f"{mesh.device}")
        # Optional parallel.Mesh; fit decides whether the model shards.
        self.mesh = mesh
        self.sharded = False
        self.k_neighbors = k_neighbors
        self.out_dim = out_dim
        self.min_dist = min_dist
        self.num_encoders = num_encoders
        self.seed = seed
        self.spectral_method = spectral_method
        self.knn_engine = knn_engine
        self.a, self.b = self.get_ab_coeffs(min_dist)
        self.encoders = [
            ModalityEncoder(k_neighbors, out_dim, id=i,
                            spectral_method=spectral_method,
                            knn_engine=knn_engine)
            for i in range(num_encoders)
        ]
        self.data: list[torch.Tensor] | None = None
        self.graphs: list[EdgeGraph] = []
        self.embeds: list[torch.Tensor] = []
        self.loss_history: dict[str, np.ndarray] = {}
        self.timer = PhaseTimer(self.device)

    def _as_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _as_table(self, x) -> torch.Tensor:
        """A training feature table on the model's device, cast straight
        to ``feature_dtype``. A bf16 table coming from another device is
        filled in row chunks, so the model's device never holds it in
        f32 (a cross-device ``.to(device, dtype)`` would copy it whole
        first and then cast)."""
        dtype = _STORAGE[self.feature_dtype]
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if dtype == torch.float32 or x.device == self.device:
            return x.to(device=self.device, dtype=dtype)
        out = torch.empty(x.shape, dtype=dtype, device=self.device)
        for s in range(0, x.shape[0], _UPLOAD_ROWS):
            out[s:s + _UPLOAD_ROWS] = x[s:s + _UPLOAD_ROWS].to(self.device)
        return out

    def fit(self, inputs, epochs: int, num_rep: int = 8, lr: float = 0.2,
            alpha: float = 0.5, batch_size: int = 512,
            progress_path: str | None = None, resume: bool = False,
            verbose: bool = False,
            graph_cache_path: str | None = None) -> None:
        """Fits the shared latent space to per-modality (N_i, D_i)
        training features: graph + spectral init per modality, then
        ``epochs`` full-batch Adam steps (InfoNCE weight 2*alpha).

        ``progress_path`` snapshots the optimizer state at chunk
        boundaries; ``resume`` continues from that snapshot with the
        draws the uninterrupted run would have used (``loss_history``
        then covers the resumed epochs only). ``graph_cache_path`` saves
        the graph stage's outputs there, and a rerun on the same features
        (fingerprint), k, out_dim and spectral method loads them instead
        of rebuilding.
        """
        if len(inputs) != self.num_encoders:
            raise ValueError(
                f"expected {self.num_encoders} modalities, got {len(inputs)}")
        # Shard only when every table divides: the layout's modalities
        # then share one placement.
        self.sharded = all(_ring_ok(self.mesh, x.shape[0]) for x in inputs)
        plan = self._plan()
        mesh = self.mesh if self.sharded else None
        data = [self._as_table(self._my_rows(x)) for x in inputs]
        self.data = data
        progress_path = _npz_path(progress_path)
        cached = None
        if graph_cache_path is not None:
            # Of the whole tables in their storage dtype, on every rank.
            fingerprints = (
                [ckpt.feature_fingerprint(x, _STORAGE[self.feature_dtype])
                 for x in inputs] if self.sharded
                else [ckpt.feature_fingerprint(x) for x in data])
            cached = ckpt.load_graph_cache(
                graph_cache_path, k_neighbors=self.k_neighbors,
                out_dim=self.out_dim, spectral_method=self.spectral_method,
                fingerprints=fingerprints, device=self.device)
        if cached is not None:
            graphs, denses, inits = (cached["graphs"], cached["denses"],
                                     cached["inits"])
            for enc, sig, rho in zip(self.encoders, cached["sigmas"],
                                     cached["rhos"]):
                enc.sigmas, enc.rhos = sig, rho
        else:
            graphs, denses, inits = [], [], []
            for i, (enc, feats) in enumerate(zip(self.encoders, data)):
                with self.timer.phase(f"fit/graph_{i}"):
                    graph, dense, init = enc.fit_graph(feats, mesh=mesh)
                graphs.append(graph)
                denses.append(dense)
                inits.append(init)
            if graph_cache_path is not None and self._writes():
                with self.timer.phase("fit/graph_cache_save"):
                    ckpt.save_graph_cache(
                        graph_cache_path, k_neighbors=self.k_neighbors,
                        out_dim=self.out_dim,
                        spectral_method=self.spectral_method, graphs=graphs,
                        denses=denses, inits=inits,
                        sigmas=[e.sigmas for e in self.encoders],
                        rhos=[e.rhos for e in self.encoders],
                        fingerprints=fingerprints)
            if graph_cache_path is not None and self.mesh is not None:
                barrier(self.mesh)  # the cache is whole before anyone reads
        self.graphs = graphs
        tasks, statics = zip(*(fit_task(d, batch_size) for d in denses))
        if self.sharded:
            tasks, inits = zip(*(shard_task(plan, t, e)
                                 for t, e in zip(tasks, inits)))
        start_epoch, snap_inits, opt_state = _load_progress(
            progress_path, resume, self.num_encoders, self.device,
            plan if self.sharded else None)

        with self.timer.phase("fit/layout"):
            embeds, hist = train_layout(
                snap_inits or list(inits), tasks, statics, mode="fit",
                epochs=epochs, num_rep=num_rep, lr=lr, alpha=alpha,
                batch_size=batch_size, a=self.a, b=self.b, seed=self.seed,
                chunk_callback=self._callback("epoch", epochs,
                                              progress_path, verbose),
                start_epoch=start_epoch, init_opt_state=opt_state,
                mesh=mesh,
            )
        self.embeds = embeds
        self.loss_history["fit"] = hist.numpy()

    def fit_transform(self, inputs, epochs: int, num_rep: int = 8,
                      lr: float = 0.2, alpha: float = 0.5,
                      batch_size: int = 512) -> list[torch.Tensor]:
        """Fits and returns the training embeddings (whole on every rank
        of a sharded model)."""
        self.fit(inputs, epochs, num_rep, lr, alpha, batch_size)
        if self.sharded:
            return [all_gather_tensor(e, self.mesh) for e in self.embeds]
        return self.embeds

    def transform(self, inputs, epochs: int,
                  data_indices: list[int] | None = None, num_rep: int = 8,
                  lr: float = 0.2, alpha: float = 0.5, batch_size: int = 512,
                  progress_path: str | None = None, resume: bool = False,
                  verbose: bool = False) -> list[torch.Tensor]:
        """Embeds new data into the learned latent space: query graphs
        in feature space against the stored training features, queries
        initialized as affinity-weighted averages of train embeddings
        and optimized with the references frozen. ``progress_path`` /
        ``resume`` as in :meth:`fit`."""
        queries, indices = self._queries(inputs, data_indices)
        tasks, statics, inits, true_rows = [], [], [], []
        mesh = self.mesh if self.sharded else None
        with self.timer.phase("transform/graph"):
            for q, idx in zip(queries, indices):
                q, n_q = self._pad_query(q)
                nbrs, weights, init = self.encoders[idx].transform_graph(
                    self._my_rows(q), self.data[idx], self.embeds[idx],
                    mesh=mesh)
                task, static = query_task(
                    nbrs, self._mask_padded(weights, n_q), batch_size,
                    ref=self.embeds[idx], num_rows=q.shape[0],
                    rep_count=self._rows(idx))
                tasks.append(task)
                statics.append(static)
                inits.append(init)
                true_rows.append(n_q)
        return self._query_layout(
            "transform", tasks, statics, inits, true_rows, epochs=epochs,
            num_rep=num_rep, lr=lr, alpha=alpha, batch_size=batch_size,
            progress_path=progress_path, resume=resume, verbose=verbose,
            seed=self.seed + 1)

    def inverse_transform(self, inputs, epochs: int,
                          data_indices: list[int] | None = None,
                          num_rep: int = 8, lr: float = 0.2,
                          alpha: float = 0.5, batch_size: int = 512,
                          progress_path: str | None = None,
                          resume: bool = False,
                          verbose: bool = False) -> list[torch.Tensor]:
        """Reconstructs original features from latent embeddings (the
        JAX package's fixed invert semantics): query graphs in latent
        space with output-curve weights, reconstructions initialized as
        affinity-weighted averages of training data rows and optimized
        with the inverse attract/repel losses against the stored
        features. ``progress_path`` / ``resume`` as in :meth:`fit`."""
        queries, indices = self._queries(inputs, data_indices)
        tasks, statics, inits, true_rows = [], [], [], []
        mesh = self.mesh if self.sharded else None
        with self.timer.phase("invert/graph"):
            for z, idx in zip(queries, indices):
                enc = self.encoders[idx]
                z, n_q = self._pad_query(z)
                nbrs, weights, init = enc.invert_graph(
                    self._my_rows(z), self.embeds[idx], self.data[idx],
                    self.a, self.b, mesh=mesh)
                task, static = query_task(
                    nbrs, self._mask_padded(weights, n_q), batch_size,
                    ref=self.data[idx], sigmas=enc.sigmas, rhos=enc.rhos,
                    num_rows=z.shape[0], rep_count=self._rows(idx))
                tasks.append(task)
                statics.append(static)
                inits.append(init)
                true_rows.append(n_q)
        return self._query_layout(
            "invert", tasks, statics, inits, true_rows, epochs=epochs,
            num_rep=num_rep, lr=lr, alpha=alpha, batch_size=batch_size,
            progress_path=progress_path, resume=resume, verbose=verbose,
            seed=self.seed + 2)

    def _queries(self, inputs, data_indices):
        """(2-D f32 query tensors, modality indices) of a transform or
        invert call."""
        self._require_fitted()
        indices = (list(data_indices) if data_indices is not None
                   else list(range(self.num_encoders)))
        queries = [self._as_f32(x) for x in inputs]
        queries = [q[None, :] if q.dim() == 1 else q for q in queries]
        if len(queries) != len(indices):
            raise ValueError("inputs and data_indices length mismatch")
        return queries, indices

    def _query_layout(self, mode: str, tasks, statics, inits, true_rows, *,
                      epochs, num_rep, lr, alpha, batch_size, progress_path,
                      resume, verbose, seed) -> list[torch.Tensor]:
        """The frozen-reference layout of transform / invert, with its
        snapshots, resume and ``loss_history[mode]``; the results are
        whole (gathered on a sharded model) and cut to ``true_rows``."""
        progress_path = _npz_path(progress_path)
        start_epoch, snap_inits, opt_state = _load_progress(
            progress_path, resume, len(inits), self.device,
            self._plan() if self.sharded else None)
        with self.timer.phase(f"{mode}/layout"):
            embeds, hist = train_layout(
                snap_inits or inits, tasks, statics, mode=mode,
                epochs=epochs, num_rep=num_rep, lr=lr, alpha=alpha,
                batch_size=batch_size, a=self.a, b=self.b, seed=seed,
                chunk_callback=self._callback(f"{mode} epoch", epochs,
                                              progress_path, verbose),
                start_epoch=start_epoch, init_opt_state=opt_state,
                mesh=self.mesh if self.sharded else None,
            )
        self.loss_history[mode] = hist.numpy()
        if self.sharded:
            embeds = [all_gather_tensor(e, self.mesh) for e in embeds]
        return [e[:n] for e, n in zip(embeds, true_rows)]

    def _callback(self, label: str, epochs: int, progress_path, verbose):
        return _progress_callback(label, epochs, progress_path, verbose,
                                  self.mesh, self.sharded)

    def _plan(self) -> ShardingPlan | None:
        return ShardingPlan(self.mesh) if self.mesh is not None else None

    def _writes(self) -> bool:
        """Whether this process writes files (rank 0 under a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _my_rows(self, x):
        """This rank's rows of ``x`` on a sharded model (host rows stay
        on the host), else ``x``."""
        if not self.sharded:
            return x
        lo, hi = self._plan().row_range(x.shape[0])
        return x[lo:hi]

    def _rows(self, i: int) -> int:
        """Whole row count of fit table ``i``."""
        return self.data[i].shape[0] * (self.mesh.size if self.sharded
                                        else 1)

    def _pad_query(self, q: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Query rows padded with zero rows to a mesh-size multiple on a
        sharded model; (padded queries, true row count)."""
        if not self.sharded:
            return q, q.shape[0]
        return pad_rows_to_multiple(q, self.mesh.size)

    def _mask_padded(self, weights: torch.Tensor, n_q: int) -> torch.Tensor:
        """Zeroes padded query rows' edge weights (this rank's rows): their
        Bernoulli keeps never fire, so they add neither loss terms nor
        kept-entry counts to the window means."""
        if not self.sharded:
            return weights
        row0 = self.mesh.rank * weights.shape[0]
        rows = torch.arange(row0, row0 + weights.shape[0],
                            device=weights.device)[:, None]
        return torch.where(rows < n_q, weights, 0.0)

    @staticmethod
    def get_ab_coeffs(min_dist: float, num_iters: int = 50):
        """Gauss-Newton fit of the (a, b) curve (see models/curve.py)."""
        return _get_ab_coeffs(min_dist, num_iters=num_iters)

    def save_state_dict(self, path: str) -> None:
        """Saves the full model state (hyperparameters, (a, b), sigmas,
        rhos, training data, graphs and embeddings) as the JAX package's
        npz schema (utils/checkpoint.py). A sharded model gathers its rows
        to rank 0, which writes; the other ranks wait for it."""
        self._require_fitted()
        data, embeds = self.data, self.embeds
        if self.sharded:
            data = [gather_rows(x, self.mesh) for x in data]
            embeds = [gather_rows(x, self.mesh) for x in embeds]
        if self._writes():
            ckpt.save_state(path, {
                "k_neighbors": self.k_neighbors, "out_dim": self.out_dim,
                "min_dist": self.min_dist, "num_encoders": self.num_encoders,
                "a": self.a, "b": self.b,
                "spectral_method": self.spectral_method,
                "knn_engine": self.knn_engine,
                "sigmas": [e.sigmas for e in self.encoders],
                "rhos": [e.rhos for e in self.encoders],
                "data": data, "graphs": self.graphs, "embeds": embeds,
            })
        if self.mesh is not None:
            barrier(self.mesh)

    save = save_state_dict

    @classmethod
    def load_state_dict(cls, path: str,
                        device: torch.device | str | None = None
                        ) -> "MultimodalUMAP":
        """Restores a model saved by :meth:`save_state_dict` (or by the
        JAX package's) onto ``device``."""
        dev = resolve_device(device)
        return cls._from_state(ckpt.load_state(path, dev), dev)

    load = load_state_dict

    @classmethod
    def from_numpy_state(cls, state, device: torch.device | str | None = None
                         ) -> "MultimodalUMAP":
        """A fitted model from numpy arrays named as the checkpoint names
        them: ``a``, ``b``, ``k_neighbors``, ``out_dim``, ``min_dist``,
        ``num_encoders`` and, per modality i, ``sigmas_i``, ``rhos_i``,
        ``data_i``, ``embeds_i``, ``graph_i_{rows,cols,weights,valid}``.
        An opened checkpoint (``np.load(path)``), whose scalars sit in
        its ``meta`` JSON, is accepted as it is."""
        dev = resolve_device(device)
        return cls._from_state(ckpt.state_from_arrays(state, dev), dev)

    @classmethod
    def _from_state(cls, state: dict, device: torch.device
                    ) -> "MultimodalUMAP":
        model = cls(state["k_neighbors"], state["out_dim"],
                    state["min_dist"], state["num_encoders"],
                    spectral_method=state["spectral_method"],
                    knn_engine=state["knn_engine"], device=device)
        model.a, model.b = state["a"], state["b"]
        for enc, sig, rho in zip(model.encoders, state["sigmas"],
                                 state["rhos"]):
            enc.sigmas, enc.rhos = sig, rho
        model.data = state["data"]
        # Inferred, not stored: the archive keeps each table's dtype.
        model.feature_dtype = (
            "bfloat16" if any(d.dtype == torch.bfloat16 for d in model.data)
            else "float32")
        model.graphs = state["graphs"]
        model.embeds = state["embeds"]
        return model

    def _require_fitted(self) -> None:
        if self.data is None or not self.embeds:
            raise RuntimeError("model is not fitted; call fit() first")


# Reference-compatible alias.
UMAPMixture = MultimodalUMAP
