"""Multimodal UMAP mixture model: the public model API.

Counterpart of ``multimodal_umap_tpu/models/mixture.py`` with the same
lifecycle surface so far: ``fit`` / ``fit_transform`` / ``transform`` /
``get_ab_coeffs``, plus :meth:`MultimodalUMAP.from_numpy_state`, which
builds a fitted model from numpy arrays named as the JAX package's
checkpoint names them. Method defaults mirror the reference's
signatures (lr=0.2, alpha=0.5, batch_size=512); the experiment values
come from ``Config``.

Every tensor lives on ``device`` (default CUDA; without a GPU that
raises unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.graph import EdgeGraph
from ..utils.device import resolve_device
from ..utils.prof import PhaseTimer
from .curve import get_ab_coeffs as _get_ab_coeffs
from .encoder import ModalityEncoder
from .layout import fit_task, query_task, train_layout


class MultimodalUMAP:
    """Shared-latent multimodal UMAP with InfoNCE alignment.

    Attributes:
        k_neighbors, out_dim, min_dist, num_encoders: hyperparameters.
        a, b: fitted UMAP curve coefficients.
        encoders: per-modality :class:`ModalityEncoder` graph state.
        data: training features per modality (transform needs them).
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
    ):
        if num_encoders < 1:
            raise ValueError(f"num_encoders must be >= 1, got {num_encoders}")
        self.device = resolve_device(device)
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

    def fit(self, inputs, epochs: int, num_rep: int = 8, lr: float = 0.2,
            alpha: float = 0.5, batch_size: int = 512,
            verbose: bool = False) -> None:
        """Fits the shared latent space to per-modality (N_i, D_i)
        training features: graph + spectral init per modality, then
        ``epochs`` full-batch Adam steps (InfoNCE weight 2*alpha)."""
        data = [self._as_f32(x) for x in inputs]
        if len(data) != self.num_encoders:
            raise ValueError(
                f"expected {self.num_encoders} modalities, got {len(data)}")
        self.data = data
        graphs, denses, inits = [], [], []
        for i, (enc, feats) in enumerate(zip(self.encoders, data)):
            with self.timer.phase(f"fit/graph_{i}"):
                graph, dense, init = enc.fit_graph(feats)
            graphs.append(graph)
            denses.append(dense)
            inits.append(init)
        self.graphs = graphs
        tasks, statics = zip(*(fit_task(d, batch_size) for d in denses))

        with self.timer.phase("fit/layout"):
            embeds, hist = train_layout(
                inits, tasks, statics, mode="fit", epochs=epochs,
                num_rep=num_rep, lr=lr, alpha=alpha, batch_size=batch_size,
                a=self.a, b=self.b, seed=self.seed,
                chunk_callback=_verbose_callback("epoch", epochs, verbose),
            )
        self.embeds = embeds
        self.loss_history["fit"] = hist.numpy()

    def fit_transform(self, inputs, epochs: int, num_rep: int = 8,
                      lr: float = 0.2, alpha: float = 0.5,
                      batch_size: int = 512) -> list[torch.Tensor]:
        """Fits and returns the training embeddings."""
        self.fit(inputs, epochs, num_rep, lr, alpha, batch_size)
        return self.embeds

    def transform(self, inputs, epochs: int,
                  data_indices: list[int] | None = None, num_rep: int = 8,
                  lr: float = 0.2, alpha: float = 0.5, batch_size: int = 512,
                  verbose: bool = False) -> list[torch.Tensor]:
        """Embeds new data into the learned latent space: query graphs
        in feature space against the stored training features, queries
        initialized as affinity-weighted averages of train embeddings
        and optimized with the references frozen."""
        self._require_fitted()
        indices = (list(data_indices) if data_indices is not None
                   else list(range(self.num_encoders)))
        queries = [self._as_f32(x) for x in inputs]
        queries = [q[None, :] if q.dim() == 1 else q for q in queries]
        if len(queries) != len(indices):
            raise ValueError("inputs and data_indices length mismatch")
        tasks, statics, inits = [], [], []
        with self.timer.phase("transform/graph"):
            for q, idx in zip(queries, indices):
                nbrs, weights, init = self.encoders[idx].transform_graph(
                    q, self.data[idx], self.embeds[idx])
                task, static = query_task(nbrs, weights, batch_size,
                                          ref=self.embeds[idx])
                tasks.append(task)
                statics.append(static)
                inits.append(init)
        with self.timer.phase("transform/layout"):
            embeds, hist = train_layout(
                inits, tasks, statics, mode="transform", epochs=epochs,
                num_rep=num_rep, lr=lr, alpha=alpha, batch_size=batch_size,
                a=self.a, b=self.b, seed=self.seed + 1,
                chunk_callback=_verbose_callback("transform epoch", epochs,
                                                 verbose),
            )
        self.loss_history["transform"] = hist.numpy()
        return embeds

    @staticmethod
    def get_ab_coeffs(min_dist: float, num_iters: int = 50):
        """Gauss-Newton fit of the (a, b) curve (see models/curve.py)."""
        return _get_ab_coeffs(min_dist, num_iters=num_iters)

    @classmethod
    def from_numpy_state(cls, state, device: torch.device | str | None = None
                         ) -> "MultimodalUMAP":
        """A fitted model from numpy arrays named as the JAX package's
        checkpoint (``utils/checkpoint.py``) names them: ``a``, ``b``,
        ``k_neighbors``, ``out_dim``, ``min_dist``, ``num_encoders`` and,
        per modality i, ``sigmas_i``, ``rhos_i``, ``data_i``,
        ``embeds_i``, ``graph_i_{rows,cols,weights,valid}``. A loaded
        JAX checkpoint (``np.load(path)``), whose scalars sit in its
        ``meta`` JSON, is accepted as it is."""
        scalars = dict(state)
        if "meta" in scalars:
            meta = json.loads(str(scalars["meta"]))
            if meta.get("bf16_keys"):
                raise ValueError("bf16-stored checkpoints are not supported "
                                 "by this port yet")
            scalars.update({k: meta[k] for k in (
                "a", "b", "k_neighbors", "out_dim", "min_dist",
                "num_encoders") if k in meta})
            for key in ("spectral_method", "knn_engine"):
                if meta.get(key):
                    scalars.setdefault(key, meta[key])
        model = cls(int(scalars["k_neighbors"]), int(scalars["out_dim"]),
                    float(scalars["min_dist"]), int(scalars["num_encoders"]),
                    spectral_method=str(scalars.get("spectral_method", "auto")),
                    knn_engine=scalars.get("knn_engine") or None,
                    device=device)
        model.a, model.b = float(scalars["a"]), float(scalars["b"])
        dev = model.device

        def t(key, dtype=None):
            return torch.as_tensor(np.array(state[key]), device=dev,
                                   dtype=dtype)

        model.data, model.embeds, model.graphs = [], [], []
        for i, enc in enumerate(model.encoders):
            enc.sigmas = t(f"sigmas_{i}", torch.float32)
            enc.rhos = t(f"rhos_{i}", torch.float32)
            model.data.append(t(f"data_{i}", torch.float32))
            model.embeds.append(t(f"embeds_{i}", torch.float32))
            n = model.data[-1].shape[0]
            model.graphs.append(EdgeGraph(
                rows=t(f"graph_{i}_rows", torch.int32),
                cols=t(f"graph_{i}_cols", torch.int32),
                weights=t(f"graph_{i}_weights", torch.float32),
                valid=t(f"graph_{i}_valid", torch.bool),
                num_rows=n, num_cols=n))
        return model

    def _require_fitted(self) -> None:
        if self.data is None or not self.embeds:
            raise RuntimeError("model is not fitted; call fit() first")


def _verbose_callback(label: str, epochs: int, verbose: bool):
    """Chunk-boundary loss readout (one host read per chunk)."""
    if not verbose:
        return None

    def callback(done, params, optimizer, hist):
        print(f"{label} {done}/{epochs}  loss {float(hist[-1]):.4f}",
              flush=True)

    return callback


# Reference-compatible alias.
UMAPMixture = MultimodalUMAP
