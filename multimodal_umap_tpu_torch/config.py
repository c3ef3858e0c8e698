"""Experiment configuration.

Field-for-field copy of ``multimodal_umap_tpu/config.py`` with the same
defaults (the reference CLI's canonical experiment values). Kept as its
own copy so the PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    """Hyperparameters for training and inference.

    Attributes:
        k_neighbors: neighbors per point in the fuzzy kNN graph.
        out_dim: shared latent dimensionality.
        min_dist: UMAP min_dist controlling the (a, b) curve fit.
        train_epochs: epochs for ``fit``.
        num_rep: negative samples per kept attractive edge.
        lr: Adam learning rate.
        alpha: InfoNCE cross-modal alignment weight.
        batch_size: row-window size for the per-window loss averaging
            (the optimizer takes one full-batch step per epoch).
        test_epochs: epochs for ``transform``.
        log_dir: per-epoch loss log directory (``utils/logging.py``).
        seed: base seed for all stochastic stages.
        spectral_method: "auto", "dense", "lobpcg" or "chebyshev"
            (ops/spectral.py).
        knn_engine: kNN engine (ops/knn.py) -- None = device default
            (bf16 tile kernel + exact f32 re-score on CUDA, exact f32
            panels on the CPU); or "bf16" / "xla" / "pallas" / "approx"
            / "stream".
        feature_dtype: storage dtype of the training feature tables,
            "float32" or "bfloat16" (half the device memory; distances
            re-scored exactly w.r.t. the stored values).
        progress_path: optimizer-state snapshot file of ``train``'s fit.
        resume: continue that fit from its snapshot.
        graph_cache_path: fit graph-stage cache file.
    """

    k_neighbors: int = 15
    out_dim: int = 64
    min_dist: float = 0.1

    train_epochs: int = 600
    num_rep: int = 8
    lr: float = 0.01
    alpha: float = 1.0
    batch_size: int = 256

    test_epochs: int = 120

    log_dir: str | None = None
    seed: int = 0
    spectral_method: str = "auto"
    knn_engine: str | None = None
    feature_dtype: str = "float32"
    progress_path: str | None = None
    resume: bool = False
    graph_cache_path: str | None = None
