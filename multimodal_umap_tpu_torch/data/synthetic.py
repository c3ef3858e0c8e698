"""Synthetic multimodal datasets for tests and benchmarks.

Paired clustered modalities: rows with the same index share a cluster,
so cross-modal alignment is learnable -- the structure (paired
text/image rows) of the flickr30k workload without any download.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

# Rows drawn at a time (in f32) for a table stored in another dtype.
ROW_CHUNK = 65_536


def _names(dims) -> list[str]:
    return (["texts", "images"] if len(dims) == 2
            else [f"mod{i}" for i in range(len(dims))])


def clustered_modalities(
    n_samples: int,
    dims: tuple[int, ...] = (768, 4096),
    n_clusters: int = 32,
    cluster_scale: float = 6.0,
    noise_scale: float = 1.0,
    seed: int = 0,
    centers_seed: int | None = None,
) -> dict[str, np.ndarray]:
    """Paired clustered features, one float32 array per modality.

    Bit-identical to ``multimodal_umap_tpu.data.synthetic.
    clustered_modalities`` (same numpy streams, same draw order).
    ``centers_seed`` fixes the cluster geometry independently of the
    sample draws so test splits lie on the train manifold.
    """
    rng = np.random.default_rng(seed)
    # centers_seed=None keeps the single-stream draw order.
    centers_rng = (
        rng if centers_seed is None else np.random.default_rng(centers_seed)
    )
    labels = rng.integers(0, n_clusters, size=n_samples)
    out = {}
    for name, d in zip(_names(dims), dims):
        centers = centers_rng.normal(size=(n_clusters, d)) * cluster_scale
        out[name] = (
            centers[labels] + rng.normal(size=(n_samples, d)) * noise_scale
        ).astype(np.float32)
    return out


def clustered_modalities_device(
    n_samples: int,
    dims: tuple[int, ...] = (768, 4096),
    n_clusters: int = 32,
    cluster_scale: float = 6.0,
    noise_scale: float = 1.0,
    seed: int = 0,
    centers_seed: int | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Device-side variant of :func:`clustered_modalities`, drawn from
    ``torch.Generator``s on ``device``: the same distribution, not the
    same numbers.

    ``dtype`` is the output dtype. Any other than float32 is drawn
    ``ROW_CHUNK`` rows at a time in f32 and written into a preallocated
    ``dtype`` table, so the f32 transient is ``ROW_CHUNK x d`` rather than
    the whole table (bf16 tables beyond the size an f32 draw would fit);
    such draws consume the generator in another order than the f32 path
    (same distribution).
    """
    dev = resolve_device(device)
    if centers_seed is None:
        centers_seed = seed
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers_gen = torch.Generator(device=dev).manual_seed(centers_seed ^ 0x5EED)
    labels = torch.randint(0, n_clusters, (n_samples,), generator=gen,
                           device=dev)
    chunk = n_samples if dtype == torch.float32 else ROW_CHUNK
    out = {}
    for name, d in zip(_names(dims), dims):
        centers = torch.randn(n_clusters, d, generator=centers_gen,
                              device=dev) * cluster_scale
        table = torch.empty((n_samples, d), dtype=dtype, device=dev)
        for s in range(0, n_samples, chunk):
            lab = labels[s:s + chunk]
            noise = torch.randn(lab.shape[0], d, generator=gen, device=dev)
            table[s:s + chunk] = noise.mul_(noise_scale).add_(centers[lab])
        out[name] = table
    return out
