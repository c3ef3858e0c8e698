"""Paired clustered feature tables drawn on the device from a seed.

A frozen copy of the port's ``data/synthetic.py::clustered_modalities_device``
(the benchmark's inputs must not move when the program does), returning the
cluster labels too. Rows with the same index share a cluster in every
modality, so cross-modal alignment is learnable.

Every table is drawn ``ROW_CHUNK`` rows at a time in float32 on the device
and written into a preallocated table of the configuration's storage dtype,
whatever that dtype is: the same draws for a float32 and a bfloat16 table of
one seed, and the float32 transient is ``ROW_CHUNK x d``.
"""

from __future__ import annotations

import torch

ROW_CHUNK = 65_536

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def storage_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def clustered_tables(n: int, dims, n_clusters: int, cluster_scale: float,
                     noise_scale: float, seed: int, device: torch.device,
                     dtype: torch.dtype):
    """(list of (n, d) tables in ``dtype``, (n,) int64 labels) drawn from
    ``torch.Generator``s on ``device`` seeded from ``seed``."""
    seed = int(seed) % (1 << 62)
    gen = torch.Generator(device=device).manual_seed(seed)
    centers_gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    labels = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    tables = []
    for d in dims:
        centers = torch.randn(n_clusters, d, generator=centers_gen,
                              device=device) * cluster_scale
        table = torch.empty((n, d), dtype=dtype, device=device)
        for s in range(0, n, ROW_CHUNK):
            lab = labels[s:s + ROW_CHUNK]
            noise = torch.randn(lab.shape[0], d, generator=gen, device=device)
            table[s:s + ROW_CHUNK] = noise.mul_(noise_scale).add_(centers[lab])
        tables.append(table)
    return tables, labels
