"""Multimodal UMAP in PyTorch for NVIDIA Hopper GPUs.

The PyTorch/CUDA port of ``multimodal_umap_tpu`` (which stays the
reference it is tested against). Same module layout and public names:
exact kNN graphs through a hand-written CUDA tile kernel
(``ops/knn_tile.py``, ``csrc/knn_tile.cu``), fuzzy weights, t-conorm
symmetrization, Chebyshev spectral init, the full-batch Adam layout with
InfoNCE alignment, out-of-sample transform, the inverse transform and
the text->image recon app with its SD-VAE decoder, checkpoints, progress
snapshots and resume, and the evaluation metrics. Imports neither JAX
nor the JAX package.
"""

from .config import Config
from .models.mixture import MultimodalUMAP, UMAPMixture

__version__ = "0.1.0"

__all__ = ["Config", "MultimodalUMAP", "UMAPMixture", "__version__"]
