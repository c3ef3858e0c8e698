"""Model layer: per-modality encoders, the mixture model, curve fit,
and the layout optimizer."""

from .curve import get_ab_coeffs
from .encoder import ModalityEncoder
from .layout import LayoutTask, TaskStatic, fit_task, query_task, train_layout
from .mixture import MultimodalUMAP, UMAPMixture

__all__ = [
    "get_ab_coeffs",
    "ModalityEncoder",
    "LayoutTask",
    "TaskStatic",
    "fit_task",
    "query_task",
    "train_layout",
    "MultimodalUMAP",
    "UMAPMixture",
]
