"""Synthetic paired datasets."""

from .synthetic import clustered_modalities, clustered_modalities_device

__all__ = ["clustered_modalities", "clustered_modalities_device"]
