"""Data pipelines: cached flickr30k features and synthetic paired data."""

from .flickr30k import load_data
from .synthetic import clustered_modalities, clustered_modalities_device

__all__ = ["load_data", "clustered_modalities", "clustered_modalities_device"]
