"""Applications: cross-modal text->image reconstruction."""

from .crossmodal import crossmodal_recon

__all__ = ["crossmodal_recon"]
