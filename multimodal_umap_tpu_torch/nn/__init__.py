"""Frozen-network inference components: the SD-VAE."""

from .vae import (
    AutoencoderKL,
    LoadedVAE,
    VAEConfig,
    load_vae,
    random_vae,
    resolve_vae_dir,
)

__all__ = ["AutoencoderKL", "LoadedVAE", "VAEConfig", "load_vae",
           "random_vae", "resolve_vae_dir"]
