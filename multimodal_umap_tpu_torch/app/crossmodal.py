"""Cross-modal reconstruction app: text -> shared latent -> image.

Counterpart of ``multimodal_umap_tpu/app/crossmodal.py``: embed text
features, reconstruct them in SD-VAE latent space through the inverse
transform, print the latent-space MSE, decode through the VAE
(``nn/vae.py``) and save original-over-reconstruction PNG pairs.

Without VAE weights (no checkpoint directory) the decode is skipped: the
raw latents are saved as npz plus channel-0 heat-map pairs; the
reconstruction MSE is unaffected. PNGs are written by a small encoder of
their own (8-bit RGB, no titles), so the app needs no plotting package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..config import Config
from ..eval.validation import embed_and_recon
from ..models.mixture import MultimodalUMAP


def _decode_with_vae(latents: np.ndarray, vae=None,
                     device=None) -> np.ndarray | None:
    """(B, 4, h, w) SD-VAE latents -> (B, H, W, 3) images in [0, 1], or
    None when no checkpoint is found (``vae`` None and no local weights).

    ``vae`` is a :class:`..nn.vae.LoadedVAE`; when None the default
    checkpoint directory is resolved (``MMUMAP_VAE_DIR``, then a local
    directory) and loaded onto ``device``. Only a missing checkpoint
    takes the offline path: a decode error with a loaded VAE
    propagates."""
    if vae is None:
        from ..nn.vae import load_vae, resolve_vae_dir

        try:
            vae = load_vae(resolve_vae_dir(), device=device)
        except FileNotFoundError:
            return None
    out = vae.decode(latents).float().cpu().numpy()
    return np.clip(out.transpose(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8, rounded to nearest."""
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Writes an (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0 on
    every row, one zlib stream)."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _save_pairs(orig: np.ndarray, recon: np.ndarray, out_dir: str) -> None:
    """One PNG per sample: the original above its reconstruction."""
    for i in range(orig.shape[0]):
        write_png(os.path.join(out_dir, f"recon_text_to_image_{i + 1}.png"),
                  to_uint8(np.concatenate([orig[i], recon[i]], axis=0)))


def crossmodal_recon(
    data: list,
    cfg: Config,
    model: MultimodalUMAP,
    out_dir: str = "results",
    latent_shape: tuple[int, int, int] = (4, 32, 32),
    vae=None,
) -> list:
    """Text->image reconstruction with on-disk visual comparison.

    Args:
        data: [text_features (B, 768), image_latents (B, 4096)].
        cfg: inference hyperparameters.
        model: fitted model.
        out_dir: directory for PNG pairs / latent dumps.
        latent_shape: VAE latent geometry.
        vae: optional :class:`..nn.vae.LoadedVAE`; when None the default
            checkpoint is resolved and loaded onto the model's device
            (without one, latents are saved instead).

    Returns:
        [reconstructed latents (B, D_image)] as a numpy array. Under a
        mesh every rank reconstructs; rank 0 prints, decodes and writes.
    """
    recon = embed_and_recon(model, [data[0]], [0], [1], cfg)[0].cpu().numpy()
    target = np.asarray(data[1])

    loss = float(np.mean((recon - target) ** 2))
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        return [recon]  # rank 0 decodes and writes
    print(f"Reconstruction loss from text to image: {loss:.4f}")

    os.makedirs(out_dir, exist_ok=True)
    recon_latent = recon.reshape(-1, *latent_shape)
    orig_latent = target.reshape(-1, *latent_shape)

    recon_imgs = _decode_with_vae(recon_latent, vae, model.device)
    orig_imgs = (_decode_with_vae(orig_latent, vae, model.device)
                 if recon_imgs is not None else None)
    if recon_imgs is not None and orig_imgs is not None:
        _save_pairs(orig_imgs, recon_imgs, out_dir)
    else:
        np.savez(os.path.join(out_dir, "recon_latents.npz"),
                 recon=recon_latent, original=orig_latent)

        def to_gray(lat):
            # Channel 0, min-max normalized per image for display.
            ch = lat[:, 0, :, :]
            lo = ch.min(axis=(1, 2), keepdims=True)
            hi = ch.max(axis=(1, 2), keepdims=True)
            ch = (ch - lo) / np.maximum(hi - lo, 1e-6)
            return ch[..., None].repeat(3, axis=-1)

        _save_pairs(to_gray(orig_latent), to_gray(recon_latent), out_dir)
    return [recon]
