"""flickr30k features: first-caption text features + SD-VAE image latents.

Counterpart of ``multimodal_umap_tpu/data/flickr30k.py`` with the same
feature definitions:

* text -- the FIRST caption only, BERT-base-uncased ``pooler_output``
  (768-d);
* image -- resize to 256 x 256 (antialiased bilinear, as PIL does on
  downscale), normalize(0.5, 0.5), ``sd-vae-ft-mse`` posterior MEAN,
  flattened (4, 32, 32) in NCHW order -> 4096-d.

Features cache to ``data/{split}_data.npz`` (the JAX package's files
load here as they are). The batching, caching and preprocessing are
encoder-agnostic: encoders are injected (:class:`Encoders`), and the
image encoder of the port's VAE is :func:`vae_image_encoder`. There is
no PyTorch BERT yet (its weights and vocabulary are not in the
repository), so :func:`load_hf_encoders` needs the text encoder passed
in. Nothing is downloaded: without a cache and without a sample stream,
:func:`load_data` raises and points at the synthetic data.
"""

from __future__ import annotations

import os
import typing

import numpy as np
import torch
import torch.nn.functional as F

_CACHE_DIR = "data"
_VAE_NAME = "stabilityai/sd-vae-ft-mse"


class Encoders(typing.NamedTuple):
    """Feature extractors for one multimodal dataset.

    encode_texts: list[str] -> (B, D_text) array.
    encode_images: (B, H, W, 3) float array in [-1, 1] -> (B, D_img).
    """

    encode_texts: typing.Callable
    encode_images: typing.Callable


def cache_path(split: str, cache_dir: str = _CACHE_DIR) -> str:
    return os.path.join(cache_dir, f"{split}_data.npz")


def load_cached(split: str, cache_dir: str = _CACHE_DIR) -> dict | None:
    path = cache_path(split, cache_dir)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {"texts": z["texts"], "images": z["images"]}


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Antialiased bilinear resize (H, W, C) -> (size, size, C): the
    triangle filter's support scales with the downscale ratio, as in
    ``PIL.Image.resize(..., BILINEAR)``, which the reference's
    torchvision ``Resize`` calls on a PIL image."""
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def preprocess_image(img: np.ndarray) -> np.ndarray:
    """The reference's transform chain: resize to 256 x 256, scale to
    [0, 1], normalize(0.5, 0.5). (The resize lands at the crop size, so
    the center crop is the identity.) Returns (256, 256, 3) float32."""
    img = _resize_bilinear(np.asarray(img, dtype=np.float32), 256) / 255.0
    return (img - 0.5) / 0.5


def vae_image_encoder(vae) -> typing.Callable:
    """``encode_images`` of a :class:`..nn.vae.LoadedVAE`: NHWC pixels in
    [-1, 1] -> the posterior mean, flattened in NCHW order (the
    reference's (B, 4, 32, 32) layout) as a float32 numpy array."""

    def encode_images(pixels_nhwc) -> np.ndarray:
        nchw = np.asarray(pixels_nhwc, dtype=np.float32).transpose(0, 3, 1, 2)
        latents = vae.encode_mean(np.ascontiguousarray(nchw))
        return latents.reshape(latents.shape[0], -1).cpu().numpy()

    return encode_images


def load_hf_encoders(vae_name: str = _VAE_NAME,
                     encode_texts: typing.Callable | None = None,
                     device: torch.device | str | None = None) -> Encoders:
    """The feature encoders: ``encode_texts`` as given, and the SD-VAE
    posterior-mean image encoder loaded from a local checkpoint
    directory (``MMUMAP_VAE_DIR`` or ``vae_name``) onto ``device``.

    The text encoder is the caller's: the PyTorch BERT pooler is not in
    this package until ``bert-base-uncased``'s weights and vocabulary are
    in the repository, so without ``encode_texts`` this raises."""
    if encode_texts is None:
        raise RuntimeError(
            "no text encoder: the PyTorch BERT pooler is not ported (the "
            "bert-base-uncased weights and vocabulary are not in this "
            "repository); pass encode_texts=")
    from ..nn.vae import load_vae, resolve_vae_dir

    vae = load_vae(resolve_vae_dir(vae_name), device=device)
    return Encoders(encode_texts=encode_texts,
                    encode_images=vae_image_encoder(vae))


def _batch_placer(mesh):
    """A function giving this rank's share of a batch's leading axis
    (identity when ``mesh`` is None). The batch must divide the mesh
    size: :func:`extract_features` pads its last partial batch."""
    if mesh is None:
        return lambda x: x

    def rows(x):
        per = len(x) // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return rows


def _encode_on_mesh(encode, batch, mesh) -> np.ndarray:
    """``encode`` of this rank's share of ``batch``, then one all-gather
    of the features: every rank gets the whole batch's."""
    if mesh is None:
        return np.asarray(encode(batch))
    from ..parallel.collectives import all_gather_tensor

    part = torch.as_tensor(np.asarray(encode(_batch_placer(mesh)(batch))))
    return all_gather_tensor(part.to(mesh.device), mesh).cpu().numpy()


def extract_features(samples: typing.Iterable[dict], encoders: Encoders,
                     batch_size: int = 64, mesh=None) -> dict:
    """Streams samples through the encoders in fixed batches.

    Each sample is a dict with ``alt_text`` (list of captions; only the
    FIRST is used) and ``image`` (a PIL image or an (H, W, 3) array).
    With ``mesh`` (every rank streaming the same samples) each rank
    encodes its share of a batch and one all-gather gives every rank
    the batch's features; the last partial batch is padded up to
    ``batch_size`` (the last sample repeated) and the padding dropped.
    Features are unchanged: both encoders are row-wise maps."""
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} not divisible by the "
                         f"{mesh.size}-rank mesh")
    texts, images = [], []
    batch_texts: list[str] = []
    batch_imgs: list[np.ndarray] = []
    total = 0

    def flush():
        nonlocal total
        if not batch_texts:
            return
        total += len(batch_texts)
        if mesh is not None and len(batch_texts) < batch_size:
            pad = batch_size - len(batch_texts)
            batch_texts.extend([batch_texts[-1]] * pad)
            batch_imgs.extend([batch_imgs[-1]] * pad)
        texts.append(_encode_on_mesh(encoders.encode_texts,
                                     list(batch_texts), mesh))
        images.append(_encode_on_mesh(encoders.encode_images,
                                      np.stack(batch_imgs), mesh))
        batch_texts.clear()
        batch_imgs.clear()

    for sample in samples:
        batch_texts.append(sample["alt_text"][0])
        img = sample["image"]
        if hasattr(img, "convert"):  # PIL
            img = np.asarray(img.convert("RGB"))
        batch_imgs.append(preprocess_image(img))
        if len(batch_texts) == batch_size:
            flush()
    flush()
    if not texts:
        raise ValueError("no samples to extract features from")
    return {"texts": np.concatenate(texts)[:total],
            "images": np.concatenate(images)[:total]}


def load_data(split: str, cache_dir: str = _CACHE_DIR, batch_size: int = 64,
              encoders: Encoders | None = None,
              stream: typing.Iterable[dict] | None = None,
              mesh=None) -> dict:
    """Cached flickr30k features: a cache hit loads the npz; a miss
    extracts ``stream`` (samples as :func:`extract_features` takes them)
    with ``encoders`` (default :func:`load_hf_encoders`) and caches the
    result (``mesh``: extraction split over the ranks, rank 0 writes).
    Without a cache and a stream, or without usable encoders, raises
    RuntimeError naming the cache path and the synthetic data."""
    cached = load_cached(split, cache_dir)
    if cached is not None:
        return cached
    path = cache_path(split, cache_dir)
    hint = ("this package downloads nothing; pass stream= and encoders=, "
            "or use multimodal_umap_tpu_torch.data.synthetic."
            "clustered_modalities or main_torch.py --synthetic")
    if stream is None:
        raise RuntimeError(f"no cached features at {path} and no sample "
                           f"stream; {hint}")
    if encoders is None:
        try:
            encoders = load_hf_encoders()
        except (RuntimeError, FileNotFoundError) as exc:
            raise RuntimeError(f"no cached features at {path} and no "
                               f"encoders ({exc}); {hint}") from exc
    data = extract_features(stream, encoders, batch_size=batch_size,
                            mesh=mesh)
    if mesh is None or mesh.rank == 0:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, **data)
    return data
