"""PyTorch port: the flickr30k data module (offline) against the JAX
package's -- batching, the first-caption rule, caching and the offline
error with stub encoders (tests/test_data_pipeline.py), the image
preprocessing against JAX's and PIL's (tests/test_image_resize.py), the
SD-VAE image encoder against the Flax module, and the synthetic device
tables' dtype and row chunks.

Tolerances: the preprocessing within one uint8 quantization level of
PIL (2/255 after normalize, plus float slack) as the JAX test holds
JAX's, and within 1e-4 of JAX's own resize (two float32 implementations
of the same antialiased triangle filter); VAE latents rtol 1e-4 / atol
1e-5 (tests/test_torch_vae.py).
"""

import json
import os

import numpy as np
import pytest
import torch
from test_data_pipeline import _samples, _stub_encoders
from test_image_resize import _pil_reference, _synthetic_u8

from multimodal_umap_tpu.data.flickr30k import (
    extract_features as j_extract_features,
    preprocess_image as j_preprocess_image,
)
from multimodal_umap_tpu.nn.vae import AutoencoderKL as FlaxVAE
from multimodal_umap_tpu.nn.vae import VAEConfig as FlaxConfig
from multimodal_umap_tpu.nn.vae import (
    make_loaded_vae as flax_loaded,
    params_from_torch_state_dict,
)
from multimodal_umap_tpu_torch.data import clustered_modalities_device
from multimodal_umap_tpu_torch.data.flickr30k import (
    cache_path,
    extract_features,
    load_cached,
    load_data,
    load_hf_encoders,
    preprocess_image,
    vae_image_encoder,
)
from multimodal_umap_tpu_torch.nn.vae import VAEConfig, random_vae

torch.set_num_threads(1)

# One uint8 quantization level on the normalized [-1, 1] scale, plus
# float slack (tests/test_image_resize.py's tolerance and helpers; the
# stub encoders and samples are tests/test_data_pipeline.py's).
_PIL_TOL = 2.0 / 255.0 + 1e-4
TINY = dict(block_out_channels=(8, 16), layers_per_block=1,
            latent_channels=4, norm_num_groups=4)


def test_extract_batches_and_first_caption():
    calls = []
    out = extract_features(_samples(10, np.random.default_rng(0)),
                           _stub_encoders(calls), batch_size=4)
    assert out["texts"].shape == (10, 4)
    assert out["images"].shape == (10, 6)
    assert calls == [("text", 4), ("image", 4), ("text", 4), ("image", 4),
                     ("text", 2), ("image", 2)]
    assert out["texts"][0, 0] == len("caption ")
    want = j_extract_features(_samples(10, np.random.default_rng(0)),
                              _stub_encoders([]), batch_size=4)
    np.testing.assert_array_equal(out["texts"], want["texts"])
    np.testing.assert_allclose(out["images"], want["images"], atol=1e-4)


def test_extract_features_is_single_device():
    """Without a mesh extraction runs on one device; a mesh must divide
    the batch (JAX's rule; the mesh run itself is in
    tests/test_torch_mesh.py)."""
    from multimodal_umap_tpu_torch.parallel import Mesh

    mesh = Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divisible"):
        extract_features(_samples(2, np.random.default_rng(0)),
                         _stub_encoders([]), batch_size=4, mesh=mesh)


def test_load_data_caches_an_injected_stream(tmp_path):
    calls = []
    encoders = _stub_encoders(calls)
    cache = str(tmp_path / "cache")
    out = load_data("train", cache_dir=cache, batch_size=4,
                    encoders=encoders,
                    stream=_samples(6, np.random.default_rng(1)))
    assert out["texts"].shape == (6, 4)
    n_calls = len(calls)
    again = load_data("train", cache_dir=cache, batch_size=4,
                      encoders=encoders)
    assert len(calls) == n_calls  # the npz cache, no encoder call
    np.testing.assert_array_equal(again["texts"], out["texts"])
    assert load_cached("train", cache) is not None
    assert cache_path("train", cache) == os.path.join(cache, "train_data.npz")


def test_load_data_offline_errors(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(RuntimeError, match="synthetic") as err:
        load_data("train", cache_dir=missing)
    assert cache_path("train", missing) in str(err.value)
    # A stream but no text encoder (no PyTorch BERT): the same pointer.
    with pytest.raises(RuntimeError, match="synthetic") as err:
        load_data("train", cache_dir=missing,
                  stream=_samples(2, np.random.default_rng(0)))
    assert "text encoder" in str(err.value)
    assert not os.path.exists(missing)


@pytest.mark.parametrize(
    "shape", [(500, 375), (333, 517), (1024, 768), (256, 256), (128, 200)])
def test_preprocess_matches_jax_and_pil(shape):
    u8 = _synthetic_u8(shape, seed=shape[0] * 7 + shape[1])
    ours = preprocess_image(u8)
    assert ours.shape == (256, 256, 3) and ours.dtype == np.float32
    assert float(np.abs(ours - _pil_reference(u8)).max()) <= _PIL_TOL
    np.testing.assert_allclose(ours, j_preprocess_image(u8), atol=1e-4)
    assert ours.min() >= -1.0 - 1e-6 and ours.max() <= 1.0 + 1e-6


@pytest.fixture(scope="module")
def tiny_vae():
    port = random_vae(VAEConfig(**TINY), seed=0, device="cpu")
    sd = {k: v.numpy() for k, v in port.module.state_dict().items()}
    params = params_from_torch_state_dict(sd, FlaxConfig(**TINY))
    return port, flax_loaded(FlaxVAE(FlaxConfig(**TINY)), params)


def test_vae_image_encoder_matches_flax(tiny_vae):
    """NHWC pixels -> posterior mean flattened in NCHW order, as the JAX
    package's ``encode_images`` computes it."""
    port, flax = tiny_vae
    pixels = np.random.default_rng(4).uniform(
        -1, 1, size=(3, 16, 16, 3)).astype(np.float32)
    ours = vae_image_encoder(port)(pixels)
    theirs = np.asarray(flax.encode_mean(pixels.transpose(0, 3, 1, 2)))
    assert ours.shape == (3, 4 * 8 * 8) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs.reshape(3, -1), rtol=1e-4,
                               atol=1e-5)


def test_load_hf_encoders_from_a_local_checkpoint(tiny_vae, tmp_path):
    port, _ = tiny_vae
    model_dir = tmp_path / "vae"
    model_dir.mkdir()
    cfg = dict(TINY, block_out_channels=list(TINY["block_out_channels"]))
    (model_dir / "config.json").write_text(json.dumps(cfg))
    torch.save(port.module.state_dict(),
               model_dir / "diffusion_pytorch_model.bin")
    with pytest.raises(RuntimeError, match="text encoder"):
        load_hf_encoders(str(model_dir))
    enc = load_hf_encoders(str(model_dir),
                           encode_texts=_stub_encoders([]).encode_texts,
                           device="cpu")
    pixels = np.random.default_rng(5).uniform(
        -1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(enc.encode_images(pixels),
                                  vae_image_encoder(port)(pixels))


def test_device_tables_dtype_and_row_chunks(monkeypatch):
    """``dtype`` sets the stored dtype; a bf16 table is drawn in row
    chunks of the same distribution (the unchunked f32 stream is
    unchanged)."""
    from multimodal_umap_tpu_torch.data import synthetic

    full = clustered_modalities_device(300, dims=(6, 5), seed=3,
                                       device="cpu")
    again = clustered_modalities_device(300, dims=(6, 5), seed=3,
                                        device="cpu")
    monkeypatch.setattr(synthetic, "ROW_CHUNK", 64)
    chunked = clustered_modalities_device(300, dims=(6, 5), seed=3,
                                          device="cpu",
                                          dtype=torch.bfloat16)
    for name in full:
        assert torch.equal(full[name], again[name])
        assert chunked[name].dtype == torch.bfloat16
        assert tuple(chunked[name].shape) == tuple(full[name].shape)
        # Same cluster geometry: per-modality means agree to noise level.
        diff = chunked[name].float().mean(0) - full[name].mean(0)
        assert float(diff.abs().max()) < 0.5
