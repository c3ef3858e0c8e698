"""PyTorch port: the SD-VAE against the Flax AutoencoderKL, its
checkpoint loader, and the text->image recon app.

The port's ``AutoencoderKL`` at a tiny configuration runs the Flax
module given ``params_from_torch_state_dict(port.state_dict())``: encode
and decode agree at rtol 1e-4 / atol 1e-5 (float32 convolutions summed
in another order; the Flax parity test's tolerance). Parameter names are
diffusers': the independent torch mirror of tests/test_flax_torch_parity
loads into the port with ``strict=True``. PNGs the app writes decode
back exactly to the uint8 images of the port's own decode.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.torch import save_file

from multimodal_umap_tpu.app import crossmodal_recon as j_crossmodal_recon
from multimodal_umap_tpu.models.mixture import MultimodalUMAP as JModel
from multimodal_umap_tpu.nn.vae import AutoencoderKL as FlaxVAE
from multimodal_umap_tpu.nn.vae import VAEConfig as FlaxConfig
from multimodal_umap_tpu.nn.vae import (
    make_loaded_vae as flax_loaded,
    params_from_torch_state_dict,
)
from multimodal_umap_tpu_torch import Config
from multimodal_umap_tpu_torch.app.crossmodal import (
    crossmodal_recon,
    to_uint8,
)
from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
from multimodal_umap_tpu_torch.nn.vae import (
    AutoencoderKL,
    VAEConfig,
    load_vae,
    random_vae,
    read_safetensors,
    resolve_vae_dir,
)

torch.set_num_threads(1)

TINY = dict(block_out_channels=(8, 16), layers_per_block=1,
            latent_channels=4, norm_num_groups=4)


@pytest.fixture(scope="module")
def tiny():
    port = random_vae(VAEConfig(**TINY), seed=0, device="cpu")
    sd = {k: v.numpy() for k, v in port.module.state_dict().items()}
    params = params_from_torch_state_dict(sd, FlaxConfig(**TINY))
    return port, flax_loaded(FlaxVAE(FlaxConfig(**TINY)), params)


@pytest.mark.parametrize("direction", ["encode_mean", "decode"])
def test_vae_matches_flax(tiny, direction):
    port, flax = tiny
    rng = np.random.default_rng(1)
    shape = (2, 3, 16, 16) if direction == "encode_mean" else (2, 4, 8, 8)
    x = rng.normal(size=shape).astype(np.float32)
    ours = getattr(port, direction)(x).numpy()
    theirs = np.asarray(getattr(flax, direction)(x))
    assert ours.shape == theirs.shape == (
        (2, 4, 8, 8) if direction == "encode_mean" else (2, 3, 16, 16))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_published_widths_and_diffusers_names():
    """sd-vae-ft-mse's widths give its 83,653,863 parameters; the torch
    mirror of the Flax parity test (diffusers names) loads strictly."""
    from test_flax_torch_parity import TorchVAE

    full = AutoencoderKL()
    assert sum(p.numel() for p in full.parameters()) == 83_653_863
    assert "encoder.down_blocks.1.downsamplers.0.conv.weight" in \
        full.state_dict()
    mirror = TorchVAE(FlaxConfig(**TINY))
    port = AutoencoderKL(VAEConfig(**TINY))
    port.load_state_dict(mirror.state_dict(), strict=True)
    z = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(port.decode(z), mirror.decode(z))


WIDE = dict(block_out_channels=(64, 128), layers_per_block=2,
            latent_channels=4, norm_num_groups=32)


@pytest.mark.parametrize("direction,widths", [
    ("encode_mean", "tiny"), ("decode", "tiny"), ("decode", "wide")])
def test_float32_matches_float64(tiny, direction, widths):
    """The float32 entry points against the same module in float64, as
    the chip smoke holds the card's decode: rtol 1e-4 and an atol of 1e-5
    per unit of the output's largest magnitude."""
    vae = tiny[0] if widths == "tiny" else random_vae(
        VAEConfig(**WIDE), seed=1, device="cpu")
    shape = (2, 3, 16, 16) if direction == "encode_mean" else (2, 4, 8, 8)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ours = getattr(vae, direction)(x).numpy()
    module = copy.deepcopy(vae.module).double()
    with torch.inference_mode():
        exact = getattr(module, direction)(
            torch.from_numpy(x).double()).numpy()
    assert ours.dtype == np.float32 and ours.shape == exact.shape
    np.testing.assert_allclose(ours, exact, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(exact).max()))


def test_random_vae_is_seeded_and_leaves_rng_alone():
    torch.manual_seed(123)
    before = torch.rand(1)
    torch.manual_seed(123)
    a = random_vae(VAEConfig(**TINY), seed=4, device="cpu")
    after = torch.rand(1)
    b = random_vae(VAEConfig(**TINY), seed=4, device="cpu")
    assert torch.equal(before, after)
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_load_vae_bin_and_safetensors(tiny, tmp_path):
    port, _ = tiny
    sd = {k: v.contiguous() for k, v in port.module.state_dict().items()}
    loaded = []
    for name, write in (
            ("diffusion_pytorch_model.bin", torch.save),
            ("diffusion_pytorch_model.safetensors", save_file)):
        d = tmp_path / name.split(".")[-1]
        d.mkdir()
        with open(d / "config.json", "w") as f:
            json.dump({**TINY, "in_channels": 3, "out_channels": 3}, f)
        write(sd, str(d / name))
        loaded.append(load_vae(str(d), device="cpu"))
    st = read_safetensors(str(tmp_path / "safetensors"
                              / "diffusion_pytorch_model.safetensors"))
    assert st.keys() == sd.keys()
    z = np.random.default_rng(2).normal(size=(2, 4, 8, 8)).astype(np.float32)
    want = port.decode(z)
    for vae in loaded:
        for k, v in vae.module.state_dict().items():
            assert torch.equal(v, sd[k]), k
        assert torch.equal(vae.decode(z), want)
    with pytest.raises(FileNotFoundError):
        load_vae(str(tmp_path))  # no config.json


def test_resolve_vae_dir_never_downloads(tmp_path, monkeypatch):
    monkeypatch.delenv("MMUMAP_VAE_DIR", raising=False)
    with pytest.raises(FileNotFoundError):
        resolve_vae_dir("no/such/checkpoint")
    assert resolve_vae_dir(str(tmp_path)) == str(tmp_path)
    monkeypatch.setenv("MMUMAP_VAE_DIR", "/elsewhere")
    assert resolve_vae_dir(str(tmp_path)) == "/elsewhere"


@pytest.fixture(scope="module")
def app_setup():
    """A small port model over (20-d text, 4x8x8 latent) pairs."""
    data = clustered_modalities(120, dims=(20, 256), n_clusters=4, seed=3)
    cfg = Config(k_neighbors=8, out_dim=4, train_epochs=40, test_epochs=8,
                 num_rep=2, lr=0.05, alpha=0.5, batch_size=32)
    model = MultimodalUMAP(8, 4, 0.1, 2, device="cpu")
    model.fit([data["texts"][:100], data["images"][:100]], epochs=40,
              num_rep=2, lr=0.05, alpha=0.5, batch_size=32)
    return model, cfg, [data["texts"][100:104], data["images"][100:104]]


def test_crossmodal_recon_writes_decoded_pairs(app_setup, tiny, tmp_path):
    port_vae, _ = tiny
    model, cfg, samples = app_setup
    out_dir = str(tmp_path / "results")
    recon = crossmodal_recon(samples, cfg, model, out_dir=out_dir,
                             latent_shape=(4, 8, 8), vae=port_vae)[0]
    assert recon.shape == (4, 256)
    assert not os.path.exists(os.path.join(out_dir, "recon_latents.npz"))

    def images(lat):
        out = port_vae.decode(lat.reshape(-1, 4, 8, 8)).numpy()
        return np.clip(out.transpose(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)

    orig, rec = images(samples[1]), images(recon)
    for i in range(4):
        png = np.asarray(Image.open(
            os.path.join(out_dir, f"recon_text_to_image_{i + 1}.png")))
        assert png.shape == (32, 16, 3)
        np.testing.assert_array_equal(
            png, to_uint8(np.concatenate([orig[i], rec[i]], axis=0)))


def test_crossmodal_recon_offline_matches_jax_keys(app_setup, tmp_path,
                                                   monkeypatch):
    """No checkpoint: both packages save the latents under the same keys
    and shapes, plus one heat-map PNG per sample."""
    model, cfg, samples = app_setup
    monkeypatch.setenv("MMUMAP_VAE_DIR", str(tmp_path / "no_weights"))
    ours = str(tmp_path / "port")
    crossmodal_recon(samples, cfg, model, out_dir=ours,
                     latent_shape=(4, 8, 8))
    state = str(tmp_path / "state.npz")
    model.save_state_dict(state)
    theirs = str(tmp_path / "jax")
    j_crossmodal_recon(samples, cfg, JModel.load_state_dict(state),
                       out_dir=theirs, latent_shape=(4, 8, 8))
    with np.load(os.path.join(ours, "recon_latents.npz")) as a, \
            np.load(os.path.join(theirs, "recon_latents.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == ["original", "recon"]
        for key in a.files:
            assert a[key].shape == b[key].shape == (4, 4, 8, 8)
        np.testing.assert_array_equal(a["original"], b["original"])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))


def test_crossmodal_recon_resolves_weights_on_model_device(
        app_setup, tiny, tmp_path, monkeypatch):
    """Without ``vae`` the app loads ``MMUMAP_VAE_DIR``'s weights onto the
    model's device (the CPU here) and decodes the same pairs as when the
    loaded VAE is passed in."""
    port_vae, _ = tiny
    model, cfg, samples = app_setup
    weights = tmp_path / "vae"
    weights.mkdir()
    with open(weights / "config.json", "w") as f:
        json.dump(TINY, f)
    torch.save(port_vae.module.state_dict(),
               str(weights / "diffusion_pytorch_model.bin"))
    monkeypatch.setenv("MMUMAP_VAE_DIR", str(weights))
    dirs = [str(tmp_path / "resolved"), str(tmp_path / "given")]
    crossmodal_recon(samples, cfg, model, out_dir=dirs[0],
                     latent_shape=(4, 8, 8))
    crossmodal_recon(samples, cfg, model, out_dir=dirs[1],
                     latent_shape=(4, 8, 8), vae=port_vae)
    for i in range(4):
        name = f"recon_text_to_image_{i + 1}.png"
        a, b = (np.asarray(Image.open(os.path.join(d, name))) for d in dirs)
        np.testing.assert_array_equal(a, b)
    assert not os.path.exists(os.path.join(dirs[0], "recon_latents.npz"))


def test_decode_error_with_loaded_vae_propagates(app_setup, tmp_path):
    model, cfg, samples = app_setup

    def broken(_):
        raise RuntimeError("decode failed")

    bad = random_vae(VAEConfig(**TINY), device="cpu")._replace(decode=broken)
    with pytest.raises(RuntimeError, match="decode failed"):
        crossmodal_recon(samples, cfg, model, out_dir=str(tmp_path),
                         latent_shape=(4, 8, 8), vae=bad)
