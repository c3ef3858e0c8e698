"""AutoencoderKL (Stable Diffusion VAE architecture) in PyTorch.

Counterpart of ``multimodal_umap_tpu/nn/vae.py`` in NCHW, with
diffusers' parameter names (``encoder.down_blocks.{i}.resnets.{j}.
conv1.weight``, ``decoder.mid_block.attentions.0.to_q.weight``, ...), so
a diffusers ``AutoencoderKL`` state dict loads with
``load_state_dict(strict=True)`` and the JAX package's
``params_from_torch_state_dict`` reads this module's ``state_dict()``.

Architecture (``DownEncoderBlock2D`` / ``UpDecoderBlock2D`` blocks; the
``stabilityai/sd-vae-ft-mse`` widths are :class:`VAEConfig`'s defaults):

  encoder: conv_in 3x3 -> down blocks (ResNet x layers_per_block, then a
           stride-2 conv after an asymmetric (0, 1) pad between blocks)
           -> mid block (ResNet, single-head spatial self-attention,
           ResNet) -> GroupNorm/SiLU/conv_out -> 2*latent channels ->
           quant_conv 1x1; the posterior mean is the first half.
  decoder: post_quant_conv 1x1 -> conv_in 3x3 -> mid block -> up blocks
           (ResNet x (layers_per_block+1), then nearest 2x upsample +
           conv 3x3 between blocks) -> GroupNorm/SiLU/conv_out.

Convolutions and the attention are plain PyTorch calls (the JAX package
leaves them to XLA: no Pallas kernel replaces them), run in float32
without TF32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import typing

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

_GN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32

    @classmethod
    def from_json(cls, path: str) -> "VAEConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            in_channels=raw.get("in_channels", 3),
            out_channels=raw.get("out_channels", 3),
            block_out_channels=tuple(
                raw.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=raw.get("layers_per_block", 2),
            latent_channels=raw.get("latent_channels", 4),
            norm_num_groups=raw.get("norm_num_groups", 32),
        )


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv3x3, twice, with a 1x1 shortcut when the
    channel count changes (diffusers ResnetBlock2D, output scale 1)."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=_GN_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=_GN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over the H*W positions with a residual
    connection (diffusers Attention as the VAE mid block uses it)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=_GN_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / c ** 0.5,
                             dim=-1)
        h = self.to_out[0](torch.matmul(attn, v))
        return x + h.transpose(1, 2).reshape(b, c, hh, ww)


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, groups),
                                      ResnetBlock(channels, channels, groups)])
        self.attentions = nn.ModuleList([AttentionBlock(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    """Holder of the ``conv`` of a down- or upsampler (diffusers'
    ``downsamplers.0.conv`` / ``upsamplers.0.conv`` names)."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(cin if j == 0 else cout, cout, groups)
            for j in range(layers)])
        self.downsamplers = nn.ModuleList(
            [_Sampler(nn.Conv2d(cout, cout, 3, stride=2))] if downsample
            else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d.conv(F.pad(x, (0, 1, 0, 1)))  # asymmetric (0, 1) pad
        return x


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(cin if j == 0 else cout, cout, groups)
            for j in range(layers + 1)])
        self.upsamplers = nn.ModuleList(
            [_Sampler(nn.Conv2d(cout, cout, 3, padding=1))] if upsample
            else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                      cfg.norm_num_groups, i < len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], cfg.norm_num_groups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[-1],
                                          eps=_GN_EPS)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0], cfg.norm_num_groups)
        self.up_blocks = nn.ModuleList([
            UpBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                    cfg.norm_num_groups, i < len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[-1],
                                          eps=_GN_EPS)
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """Encoder + decoder + quant convs; NCHW in and out."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def encode_moments(self, x):
        """(B, C, H, W) -> (mean, logvar), each (B, latent, h, w)."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_mean(self, x):
        """Posterior mean: the reference's deterministic image feature."""
        return self.encode_moments(x)[0]

    def decode(self, z):
        """(B, latent, h, w) -> (B, C, H, W) sample."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode_mean(x))


class LoadedVAE(typing.NamedTuple):
    """A ready-to-use VAE: NCHW encode-mean and decode that take numpy
    arrays or tensors and return float32 tensors on the module's
    device."""

    module: AutoencoderKL
    encode_mean: typing.Callable
    decode: typing.Callable


def make_loaded_vae(module: AutoencoderKL) -> LoadedVAE:
    """Wraps a module into its NCHW entry points: inference mode, float32,
    cuDNN convolutions without TF32 (PyTorch's float32 matmuls already
    run without it)."""
    module.eval()
    device = next(module.parameters()).device

    def entry(method):
        def fn(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x, dtype=np.float32))
            with torch.inference_mode(), torch.backends.cudnn.flags(
                    enabled=True, allow_tf32=False):
                return method(x.to(device, torch.float32))
        return fn

    return LoadedVAE(module, entry(module.encode_mean), entry(module.decode))


def random_vae(config: VAEConfig = VAEConfig(), seed: int = 0,
               device: torch.device | str | None = None) -> LoadedVAE:
    """A VAE at ``config``'s widths with PyTorch's default initialization
    drawn on the CPU from ``seed`` (the same weights on every device),
    moved to ``device``. The caller's random state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        module = AutoencoderKL(config)
    return make_loaded_vae(module.to(resolve_device(device)))


_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Reads a ``.safetensors`` file by its documented layout: an 8-byte
    little-endian header length, a JSON header mapping each name to its
    dtype, shape and [begin, end) byte offsets, then the raw
    little-endian buffers."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        blob = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        begin, end = info["data_offsets"]
        buf = bytearray(blob[begin:end])
        t = (torch.frombuffer(buf, dtype=_ST_DTYPES[info["dtype"]])
             if buf else torch.empty(0, dtype=_ST_DTYPES[info["dtype"]]))
        out[name] = t.reshape(info["shape"])
    return out


def _load_state_dict_file(model_dir: str) -> dict[str, torch.Tensor]:
    st_path = os.path.join(model_dir, "diffusion_pytorch_model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(model_dir, "diffusion_pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no diffusion_pytorch_model.(safetensors|bin) under {model_dir}")


def load_vae(model_dir: str,
             device: torch.device | str | None = None) -> LoadedVAE:
    """Loads a diffusers-format AutoencoderKL checkpoint directory
    (``config.json`` + ``diffusion_pytorch_model.safetensors`` or
    ``.bin``) onto ``device``. A missing file raises FileNotFoundError."""
    config = VAEConfig.from_json(os.path.join(model_dir, "config.json"))
    module = AutoencoderKL(config)
    sd = _load_state_dict_file(model_dir)
    module.load_state_dict({k: v.float() for k, v in sd.items()},
                           strict=True)
    return make_loaded_vae(module.to(resolve_device(device)))


_VAE_NAME = "stabilityai/sd-vae-ft-mse"


def resolve_vae_dir(name_or_dir: str = _VAE_NAME) -> str:
    """A VAE checkpoint location as a local directory: the
    ``MMUMAP_VAE_DIR`` override, else ``name_or_dir`` when it is a
    directory. There is no hub download: anything else raises
    FileNotFoundError."""
    override = os.environ.get("MMUMAP_VAE_DIR")
    if override:
        return override
    if os.path.isdir(name_or_dir):
        return name_or_dir
    raise FileNotFoundError(
        f"no local VAE checkpoint {name_or_dir!r} and MMUMAP_VAE_DIR is "
        f"not set (this package downloads nothing)")
