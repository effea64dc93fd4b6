"""AutoencoderKL, the frozen first stage (counterpart of
``panacea_tpu/models/vae.py``; reference sgm/models/autoencoder.py:126-374
and sgm/modules/diffusionmodules/model.py:479-1010).

Channels-last (N, H, W, C). It runs in fp32 whatever the UNet's dtype
(the reference disables autocast for the first stage). Attention in the
middle blocks and, in the encoder, after each block of a level whose
resolution is in ``attn_resolutions`` (the JAX decoder has none there),
through the port's attention dispatch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.models.layers import Conv2d, GroupNorm
from panacea_tpu_torch.ops.attention import attention, merge_heads, split_heads


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out, 3, padding=1)
        self.norm2 = GroupNorm(out, eps=1e-6)
        self.conv2 = Conv2d(out, out, 3, padding=1)
        if out != in_channels:
            self.nin_shortcut = Conv2d(in_channels, out, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (model.py:417-478)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        n, h, w, c = x.shape
        hh = self.norm(x)
        q, k, v = (split_heads(m(hh).reshape(n, h * w, c), 1) for m in (self.q, self.k, self.v))
        out = merge_heads(attention(q, k, v)).reshape(n, h, w, c)
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` (one per block at the
    encoder's ``attn_resolutions``, else empty) and the resampling conv."""

    def __init__(self, blocks, resample: Optional[str], channels: int, attn: bool = False):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList([AttnBlock(channels) for _ in blocks] if attn else [])
        if resample is not None:
            setattr(self, resample, nn.Module())
            getattr(self, resample).conv = Conv2d(
                channels, channels, 3, stride=2 if resample == "downsample" else 1,
                padding=0 if resample == "downsample" else 1)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4,
                 double_z=True, in_channels=3, attn_resolutions=(), resolution=256):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        res = resolution
        for lv, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            last = lv == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else "downsample", cin,
                                    attn=res in attn_resolutions))
            res //= 2
        self.mid = _Mid(cin)
        self.norm_out = GroupNorm(cin, eps=1e-6)
        self.conv_out = Conv2d(cin, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                # asymmetric (0, 1) pad, then a stride-2 conv (model.py:727-739)
                h = level.downsample.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4,
                 out_ch=3):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin)
        levels = {}
        for lv in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, ch * ch_mult[lv]))
                cin = ch * ch_mult[lv]
            levels[lv] = _Level(blocks, "upsample" if lv != 0 else None, cin)
        self.up = nn.ModuleList([levels[lv] for lv in range(len(ch_mult))])
        self.norm_out = GroupNorm(cin, eps=1e-6)
        self.conv_out = Conv2d(cin, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
                h = level.upsample.conv(h.permute(0, 2, 3, 1))
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """KL autoencoder with quant convs (autoencoder.py:333-368)."""

    def __init__(self, embed_dim: int = 4, ddconfig: Optional[dict] = None, monitor=None):
        super().__init__()
        dd = dict(ddconfig or {})
        z = dd.get("z_channels", 4)
        common = dict(ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                      num_res_blocks=dd.get("num_res_blocks", 2), z_channels=z)
        self.encoder = Encoder(double_z=dd.get("double_z", True),
                               in_channels=dd.get("in_channels", 3),
                               attn_resolutions=tuple(dd.get("attn_resolutions", ())),
                               resolution=dd.get("resolution", 256), **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", 3), **common)
        self.quant_conv = Conv2d((2 if dd.get("double_z", True) else 1) * z, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, z, 1)
        self.embed_dim = embed_dim
        self.downsample = 2 ** (len(common["ch_mult"]) - 1)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A posterior sample drawn with ``generator`` (autoencoder.py:371-374)
        or with the given standard normals ``noise``; the posterior mean
        without either."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        if generator is None and noise is None:
            return mean
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        return mean + std * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


class AutoencoderKLInferenceWrapper(AutoencoderKL):
    """Alias for config parity (autoencoder.py:371-374)."""
