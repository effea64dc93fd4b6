"""Temporal VAE blocks (counterpart of ``panacea_tpu/models/vae_temporal.py``;
reference model.py:79-366, 479-541).

The reference autoencoder ships video-VAE blocks that the production
``ddconfig`` does not use: temporal up- and downsampling, a temporal residual
block, a spatial residual block that carries zero-init temporal 3-D convs its
forward never calls (kept as parameters so that checkpoints map one to one),
and single-head attention along the frames.

Channels-last: spatial maps are (B*T, H, W, C); the 1-D blocks see them as
per-pixel series (B*H*W, T, C). Convolutions along T are ``Conv1d``s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.models.layers import Conv2d, GroupNorm, zero_init
from panacea_tpu_torch.ops.attention import attention


def to_time_major(x: torch.Tensor, num_frames: int):
    """(B*T, H, W, C) -> (B*H*W, T, C) and (B, H, W)."""
    bt, h, w, c = x.shape
    b = bt // num_frames
    y = x.reshape(b, num_frames, h, w, c).permute(0, 2, 3, 1, 4)
    return y.reshape(b * h * w, num_frames, c), (b, h, w)


def from_time_major(y: torch.Tensor, shape) -> torch.Tensor:
    b, h, w = shape
    t, c = y.shape[1], y.shape[-1]
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).reshape(b * t, h, w, c)


def conv_t(conv: nn.Conv1d, y: torch.Tensor) -> torch.Tensor:
    """A Conv1d along T of (N, T, C) series."""
    return conv(y.transpose(1, 2)).transpose(1, 2)


class Upsample1D(nn.Module):
    """Nearest 2x along the frames, then an optional k=3 temporal conv
    (model.py:79-97)."""

    def __init__(self, in_channels: int, with_conv: bool = True, num_frames: int = 8):
        super().__init__()
        self.num_frames = num_frames
        self.conv = nn.Conv1d(in_channels, in_channels, 3, padding=1) if with_conv else None

    def forward(self, x):
        y, shape = to_time_major(x, self.num_frames)
        y = y.repeat_interleave(2, dim=1)
        if self.conv is not None:
            y = conv_t(self.conv, y)
        return from_time_major(y, shape)


class Downsample1D(nn.Module):
    """A stride-2 temporal conv after an asymmetric (0, 1) pad, or the mean
    of frame pairs (model.py:117-138)."""

    def __init__(self, in_channels: int, with_conv: bool = True, num_frames: int = 8):
        super().__init__()
        self.num_frames = num_frames
        self.conv = nn.Conv1d(in_channels, in_channels, 3, stride=2) if with_conv else None

    def forward(self, x):
        y, shape = to_time_major(x, self.num_frames)
        if self.conv is not None:
            y = conv_t(self.conv, F.pad(y, (0, 0, 0, 1)))
        else:
            t = y.shape[1]
            y = y[:, : t - t % 2].reshape(y.shape[0], t // 2, 2, -1).mean(2)
        return from_time_major(y, shape)


def _shortcut(cin: int, cout: int, use_conv_shortcut: bool) -> dict:
    if cin == cout:
        return {}
    if use_conv_shortcut:
        return {"conv_shortcut": Conv2d(cin, cout, 3, padding=1)}
    return {"nin_shortcut": Conv2d(cin, cout, 1)}


class ResnetBlock1D(nn.Module):
    """Temporal residual block (model.py:199-271): norm, SiLU and a k=3
    temporal conv, twice, per pixel; ``conv1`` zero-initialised; a spatial
    1x1 (or 3x3) shortcut where the width changes."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 use_conv_shortcut: bool = False, num_frames: int = 8):
        super().__init__()
        cout = out_channels or in_channels
        self.num_frames = num_frames
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = zero_init(nn.Conv1d(in_channels, cout, 3, padding=1))
        self.norm2 = GroupNorm(cout)
        self.conv2 = nn.Conv1d(cout, cout, 3, padding=1)
        for name, m in _shortcut(in_channels, cout, use_conv_shortcut).items():
            setattr(self, name, m)

    def forward(self, x):
        h, shape = to_time_major(x, self.num_frames)
        h = conv_t(self.conv1, self.norm1(h, silu=True))
        h = conv_t(self.conv2, self.norm2(h, silu=True))
        for name in ("conv_shortcut", "nin_shortcut"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return x + from_time_major(h, shape)


class ResnetBlock3D(nn.Module):
    """The VAE's ResnetBlock3D (model.py:272-366): its forward is the plain
    spatial residual block. The zero-init temporal 3-D convs and their norms
    are built and never applied, as in the reference."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 use_conv_shortcut: bool = False):
        super().__init__()
        cout = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        for i in (1, 2):   # dead temporal towers
            setattr(self, f"conv{i}_temporal_norm", GroupNorm(cout))
            setattr(self, f"conv{i}_temporal", zero_init(nn.Conv3d(cout, cout, 3, padding=1)))
        for name, m in _shortcut(in_channels, cout, use_conv_shortcut).items():
            setattr(self, name, m)
            k = 3 if name == "conv_shortcut" else 1
            setattr(self, f"{name}_temporal", zero_init(nn.Conv3d(cout, cout, k, padding=k // 2)))

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        for name in ("conv_shortcut", "nin_shortcut"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return x + h


class AttnBlockTemporal(nn.Module):
    """MemoryEfficientAttnBlockTemporal (model.py:479-541): single-head
    self-attention along the frames of each pixel, k=1 conv q/k/v/out."""

    def __init__(self, in_channels: int, num_frames: int = 8):
        super().__init__()
        self.num_frames = num_frames
        self.norm = GroupNorm(in_channels)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, nn.Conv1d(in_channels, in_channels, 1))

    def forward(self, x):
        y, shape = to_time_major(x, self.num_frames)
        h = self.norm(y)
        q, k, v = (conv_t(getattr(self, n), h)[:, :, None, :] for n in ("q", "k", "v"))
        out = conv_t(self.proj_out, attention(q, k, v)[:, :, 0])
        return from_time_major(y + out, shape)
