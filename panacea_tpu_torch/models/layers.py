"""UNet building blocks (counterpart of ``panacea_tpu/models/layers.py``).

Activations are channels-last, (N, H, W, C) with N = B*T flattened frames,
as in the JAX package. Convolutions take a permuted view, so on the card
cuDNN sees a channels-last tensor and nothing is copied. GroupNorm and
TemporalGroupNorm reduce in fp32 whatever the compute dtype. Submodule and
parameter names are the reference checkpoint's
(sgm/modules/diffusionmodules/openaimodel.py:106-542).

Under a sharded context (``parallel/shardctx.py``: this rank holds 1/t of
the frames and 1/V of the panorama's columns) the convolutions take a
column halo from the neighbouring view ranks, GroupNorm shares its
statistics over the view group, TemporalGroupNorm over the frame group,
and TemporalConv takes a frame halo. Without it they run as before.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.parallel import shardctx


def zero_init(module: nn.Module) -> nn.Module:
    """Mark a module whose parameters start at zero (``init_weights``)."""
    module.zero_init = True
    return module


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channels-last (N, H, W, C) tensors. Sharded over
    view ranks, a convolution wider than one column takes a halo of its
    width padding from the neighbours (zeros at the panorama's ends) and
    pads only the height; a stride-2 one needs an even slab."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = shardctx.current()
        if g is None or g.view == 1 or self.kernel_size[1] == 1:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        pw, sw = self.padding[1], self.stride[1]
        if self.kernel_size[1] != 2 * pw + 1 or (sw > 1 and x.shape[2] % sw):
            raise ValueError(f"Conv2d {self.kernel_size} stride {self.stride} padding "
                             f"{self.padding} on a slab {x.shape[2]} columns wide: no halo form")
        xh = shardctx.halo_w(x, pw).permute(0, 3, 1, 2)
        out = F.conv2d(xh, self.weight, self.bias, self.stride, (self.padding[0], 0),
                       self.dilation, self.groups)
        return out.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """GroupNorm(32) over the last (channel) axis with an fp32 reduction;
    ``silu=True`` applies the SiLU that follows most norms in the same pass
    (layers.py:25-56). Widths not divisible by 32 (tiny test configs) use
    one group per channel, as the JAX module does."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups if channels % num_groups == 0 else channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        xf = x.float().reshape(n, -1, self.num_groups, c // self.num_groups)
        g = shardctx.current()
        if g is None or g.view == 1:
            var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
            y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        else:   # the columns are split over the view group
            mean, inv = shardctx.group_stats(xf, (1, 3), "view", self.eps)
            y = ((xf - mean) * inv).reshape(x.shape)
        y = y * self.weight.float() + self.bias.float()
        return (F.silu(y) if silu else y).to(x.dtype)


class TemporalGroupNorm(GroupNorm):
    """GroupNorm in the reference's temporal layout (layers.py:59-108): the
    reference normalises a (b*h*w, C, T) view, so the statistics are taken
    per pixel over (frames x channel group), not over space."""

    def __init__(self, channels: int, num_frames: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__(channels, num_groups, eps)
        self.num_frames = num_frames

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        n, h, w, c = x.shape
        t, g = shardctx.local_frames(self.num_frames), self.num_groups
        xf = x.float().reshape(n // t, t, h * w, g, c // g)
        grid = shardctx.current()
        if grid is None or grid.t == 1:
            var, mean = torch.var_mean(xf, dim=(1, 4), keepdim=True, correction=0)
            y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        else:   # the frames are split over the t group
            mean, inv = shardctx.group_stats(xf, (1, 4), "t", self.eps)
            y = ((xf - mean) * inv).reshape(x.shape)
        y = y * self.weight.float() + self.bias.float()
        return (F.silu(y) if silu else y).to(x.dtype)


class TemporalConv(nn.Conv1d):
    """Zero-initialised k=3 convolution over the frame axis (layers.py:157-232).

    The parameters are the reference Conv1d's, weight (C_out, C_in, k); the
    JAX module stores (k, C_in, C_out) (convert.py:33). The frame axis of the
    (B*T, H, W, C) activation becomes the height of one 2-D convolution with
    a (k, 1) window over (B, C, T, H*W), so nothing is transposed.
    """

    def __init__(self, channels: int, num_frames: int, kernel_size: int = 3):
        super().__init__(channels, channels, kernel_size)
        self.num_frames = num_frames
        zero_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        t = shardctx.local_frames(self.num_frames)
        k = self.kernel_size[0]
        xb = x.reshape(n // t, t, h * w, c)
        grid = shardctx.current()
        if grid is None or grid.t == 1:
            pad = k // 2
        else:   # the neighbouring frame ranks' edge frames, zeros at the clip's ends
            xb, pad = shardctx.halo_t(xb, k // 2), 0
        out = F.conv2d(xb.permute(0, 3, 1, 2), self.weight.unsqueeze(-1), self.bias,
                       padding=(pad, 0))
        return out.permute(0, 2, 3, 1).reshape(n, h, w, c)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of (N, H, W, C), each pixel repeated."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def downsample_avg(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of (N, H, W, C), stride 2 (flax ``nn.avg_pool``)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv (openaimodel.py:106-142)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class Downsample(nn.Module):
    """3x3 stride-2 conv (openaimodel.py:167-203)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.op = Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class ResBlock3D(nn.Module):
    """Residual block with a zero-init temporal conv after each spatial conv
    (layers.py:235-291, openaimodel.py:356-542). With ``up`` or ``down``
    (the reference's in-block resampling) the normalised ``h`` and the skip
    input ``x`` are resampled without a conv (nearest 2x, or a 2x2 average)
    before the first conv, and the first temporal sub-block is left out.

    The ``nn.SiLU``/``nn.Dropout`` entries only keep the reference's indices
    (``in_layers.2``, ``out_layers.3``, ...); the norms apply SiLU themselves.
    """

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, num_frames: int = 8,
                 use_conv: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        out = out_channels or channels
        self.resample = upsample_nearest if up else downsample_avg if down else None
        self.in_layers = nn.ModuleList(
            [GroupNorm(channels), nn.SiLU(), Conv2d(channels, out, 3, padding=1)])
        if self.resample is None:
            self.in_layers_temporal = nn.ModuleList(
                [TemporalGroupNorm(out, num_frames), nn.SiLU(), TemporalConv(out, num_frames)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(emb_channels, out)])
        self.out_layers = nn.ModuleList(
            [GroupNorm(out), nn.SiLU(), nn.Dropout(0.0),
             zero_init(Conv2d(out, out, 3, padding=1))])
        self.out_layers_temporal = nn.ModuleList(
            [TemporalGroupNorm(out, num_frames), nn.SiLU(), nn.Dropout(0.0),
             TemporalConv(out, num_frames)])
        if out == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv2d(channels, out, 3, padding=1)
        else:
            self.skip_connection = Conv2d(channels, out, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x, silu=True)
        if self.resample is not None:
            h, x = self.resample(h), self.resample(x)
            h = self.in_layers[2](h)
        else:
            h = self.in_layers[2](h)
            h = h + self.in_layers_temporal[2](self.in_layers_temporal[0](h, silu=True))
        h = h + self.emb_layers[1](F.silu(emb))[:, None, None, :].to(h.dtype)
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        h = h + self.out_layers_temporal[3](self.out_layers_temporal[0](h, silu=True))
        return self.skip_connection(x) + h
