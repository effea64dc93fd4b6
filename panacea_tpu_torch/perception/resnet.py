"""ResNet-50 backbone of the eval detector (NCHW).

Counterpart of ``panacea_tpu/perception/resnet.py``: the mmdet ResNet of
the reference eval config (streampetr_r50_atss_512x256_window.py:46-55),
depth 50, out_indices (0, 1, 2, 3), batch norm in eval mode on its stored
statistics. Keys are mmdet's: ``conv1``, ``bn1``, ``layer{s}.{i}.conv{1,2,3}``,
``layer{s}.{i}.bn{1,2,3}``, ``layer{s}.0.downsample.{0,1}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Batch norm on stored statistics: (x - running_mean) weight /
    sqrt(running_var + eps) + bias, per channel of dim 1, for any number of
    trailing dims."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


class Bottleneck(nn.Module):
    """The 'pytorch-style' bottleneck: the stride on the 3x3."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                                         FrozenBatchNorm(out_ch)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class ResNet50(nn.Module):
    """(N, 3, H, W) -> the four stage outputs C2..C5, strides 4/8/16/32."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, planes = 64, 64
        for si, n_blocks in enumerate(stage_blocks):
            blocks = []
            for bi in range(n_blocks):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                blocks.append(Bottleneck(in_ch, planes, stride, downsample=bi == 0))
                in_ch = planes * 4
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = F.relu(self.bn1(self.conv1(x)))
        # padding 1 of -inf, as the reference's max pool pads
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for si in range(self.num_stages):
            h = getattr(self, f"layer{si + 1}")(h)
            outs.append(h)
        return tuple(outs)
