"""FPN neck of the eval detector (NCHW).

Counterpart of ``panacea_tpu/perception/fpn.py`` (config
streampetr_r50_atss_512x256_window.py:56-62): inputs from ``start_level``
1, 256 channels out, 5 levels with the extra convolutions on the last
output (strides 8/16/32/64/128). Keys ``lateral_convs.{i}.conv`` and
``fpn_convs.{i}.conv``, mmdet's ConvModule names.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


class ConvModule(nn.Module):
    """mmcv's ConvModule without norm or activation: only ``.conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, start_level: int = 1, num_outs: int = 5):
        super().__init__()
        self.start_level, self.num_outs = start_level, num_outs
        ins = list(in_channels[start_level:])
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in ins)
        convs = [ConvModule(out_channels, out_channels, 3) for _ in ins]
        convs += [ConvModule(out_channels, out_channels, 3, stride=2)
                  for _ in range(len(ins), num_outs)]
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, inputs[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            # nearest x2 by repetition, cropped to the lower level's size
            h, w = laterals[i - 1].shape[-2:]
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        for conv in self.fpn_convs[len(laterals):]:
            outs.append(conv(outs[-1]))
        return tuple(outs)
