"""I3D (inflated Inception-V1) video feature extractor for FVD (NCTHW).

Counterpart of ``panacea_tpu/metrics_gen/i3d.py``: the inflated GoogLeNet
topology to (N, 1024) pooled features, and with ``return_logits`` the
400-way logits. It follows the JAX module, not pytorch-i3d:
  * every ``Unit3D`` pads its convolution symmetrically by ``k // 2`` on
    each axis (pytorch-i3d pads as TF's SAME, asymmetrically: ROADMAP
    Queue C), then batch norm on stored statistics with eps 1e-3 and a ReLU;
  * the max pools with padding pad with -inf, as ``max_pool3d`` does.
State-dict names are pytorch-i3d's (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_4b.b3b.bn.weight``, ``logits.conv3d.bias``), the reference names
of ``build_i3d_mapping``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.resnet import FrozenBatchNorm

MIN_FRAMES = 8


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
                 act: bool = True):
        super().__init__()
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride=stride,
                                padding=tuple(k // 2 for k in kernel), bias=not use_bn)
        self.bn = FrozenBatchNorm(cout, eps=1e-3) if use_bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class InceptionModule3D(nn.Module):
    def __init__(self, cin: int, b0: int, b1a: int, b1b: int, b2a: int, b2b: int, b3: int):
        super().__init__()
        self.b0 = Unit3D(cin, b0)
        self.b1a = Unit3D(cin, b1a)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(cin, b2a)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3b = Unit3D(cin, b3)

    def forward(self, x):
        o3 = F.max_pool3d(x, 3, stride=1, padding=1)
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(o3)], dim=1)


# (name, cin, b0, b1a, b1b, b2a, b2b, b3); each output has b0 + b1b + b2b + b3 channels
MIXED: Sequence[Tuple[str, int, int, int, int, int, int, int]] = (
    ("Mixed_3b", 192, 64, 96, 128, 16, 32, 32),
    ("Mixed_3c", 256, 128, 128, 192, 32, 96, 64),
    ("Mixed_4b", 480, 192, 96, 208, 16, 48, 64),
    ("Mixed_4c", 512, 160, 112, 224, 24, 64, 64),
    ("Mixed_4d", 512, 128, 128, 256, 24, 64, 64),
    ("Mixed_4e", 512, 112, 144, 288, 32, 64, 64),
    ("Mixed_4f", 528, 256, 160, 320, 32, 128, 128),
    ("Mixed_5b", 832, 256, 160, 320, 32, 128, 128),
    ("Mixed_5c", 832, 384, 192, 384, 48, 128, 128),
)


class I3D(nn.Module):
    """(N, 3, T, H, W) in [-1, 1], T >= 8 -> (N, 1024) features, and with
    ``return_logits`` also the (N, num_classes) logits."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.num_classes = num_classes
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, *widths in MIXED:
            self.add_module(name, InceptionModule3D(*widths))
        self.logits = Unit3D(1024, num_classes, use_bn=False, act=False)

    def forward(self, x: torch.Tensor, return_logits: bool = False):
        # three temporal stride-2 stages: fewer frames collapse the frame
        # axis to nothing (NaN features)
        if x.shape[2] < MIN_FRAMES:
            raise ValueError(f"I3D needs >= {MIN_FRAMES} frames, got {x.shape[2]}")
        x = self.Conv3d_1a_7x7(x)
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = F.max_pool3d(x, 3, stride=2, padding=1)
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = F.max_pool3d(x, 2, stride=2)
        x = self.Mixed_5c(self.Mixed_5b(x))
        pooled = x.mean(dim=(2, 3, 4), keepdim=True)
        feats = pooled.flatten(1)
        if return_logits:
            return feats, self.logits(pooled).reshape(x.shape[0], self.num_classes)
        return feats
