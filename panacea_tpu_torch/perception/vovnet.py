"""VoVNetV2 backbone (NCHW), the StreamPETR paper's main backbone.

Counterpart of ``panacea_tpu/perception/vovnet.py`` (reference
models/backbones/vovnet.py, vovnetcp.py): a three-convolution stem, then
four stages of OSA blocks (one-shot aggregation: a chain of 3 x 3
convolutions whose outputs are concatenated with the block's input and
compressed by a 1 x 1 convolution), each block gated by an effective
squeeze-excite (eSE) and, after the first of its stage, added to its input.
V2-99 by default. ``use_checkpoint`` (VoVNetCP) recomputes each block in
the backward pass while training.

Keys are mmdet's, as ``panacea_tpu/utils/convert.py:963-1002``
(``build_vovnet_mapping``) names them: ``stem.stem_{k}/conv``,
``stage{s}.OSA{s}_{b}.layers.{i}.OSA{s}_{b}_{i}/conv`` and ``/norm``,
``...concat.OSA{s}_{b}_concat/conv``, ``...ese.fc``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from panacea_tpu_torch.perception.resnet import FrozenBatchNorm

# V2-99: stage conv channels, concat channels, blocks a stage, convs a block
V99_STAGE_CH = (128, 160, 192, 224)
V99_CONCAT_CH = (256, 512, 768, 1024)
V99_BLOCKS = (1, 3, 9, 3)
V99_LAYERS = 5


def conv_bn_relu(name: str, cin: int, cout: int, kernel: int = 3, stride: int = 1):
    """``{name}/conv`` (no bias), ``{name}/norm`` (frozen) and ``{name}/relu``."""
    return nn.Sequential(OrderedDict([
        (f"{name}/conv", nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)),
        (f"{name}/norm", FrozenBatchNorm(cout)),
        (f"{name}/relu", nn.ReLU())]))


class ESE(nn.Module):
    """Effective squeeze-excite: the spatial mean, a 1 x 1 convolution and
    the hard sigmoid clip(g + 3, 0, 6) / 6 as the channel gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.clamp(g + 3.0, 0.0, 6.0) / 6.0)


class OSABlock(nn.Module):
    def __init__(self, cin: int, stage_ch: int, concat_ch: int, num_layers: int, name: str,
                 identity: bool = False):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList(
            conv_bn_relu(f"{name}_{i}", cin if i == 0 else stage_ch, stage_ch)
            for i in range(num_layers))
        self.concat = conv_bn_relu(f"{name}_concat", cin + num_layers * stage_ch, concat_ch, 1)
        self.ese = ESE(concat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, h = [x], x
        for layer in self.layers:
            h = layer(h)
            outs.append(h)
        h = self.ese(self.concat(torch.cat(outs, dim=1)))
        return h + x if self.identity else h


class VoVNet(nn.Module):
    """(N, 3, H, W) -> the four stage outputs, strides 4/8/16/32."""

    def __init__(self, stage_ch: Sequence[int] = V99_STAGE_CH,
                 concat_ch: Sequence[int] = V99_CONCAT_CH,
                 num_blocks: Sequence[int] = V99_BLOCKS, num_layers: int = V99_LAYERS,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.out_channels = tuple(concat_ch)
        self.stem = nn.Sequential(OrderedDict(
            item for k, cin, cout, stride in ((1, 3, 64, 2), (2, 64, 64, 1), (3, 64, 128, 2))
            for item in conv_bn_relu(f"stem_{k}", cin, cout, stride=stride).named_children()))
        cin = 128
        for si in range(4):
            s = si + 2
            stage = nn.Sequential()
            for bi in range(num_blocks[si]):
                name = f"OSA{s}_{bi + 1}"
                stage.add_module(name, OSABlock(cin, stage_ch[si], concat_ch[si], num_layers,
                                                name, identity=bi > 0))
                cin = concat_ch[si]
            self.add_module(f"stage{s}", stage)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        outs = []
        for s in range(2, 6):
            if s > 2:
                # 3 x 3, stride 2, padding 1 of -inf (flax's max_pool)
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for block in getattr(self, f"stage{s}"):
                if self.use_checkpoint and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            outs.append(x)
        return tuple(outs)
