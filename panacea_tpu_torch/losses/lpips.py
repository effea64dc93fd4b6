"""LPIPS perceptual distance (NCHW).

Counterpart of ``panacea_tpu/losses/lpips.py`` (reference
sgm/modules/autoencoding/lpips/loss/lpips.py:1-147): the VGG16 convolution
stack up to relu5_3, its five taps (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3) each normalised to unit length over the channels, the squared
difference weighted by a 1 x 1 head per tap, averaged over space and summed
over the taps.

State-dict names are the reference lpips module's, as
``build_vgg16_lpips_mapping(naming="lpips")`` names them: the convolutions
at ``net.slice{s}.{i}`` (``i`` torchvision's index in ``vgg16.features``),
the heads at ``lin{k}.model.1.weight``. The reference's ``model.0`` is a
Dropout that the eval-mode loss never applies; here, as in the JAX module,
it is an identity. The shift and scale of the input are constants, not
state.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

# channels of the 5 taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG_TAPS = (64, 128, 256, 512, 512)
# (channels, convolutions) of each slice
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# ImageNet scaling of lpips, in [-1, 1] space
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision's ``vgg16.features[:30]`` cut into lpips's five slices;
    ``forward`` returns the five taps."""

    def __init__(self):
        super().__init__()
        idx, cin = 0, 3
        for s, (ch, n) in enumerate(_VGG_BLOCKS, start=1):
            sl = nn.Sequential()
            if s > 1:
                sl.add_module(str(idx), nn.MaxPool2d(2, 2))
                idx += 1
            for _ in range(n):
                sl.add_module(str(idx), nn.Conv2d(cin, ch, 3, padding=1))
                sl.add_module(str(idx + 1), nn.ReLU())
                idx, cin = idx + 2, ch
            setattr(self, f"slice{s}", sl)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s in range(1, 6):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """The 1 x 1 head of one tap, under ``model.1``."""

    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length over the channel axis (dim 1): x / (|x| + eps)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """d(x, y) for images (N, 3, H, W) in [-1, 1]; returns (N, 1, 1, 1)."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, ch in enumerate(VGG_TAPS):
            setattr(self, f"lin{k}", NetLinLayer(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        taps = self.net((torch.cat([x, y]) - self.shift) / self.scale)
        total = 0.0
        for k, f in enumerate(taps):
            d = (normalize_tensor(f[:n]) - normalize_tensor(f[n:])) ** 2
            total = total + getattr(self, f"lin{k}")(d).mean(dim=(2, 3), keepdim=True)
        return total
