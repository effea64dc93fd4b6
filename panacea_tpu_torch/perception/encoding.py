"""Positional encodings and the MLN modulations of the SparseHead.

Counterpart of ``panacea_tpu/perception/encoding.py`` (reference
positional_encoding.py:14-61, misc.py:178-213, detr3d_transformer.py:24-56).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _sine_emb(pos: torch.Tensor, num_pos_feats: int, temperature: float) -> torch.Tensor:
    """(...) -> (..., num_pos_feats): sin of the even and cos of the odd
    bands of pos / dim_t, interleaved."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    p = pos[..., None] / dim_t
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).flatten(-2)


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000) -> torch.Tensor:
    """(..., 3) in [0, 1] -> (..., 3 num_pos_feats), in the order (y, x, z)."""
    pos = pos * (2 * math.pi)
    ex, ey, ez = (_sine_emb(pos[..., i], num_pos_feats, temperature) for i in range(3))
    return torch.cat([ey, ex, ez], dim=-1)


def pos2posemb1d(pos: torch.Tensor, num_pos_feats: int = 256,
                 temperature: float = 10000) -> torch.Tensor:
    return _sine_emb(pos[..., 0] * (2 * math.pi), num_pos_feats, temperature)


def nerf_positional_encoding(x: torch.Tensor, num_encoding_functions: int = 6) -> torch.Tensor:
    """(..., D) -> (..., 2 F D): [sin(f x), cos(f x)] per frequency f = 2^i,
    the reference's order (positional_encoding.py:73-75)."""
    bands = 2.0 ** torch.linspace(0.0, num_encoding_functions - 1, num_encoding_functions,
                                  device=x.device)
    xb = x[..., None, :] * bands[:, None]                      # (..., F, D)
    return torch.stack([xb.sin(), xb.cos()], dim=-2).flatten(-3)


class MLNv2(nn.Module):
    """Latent modulation without a LayerNorm: y = gamma(c) x + beta(c)
    (detr3d_transformer.py:24-56). ``gamma`` starts at weight 0, bias 1 and
    ``beta`` at 0, so a fresh module is the identity."""

    def __init__(self, c_dim: int, f_dim: int = 256):
        super().__init__()
        self.reduce = nn.Sequential(nn.Linear(c_dim, f_dim), nn.ReLU())
        self.gamma = nn.Linear(f_dim, f_dim)
        self.beta = nn.Linear(f_dim, f_dim)

    def gamma_beta(self, c: torch.Tensor):
        h = self.reduce(c)
        return self.gamma(h), self.beta(h)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.gamma_beta(c)
        return gamma * x + beta


class MLN(MLNv2):
    """y = gamma(c) LN(x) + beta(c), the LayerNorm without an affine part
    (misc.py:178-213)."""

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.gamma_beta(c)
        return gamma * F.layer_norm(x, x.shape[-1:], eps=1e-5) + beta
