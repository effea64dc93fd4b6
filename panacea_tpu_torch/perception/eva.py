"""EVA-02 ViT detection backbone with its SimpleFeaturePyramid adapter.

Counterpart of ``panacea_tpu/perception/eva.py`` (reference
models/backbones/eva.py EVAViT and blocks.py): a stride-16 patch embedding
with an absolute position table, blocks of pre-LN attention (windowed on
most blocks, over the whole map on the rest) with 2D axial rotary
embeddings on q and k, a sub-LN SwiGLU MLP (``silu(w1) * w2 -> ffn_ln ->
w3``) and an optional residual bottleneck, then the adapter's four levels
at strides 4, 8, 16 and 32. With ``fusion_stage`` the CBEVAViT second pass
runs the blocks from that stage again on the sum with the activation saved
before it.

Modules carry the reference's names (``patch_embed.proj``,
``blocks.{i}.attn.q_proj``, ``q_bias``, ``v_bias``, ``mlp.w1/w2/ffn_ln/w3``,
``residual.conv1``, ``adapter.simfp_{s}.{idx}`` with detectron2's
Sequential indices and each convolution's ``.norm``), so an mmdet ``.pth``
loads by name. ``pos_embed`` is held at the working grid, ``img_size //
patch_size``, as the JAX package holds it; ``pos_embed_from_reference``
brings the reference's (1, 1 + n, C) pretrain table there as the
reference's ``get_abs_pos`` does (``F.interpolate``, bicubic,
align_corners False).

The attention is self-attention (Skv == Sq), which ``ops.attention``
routes to ``attention_sdpa``, as the JAX router keeps it on XLA. The
SwiGLU is plain linear layers, as in the JAX package. Feature maps are
channels-last inside the blocks (as the reference's) and NCHW at the
adapter's outputs.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.ops.attention import attention, merge_heads, split_heads


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B nW, ws ws, C), zero-padded to whole windows
    (blocks.py window_partition). Returns the windows and the padded grid."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hh, ww = h + ph, w + pw
    x = x.reshape(b, hh // ws, ws, ww // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c), (hh, ww)


def window_unpartition(x: torch.Tensor, ws: int, padded_hw: Tuple[int, int],
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    hh, ww = padded_hw
    b = x.shape[0] // ((hh // ws) * (ww // ws))
    x = x.reshape(b, hh // ws, ww // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, -1)[:, :out_hw[0], :out_hw[1]]


def rope_cos_sin(grid_hw: Tuple[int, int], head_dim: int, pt_seq_len: int = 16,
                 theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """The VisionRotaryEmbeddingFast tables (blocks.py:326-363) of an (H, W)
    token grid, (H W, head_dim) in float64: per-axis frequencies on half
    the head dim, each repeated twice (interleaved), the rows' in the first
    half and the columns' in the second."""
    dim_half = head_dim // 2
    base = 1.0 / (theta ** (np.arange(0, dim_half, 2)[: dim_half // 2] / dim_half))

    def axis_tab(n):
        t = np.arange(n) / n * pt_seq_len
        return np.repeat(np.einsum("i,f->if", t, base), 2, axis=-1)   # (n, dim_half)

    h, w = grid_hw
    rows = np.broadcast_to(axis_tab(h)[:, None, :], (h, w, dim_half))
    cols = np.broadcast_to(axis_tab(w)[None, :, :], (h, w, dim_half))
    full = np.concatenate([rows, cols], axis=-1).reshape(h * w, head_dim)
    return np.cos(full), np.sin(full)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., D); the rotation of the interleaved pairs (even, odd lanes;
    blocks.py rotate_half)."""
    x2 = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


class EVAAttention(nn.Module):
    """eva.py:64-134: q, k, v projections without bias, a learnable q and v
    bias (none on k), rope on q and k, the output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """x (B, N, C); cos and sin (N, D)."""
        h = self.num_heads
        q = apply_rope(split_heads(F.linear(x, self.q_proj.weight, self.q_bias), h),
                       cos[:, None], sin[:, None])
        k = apply_rope(split_heads(self.k_proj(x), h), cos[:, None], sin[:, None])
        v = split_heads(F.linear(x, self.v_proj.weight, self.v_bias), h)
        return self.proj(merge_heads(attention(q, k, v)))


class ChannelLN(nn.LayerNorm):
    """detectron2's LayerNorm over the channels of an NCHW map (eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class NormConv2d(nn.Conv2d):
    """detectron2's Conv2d with a ``norm`` after it (no bias)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelLN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class ResBottleneckBlock(nn.Module):
    """eva.py:137-232: 1x1, 3x3, 1x1 convolutions without bias, each with a
    channel LayerNorm, exact GELU between, ``norm3`` zero-initialised, the
    residual added. Takes and returns (B, H, W, C)."""

    def __init__(self, width: int):
        super().__init__()
        mid = width // 2
        self.conv1 = nn.Conv2d(width, mid, 1, bias=False)
        self.norm1 = ChannelLN(mid)
        self.act1 = nn.GELU()
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.norm2 = ChannelLN(mid)
        self.act2 = nn.GELU()
        self.conv3 = nn.Conv2d(mid, width, 1, bias=False)
        self.norm3 = ChannelLN(width)
        nn.init.zeros_(self.norm3.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.permute(0, 3, 1, 2)
        for layer in self.children():
            out = layer(out)
        return x + out.permute(0, 2, 3, 1)


class SwiGLU(nn.Module):
    """eva.py:37-61: ``w3(ffn_ln(silu(w1 x) * w2 x))``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = nn.LayerNorm(hidden, eps=1e-6)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EVABlock(nn.Module):
    """eva.py:233-310 Block: pre-LN attention over windows of
    ``window_size`` (0: the whole map), the windows padded after ``norm1``;
    the SwiGLU MLP; the optional residual bottleneck. (B, H, W, C) in and
    out."""

    def __init__(self, width: int, heads: int, window_size: int = 0,
                 mlp_ratio: float = 4 * 2 / 3, use_residual_block: bool = False,
                 pt_seq_len: int = 16):
        super().__init__()
        self.heads, self.window_size, self.pt_seq_len = heads, window_size, pt_seq_len
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = EVAAttention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = SwiGLU(width, int(width * mlp_ratio))
        self.residual = ResBottleneckBlock(width) if use_residual_block else None
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, grid_hw: Tuple[int, int], head_dim: int, like: torch.Tensor):
        """The rope tables of ``grid_hw`` in ``like``'s type and device, built
        in float64 on the host once and kept."""
        key = (grid_hw, head_dim, like.dtype, like.device)
        if key not in self._tables:
            cos, sin = rope_cos_sin(grid_hw, head_dim, self.pt_seq_len)
            with torch.inference_mode(False):   # usable by a later step with gradients
                self._tables[key] = tuple(torch.as_tensor(t, dtype=like.dtype).to(like.device)
                                          for t in (cos, sin))
        return self._tables[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.norm1(x)
        if self.window_size > 0:
            y, padded = window_partition(y, self.window_size)
            grid = (self.window_size, self.window_size)
        else:
            y, grid = y.reshape(b, h * w, c), (h, w)
        y = self.attn(y, *self.rope(grid, c // self.heads, y))
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, padded, (h, w))
        else:
            y = y.reshape(b, h, w, c)
        x = x + y
        x = x + self.mlp(self.norm2(x))
        return x if self.residual is None else self.residual(x)


class SimpleFeaturePyramid(nn.Module):
    """eva.py:698-804: per scale factor (relative to the stride-16 map) a
    resampler (two deconvolutions with a channel LN and GELU between for 4,
    one for 2, none for 1, a 2 x 2 max-pool for 0.5), then a 1x1 and a 3x3
    convolution without bias, each with a channel LN. Stage ``simfp_{s}``
    with s = log2(16 / scale)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        dim = in_channels
        for scale in self.scale_factors:
            if scale == 4.0:
                layers, cout = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2),
                                ChannelLN(dim // 2), nn.GELU(),
                                nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)], dim // 4
            elif scale == 2.0:
                layers, cout = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)], dim // 2
            elif scale == 1.0:
                layers, cout = [], dim
            elif scale == 0.5:
                layers, cout = [nn.MaxPool2d(2, stride=2)], dim
            else:
                raise NotImplementedError(f"scale {scale}")
            layers += [NormConv2d(cout, out_channels, 1), NormConv2d(out_channels, out_channels, 3)]
            self.add_module(f"simfp_{int(math.log2(16 / scale))}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, C, h, w) -> one NCHW map per scale factor."""
        return tuple(stage(x) for stage in self.children())


class EVAViT(nn.Module):
    """eva.py:312-696: patch embedding, the position table at the working
    grid, the blocks, the adapter. The defaults are the JAX package's (the
    EVA-02-B widths); ``img_size`` (H, W) the images it takes, which fixes
    ``pos_embed``'s grid."""

    def __init__(self, img_size: Sequence[int] = (256, 512), patch_size: int = 16,
                 width: int = 768, heads: int = 12, layers: int = 12, window_size: int = 16,
                 window_block_indexes: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10),
                 residual_block_indexes: Sequence[int] = (), pt_hw_seq_len: int = 16,
                 out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5), fusion_stage: int = 0):
        super().__init__()
        self.patch_size, self.fusion_stage = patch_size, fusion_stage
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros((1,) + self.grid + (width,)))
        self.blocks = nn.ModuleList(
            EVABlock(width, heads, window_size if i in window_block_indexes else 0,
                     use_residual_block=i in residual_block_indexes, pt_seq_len=pt_hw_seq_len)
            for i in range(layers))
        self.adapter = SimpleFeaturePyramid(width, out_channels, scale_factors)
        self.strides = tuple(int(patch_size / s) for s in scale_factors)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, 3, H, W) -> the adapter's maps, (B, out_channels, H / s, W / s)."""
        h = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        if tuple(h.shape[1:3]) != self.grid:
            raise ValueError(f"images of {tuple(x.shape[2:])} give a {tuple(h.shape[1:3])} "
                             f"token grid; pos_embed is at {self.grid}: build the backbone "
                             f"with img_size {tuple(x.shape[2:])}")
        h = h + self.pos_embed
        res = None
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if self.fusion_stage and i == self.fusion_stage - 1:
                res = h
        if self.fusion_stage:
            h = h + res
            for blk in self.blocks[self.fusion_stage:]:
                h = blk(h)
        return self.adapter(h.permute(0, 3, 1, 2))


def pos_embed_from_reference(pos: torch.Tensor, grid_hw: Sequence[int],
                             use_cls_token: bool = True) -> torch.Tensor:
    """The reference's (1, [1 +] n, C) pretrain table at the working grid,
    (1, H, W, C), as its ``get_abs_pos`` computes it (blocks.py): the class
    token dropped, the square table resized by ``F.interpolate``, bicubic,
    align_corners False; unchanged when the grid already matches."""
    if use_cls_token:
        pos = pos[:, 1:]
    n, c = pos.shape[1], pos.shape[-1]
    side = int(round(math.sqrt(n)))
    if side * side != n:
        raise ValueError(f"a position table of {n} entries is not square")
    grid = pos.reshape(1, side, side, c)
    if (side, side) == tuple(grid_hw):
        return grid
    out = F.interpolate(grid.permute(0, 3, 1, 2).float(), size=tuple(grid_hw), mode="bicubic",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(pos.dtype)
