"""Legacy (non-transformer) UNet attention, the ``use_spatial_transformer
=False`` form (counterpart of ``panacea_tpu/models/legacy_attention.py``;
reference openaimodel.py:544-775: AttentionBlock3D, QKVAttentionLegacy,
QKVAttention).

No shipped config selects it. Channels-last, with the reference's quirks:

  * the two-sided scale (q s) . (k s) with s = 1/sqrt(sqrt(ch));
  * the legacy channel order of the fused qkv, heads-major with (q, k, v)
    inside each head, beside the new order, (q, k, v)-major;
  * the temporal half applies the SPATIAL ``qkv``: ``qkv_temporal`` exists
    only as parameters, so that checkpoints map one to one.

The projections are the reference's k=1 ``Conv1d``s (``qkv``, ``proj_out``
and their ``_temporal`` twins), applied to channels-last tokens as linears.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.models.layers import GroupNorm, zero_init
from panacea_tpu_torch.parallel import shardctx


def qkv_attention(qkv: torch.Tensor, n_heads: int, legacy_order: bool = True) -> torch.Tensor:
    """qkv: (N, L, 3*H*ch) channels-last. Returns (N, L, H*ch)."""
    n, length, width = qkv.shape
    if width % (3 * n_heads):
        raise ValueError(f"qkv width {width} is not a multiple of 3 x {n_heads} heads")
    ch = width // (3 * n_heads)
    if legacy_order:
        q, k, v = qkv.reshape(n, length, n_heads, 3 * ch).chunk(3, dim=-1)
    else:
        q, k, v = (t.reshape(n, length, n_heads, ch) for t in qkv.chunk(3, dim=-1))
    scale = 1.0 / float(ch) ** 0.25
    logits = torch.einsum("nthc,nshc->nhts", (q * scale).float(), (k * scale).float())
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhts,nshc->nthc", w, v).reshape(n, length, n_heads * ch)


def _conv1x1(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A k=1 Conv1d on channels-last tokens (..., C)."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class LegacyAttentionBlock3D(nn.Module):
    """AttentionBlock3D (openaimodel.py:603-677): spatial self-attention with
    a residual, then per-pixel self-attention over the frames with a
    residual. ``temporal=False`` is the plain 2-D AttentionBlock
    (:544-601). The text context is accepted and ignored."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 use_new_attention_order: bool = False, num_frames: int = 8,
                 temporal: bool = True):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.legacy_order = not use_new_attention_order
        self.num_frames = num_frames
        self.temporal = temporal
        self.norm = GroupNorm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_init(nn.Conv1d(channels, channels, 1))
        if temporal:
            self.norm_temporal = GroupNorm(channels)
            self.qkv_temporal = nn.Conv1d(channels, 3 * channels, 1)   # never applied
            self.proj_out_temporal = zero_init(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        if shardctx.current() is not None:
            raise NotImplementedError("LegacyAttentionBlock3D (use_spatial_transformer=False) "
                                      "has no sharded form: run it on one rank")
        n, hh, ww, c = x.shape
        h = _conv1x1(self.qkv, self.norm(x).reshape(n, hh * ww, c))
        h = qkv_attention(h, self.heads, self.legacy_order)
        x = x + _conv1x1(self.proj_out, h).reshape(n, hh, ww, c)
        if not self.temporal:
            return x
        # (b t) h w c -> (b h w) t c
        t = self.num_frames
        b = n // t
        xt = x.reshape(b, t, hh, ww, c).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, c)
        ht = _conv1x1(self.qkv, self.norm_temporal(xt))   # the reference's spatial qkv
        ht = qkv_attention(ht, self.heads, self.legacy_order)
        out = xt + _conv1x1(self.proj_out_temporal, ht)
        return out.reshape(b, hh, ww, t, c).permute(0, 3, 1, 2, 4).reshape(n, hh, ww, c)
