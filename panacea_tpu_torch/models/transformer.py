"""Decomposed 4D attention transformer (counterpart of
``panacea_tpu/models/transformer.py``; reference sgm/modules/attention.py:
92-115, 203-747, 898-1134).

  * intra-view: self-attention within each of the 6 camera views, the view
    axis folded into the batch (one attention call).
  * full: self-attention over every token of the panorama (stage 1's
    single-view mode; Skv == Sq, so the dispatch hands it to SDPA).
  * inter-view: view i attends to the K/V of its neighbours [i-1, i+1] with
    wraparound, except the last view (FL), which sees its left neighbour
    only (reference quirk, attention.py:545-559). Views 0-4 make one call
    with Skv = 2 Sq, which goes to the flash kernel.
  * temporal: per-pixel attention over the frames with the legacy sin-cos
    embedding.
  * text cross-attention: K/V projected once per clip; the frames sharing a
    clip's context are folded into the query sequence.

The feed-forward is GEGLU through the fused kernel (``ops/geglu.py``).

Under a sharded context (``parallel/shardctx.py``) a rank holds 1/V of the
views and 1/t of the frames: the inter-view mode runs the ring
(``parallel/ring_attention.py``), 'full' gathers K and V over the view
group, and the temporal stage runs between two all-to-alls over the frame
group, with the sin-cos table of the clip's full T. Intra-view attention,
text cross-attention, the LayerNorms and the GEGLU stay rank-local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.diffusion.util import sincos_1d_embedding
from panacea_tpu_torch.models.layers import GroupNorm, zero_init
from panacea_tpu_torch.ops.attention import attention, merge_heads, split_heads
from panacea_tpu_torch.ops.geglu import geglu
from panacea_tpu_torch.ops.panorama import NUM_VIEWS, merge_views, neighbor_kv, split_views
from panacea_tpu_torch.parallel import shardctx
from panacea_tpu_torch.parallel.ring_attention import ring_cross_view_attention


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around the attention op (transformer.py:41-124)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                attn_fn=attention) -> torch.Tensor:
        """x: (B, S, C). context: (B', L, D) with B = B' * r: r frames share
        one clip's context and are folded into the query sequence.
        ``attn_fn(q, k, v)`` on (B, S, H, D) heads: the attention op, or
        the sharded context's ring or gathered form."""
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        if context is None:
            # self-attention: one merged qkv product, a single read of x
            q, k, v = F.linear(x, torch.cat([wq, wk, wv])).chunk(3, dim=-1)
        else:
            q = F.linear(x, wq)
            k, v = F.linear(context, torch.cat([wk, wv])).chunk(2, dim=-1)
        b, s, inner = q.shape
        bk = k.shape[0]
        if bk != b:
            if b % bk:
                raise ValueError(f"query batch {b} is not a multiple of context batch {bk}")
            q = q.reshape(bk, (b // bk) * s, inner)
        out = attn_fn(split_heads(q, self.heads), split_heads(k, self.heads),
                      split_heads(v, self.heads))
        out = merge_heads(out)
        if bk != b:
            out = out.reshape(b, s, inner)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu(x, self.proj.weight, self.proj.bias)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP (transformer.py:146-172, reference attention.py:92-115)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """attn1 (self or a spatial variant) + attn2 (text cross) + GEGLU FF,
    each pre-LayerNorm with a residual (transformer.py:175-331).

    mode: 'full' | 'intra-view' | 'inter-view' | 'temporal'. Spatial modes
    take x (N, H, W, C); 'temporal' takes (B*H*W, T, C).
    """

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, mode: str):
        super().__init__()
        if mode not in ("full", "intra-view", "inter-view", "temporal"):
            raise ValueError(f"unknown attention mode {mode!r}")
        self.mode = mode
        self.attn1 = MultiHeadAttention(dim, heads, dim_head)
        self.attn2 = MultiHeadAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                temporal_tail: Optional[tuple] = None) -> torch.Tensor:
        if self.mode == "temporal":
            x = x + self.attn1(self.norm1(x))
            if temporal_tail is not None:
                # back to frame-major (B*T, H*W, C) before attn2 and the FF,
                # which are token-wise (transformer.py:198-216)
                b, hh, ww, t = temporal_tail
                c = x.shape[-1]
                x = x.reshape(b, hh * ww, t, c).transpose(1, 2).reshape(b * t, hh * ww, c)
            x = x + self.attn2(self.norm2(x), context=context)
            return x + self.ff(self.norm3(x))

        n, hh, ww, c = x.shape
        h = self.norm1(x)
        g = shardctx.current()
        split = g is not None and g.view > 1   # this rank holds 6 / V of the views
        nv = shardctx.local_views()
        wv = ww // nv
        s = hh * wv
        if self.mode == "intra-view":
            tokens = split_views(h, nv).reshape(n * nv, s, c)
            out = merge_views(self.attn1(tokens).reshape(n, nv, hh, wv, c))
        elif self.mode == "inter-view" and split:
            tokens = split_views(h, nv).reshape(n * nv, s, c)

            def ring(q, k, v):   # (n * nv, s, H, D) -> the ring's (n, nv, s, H, D)
                def by_view(z):
                    return z.reshape(n, nv, s, *z.shape[2:])

                return ring_cross_view_attention(by_view(q), by_view(k), by_view(v),
                                                 g).flatten(0, 1)

            out = self.attn1(tokens, context=tokens, attn_fn=ring)
            out = merge_views(out.reshape(n, nv, hh, wv, c))
        elif self.mode == "inter-view":
            tokens = split_views(h).reshape(n, NUM_VIEWS, s, c)
            kv_both = neighbor_kv(tokens)                    # (n, V, 2s, c)
            out04 = self.attn1(tokens[:, :NUM_VIEWS - 1].reshape(-1, s, c),
                               context=kv_both[:, :NUM_VIEWS - 1].reshape(-1, 2 * s, c))
            out5 = self.attn1(tokens[:, NUM_VIEWS - 1],
                              context=kv_both[:, NUM_VIEWS - 1, :s])
            out = torch.cat([out04.reshape(n, NUM_VIEWS - 1, s, c), out5[:, None]], dim=1)
            out = merge_views(out.reshape(n, NUM_VIEWS, hh, wv, c))
        elif split:   # full, over the panorama's tokens on every view rank
            def gathered(q, k, v):
                kv = shardctx.gather_view(torch.stack([k, v]), dim=2)
                return attention(q, kv[0], kv[1])

            out = self.attn1(h.reshape(n, hh * ww, c), attn_fn=gathered).reshape(n, hh, ww, c)
        else:  # full: every token of the panorama (transformer.py:307-309)
            out = self.attn1(h.reshape(n, hh * ww, c)).reshape(n, hh, ww, c)
        x = x + out
        h = self.norm2(x).reshape(n, hh * ww, c)
        x = x + self.attn2(h, context=context).reshape(n, hh, ww, c)
        return x + self.ff(self.norm3(x))


class SpatialTemporalTransformer(nn.Module):
    """Spatial stage -> cross-view stage -> temporal stage, each with its own
    GroupNorm, in/out projections (zero-init out) and residual
    (transformer.py:334-453; the use_linear=True form of the reference)."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, num_frames: int = 8,
                 spatial_attn_mode: str = "intra-view", insert_crossview: bool = True):
        super().__init__()
        inner = num_heads * head_dim
        self.num_frames = num_frames
        self.insert_crossview = insert_crossview

        def blocks(mode):
            return nn.ModuleList([BasicTransformerBlock(inner, num_heads, head_dim,
                                                        context_dim, mode)
                                  for _ in range(depth)])

        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = blocks(spatial_attn_mode)
        self.proj_out = zero_init(nn.Linear(inner, channels))
        if insert_crossview:
            self.norm_crossview = GroupNorm(channels, eps=1e-6)
            self.proj_in_crossview = nn.Linear(channels, inner)
            self.transformer_blocks_crossview = blocks("inter-view")
            self.proj_out_crossview = zero_init(nn.Linear(inner, channels))
        self.norm_temporal = GroupNorm(channels, eps=1e-6)
        self.proj_in_temporal = nn.Linear(channels, inner)
        self.transformer_blocks_temporal = blocks("temporal")
        self.proj_out_temporal = zero_init(nn.Linear(inner, channels))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) with N = B*T; context: (B, L, context_dim) per clip."""
        h = self.proj_in(self.norm(x))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        x = x + self.proj_out(h)

        if self.insert_crossview:
            h = self.proj_in_crossview(self.norm_crossview(x))
            for blk in self.transformer_blocks_crossview:
                h = blk(h, context)
            x = x + self.proj_out_crossview(h)
        return self.temporal_stage(x, context)

    def temporal_stage(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """The temporal stage with its residual: per-pixel attention over
        the frames."""
        n, hh, ww, _ = x.shape
        t = shardctx.local_frames(self.num_frames)   # this rank's frames of each clip
        b = n // t
        h = self.proj_in_temporal(self.norm_temporal(x))
        inner = h.shape[-1]
        g = shardctx.current()
        depth = len(self.transformer_blocks_temporal)
        if g is not None and g.t > 1:
            # frames over the t group: all T frames of 1/t of the pixels on
            # each rank (the all-to-all in), the blocks without the tail's
            # back-transpose, and the all-to-all out (JAX transformer.py:397-447)
            h = shardctx.temporal_in(h, b, t)
            pe = sincos_1d_embedding(self.num_frames, inner, legacy_int_freq=True)
            h = h + torch.as_tensor(pe, dtype=h.dtype, device=h.device)
            for blk in self.transformer_blocks_temporal:
                h = blk(h, context)
            return x + self.proj_out_temporal(shardctx.temporal_out(h, b, hh, ww))
        # (B*T, H, W, C) -> (B*H*W, T, C)
        h = h.reshape(b, t, hh, ww, inner).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, inner)
        pe = sincos_1d_embedding(t, inner, legacy_int_freq=True)  # as trained
        h = h + torch.as_tensor(pe, dtype=h.dtype, device=h.device)
        for d, blk in enumerate(self.transformer_blocks_temporal):
            # the last block returns frame-major (B*T, H*W, C)
            h = blk(h, context, temporal_tail=(b, hh, ww, t) if d == depth - 1 else None)
        return x + self.proj_out_temporal(h.reshape(n, hh, ww, inner))
