"""Attention dispatch (counterpart of ``panacea_tpu/ops/attention.py:203-251``).

Layout: q (B, Sq, H, D), k and v (B, Skv, H, D) -> (B, Sq, H, D).

A call with Sq >= 128 and either Skv > Sq or per-row ``kv_lens`` goes to the
flash kernel (``ops/flash_attention.py``): on the main path that is the
cross-view call of views 0-4, whose [left, right] neighbour K/V make
Skv = 2 Sq. Every other call is plain PyTorch
(``F.scaled_dot_product_attention``), as the JAX package hands those calls
to XLA and not to Pallas: intra-view Skv == Sq, text cross Skv = 77, the
8-frame temporal stage, the VAE mid-block, the last-view call and the
mid-block transformers with Sq = 32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from panacea_tpu_torch.ops.flash_attention import flash_attention


def attention_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None,
                   kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense attention through ``F.scaled_dot_product_attention``. Keys at
    or past ``kv_lens[b]`` get -1e30 added to their scores, as in the
    reference ``attention_xla``: a row with no valid key gets the uniform
    softmax, the mean of V. Without ``kv_lens`` the call takes no mask, so
    SDPA keeps its fused backends."""
    mask = None
    if kv_lens is not None:
        col = torch.arange(k.shape[1], device=k.device)
        valid = (col[None, :] < kv_lens.to(k.device)[:, None])[:, None, None, :]
        mask = torch.zeros(valid.shape, dtype=q.dtype, device=q.device).masked_fill(~valid, -1e30)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale)
    return out.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None,
              kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention, routed by shape."""
    sq, skv = q.shape[1], k.shape[1]
    if sq >= 128 and (skv > sq or kv_lens is not None):
        return flash_attention(q, k, v, scale=scale, kv_lens=kv_lens)
    return attention_sdpa(q, k, v, scale=scale, kv_lens=kv_lens)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, S, H, D)"""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D)"""
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)
