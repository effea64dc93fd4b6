"""PETRHeadDN: the non-streaming PETRv2 dense head with denoising queries.

Counterpart of ``panacea_tpu/perception/petr_head_dn.py`` (reference
models/dense_heads/petr_head_dn.py:31-905): ``StreamPETRHead``'s tokens,
frustum position encoding and decoder layers, with no streaming memory. It
has no pseudo reference points, time embedding or ego-motion MLNs (so its
state dict is the reference's), and its self-attention runs over the
current queries only (tgt None and no temp_memory, :456). The memory
passed in is returned untouched (reset_memory is a no-op, :284-285).

With the eval recipe's 644 queries the self-attention has Sq = Skv = 644,
which the router keeps on ``F.scaled_dot_product_attention`` as the JAX
package keeps it on XLA; the cross-attention to the tokens takes the flash
kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from panacea_tpu_torch.perception.encoding import pos2posemb3d
from panacea_tpu_torch.perception.head import MemoryState
from panacea_tpu_torch.perception.petr_head import StreamPETRHead


class PETRHeadDN(StreamPETRHead):
    """StreamPETRHead's config; memory_len, num_propagated and
    topk_proposals are inert (kept so the detector builds every head
    alike)."""

    def _uses_memory(self) -> bool:
        return False

    def forward(self, mlvl_feats: Sequence[torch.Tensor], memory: MemoryState,
                data: Dict[str, torch.Tensor], pad_hw: Tuple[int, int], dn: Optional[Any] = None,
                topk_indexes: Optional[torch.Tensor] = None):
        """One frame (petr_head_dn.py:437-512). Returns (outs, memory)."""
        tokens, pos_embed = self.encode_tokens(mlvl_feats[self.feat_level], data, pad_hw,
                                               topk_indexes)
        ref, tgt = self.make_queries(tokens.shape[0], dn, data)
        query_pos = self.query_embedding(pos2posemb3d(ref))
        all_cls, all_reg, _ = self.decode(tgt, query_pos, ref, tokens, pos_embed,
                                          attn_bias=dn.attn_mask if dn is not None else None)
        return self.split_dn(all_cls, all_reg, dn.pad_size if dn is not None else 0), memory
